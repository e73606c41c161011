"""Oracle renderer: exact but slow per-pixel splatting, O(N·H·W).

Port of `wast3d_tpu/ops/rasterizer/oracle.py`, the test-only reference of
the compositing semantics of `renderCUDA`:

- per-pixel jittered sample position pixf = pix + offset;
- alpha = min(0.99, opacity * exp(power)), skipped when power > 0 or
  alpha < 1/255; power is clipped to [-50, 0] before the exp, so far-away
  Gaussians keep finite gradients;
- front-to-back order by view depth (a stable sort, invalid Gaussians at
  +inf); compositing stops *before* the Gaussian whose inclusion would
  push transmittance below 1e-4;
- expected depth D += depth * alpha * T; final color = C + T_final * bg.

With tile_cull=True (default) a Gaussian only touches the pixels of the
tiles in its 3-sigma screen rect, the tile taken from the integer pixel
before jitter, as the tiled renderers do; tile_cull=False composites every
Gaussian at every pixel.

Plain PyTorch on the device of `prep`, differentiable by autograd; it
launches no kernel. It holds [row_block, W, N] tensors for every quantity
of a block of rows, so memory and time grow as N·H·W: use it at test
sizes (a few thousand Gaussians, a few hundred pixels a side).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from wast3d_tpu_torch.ops.rasterizer.binning import TILE, compute_rects, tile_grid
from wast3d_tpu_torch.ops.rasterizer.preprocess import Preprocessed

ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
T_EPS = 1e-4


def _sort_by_depth(prep: Preprocessed) -> Preprocessed:
    inf = torch.full_like(prep.depths, float("inf"))
    order = torch.argsort(torch.where(prep.valid, prep.depths.detach(), inf), stable=True)
    return Preprocessed(*(x[order] for x in prep))


def render_oracle(
    prep: Preprocessed,
    width: int,
    height: int,
    bg_color: torch.Tensor,
    sampling_offsets: Optional[torch.Tensor] = None,
    row_block: int = 16,
    tile_cull: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Composite all Gaussians at every pixel, `row_block` rows at a time.
    Returns (color [H,W,3], depth [H,W], final_T [H,W])."""
    prep = _sort_by_depth(prep)
    dev = prep.means2d.device
    xs = torch.arange(width, dtype=torch.float32, device=dev)
    ys = torch.arange(height, dtype=torch.float32, device=dev)
    py, px = torch.meshgrid(ys, xs, indexing="ij")  # [H,W]
    tx = (px / TILE).to(torch.int64)  # tile of the *integer* pixel
    ty = (py / TILE).to(torch.int64)
    if sampling_offsets is not None:
        px = px + sampling_offsets[..., 0]
        py = py + sampling_offsets[..., 1]
    gx, gy = tile_grid(width, height)
    xmin, ymin, xmax, ymax = compute_rects(prep.means2d.detach(), prep.radii, gx, gy)

    conic = prep.conics
    alpha_gate = prep.valid & (prep.radii > 0)
    mx, my = prep.means2d[:, 0], prep.means2d[:, 1]
    bg = bg_color.to(dev, torch.float32)

    colors, depths, finals = [], [], []
    for r0 in range(0, height, row_block):
        pxr, pyr = px[r0:r0 + row_block], py[r0:r0 + row_block]  # [B,W]
        dx = mx - pxr[..., None]  # [B,W,N]
        dy = my - pyr[..., None]
        gate = alpha_gate
        if tile_cull:
            txr = tx[r0:r0 + row_block, :, None]
            tyr = ty[r0:r0 + row_block, :, None]
            gate = gate & (txr >= xmin) & (txr < xmax) & (tyr >= ymin) & (tyr < ymax)
        power = (-0.5 * (conic[:, 0] * dx * dx + conic[:, 2] * dy * dy)
                 - conic[:, 1] * dx * dy)
        alpha = torch.clamp_max(
            prep.opacities * torch.exp(torch.clamp(power, -50.0, 0.0)), ALPHA_MAX)
        skip = (power > 0.0) | (alpha < ALPHA_MIN) | ~gate
        alpha = torch.where(skip, torch.zeros_like(alpha), alpha)

        # Transmittance before each Gaussian (exclusive cumprod, front to back).
        one_m = 1.0 - alpha
        cp = torch.cumprod(one_m, dim=-1)
        t_prev = torch.cat([torch.ones_like(cp[..., :1]), cp[..., :-1]], dim=-1)
        # Stop before the Gaussian that would drop T below 1e-4.
        test_t = t_prev * one_m
        done = torch.cumsum((test_t < T_EPS).to(torch.int32), dim=-1) > 0
        zero = torch.zeros_like(alpha)
        w = torch.where(done, zero, alpha * t_prev)  # [B,W,N]

        color = torch.einsum("bwn,nc->bwc", w, prep.colors)
        depth = torch.einsum("bwn,n->bw", w, prep.depths)
        final_t = torch.prod(1.0 - torch.where(done, zero, alpha), dim=-1)
        colors.append(color + final_t[..., None] * bg)
        depths.append(depth)
        finals.append(final_t)
    return torch.cat(colors), torch.cat(depths), torch.cat(finals)
