"""K1, the per-tile alpha-blend forward: CUDA kernel wrapper + plain version.

`blend_fwd` replaces `wast3d_tpu/ops/rasterizer/pallas_blend.py::blend`
(forward, exact f32 tier). For a CUDA tensor it launches the hand-written
kernel `csrc/blend_fwd.cu` or raises; for a CPU tensor it runs
`blend_fwd_reference`, the plain PyTorch version of the same function. Nothing
falls back from one to the other.

Inputs (one layout for both):
  rows    [K, 12] f32, the sorted duplicates: mx, my, A, B, C, opa, depth,
          r, g, b, pad, pad; means in image pixel coordinates.
  starts, ends  [T] int32, each tile's range [start, end) into `rows`;
          tiles are row-major over the ceil(W/16) x ceil(H/16) grid.
  bg      [3] f32 background colour.
  offsets [H, W, 2] f32 per-pixel sample offsets (jitter), or None.
Outputs, in image layout with the background composited:
  color [H, W, 3], depth [H, W] (sum of depth * alpha * T), final_T [H, W].

Per pixel, entries are taken front to back: alpha = min(0.99,
opa * exp(power)) with power = -1/2 (A dx^2 + C dy^2) - B dx dy; an entry is
skipped if power > 0 or alpha < 1/255; the walk stops *before* the entry
that would take T below 1e-4.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from wast3d_tpu_torch.ops.rasterizer.binning import TILE, tile_grid

ROW = 12
R_MX, R_MY, R_A, R_B, R_C, R_OPA, R_DEPTH, R_R, R_G, R_B2 = range(10)
ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
T_EPS = 1e-4
PIXELS = TILE * TILE
CHUNK = 32  # entry slots per step of the plain version


class BlendOutput(NamedTuple):
    color: torch.Tensor  # [H, W, 3]
    depth: torch.Tensor  # [H, W]
    final_T: torch.Tensor  # [H, W]


def _check_inputs(rows, starts, ends, width, height, bg, offsets):
    dev = rows.device
    grid_x, grid_y = tile_grid(width, height)
    num_tiles = grid_x * grid_y
    want = [
        ("rows", rows, torch.float32, None),
        ("starts", starts, torch.int32, (num_tiles,)),
        ("ends", ends, torch.int32, (num_tiles,)),
        ("bg", bg, torch.float32, (3,)),
    ]
    if offsets is not None:
        want.append(("offsets", offsets, torch.float32, (height, width, 2)))
    if rows.dim() != 2 or rows.shape[1] != ROW:
        raise ValueError(f"rows must be [K, {ROW}], got {tuple(rows.shape)}")
    for name, t, dtype, shape in want:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, rows on {dev}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return num_tiles


def blend_fwd(rows: torch.Tensor, starts: torch.Tensor, ends: torch.Tensor,
              width: int, height: int, bg: torch.Tensor,
              offsets: Optional[torch.Tensor] = None) -> BlendOutput:
    """K1. CUDA tensors launch the kernel (counted in `blend_fwd.launches`);
    CPU tensors take `blend_fwd_reference`."""
    num_tiles = _check_inputs(rows, starts, ends, width, height, bg, offsets)
    dev = rows.device
    if dev.type == "cpu":
        return blend_fwd_reference(rows, starts, ends, width, height, bg, offsets)
    if dev.type != "cuda":
        raise ValueError(f"blend_fwd runs on cuda or cpu, not {dev}")
    from wast3d_tpu_torch import _build

    lib = _build.load_library()
    color = torch.empty((height, width, 3), dtype=torch.float32, device=dev)
    depth = torch.empty((height, width), dtype=torch.float32, device=dev)
    final_t = torch.empty((height, width), dtype=torch.float32, device=dev)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    err = lib.w3d_blend_fwd(
        rows.data_ptr(), starts.data_ptr(), ends.data_ptr(),
        None if offsets is None else offsets.data_ptr(), bg.data_ptr(),
        color.data_ptr(), depth.data_ptr(), final_t.data_ptr(),
        width, height, tile_grid(width, height)[0], num_tiles, index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"blend_fwd kernel launch failed: CUDA error {err} "
            f"({lib.w3d_error_string(err).decode()})")
    blend_fwd.launches += 1
    return BlendOutput(color, depth, final_t)


blend_fwd.launches = 0


def _pixel_coords(width, height, offsets, device):
    """[T, 256] sample coordinates per tile pixel (image coordinates plus
    jitter) and the [T, 256] mask of pixels inside the image."""
    grid_x, grid_y = tile_grid(width, height)
    t = torch.arange(grid_x * grid_y, device=device)
    p = torch.arange(PIXELS, device=device)
    x = (t % grid_x)[:, None] * TILE + (p % TILE)[None, :]
    y = (t // grid_x)[:, None] * TILE + (p // TILE)[None, :]
    inside = (x < width) & (y < height)
    px, py = x.to(torch.float32), y.to(torch.float32)
    if offsets is not None:
        flat = (y.clamp(max=height - 1) * width + x.clamp(max=width - 1))
        off = offsets.reshape(-1, 2)[flat]
        zero = torch.zeros_like(px)
        px = px + torch.where(inside, off[..., 0], zero)
        py = py + torch.where(inside, off[..., 1], zero)
    return px, py, inside


def _walk(rows, starts, ends, width, height, offsets):
    """The plain blend over all pixels of all tiles at once, CHUNK entry
    slots per step: a cumprod gives T inside a chunk, and T and `done` carry
    from chunk to chunk. Returns per-tile colour, depth, T and the number of
    (pixel, entry) pairs the walk evaluates."""
    dev = rows.device
    px, py, inside = _pixel_coords(width, height, offsets, dev)
    num_tiles = px.shape[0]
    starts, ends = starts.long(), ends.long()
    lengths = ends - starts
    t_run = torch.ones((num_tiles, PIXELS), dtype=torch.float32, device=dev)
    done = ~inside  # pixels beyond the image take part in nothing
    color = torch.zeros((num_tiles, PIXELS, 3), dtype=torch.float32, device=dev)
    depth = torch.zeros((num_tiles, PIXELS), dtype=torch.float32, device=dev)
    pairs = torch.zeros((), dtype=torch.int64, device=dev)
    slot = torch.arange(CHUNK, device=dev)
    max_len = int(lengths.max()) if num_tiles else 0
    for c0 in range(0, max_len, CHUNK):
        ti = torch.nonzero((lengths > c0) & ~done.all(dim=1)).squeeze(1)
        if ti.numel() == 0:
            break
        idx = starts[ti, None] + c0 + slot[None, :]  # [A, G]
        in_range = idx < ends[ti, None]
        r = rows[torch.minimum(idx, ends[ti, None] - 1)]  # [A, G, 12]
        dx = r[:, None, :, R_MX] - px[ti][:, :, None]  # [A, P, G]
        dy = r[:, None, :, R_MY] - py[ti][:, :, None]
        a = r[:, None, :, R_A]
        b = r[:, None, :, R_B]
        c = r[:, None, :, R_C]
        power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
        alpha = torch.clamp_max(r[:, None, :, R_OPA] * torch.exp(power), ALPHA_MAX)
        skip = (power > 0.0) | (alpha < ALPHA_MIN) | ~in_range[:, None, :]
        alpha = torch.where(skip, torch.zeros_like(alpha), alpha)

        one_m = 1.0 - alpha
        cp = torch.cumprod(one_m, dim=-1)
        t_prev = t_run[ti][..., None] * torch.cat(
            [torch.ones_like(cp[..., :1]), cp[..., :-1]], dim=-1)
        stop = torch.cumsum((t_prev * one_m < T_EPS).to(torch.int32), dim=-1) > 0
        done_before = done[ti][..., None]
        done_g = done_before | stop
        w = torch.where(done_g, torch.zeros_like(alpha), alpha * t_prev)
        color[ti] += torch.einsum("apg,agc->apc", w, r[..., R_R:R_B2 + 1])
        depth[ti] += torch.einsum("apg,ag->ap", w, r[..., R_DEPTH])
        kept = torch.where(done_g, torch.zeros_like(alpha), alpha)
        t_run[ti] = t_run[ti] * torch.prod(1.0 - kept, dim=-1)
        # an entry is evaluated unless the pixel stopped at an earlier one
        stopped_earlier = done_before | torch.cat(
            [torch.zeros_like(stop[..., :1]), stop[..., :-1]], dim=-1)
        pairs += (~stopped_earlier & in_range[:, None, :]).sum()
        done[ti] = done_g[..., -1]
    return color, depth, t_run, pairs


def _untile(x, width, height):
    grid_x, grid_y = tile_grid(width, height)
    ch = x.shape[-1]
    img = x.reshape(grid_y, grid_x, TILE, TILE, ch).permute(0, 2, 1, 3, 4)
    return img.reshape(grid_y * TILE, grid_x * TILE, ch)[:height, :width]


def blend_fwd_reference(rows: torch.Tensor, starts: torch.Tensor,
                        ends: torch.Tensor, width: int, height: int,
                        bg: torch.Tensor,
                        offsets: Optional[torch.Tensor] = None) -> BlendOutput:
    """Plain PyTorch version of K1: same inputs, same outputs, same skip and
    stop rules in the same order; runs on any device."""
    _check_inputs(rows, starts, ends, width, height, bg, offsets)
    color, depth, t_run, _ = _walk(rows, starts, ends, width, height, offsets)
    color = color + t_run[..., None] * bg
    return BlendOutput(
        color=_untile(color, width, height).contiguous(),
        depth=_untile(depth[..., None], width, height)[..., 0].contiguous(),
        final_T=_untile(t_run[..., None], width, height)[..., 0].contiguous(),
    )


def evaluated_pairs(rows: torch.Tensor, starts: torch.Tensor,
                    ends: torch.Tensor, width: int, height: int,
                    offsets: Optional[torch.Tensor] = None) -> int:
    """Number of (pixel, entry) pairs K1 evaluates on these inputs: every
    entry in range up to and including the one where the pixel stops. Used
    to state the kernel's operation count."""
    return int(_walk(rows, starts, ends, width, height, offsets)[3])
