"""The photometric loss of a row-strip-sharded render, by halo exchange.

Port of `wast3d_tpu/parallel/losses.py`. `render_sharded` leaves each rank
of the model axis with a strip of image rows. SSIM's window is 11 taps
(sigma 1.5), so a strip needs only the 5 rows on either side of it from its
neighbours: each rank sends its first 5 rows up and its last 5 rows down
(one `collectives.all_to_all`, whose backward is the reverse exchange),
computes the L1 and SSIM sums over its own rows below the image height H,
and the two partial sums are added over the axis (`all_reduce_sum`). The
strips at the image's edges receive zeros, which is the zero padding of the
unsharded blur (`ops.image_losses._depthwise_blur`).

Exactness: rows at or beyond H (the strip padding of the tile grid) are
masked to zero, as the unsharded loss's [:H] crop drops them; each pixel's
blur is the same shifted multiply-adds in the same order as the unsharded
blur, and the sums divide by the same H W C. Only the order of the final
sums differs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from wast3d_tpu_torch.ops.image_losses import _gaussian_window
from wast3d_tpu_torch.parallel import collectives as C
from wast3d_tpu_torch.parallel.mesh import axis_group, axis_index, axis_size

HALO = 5  # (11-tap window) // 2


def _halo_extend(x: torch.Tensor, group, num_shards: int, me: int) -> torch.Tensor:
    """[rp, W, C] -> [rp + 2 HALO, W, C]: the strip above's last rows, the
    strip, the strip below's first rows (zeros at the image's edges)."""
    zeros = x.new_zeros((HALO,) + tuple(x.shape[1:]))
    if num_shards == 1:
        return torch.cat([zeros, x, zeros])
    up, down = me > 0, me < num_shards - 1
    send, recv = [0] * num_shards, [0] * num_shards
    parts = []
    if up:  # my first rows to the strip above; its last rows come back
        send[me - 1] = recv[me - 1] = HALO
        parts.append(x[:HALO])
    if down:
        send[me + 1] = recv[me + 1] = HALO
        parts.append(x[-HALO:])
    got = C.all_to_all(torch.cat(parts), send, recv, group)
    above = got[:HALO] if up else zeros
    below = got[-HALO:] if down else zeros
    return torch.cat([above, x, below])


def _blur_rows_valid(x: torch.Tensor, window: torch.Tensor, rp: int) -> torch.Tensor:
    """Vertical blur of a halo-extended strip [rp + 10, W, C] -> [rp, W, C]."""
    return sum(window[i] * x[i:i + rp] for i in range(window.shape[0]))


def _blur_cols_same(x: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """Horizontal zero-padded same-size blur of [rp, W, C] (row-local)."""
    k = window.shape[0]
    w = x.shape[1]
    xp = F.pad(x, (0, 0, k // 2, k // 2))
    return sum(window[i] * xp[:, i:i + w] for i in range(k))


def photometric_loss_sharded(render_strip: torch.Tensor, gt: torch.Tensor, mesh,
                             height: int, lambda_dssim: float = 0.2,
                             axis_name: str = "model") -> torch.Tensor:
    """(1 - lambda) L1 + lambda (1 - SSIM) of the whole image from this
    rank's strip [rp, W, 3] (rank r holds rows [r rp, (r + 1) rp) of the
    padded image, as `render_tile_sharded` returns them) and the full
    ground truth gt [H, W, 3]. Returns the same scalar on every rank of the
    axis, differentiable with respect to the strip."""
    group = axis_group(mesh, axis_name)
    num_shards, me = axis_size(mesh, axis_name), axis_index(mesh, axis_name)
    rp = render_strip.shape[0]
    if rp < HALO:
        raise ValueError(f"strip of {rp} rows < halo {HALO}: the single-neighbour "
                         f"halo exchange needs >= {HALO} rows per shard")
    row0 = me * rp
    gt = gt.to(render_strip.device, render_strip.dtype)
    gt_strip = F.pad(gt, (0, 0, 0, 0, 0, rp * num_shards - gt.shape[0]))[row0:row0 + rp]
    valid = ((row0 + torch.arange(rp, device=render_strip.device)) < height).to(
        render_strip.dtype)[:, None, None]
    x = render_strip * valid
    y = gt_strip * valid
    denom = float(height * x.shape[1] * x.shape[2])
    l1_part = torch.sum(torch.abs(x - y)) / denom

    c = x.shape[2]
    xye = _halo_extend(torch.cat([x, y], 2), group, num_shards, me)  # one exchange
    xe, ye = xye[..., :c], xye[..., c:]
    w = _gaussian_window(11, 1.5, x.device)

    def blur(a):
        return _blur_cols_same(_blur_rows_valid(a, w, rp), w)

    mu1, mu2 = blur(xe), blur(ye)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s11 = blur(xe * xe) - mu1_sq
    s22 = blur(ye * ye) - mu2_sq
    s12 = blur(xe * ye) - mu12
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu12 + c1) * (2 * s12 + c2)) / ((mu1_sq + mu2_sq + c1) * (s11 + s22 + c2))
    ssim_part = torch.sum(ssim_map * valid) / denom

    l1 = C.all_reduce_sum(l1_part, group)
    ssim_v = C.all_reduce_sum(ssim_part, group)
    return (1.0 - lambda_dssim) * l1 + lambda_dssim * (1.0 - ssim_v)
