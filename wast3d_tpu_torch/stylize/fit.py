"""W2-style patch fitting: nearest-neighbour-distance descriptors and the
batched Adam fit of one style-patch copy per coverage ball.

Port of `wast3d_tpu/stylize/fit.py`, the WaSt-3D core (notebook 11 cell 28):
for each ball of the content domain, a copy of the style patch is moved so
that its nearest-neighbour distance descriptors match the patch's (the
neighbour indices frozen from the style patch) while it stays attached to
the ball. Two descriptor scales: global (k = 2000, every 20th point) and
local (k = 100, all points). Domain attachment: the mean over the whole
|X| x |domain| matrix of the squared distances masked to each point's 20
domain neighbours. Init: style points * domain std * 5 + domain mean. Adam
(lr 1e-3), 1000 steps, loss weights 1 / 2e2 / 3e1.

Both descriptor scales are exactly sum_ij W_ij (D_ij - T_ij)^2, with W the
per-pair weight and T the frozen target distances. W is stored as two
bit-packed masks ([Mp, Mp/8] uint8, little-endian) and, for K4/K5, as one
[Mp, Mp] uint8 pair code (bit 0 global, bit 1 local) and its pair list
(`desc_kernel.PairList`, built once per fit from the code; the kernels read
only the list). `descriptor_loss` has three paths, chosen as in JAX:
  - kernel (the pair list exists: `cfg.desc_kernel`, Mp >= 2048, CUDA):
    `desc_kernel.pair_loss`, K4 forward and K5 backward on the list on
    CUDA, their plain versions on the CPU;
  - dense single block (Mp <= desc_block): (W, T) built once per fit;
  - streaming column blocks otherwise, each block recomputed in the
    backward (`torch.utils.checkpoint`, JAX's `jax.checkpoint`), so
    memory is O(B Mp block), never [Mp, Mp] floats.
Below Mp = 2048 the single-block path is what JAX runs, not a fallback.

The JAX package fits one ball per `vmap` lane; here the ball axis is a
tensor dimension: every loss takes [B, ...] and returns [B], and the
gradient of their sum is each ball's own.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from wast3d_tpu_torch.config import StylizeConfig
from wast3d_tpu_torch.device import DeviceLike, resolve_device
from wast3d_tpu_torch.ops.knn import (knn_sq_dists, knn_sq_dists_sort,
                                      pairwise_sq_dists)
from wast3d_tpu_torch.stylize import desc_kernel

_BIG = 1e30
KERNEL_MIN_MP = 2048  # the kernel path's threshold (JAX: below it streaming wins)


class TargetDescriptors(NamedTuple):
    """Frozen nearest-neighbour structure of the style patch: the index
    forms (inspection, tests) and what the fit consumes."""

    idx_global: torch.Tensor  # [Mg, kg] frozen NN indices of the strided points
    desc_global: torch.Tensor  # [Mg, kg - 1]
    idx_local: torch.Tensor  # [M, kl]
    desc_local: torch.Tensor  # [M, kl - 1]
    points: torch.Tensor  # [Mp, 3] padded style points (T recomputed from them)
    bits_global: torch.Tensor  # [Mp, Mp // 8] uint8: bit j of byte b = pair
    #   (row, column 8b + j) is in the global descriptor (little-endian)
    bits_local: torch.Tensor  # [Mp, Mp // 8] uint8
    coef_global: float  # w_global / desc_global.size, a float32 value
    coef_local: float  # w_local / desc_local.size, a float32 value
    pair_code: Optional[torch.Tensor] = None  # [Mp, Mp] uint8, bits_g + 2 bits_l (kernel path)
    pair_list: Optional[desc_kernel.PairList] = None  # the code's pairs, for K4/K5 (kernel path)


def descriptors_from_indices(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[N, 3] x [R, k] -> [R, k - 1]: distances from each row's own point
    (column 0) to its k - 1 neighbours (the reference's `get_descriptors`)."""
    nns = points[idx]
    return torch.linalg.vector_norm(nns[:, 1:] - nns[:, :1], dim=-1)


def padded_patch_size(m: int, block: int) -> int:
    """One 128-aligned block when the patch fits, else whole blocks."""
    if m <= block:
        return -(-m // 128) * 128
    return -(-m // block) * block


def pair_dense(idx: torch.Tensor, rows: torch.Tensor, mp: int) -> torch.Tensor:
    """[R, k] frozen NN indices (column 0 = self) -> [mp, mp] 0/1 uint8 mask
    of the (row point, neighbour) pairs the descriptor compares: one scatter
    of R (k - 1) ones on the indices' device."""
    dense = torch.zeros((mp, mp), dtype=torch.uint8, device=idx.device)
    dense[torch.repeat_interleave(rows, idx.shape[1] - 1), idx[:, 1:].reshape(-1)] = 1
    return dense


def packbits(dense: torch.Tensor) -> torch.Tensor:
    """np.packbits(dense, axis=1, bitorder="little"): [R, C] 0/1 uint8 ->
    [R, C // 8] uint8."""
    d = dense.view(dense.shape[0], dense.shape[1] // 8, 8)
    out = d[..., 0].clone()
    for k in range(1, 8):
        out |= d[..., k] << k
    return out


def unpack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[R, C // 8] uint8 -> [R, C] float32 (little-endian bit order)."""
    shifts = torch.arange(8, dtype=torch.uint8, device=bits.device)
    return ((bits[:, :, None] >> shifts) & 1).reshape(bits.shape[0], -1).to(torch.float32)


def compute_target_descriptors(target_points, cfg: StylizeConfig = StylizeConfig(),
                               device: DeviceLike = None) -> TargetDescriptors:
    """Frozen NN structure and descriptors of the style patch, on `device`.

    JAX's rule picks the kernel path (pair code, Mp aligned to
    `desc_kernel.MP_ALIGN`): `cfg.desc_kernel`, a padded patch of at least
    2048 points, and a CUDA device (JAX: a TPU)."""
    dev = resolve_device(device)
    pts = torch.as_tensor(np.asarray(target_points, np.float32), device=dev)
    m = pts.shape[0]
    kg = min(cfg.global_knn, m)
    kl = min(cfg.local_knn, m)
    # exclude_self=False: a point's nearest neighbour is itself, which the
    # reference relies on (descriptor column 0 = self). The global
    # descriptor strides its queries, not the result.
    knn = knn_sq_dists_sort if max(kg, kl) >= 64 else knn_sq_dists
    _, idx_g = knn(pts[:: cfg.global_stride], pts, k=kg)
    _, idx_l = knn(pts, pts, k=kl)
    desc_g = descriptors_from_indices(pts, idx_g)
    desc_l = descriptors_from_indices(pts, idx_l)

    mp = padded_patch_size(m, cfg.desc_block)
    use_kernel = cfg.desc_kernel and mp >= KERNEL_MIN_MP and dev.type == "cuda"
    if use_kernel:
        mp = -(-mp // desc_kernel.MP_ALIGN) * desc_kernel.MP_ALIGN
    rows_g = torch.arange(m, device=dev)[:: cfg.global_stride]
    rows_l = torch.arange(m, device=dev)
    dense_g = pair_dense(idx_g, rows_g, mp)
    dense_l = pair_dense(idx_l, rows_l, mp)
    pair_code = dense_g + 2 * dense_l if use_kernel else None
    pair_list = desc_kernel.build_pair_list(pair_code) if use_kernel else None
    return TargetDescriptors(
        idx_g, desc_g, idx_l, desc_l,
        points=torch.nn.functional.pad(pts, (0, 0, 0, mp - m)),
        bits_global=packbits(dense_g),
        bits_local=packbits(dense_l),
        coef_global=float(np.float32(cfg.w_global / desc_g.numel())),
        coef_local=float(np.float32(cfg.w_local / desc_l.numel())),
        pair_code=pair_code,
        pair_list=pair_list,
    )


def _dist(d2: torch.Tensor) -> torch.Tensor:
    """The streaming path's distance, sqrt(max(d^2, 1e-24))."""
    return torch.sqrt(torch.clamp_min(d2, 1e-24))


def _pair_weights(target: TargetDescriptors, bits_g, bits_l) -> torch.Tensor:
    return target.coef_global * unpack_bits(bits_g) + target.coef_local * unpack_bits(bits_l)


def dense_pair_terms(target: TargetDescriptors):
    """Dense [Mp, Mp] (W, T) for the single-block path: loop invariants of
    the fit, built once (JAX measured ~3x the step's elementwise work when
    they were rebuilt every step)."""
    return (_pair_weights(target, target.bits_global, target.bits_local),
            _dist(pairwise_sq_dists(target.points, target.points)))


def descriptor_loss(points_pad: torch.Tensor, target: TargetDescriptors, block: int,
                    dense_wt=None) -> torch.Tensor:
    """[B] sum_ij W_ij (D_ij - T_ij)^2 of each ball's points [B, Mp, 3]
    (padded like target.points; padded rows carry no pair bits, so they
    contribute nothing). dense_wt: `dense_pair_terms`, single block only."""
    if target.pair_list is not None:
        return desc_kernel.pair_loss(points_pad, target.points, target.pair_list,
                                     target.coef_global, target.coef_local)
    mp = points_pad.shape[1]

    def block_term(x, xb, tb, bg, bl):
        d = _dist(pairwise_sq_dists(x, xb))
        t = _dist(pairwise_sq_dists(target.points, tb))
        return torch.sum(_pair_weights(target, bg, bl) * (d - t) ** 2, dim=(1, 2))

    if mp <= block:
        if dense_wt is not None:
            w, t = dense_wt
            d = _dist(pairwise_sq_dists(points_pad, points_pad))
            return torch.sum(w * (d - t) ** 2, dim=(1, 2))
        return block_term(points_pad, points_pad, target.points,
                          target.bits_global, target.bits_local)
    loss = points_pad.new_zeros(points_pad.shape[0])
    cb = block // 8
    for s in range(0, mp, block):
        args = (points_pad, points_pad[:, s:s + block], target.points[s:s + block],
                target.bits_global[:, s // 8:s // 8 + cb], target.bits_local[:, s // 8:s // 8 + cb])
        term = (checkpoint(block_term, *args, use_reentrant=False)
                if torch.is_grad_enabled() else block_term(*args))
        loss = loss + term
    return loss


def domain_adaptation_loss(x: torch.Tensor, domain: torch.Tensor, domain_mask: torch.Tensor,
                           k: int, x_rows: Optional[int] = None,
                           dense_block: int = 4096) -> torch.Tensor:
    """[B] the reference's `get_loss_domain_adaptation` for each ball:
    squared distances from x [B, X, 3] masked to each row's k nearest valid
    domain points [B, D, 3], summed and divided by n_rows x n_valid (the
    unmasked entries count in the denominator). x_rows: only the first
    x_rows rows count, and n_rows = x_rows.

    A dense [X, D] top-k when the domain fits one block, the streaming
    kNN beyond (the masked sum is the sum of each row's k smallest valid
    squared distances in both)."""
    n_rows = x.shape[1] if x_rows is None else x_rows
    row_live = torch.arange(x.shape[1], device=x.device) < n_rows
    dmask = domain_mask.to(torch.bool)
    n_valid = torch.clamp_min(dmask.sum(dim=1), 1).to(torch.float32)
    kk = min(k, domain.shape[1])
    if domain.shape[1] <= dense_block:
        d2 = pairwise_sq_dists(x, domain)
        d2m = torch.where(dmask[:, None, :], d2, _BIG)
        kth = torch.topk(d2m, kk, dim=-1, largest=False).values[..., -1:]
        nn_mask = (d2m <= kth).to(torch.float32)
        d2 = d2 * nn_mask * dmask[:, None, :].to(torch.float32) \
            * row_live[None, :, None].to(torch.float32)
        return torch.sum(d2, dim=(1, 2)) / (n_rows * n_valid)
    out = []
    for xb, db, mb in zip(x, domain, dmask):
        d, _ = knn_sq_dists(xb, db, k=kk, data_mask=mb)
        d = torch.where(d > _BIG * 0.5, 0.0, d)  # rows with fewer than k valid neighbours
        out.append(torch.sum(torch.where(row_live[:, None], d, 0.0)))
    return torch.stack(out) / (n_rows * n_valid)


def domain_coverage_loss(fitted_points: torch.Tensor, domain: torch.Tensor,
                         domain_mask: torch.Tensor, x_rows: Optional[int] = None) -> torch.Tensor:
    """[B] mean over valid domain points of the squared distance to the
    nearest fitted point: pulls the patches to cover the domain (the
    reference's `loss_domain_coverage`; off by default, as in notebook 11).
    Gradients split evenly among tied minima, as JAX's `min` does."""
    d2 = pairwise_sq_dists(domain, fitted_points)
    if x_rows is not None:
        col_live = torch.arange(fitted_points.shape[1], device=d2.device) < x_rows
        d2 = torch.where(col_live[None, None, :], d2, _BIG)
    m = domain_mask.to(torch.float32)
    return torch.sum(torch.amin(d2, dim=2) * m, dim=1) / torch.clamp_min(m.sum(dim=1), 1.0)


def _fit_loss(points_pad, m_true, target, domain, domain_mask, cfg, dense_wt=None):
    loss = descriptor_loss(points_pad, target, cfg.desc_block, dense_wt=dense_wt)
    loss = loss + cfg.w_domain * domain_adaptation_loss(points_pad, domain, domain_mask,
                                                        cfg.domain_knn, x_rows=m_true)
    if cfg.w_coverage:
        loss = loss + cfg.w_coverage * domain_coverage_loss(points_pad, domain, domain_mask,
                                                            x_rows=m_true)
    return loss


def fit_balls(target_points: torch.Tensor, target_desc: TargetDescriptors,
              domain_points: torch.Tensor, domain_mask: torch.Tensor,
              cfg: StylizeConfig = StylizeConfig()) -> torch.Tensor:
    """Fit one style-patch copy into every ball of the batch at once.

    target_points [M, 3] (re-centred style patch), domain_points [B, Dcap, 3]
    and domain_mask [B, Dcap] (padded balls). Returns fitted points
    [B, M, 3]. A hand-written Adam over the whole [B, Mp, 3] batch, as JAX's
    (bias-corrected, eps outside the square root)."""
    m = target_points.shape[0]
    mp = target_desc.points.shape[0]
    tp_pad = torch.nn.functional.pad(target_points.to(torch.float32), (0, 0, 0, mp - m))
    dense_wt = (dense_pair_terms(target_desc)
                if mp <= cfg.desc_block and target_desc.pair_list is None else None)
    mask = domain_mask.to(torch.bool)
    mk = mask.to(torch.float32)[..., None]
    n = torch.clamp_min(mk.sum(dim=1), 2.0)  # [B, 1]
    mean = torch.sum(domain_points * mk, dim=1) / n
    var = torch.sum((domain_points - mean[:, None]) ** 2 * mk, dim=1) / (n - 1.0)
    std = torch.sqrt(var)
    # Padded domain points sit at the ball mean, where they are inert.
    domain_c = torch.where(mask[..., None], domain_points, mean[:, None])
    pts = tp_pad[None] * std[:, None] * 5.0 + mean[:, None]
    mu, nu = torch.zeros_like(pts), torch.zeros_like(pts)
    for step in range(1, cfg.fit_steps + 1):
        x = pts.detach().requires_grad_(True)
        with torch.enable_grad():
            loss = _fit_loss(x, m, target_desc, domain_c, mask, cfg, dense_wt)
            (g,) = torch.autograd.grad(loss.sum(), [x])
        t = np.float32(step)
        mu = 0.9 * mu + 0.1 * g
        nu = 0.999 * nu + 0.001 * g * g
        mh = mu / float(np.float32(1) - np.float32(0.9) ** t)
        nh = nu / float(np.float32(1) - np.float32(0.999) ** t)
        pts = pts - cfg.fit_lr * mh / (torch.sqrt(nh) + 1e-8)
    return pts[:, :m]


def pad_balls(points: np.ndarray, circles: List[np.ndarray],
              capacity: int) -> Tuple[np.ndarray, np.ndarray]:
    """Stack the balls' index sets into [B, capacity] padded arrays; a
    ball larger than capacity is subsampled (seeded, as in JAX)."""
    out = np.zeros((len(circles), capacity, 3), np.float32)
    mask = np.zeros((len(circles), capacity), bool)
    rng = np.random.default_rng(0)
    for i, idx in enumerate(circles):
        if len(idx) > capacity:
            idx = rng.choice(idx, size=capacity, replace=False)
        out[i, : len(idx)] = points[idx]
        mask[i, : len(idx)] = True
    return out, mask


def fit_all_balls(target_points: np.ndarray, domain_points: np.ndarray,
                  circles: List[np.ndarray], cfg: StylizeConfig = StylizeConfig(),
                  batch_size: int = 8, device: DeviceLike = None) -> List[np.ndarray]:
    """Pad the balls, fit them in batches of `batch_size`, return each
    ball's fitted points [M, 3] (the reference's sequential
    `optimize_all_by_clusters`, batched). The last batch holds only the
    balls that are left: eager PyTorch shares no compilation between batch
    sizes, so JAX's zero-padded balls would only cost time."""
    dev = resolve_device(device)
    target_desc = compute_target_descriptors(target_points, cfg, device=dev)
    tp = torch.as_tensor(np.asarray(target_points, np.float32), device=dev)
    cap = min(cfg.ball_capacity, max(len(c) for c in circles))
    balls, mask = pad_balls(np.asarray(domain_points, np.float32), circles, cap)
    results = []
    for s in range(0, len(circles), batch_size):
        fitted = fit_balls(tp, target_desc, torch.as_tensor(balls[s:s + batch_size], device=dev),
                           torch.as_tensor(mask[s:s + batch_size], device=dev), cfg)
        results.extend(fitted.cpu().numpy())
    return results
