"""Adaptive density control: clone, split, prune, opacity reset.

Port of `wast3d_tpu/train/densify.py` (the reference's
`gaussian_model.py:349-407`). The JAX version keeps a fixed-capacity table
and fills free slots under a validity mask, because XLA needs static
shapes. Here N is exact, as in the reference: clones and split children are
appended and dropped rows are removed, and the optimizer's moments get the
same surgery (new rows start at zero, dropped rows go). Appended rows come
in the JAX slot order: all clones in source order, then the two children of
each split source in source order. Rows the JAX package would mark dead are
removed, so the two agree as sets of active rows, not row for row.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from wast3d_tpu_torch.core.transforms import quat_to_rotmat
from wast3d_tpu_torch.scene.gaussians import GaussianScene, compact
from wast3d_tpu_torch.train.optim import AdamState


class DensifyStats(NamedTuple):
    xyz_gradient_accum: torch.Tensor  # [N]
    denom: torch.Tensor  # [N]
    max_radii2d: torch.Tensor  # [N] float32 (pixels)


def init_stats(n: int, device=None) -> DensifyStats:
    return DensifyStats(*(torch.zeros((n,), dtype=torch.float32, device=device)
                          for _ in range(3)))


def add_stats(stats: DensifyStats, means2d_grad: torch.Tensor, radii: torch.Tensor,
              visibility: torch.Tensor, width: int, height: int) -> DensifyStats:
    """Accumulate the view-space positional gradient norms of visible
    Gaussians. `means2d_grad` is in pixel units; it is rescaled to the
    reference's NDC units (x 0.5 W, 0.5 H) so `densify_grad_threshold` means
    the same."""
    gx = means2d_grad[:, 0] * (0.5 * width)
    gy = means2d_grad[:, 1] * (0.5 * height)
    norm = torch.sqrt(gx * gx + gy * gy)
    vis = visibility.to(torch.float32)
    zero = torch.zeros_like(stats.max_radii2d)
    return DensifyStats(
        xyz_gradient_accum=stats.xyz_gradient_accum + norm * vis,
        denom=stats.denom + vis,
        max_radii2d=torch.maximum(
            stats.max_radii2d, torch.where(visibility, radii.to(torch.float32), zero)),
    )


def add_stats_batch(stats: DensifyStats, means2d_grad: torch.Tensor, radii: torch.Tensor,
                    visibility: torch.Tensor, width: int, height: int) -> DensifyStats:
    """`add_stats` for a batch of B views, one reference iteration each:
    means2d_grad [B, N, 2] are the per-view gradients of the batch's mean
    loss (a view's offset reaches only its own term, so B times it is the
    view's own gradient), radii and visibility [B, N]."""
    b = means2d_grad.shape[0]
    gx = means2d_grad[..., 0] * (0.5 * width * b)
    gy = means2d_grad[..., 1] * (0.5 * height * b)
    norm = torch.sqrt(gx * gx + gy * gy)
    vis = visibility.to(torch.float32)
    zero = torch.zeros_like(radii, dtype=torch.float32)
    return DensifyStats(
        xyz_gradient_accum=stats.xyz_gradient_accum + torch.sum(norm * vis, 0),
        denom=stats.denom + torch.sum(vis, 0),
        max_radii2d=torch.maximum(
            stats.max_radii2d,
            torch.amax(torch.where(visibility, radii.to(torch.float32), zero), 0)),
    )


def densify_and_prune(
    scene: GaussianScene,
    opt_state: AdamState,
    stats: DensifyStats,
    max_grad: float,
    min_opacity: float,
    extent: float,
    max_screen_size: float,
    percent_dense: float,
    prune_big_screen: bool = False,
    generator: Optional[torch.Generator] = None,
    eps: Optional[torch.Tensor] = None,
) -> Tuple[GaussianScene, AdamState, DensifyStats, int]:
    """One density-control step. `eps` [2, N, 3] is the split noise (drawn
    from `generator` when not given; the JAX package draws
    `jax.random.normal(key, (2, C, 3))`). `max_screen_size <= 0` disables
    the size prunes. `prune_big_screen=False` reproduces the reference,
    whose screen-size prune never fires (its clone and split zero
    `max_radii2D` before the prune reads it); True makes it live.
    Returns (scene, opt_state, reset stats, n_dropped); n_dropped is always
    0, there being no capacity to run out of."""
    n = scene.capacity
    dev = scene.device
    grads = stats.xyz_gradient_accum / stats.denom
    grads = torch.where(torch.isnan(grads), torch.zeros_like(grads), grads)

    scaling = scene.get_scaling
    max_scale = torch.max(scaling, dim=1).values
    high_grad = (grads >= max_grad) & scene.mask
    clone_mask = high_grad & (max_scale <= percent_dense * extent)
    split_mask = high_grad & (max_scale > percent_dense * extent)
    if eps is None:
        eps = torch.randn((2, n, 3), generator=generator, device=dev)
    eps = eps.to(dev, torch.float32)

    params = scene.params()
    clones = {k: v[clone_mask] for k, v in params.items()}
    src = torch.nonzero(split_mask).squeeze(1)
    rot = quat_to_rotmat(scene.rotation[src])  # [S, 3, 3]
    child_scale = torch.log(scaling[src] / (0.8 * 2))
    children = []
    for child in range(2):
        offset = torch.einsum("cij,cj->ci", rot, scaling[src] * eps[child, src])
        rows = {k: v[src] for k, v in params.items()}
        rows["xyz"] = scene.xyz[src] + offset
        rows["scaling"] = child_scale
        children.append(rows)
    # Interleave: source 0 child 0, source 0 child 1, source 1 child 0, ...
    split_rows = {k: torch.stack([children[0][k], children[1][k]], dim=1).flatten(0, 1)
                  for k in params}
    n_new = int(clones["xyz"].shape[0] + split_rows["xyz"].shape[0])

    arrays = {k: torch.cat([params[k], clones[k], split_rows[k]]) for k in params}
    fresh = torch.cat([torch.zeros(n, dtype=torch.bool, device=dev),
                       torch.ones(n_new, dtype=torch.bool, device=dev)])
    mask2 = torch.cat([scene.mask & ~split_mask,
                       torch.ones(n_new, dtype=torch.bool, device=dev)])
    scene2 = scene.with_params(arrays).replace(mask=mask2)

    prune = scene2.get_opacity[:, 0] < min_opacity
    if max_screen_size and max_screen_size > 0:
        prune = prune | (torch.max(scene2.get_scaling, dim=1).values > 0.1 * extent)
        if prune_big_screen:
            radii2 = torch.cat([stats.max_radii2d,
                                torch.zeros(n_new, dtype=torch.float32, device=dev)])
            prune = prune | ((radii2 > max_screen_size) & ~fresh)
    keep = mask2 & ~prune
    scene3 = compact(scene2.replace(mask=keep))

    def surgery(moments):
        return {k: torch.cat([v, v.new_zeros((n_new,) + v.shape[1:])])[keep]
                for k, v in moments.items()}

    new_opt = AdamState(mu=surgery(opt_state.mu), nu=surgery(opt_state.nu),
                        count=opt_state.count)
    return scene3, new_opt, init_stats(scene3.capacity, dev), 0


def reset_opacity(scene: GaussianScene, opt_state: AdamState) -> Tuple[GaussianScene, AdamState]:
    """Clamp opacity to <= 0.01 and zero its Adam moments."""
    new_op = torch.clamp_max(scene.get_opacity, 0.01)
    logit = torch.log(new_op / (1.0 - new_op))
    logit = torch.where(scene.mask[:, None], logit, scene.opacity)
    new_opt = AdamState(
        mu={**opt_state.mu, "opacity": torch.zeros_like(opt_state.mu["opacity"])},
        nu={**opt_state.nu, "opacity": torch.zeros_like(opt_state.nu["opacity"])},
        count=opt_state.count)
    return scene.replace(opacity=logit), new_opt
