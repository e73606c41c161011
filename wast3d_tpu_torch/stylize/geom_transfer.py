"""Cluster geometry transfer: distance-preservation + OT losses.

Port of `wast3d_tpu/stylize/geom_transfer.py`, the reference's
`aux_optimize_cluster_D*.py` ladder (the precursors of the notebook-11
pipeline):

- v0: full-matrix distance preservation over the xyz / rotation / scaling
  distance matrices (squared residuals);
- v1: k-NN-masked L1 residuals + an OT term (Sinkhorn, `ops/sinkhorn.py`)
  between `num_samples` sampled points and as many sampled shape points
  scaled by the target's mean radius;
- v4: squared xyz residuals (unmasked) + masked rotation / scaling
  residuals + the shape-attachment term (mean squared distance of each
  point to its 20 nearest of the 1/5-scaled shape points), weight 3e2.

Reference quirk kept: the 'rotation' and 'scaling' distance matrices are
cross-distances AGAINST THE XYZ coordinates,
  D_rotation = cdist(rot[:, :3], xyz) + cdist(rot[:, 1:], xyz),
  D_scaling  = cdist(scaling, xyz).
Distances use JAX's expansion |a|^2 + |b|^2 - 2 a.b, clamped at 0 and then
at 1e-24 under the square root, so they match JAX's to rounding.

The optimiser is JAX's hand-written Adam (eps 1e-15 outside the square
root, a float32 step count). Where JAX splits a PRNG key, the port takes a
`torch.Generator`; the tests hand it JAX's draws instead (`indices`).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

from wast3d_tpu_torch.ops.knn import pairwise_sq_dists
from wast3d_tpu_torch.ops.sinkhorn import emd2_approx


def _cdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp_min(pairwise_sq_dists(a, b), 1e-24))


class GeomTargets(NamedTuple):
    d_xyz: torch.Tensor  # [N,N]
    d_rotation: torch.Tensor
    d_scaling: torch.Tensor
    knn_mask: torch.Tensor  # [N,N] float k-NN mask on target xyz distances


def attribute_distances(xyz, rotation, scaling):
    """The reference's three distance matrices (quirk included)."""
    d_xyz = _cdist(xyz, xyz)
    d_rot = _cdist(rotation[:, :-1], xyz) + _cdist(rotation[:, 1:], xyz)
    d_scal = _cdist(scaling, xyz)
    return d_xyz, d_rot, d_scal


def _knn_mask(d: torch.Tensor, k: int) -> torch.Tensor:
    """1 where d is at most the k-th smallest value of its row."""
    kth = torch.topk(d, min(k, d.shape[1]), dim=1, largest=False).values[:, -1:]
    return (d <= kth).to(torch.float32)


def compute_targets(xyz, rotation, scaling, k: int = 100) -> GeomTargets:
    d_xyz, d_rot, d_scal = attribute_distances(xyz, rotation, scaling)
    return GeomTargets(d_xyz, d_rot, d_scal, _knn_mask(d_xyz, k))


def loss_v0(xyz, rotation, scaling, targets: GeomTargets) -> torch.Tensor:
    """Full-matrix squared residuals."""
    d_xyz, d_rot, d_scal = attribute_distances(xyz, rotation, scaling)
    return (torch.mean((d_xyz - targets.d_xyz) ** 2)
            + torch.mean((d_rot - targets.d_rotation) ** 2)
            + torch.mean((d_scal - targets.d_scaling) ** 2))


def shape_attachment_loss(xyz, shape_points, k: int = 20,
                          shape_scale: float = 0.2) -> torch.Tensor:
    """mean(sq(D_to_shape) * k-NN mask), shape points scaled by 1/5."""
    d = _cdist(xyz, shape_points * shape_scale)
    return torch.mean(torch.square(d) * _knn_mask(d, k))


def loss_v4(xyz, rotation, scaling, targets: GeomTargets, shape_points,
            w_shape: float = 3e2) -> torch.Tensor:
    """v4 composite."""
    d_xyz, d_rot, d_scal = attribute_distances(xyz, rotation, scaling)
    m = targets.knn_mask
    return (torch.mean((d_xyz - targets.d_xyz) ** 2)
            + torch.mean(((d_rot - targets.d_rotation) ** 2) * m)
            + torch.mean(((d_scal - targets.d_scaling) ** 2) * m)
            + w_shape * shape_attachment_loss(xyz, shape_points))


def sample_indices(generator: torch.Generator, n: int, m: int,
                   num_samples: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """v1's draw: the first `num_samples` of a permutation of the n points
    and of the m shape points."""
    dev = generator.device
    return (torch.randperm(n, generator=generator, device=dev)[:num_samples],
            torch.randperm(m, generator=generator, device=dev)[:num_samples])


def loss_v1(xyz, rotation, scaling, targets: GeomTargets, shape_points,
            generator: Optional[torch.Generator] = None, num_samples: int = 100,
            target_mean_radius: Optional[torch.Tensor] = None,
            indices: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """v1: masked L1 residuals + sampled OT to the scaled shape. The
    samples are drawn from `generator`, or given as `indices` (idx_a,
    idx_b)."""
    d_xyz, d_rot, d_scal = attribute_distances(xyz, rotation, scaling)
    m = targets.knn_mask
    l1 = (torch.mean(torch.abs(d_xyz - targets.d_xyz) * m)
          + torch.mean(torch.abs(d_rot - targets.d_rotation) * m)
          + torch.mean(torch.abs(d_scal - targets.d_scaling) * m))
    if indices is None:
        indices = sample_indices(generator, xyz.shape[0], shape_points.shape[0], num_samples)
    idx_a, idx_b = (i.to(xyz.device) for i in indices)
    radius = 1.0 if target_mean_radius is None else target_mean_radius
    return l1 + emd2_approx(xyz[idx_a], shape_points[idx_b] * radius)


def optimize_cluster_geometry(
    xyz0: torch.Tensor,
    rotation: torch.Tensor,
    scaling: torch.Tensor,
    targets: GeomTargets,
    shape_points: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    variant: str = "v4",
    steps: int = 1000,
    lr: float = 1.6e-4,
    num_samples: int = 100,
    target_mean_radius: Optional[torch.Tensor] = None,
    indices: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    losses: Optional[List[torch.Tensor]] = None,
) -> torch.Tensor:
    """Optimise the cluster's xyz against a frozen target's distance
    structure with JAX's Adam; rotation and scaling stay fixed inputs.
    Returns the final xyz.

    v1 draws its samples from `generator` at every step. `indices`
    ([steps, S] idx_a, [steps, S] idx_b) gives them instead: it exists for
    the tests, which hand the port JAX's draws. `losses`, when a list, gets
    each step's loss (a 0-d tensor, before that step's update)."""
    if variant not in ("v0", "v1", "v4"):
        raise ValueError(f"variant must be v0, v1 or v4, got {variant!r}")

    def loss_fn(x, step):
        if variant == "v0":
            return loss_v0(x, rotation, scaling, targets)
        if variant == "v1":
            idx = None if indices is None else (indices[0][step], indices[1][step])
            return loss_v1(x, rotation, scaling, targets, shape_points, generator,
                           num_samples, target_mean_radius, indices=idx)
        return loss_v4(x, rotation, scaling, targets, shape_points)

    x = xyz0.detach()
    mu, nu = torch.zeros_like(x), torch.zeros_like(x)
    t = torch.zeros((), dtype=torch.float32, device=x.device)
    for step in range(steps):
        xg = x.requires_grad_(True)
        with torch.enable_grad():
            loss = loss_fn(xg, step)
            (g,) = torch.autograd.grad(loss, [xg])
        if losses is not None:
            losses.append(loss.detach())
        t = t + 1
        mu = 0.9 * mu + 0.1 * g
        nu = 0.999 * nu + 0.001 * g * g
        x = (x.detach() - lr * (mu / (1 - 0.9 ** t))
             / (torch.sqrt(nu / (1 - 0.999 ** t)) + 1e-15))
    return x
