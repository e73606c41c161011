"""Style sweep: one content scene x S style patches.

Port of `wast3d_tpu/stylize/sweep.py`. As in JAX, every patch is cleaned
and subsampled to one common point count `m_common` (one seeded draw
sequence over the styles), content preparation runs once, ball coverage
runs once per style (patch radii differ), and every style's balls are
padded to one common capacity `d_cap`, so each style's padded domains are
JAX's (`fit.pad_balls`, with its own seed).

JAX fits all styles in one program, vmapping the ball fit over the style
axis (and sharding it over a mesh's `data` axis). The port loops over the
styles (with a mesh, each rank over its share of them) and fits each
style's real balls in batches of at most `batch_size` through
`fit.fit_balls`, as `fit.fit_all_balls` does:
JAX's empty ball rows (padding to the largest ball count) are not fitted.
Each ball's fit is independent of the others (the loss is a sum over balls
and Adam is elementwise), so the batching changes only rounding. At a
padded patch of 2048 points or more on CUDA the fit runs through K4/K5.
"""

from __future__ import annotations

import time
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from wast3d_tpu_torch.config import StylizeConfig
from wast3d_tpu_torch.device import DeviceLike, resolve_device
from wast3d_tpu_torch.scene.gaussians import GaussianScene
from wast3d_tpu_torch.stylize import coverage, fit, merge, prepare
from wast3d_tpu_torch.stylize.cluster import StylePatch
from wast3d_tpu_torch.stylize.pipeline import clean_style_patch


class SweepInputs(NamedTuple):
    domain: np.ndarray  # [D, 3] prepared content points
    patches: List[StylePatch]  # cleaned, each subsampled to m_common points
    circles: List[List[np.ndarray]]  # per style: each ball's domain indices
    d_cap: int  # the common ball capacity


def prepare_sweep(content: GaussianScene, style_patches: Sequence[StylePatch],
                  cfg: StylizeConfig = StylizeConfig(), seed: int = 0,
                  max_style_points: int = 16384, device: DeviceLike = None) -> SweepInputs:
    """The sweep's host-side stages, JAX's draws in JAX's order: the
    content domain, the cleaned and equalised patches, each style's balls
    and the common ball capacity."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    mask = content.mask.cpu().numpy()
    content_xyz = content.xyz.detach().cpu().numpy()[mask]
    domain_idx = prepare.prepare_scene(
        content_xyz, num_clusters=cfg.num_content_clusters, q=cfg.outlier_quantile,
        kth_neighbor=cfg.outlier_knn, seed=seed, device=dev)
    domain = content_xyz[domain_idx]

    patches = [clean_style_patch(p, device=dev) for p in style_patches]
    m_common = min(min(len(p) for p in patches), max_style_points)
    patches = [p.select(rng.choice(len(p), size=m_common, replace=False)) for p in patches]

    circles = []
    for p in patches:
        _, d_outer = coverage.cluster_radius(p.xyz, device=dev)
        circles.append(coverage.filter_circles(
            coverage.sample_circles(domain, r=d_outer * cfg.ball_radius_factor,
                                    min_points_per_cluster=cfg.min_ball_points, device=dev),
            min_points=max(1, cfg.min_ball_points // 2)))
    d_cap = min(cfg.ball_capacity, max(max(len(i) for i in c) for c in circles))
    return SweepInputs(domain, patches, circles, d_cap)


def style_range(num_styles: int, mesh=None) -> range:
    """The styles this rank fits: all of them without a mesh, else its
    contiguous share over the mesh's data axis."""
    if mesh is None:
        return range(num_styles)
    from wast3d_tpu_torch.parallel.mesh import axis_index, axis_size, row_range

    r = row_range(num_styles, axis_size(mesh, "data"), axis_index(mesh, "data"))
    return range(r.start, r.stop)


def fit_balls_sweep(targets: torch.Tensor, descs: Sequence[fit.TargetDescriptors],
                    balls: Sequence[torch.Tensor], mask: Sequence[torch.Tensor],
                    cfg: StylizeConfig = StylizeConfig(),
                    batch_size: int = 8, mesh=None) -> Optional[List[torch.Tensor]]:
    """Fit every style's balls: targets [S, M, 3], and per style its
    descriptors, balls [B_s, Dcap, 3] and mask [B_s, Dcap]. Each style's
    balls go through `fit.fit_balls` in batches of at most `batch_size`.
    Returns per style the fitted points [B_s, M, 3].

    With a `mesh` the styles split over its data axis (`style_range`;
    `descs` is read only for this rank's styles): each rank fits its
    styles, and rank 0 gathers them and returns the list; the other ranks
    return None."""
    mine = {}
    for s in style_range(targets.shape[0], mesh):
        mine[s] = torch.cat([
            fit.fit_balls(targets[s], descs[s], balls[s][b:b + batch_size],
                          mask[s][b:b + batch_size], cfg)
            for b in range(0, balls[s].shape[0], batch_size)])
    if mesh is None:
        return [mine[s] for s in range(targets.shape[0])]
    from wast3d_tpu_torch.parallel.collectives import gather_object

    parts = gather_object({s: f.cpu().numpy() for s, f in mine.items()})
    if parts is None:
        return None
    got = {}
    for part in parts:  # the model axis's ranks fit the same styles: keep one
        for s, f in part.items():
            got.setdefault(s, f)
    return [torch.as_tensor(got[s], device=targets.device) for s in range(targets.shape[0])]


def stylize_sweep(content: GaussianScene, style_patches: Sequence[StylePatch],
                  cfg: StylizeConfig = StylizeConfig(), seed: int = 0,
                  max_style_points: int = 16384, verbose: bool = False,
                  device: DeviceLike = None, mesh=None) -> Optional[List[GaussianScene]]:
    """Stylize one content scene with every style patch on `device` (None
    means CUDA). Returns one stylized scene per style. With a `mesh` (on
    every rank; `device` is the rank's) the styles split over its data axis
    (`fit_balls_sweep`); rank 0 returns the scenes, the other ranks None."""
    dev = resolve_device(device)
    t0 = time.time()
    inp = prepare_sweep(content, style_patches, cfg, seed, max_style_points, dev)
    padded = [fit.pad_balls(inp.domain, circ, inp.d_cap) for circ in inp.circles]
    targets = torch.as_tensor(np.stack([p.xyz for p in inp.patches]).astype(np.float32),
                              device=dev)
    mine = style_range(len(inp.patches), mesh)
    descs = [fit.compute_target_descriptors(p.xyz, cfg, device=dev) if s in mine else None
             for s, p in enumerate(inp.patches)]
    if verbose:
        print(f"sweep: {len(inp.patches)} styles x {[len(c) for c in inp.circles]} balls "
              f"x {len(inp.patches[0])} patch pts ({time.time() - t0:.1f}s)")

    fitted = fit_balls_sweep(targets, descs,
                             [torch.as_tensor(b, device=dev) for b, _ in padded],
                             [torch.as_tensor(m, device=dev) for _, m in padded], cfg,
                             mesh=mesh)
    if fitted is None:
        return None
    outputs = []
    for patch, f in zip(inp.patches, fitted):
        outputs.append(merge.merge_patches(patch, list(f.cpu().numpy()), domain=inp.domain,
                                           cfg=cfg, max_sh_degree=content.max_sh_degree,
                                           device=dev))
    if verbose:
        print(f"sweep done ({time.time() - t0:.1f}s)")
    return outputs
