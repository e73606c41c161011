"""End-to-end scene-to-scene stylization: the WaSt-3D pipeline.

Port of `wast3d_tpu/stylize/pipeline.py`, the notebook-11 flow:
  1. content scene -> cleaned 'domain' point set (prepare.py);
  2. style patch load and outlier clean (cluster.py, cell 10);
  3. ball coverage of the domain (coverage.py, r = 0.45 x outer diameter);
  4. the batched descriptor fit of one patch copy per ball (fit.py, with
     K4/K5 for padded patches of 2048 points or more on CUDA);
  5. merge and Voronoi de-overlap into a stylized GaussianScene (merge.py).
Everything runs on one device; `device=None` means CUDA.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from wast3d_tpu_torch.config import StylizeConfig
from wast3d_tpu_torch.device import DeviceLike, resolve_device
from wast3d_tpu_torch.scene.gaussians import GaussianScene
from wast3d_tpu_torch.stylize import coverage, fit, merge, prepare
from wast3d_tpu_torch.stylize.cluster import StylePatch, load_cluster


def clean_style_patch(patch: StylePatch, kth: int = 30, q: float = 0.925,
                      device: DeviceLike = None) -> StylePatch:
    """Outlier-clean the style patch (notebook 11 cell 10)."""
    return patch.select(prepare.remove_outliers(patch.xyz, kth_neighbor=kth, q=q,
                                                device=device))


def stylize_scene(content: GaussianScene, style_patch: StylePatch,
                  cfg: StylizeConfig = StylizeConfig(), seed: int = 0,
                  batch_size: int = 8, verbose: bool = False,
                  max_style_points: Optional[int] = 16384,
                  device: DeviceLike = None) -> GaussianScene:
    """Content scene + style patch -> stylized scene, on `device`.

    Memory: the kernel path holds an [Mp, Mp] uint8 pair code (268 MB at
    Mp = 16384) and, per Adam step, the [B, Mp, ball] domain-loss matrices
    (~1 GB each at B = 8, Mp = 16384, 2048-point balls); shrink
    `batch_size` before subsampling the patch."""
    dev = resolve_device(device)
    t0 = time.time()
    mask = content.mask.cpu().numpy()
    content_xyz = content.xyz.detach().cpu().numpy()[mask]

    domain_idx = prepare.prepare_scene(
        content_xyz, num_clusters=cfg.num_content_clusters, q=cfg.outlier_quantile,
        kth_neighbor=cfg.outlier_knn, seed=seed, device=dev)
    domain = content_xyz[domain_idx]

    patch = clean_style_patch(style_patch, device=dev)
    if max_style_points and len(patch) > max_style_points:
        rng = np.random.default_rng(seed)
        patch = patch.select(rng.choice(len(patch), size=max_style_points, replace=False))

    _, d_outer = coverage.cluster_radius(patch.xyz, device=dev)
    circles = coverage.sample_circles(domain, r=d_outer * cfg.ball_radius_factor,
                                      min_points_per_cluster=cfg.min_ball_points, device=dev)
    # Reference cell 22 drops balls with <= 21 points (about half the
    # growth minimum of 40); scale with the configured minimum.
    circles = coverage.filter_circles(circles, min_points=max(1, cfg.min_ball_points // 2))
    if verbose:
        print(f"domain {len(domain)} pts, {len(circles)} balls, "
              f"patch {len(patch)} pts ({time.time() - t0:.1f}s)")

    fitted = fit.fit_all_balls(patch.xyz, domain, circles, cfg=cfg, batch_size=batch_size,
                               device=dev)
    if verbose:
        print(f"fit done ({time.time() - t0:.1f}s)")

    out = merge.merge_patches(patch, fitted, domain=domain, cfg=cfg,
                              max_sh_degree=content.max_sh_degree, device=dev)
    if verbose:
        print(f"stylized scene: {int(out.num_active)} gaussians "
              f"({time.time() - t0:.1f}s total)")
    return out


def stylize_from_files(content_ply: str, style_cluster_npz: str, output_ply: str,
                       cfg: StylizeConfig = StylizeConfig(), device: DeviceLike = None,
                       **kwargs) -> GaussianScene:
    """Content PLY + style cluster npz -> stylized PLY."""
    from wast3d_tpu_torch.scene.ply import load_ply, save_ply

    dev = resolve_device(device)
    out = stylize_scene(load_ply(content_ply, device=dev), load_cluster(style_cluster_npz),
                        cfg=cfg, device=dev, **kwargs)
    save_ply(out, output_ply)
    return out
