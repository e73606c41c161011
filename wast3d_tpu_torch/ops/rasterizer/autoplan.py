"""Scene-adaptive emission-plan tuning for serving.

Port of `wast3d_tpu/ops/rasterizer/autoplan.py`, with JAX's signatures and
results. The JAX binning works inside static capacities (an emission plan,
a `dup_capacity`, a `max_tiles_per_gaussian` ceiling) whose safe values
depend on the scene's tile-straddle distribution, so JAX measures the scene
once at load and synthesizes the tightest plan:

1. `probe_straddle`: per probe camera, the count of Gaussians touching
   more than t tiles for each threshold t, and the most tiles any touches;
2. `synthesize_plan`: band budgets from those counts x margin (numpy);
3. `measure_duplicates`: the post-cull duplicate count per camera, which
   sizes `dup_capacity`.

The port's binning sizes everything from the data (`binning.py`), so it
reads none of the tuned fields: `tune_serving_settings` returns the
`RasterizeSettings` JAX returns (`phase_plan`, `dup_capacity`,
`max_tiles_per_gaussian`), and nothing on the port's render path calls it
(`eval/render_sets.py`). `measure_duplicates` counts the port's own
duplicates, which equal JAX's wherever JAX's plan does not overflow; the
port never overflows, so its flag is always False.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from wast3d_tpu_torch.device import DeviceLike, resolve_device
from wast3d_tpu_torch.ops.rasterizer import preprocess as prep_mod
from wast3d_tpu_torch.ops.rasterizer.api import RasterizeSettings
from wast3d_tpu_torch.ops.rasterizer.binning import bin_gaussians, compute_rects, tile_grid

# Phase-A widths to consider. Band starts double from ra, so the static
# threshold set (union over candidates) stays small.
_RA_CANDIDATES = (2, 3, 4, 6, 8)


def _padded(total: int) -> int:
    return 1 << (max(int(total), 1) - 1).bit_length()


def _band_starts(ra: int, max_tiles: int):
    starts = []
    s = ra
    while s < max_tiles:
        starts.append(s)
        s *= 2
    return starts


def _probe_prep(camera, scene, scaling_modifier: float) -> prep_mod.Preprocessed:
    """Geometry-only preprocess (zero precomputed colours, no SH)."""
    n = scene.get_xyz.shape[0]
    return prep_mod.preprocess(
        means3d=scene.get_xyz,
        opacities=scene.get_opacity,
        view_transform=camera.view_transform,
        full_proj_transform=camera.full_proj_transform,
        camera_center=camera.camera_center,
        tan_fovx=camera.tan_fovx,
        tan_fovy=camera.tan_fovy,
        width=camera.width,
        height=camera.height,
        colors_precomp=torch.zeros((n, 3), dtype=torch.float32, device=scene.device),
        scales=scene.get_scaling,
        rotations=scene.get_rotation,
        scaling_modifier=scaling_modifier,
        mask=scene.mask,
    )


@torch.no_grad()
def probe_straddle(scene, cameras, thresholds, scaling_modifier: float = 1.0, *,
                   device: DeviceLike = None):
    """Per-camera straddle stats: counts of Gaussians with tiles_touched > t
    for each t in `thresholds`, plus the largest tiles_touched.

    Returns (counts [C, T], max_tt [C]) as numpy int arrays."""
    dev = resolve_device(device)
    scene = scene.to(dev)
    thr = torch.as_tensor(np.asarray(thresholds, np.int64), device=dev)
    counts, max_tt = [], []
    for cam in cameras:
        cam = cam.to(dev)
        prep = _probe_prep(cam, scene, scaling_modifier)
        gx, gy = tile_grid(cam.width, cam.height)
        xmin, ymin, xmax, ymax = compute_rects(prep.means2d, prep.radii, gx, gy,
                                               ext_x=prep.extent_x, ext_y=prep.extent_y)
        tt = (xmax - xmin) * (ymax - ymin)
        counts.append((tt[None, :] > thr[:, None]).sum(dim=1).cpu().numpy())
        max_tt.append(int(tt.max()))
    return np.stack(counts), np.asarray(max_tt)


def synthesize_plan(n: int, need, max_tiles: int, band_margin: float = 1.5):
    """Build the smallest-padded-grid emission plan whose band budgets
    hold the measured straddle counts with margin.

    need: dict threshold -> worst probed count(tiles_touched > threshold).
    Bands double in extent from phase A's width; each band's budget is
    band_margin x its measured demand, rounded up to a multiple of 8
    (min 8). Returns a phases tuple ((0, ra, None), (start, extra,
    budget), ...), JAX's `RasterizeSettings.phase_plan`."""
    best = None
    for ra in _RA_CANDIDATES:
        phases = [(0, ra, None)]
        covered = ra
        for start in _band_starts(ra, max_tiles):
            extra = min(start, max_tiles - covered)  # band end = 2*start
            demand = need.get(start)
            assert demand is not None, (start, sorted(need))
            budget = max(8, int(-(-band_margin * demand // 8)) * 8)
            budget = min(budget, n)
            phases.append((covered, extra, budget))
            covered += extra
        total = n * ra + sum(e * b for _, e, b in phases[1:])
        key = (_padded(total), len(phases), total)
        if best is None or key < best[0]:
            best = (key, tuple(phases))
    return best[1]


@torch.no_grad()
def measure_duplicates(scene, cameras, plan, max_tiles: int,
                       scaling_modifier: float = 1.0,
                       jitter_margin: float = 0.0,
                       tile_cull: bool = True, *,
                       device: DeviceLike = None):
    """Post-cull duplicate count of the port's binning for each camera.
    Returns (num_duplicates [C], any_emit_overflow), the flag always False.
    `plan` and `max_tiles` are JAX's and read by nothing (module
    docstring); tile_cull / jitter_margin mirror the render being sized."""
    del plan, max_tiles
    dev = resolve_device(device)
    scene = scene.to(dev)
    dups = []
    for cam in cameras:
        cam = cam.to(dev)
        prep = _probe_prep(cam, scene, scaling_modifier)
        b = bin_gaussians(
            prep.means2d, prep.depths, prep.radii, cam.width, cam.height,
            ext_x=prep.extent_x, ext_y=prep.extent_y,
            conics=prep.conics if tile_cull else None,
            opacities=prep.opacities if tile_cull else None,
            jitter_margin=jitter_margin,
        )
        dups.append(int(b.num_duplicates))
    return np.asarray(dups), False


def tune_serving_settings(
    scene,
    cameras: Sequence,
    base: RasterizeSettings,
    band_margin: float = 1.5,
    cap_margin: float = 1.15,
    max_cameras: int = 8,
    scaling_modifier: float = 1.0,
    jitter: bool = False,
    cap_quantile: float = 1.0,
    *,
    device: DeviceLike = None,
) -> RasterizeSettings:
    """`base` with JAX's tuned `phase_plan`, `max_tiles_per_gaussian` and
    `dup_capacity` for serving `scene` from cameras like `cameras` (evenly
    subsampled to `max_cameras` probe views): band budgets of band_margin x
    the probed demand, and dup_capacity = cap_margin x the
    cap_quantile-quantile of the probed duplicate counts, rounded up to a
    4096 multiple. The port's render reads none of these fields."""
    cams = list(cameras)
    if len(cams) > max_cameras:
        idx = np.linspace(0, len(cams) - 1, max_cameras).round().astype(int)
        cams = [cams[i] for i in sorted(set(idx.tolist()))]
    if not cams:
        return base

    n = int(scene.get_xyz.shape[0])
    max_tiles = int(base.max_tiles_per_gaussian)

    def probe(max_tiles):
        thresholds = sorted({s for ra in _RA_CANDIDATES for s in _band_starts(ra, max_tiles)})
        counts, max_tt = probe_straddle(scene, cams, thresholds,
                                        scaling_modifier=scaling_modifier, device=device)
        return thresholds, counts, max_tt

    thresholds, counts, max_tt = probe(max_tiles)
    peak_tt = int(max_tt.max())
    if peak_tt > max_tiles:
        # A probed camera exceeds the rect ceiling: grow it to the next
        # power of two, as JAX does, and probe again.
        max_tiles = _padded(peak_tt)
        thresholds, counts, max_tt = probe(max_tiles)
    elif _padded(max(int(peak_tt * 1.5), 32)) < max_tiles:
        # Shrink the ceiling to the probed envelope (x1.5 margin, pow2).
        max_tiles = _padded(max(int(peak_tt * 1.5), 32))

    need = dict(zip(thresholds, counts.max(axis=0).tolist()))
    plan = synthesize_plan(n, need, max_tiles, band_margin=band_margin)
    dups, _ = measure_duplicates(
        scene, cams, plan, max_tiles, scaling_modifier=scaling_modifier,
        jitter_margin=1.0 if jitter else 0.0, tile_cull=bool(base.tile_cull),
        device=device)
    dup_ref = float(np.quantile(dups, cap_quantile))
    cap = int(np.ceil(cap_margin * dup_ref / 4096.0) * 4096)
    return base._replace(
        phase_plan=plan,
        max_tiles_per_gaussian=max_tiles,
        dup_capacity=max(cap, 4096),
    )
