"""Batch rendering of train/test camera sets to image files.

Port of `wast3d_tpu/eval/render_sets.py`: loads a trained scene (PLY at the
requested iteration), renders every view and writes `renders/NNNNN.png` +
`gt/NNNNN.png` (with `save_depth`, also `depth/NNNNN.png`: the depth
min-max normalised, in three channels) under
`<model_path>/<split>/ours_<iteration>/`. `render_set` renders the views in
groups of `batch` through `render_batch`, as JAX's does; JAX renders a group
in one dispatch to amortise its dispatch latency, the port renders its views
one after another (a CUDA launch is cheap) and stacks their outputs, so the
images do not depend on `batch`. The JAX package's `autoplan` sizes static
binning capacities to the scene (`ops/rasterizer/autoplan.py`); binning here
has none and nothing would read the tuned settings, so `render_sets` does not
call the tuner and `autoplan` does nothing.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from wast3d_tpu_torch.core.camera import Camera
from wast3d_tpu_torch.device import DeviceLike, resolve_device
from wast3d_tpu_torch.ops.rasterizer import api as raster_api
from wast3d_tpu_torch.scene.datasets import build_cameras, load_scene_info
from wast3d_tpu_torch.scene.gaussians import GaussianScene
from wast3d_tpu_torch.scene.ply import load_ply
from wast3d_tpu_torch.train.checkpoint import find_max_iteration
from wast3d_tpu_torch.utils.png import write_png


def save_image(path: str, img: np.ndarray) -> None:
    """[H,W,C] float in [0,1] -> 8-bit PNG (truncating, as the JAX package
    does)."""
    write_png(path, (np.clip(np.asarray(img), 0, 1) * 255).astype(np.uint8))


def render_batch(
    cameras: List[Camera],
    scene: GaussianScene,
    bg_color: torch.Tensor,
    settings: raster_api.RasterizeSettings = raster_api.RasterizeSettings(),
    mode: str = "map",
    *,
    device: DeviceLike = None,
) -> dict:
    """Render B views and return `render`'s dict with a leading [B] axis on
    every entry. `mode` is JAX's ("map" or "vmap"); both render the views
    one after another here."""
    if mode not in ("map", "vmap"):
        raise ValueError(f"mode must be 'map' or 'vmap', got {mode!r}")
    outs = [raster_api.render(cam, scene, bg_color, settings=settings, device=device)
            for cam in cameras]
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


def render_set(
    model_path: str,
    name: str,
    iteration: int,
    cameras: List[Tuple[Camera, Optional[np.ndarray]]],
    scene: GaussianScene,
    bg_color: torch.Tensor,
    settings: raster_api.RasterizeSettings = raster_api.RasterizeSettings(),
    save_depth: bool = False,
    batch: int = 1,
    *,
    device: DeviceLike = None,
) -> str:
    """Render the (camera, ground truth or None) views in groups of `batch`
    and write their PNGs; returns the `ours_<iteration>` directory."""
    base = os.path.join(model_path, name, f"ours_{iteration}")
    for b0 in range(0, len(cameras), batch):
        group = cameras[b0:b0 + batch]
        out = render_batch([c for c, _ in group], scene, bg_color, settings=settings,
                           device=device)
        renders = out["render"].cpu().numpy()
        depths = out["depth"].cpu().numpy() if save_depth else None
        for j, (_, gt) in enumerate(group):
            idx = b0 + j
            save_image(os.path.join(base, "renders", f"{idx:05d}.png"), renders[j])
            if gt is not None:
                save_image(os.path.join(base, "gt", f"{idx:05d}.png"), gt)
            if save_depth:
                d = depths[j]
                dn = (d - d.min()) / (np.ptp(d) + 1e-9)
                save_image(os.path.join(base, "depth", f"{idx:05d}.png"),
                           np.stack([dn] * 3, -1))
    return base


def render_sets(
    model_path: str,
    source_path: str,
    iteration: int = -1,
    skip_train: bool = False,
    skip_test: bool = False,
    white_background: bool = False,
    resolution: int = -1,
    settings: raster_api.RasterizeSettings = raster_api.RasterizeSettings(),
    batch: int = 1,
    autoplan: bool = True,
    device: DeviceLike = None,
) -> None:
    """Render the train and test splits of `source_path` with the model in
    `model_path` on `device` (None means CUDA), `batch` views to a
    `render_batch` call. `autoplan` is accepted and does nothing: the tuner
    is not called (module docstring)."""
    del autoplan
    dev = resolve_device(device)
    if iteration == -1:
        iteration = find_max_iteration(model_path)
    ply = os.path.join(model_path, "point_cloud", f"iteration_{iteration}",
                       "point_cloud.ply")
    scene = load_ply(ply, device=dev)
    info = load_scene_info(source_path, white_background=white_background,
                           eval_split=True)
    bg = torch.full((3,), 1.0 if white_background else 0.0, device=dev)
    splits = []
    if not skip_train:
        splits.append(("train", info.train_cameras))
    if not skip_test and info.test_cameras:
        splits.append(("test", info.test_cameras))
    for name, infos in splits:
        render_set(model_path, name, iteration,
                   build_cameras(infos, resolution, device=dev), scene, bg,
                   settings, batch=batch, device=dev)
