"""End-to-end scene training: the `train.py` entry point.

Port of `wast3d_tpu/train/driver.py::train_scene` (the reference's
`train.py`, and with `sphere_cfg` its `train_spheres*.py` style-scene
variants): load the dataset, initialise Gaussians from its point cloud
(random 100k-point cube for a Blender scene without one), run the
reconstruction schedule, write PLYs at `save_iterations` and checkpoints at
`checkpoint_iterations`, and report test / train PSNR at each save
(`<model_path>/log.jsonl`, plus `cfg_args`). `gui`, a
`viewer.network_gui.NetworkGUI`, serves one live-view frame per iteration
with a request pending (`Trainer._pre_step`), as in the JAX driver.
"""

from __future__ import annotations

import json
import os
import time
from typing import List, Optional

import numpy as np
import torch

from wast3d_tpu_torch.config import (
    ModelConfig, OptimizationConfig, SphereConfig, save_cfg_args)
from wast3d_tpu_torch.device import DeviceLike, resolve_device
from wast3d_tpu_torch.ops.image_losses import psnr
from wast3d_tpu_torch.ops.rasterizer import api as raster_api
from wast3d_tpu_torch.scene.datasets import build_cameras, load_scene_info
from wast3d_tpu_torch.scene.gaussians import from_point_cloud
from wast3d_tpu_torch.train import checkpoint as ckpt_mod
from wast3d_tpu_torch.train.reconstruct import Trainer, init_train_state
from wast3d_tpu_torch.utils.cache import enable as enable_cache


def train_scene(
    source_path: str,
    model_path: str,
    images: str = "images",
    resolution: int = -1,
    iterations: int = 30_000,
    eval_split: bool = False,
    white_background: bool = False,
    sh_degree: int = 3,
    save_iterations: Optional[List[int]] = None,
    checkpoint_iterations: Optional[List[int]] = None,
    start_checkpoint: Optional[str] = None,
    opt_cfg: Optional[OptimizationConfig] = None,
    sphere_cfg: Optional[SphereConfig] = None,
    settings: Optional[raster_api.RasterizeSettings] = None,
    seed: int = 0,
    quiet: bool = False,
    log_every: int = 100,
    gui=None,
    jitter: bool = True,
    data_device: str = "tpu",
    device: DeviceLike = None,
) -> Trainer:
    """Train one scene on `device` (None means CUDA). Returns the final
    Trainer (with .state)."""
    enable_cache()
    dev = resolve_device(device)
    save_iterations = sorted(set(save_iterations or [7_000, 30_000]))
    checkpoint_iterations = sorted(set(checkpoint_iterations or []))
    opt_cfg = opt_cfg or OptimizationConfig(iterations=iterations)
    settings = settings or raster_api.RasterizeSettings()

    info = load_scene_info(source_path, images, white_background, eval_split)
    cameras_extent = info.nerf_normalization["radius"]
    train_cams = build_cameras(info.train_cameras, resolution, device=dev)
    test_cams = build_cameras(info.test_cameras, resolution, device=dev)

    scene = from_point_cloud(np.asarray(info.point_cloud.points, np.float32),
                             np.asarray(info.point_cloud.colors, np.float32),
                             max_sh_degree=sh_degree, device=dev)
    state = init_train_state(scene, opt_cfg, spatial_lr_scale=cameras_extent)
    start_iter = 0
    if start_checkpoint:
        state, _ = ckpt_mod.load_checkpoint(start_checkpoint, device=dev)
        start_iter = int(state.step)

    os.makedirs(model_path, exist_ok=True)
    save_cfg_args(ModelConfig(sh_degree=sh_degree,
                              source_path=os.path.abspath(source_path),
                              model_path=model_path, images=images,
                              resolution=resolution,
                              white_background=white_background, eval=eval_split),
                  model_path)
    log_f = open(os.path.join(model_path, "log.jsonl"), "a")

    trainer = Trainer(state, train_cams, opt_cfg=opt_cfg, settings=settings,
                      spatial_lr_scale=cameras_extent, cameras_extent=cameras_extent,
                      sphere_cfg=sphere_cfg, seed=seed, white_background=white_background,
                      gui=gui, jitter=jitter, data_device=data_device, device=dev)
    trainer.history_sink = lambda e: (log_f.write(json.dumps(e) + "\n"), log_f.flush())

    def report(it):
        entry = {"iter": it, "n_active": int(trainer.state.scene.num_active),
                 "t": time.time()}
        for split, cams in (("test", test_cams), ("train", train_cams[:5])):
            if not cams:
                continue
            psnrs = []
            with torch.no_grad():
                for cam, gt in cams[:8]:
                    img = raster_api.render(cam, trainer.state.scene, trainer.bg_color,
                                            settings=settings, device=dev)["render"]
                    psnrs.append(float(psnr(img, torch.from_numpy(gt).to(dev))))
            entry[f"psnr_{split}"] = float(np.mean(psnrs))
        if not quiet:
            print(f"[{it}] " + json.dumps(entry))
        log_f.write(json.dumps(entry) + "\n")
        log_f.flush()

    milestones = sorted(set(
        [it for it in save_iterations if start_iter < it <= iterations]
        + [it for it in checkpoint_iterations if start_iter < it <= iterations]
        + [iterations]))
    t0 = time.time()
    prev = start_iter
    for target in milestones:
        trainer.run(target - prev, log_every=log_every)
        prev = target
        if target in save_iterations or target == iterations:
            ckpt_mod.save_point_cloud(model_path, target, trainer.state.scene)
            report(target)
        if target in checkpoint_iterations:
            ckpt_mod.save_checkpoint(os.path.join(model_path, f"chkpnt{target}"),
                                     trainer.state, cameras_extent)
    if not quiet:
        steps = iterations - start_iter
        dt = time.time() - t0
        print(f"Training complete: {steps} iters in {dt:.1f}s "
              f"({steps / max(dt, 1e-9):.2f} it/s)")
    trainer.history_sink = None
    log_f.close()
    return trainer
