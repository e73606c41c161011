"""Full evaluation harness: train -> render -> metrics over scene lists.

Port of `wast3d_tpu/eval/full_eval.py` (the reference `full_eval.py:15-75`):
the standard 3DGS benchmark sweep over MipNeRF-360 (outdoor / indoor),
Tanks&Temples and DeepBlending scenes, each trained to 30k iterations with
the eval split, rendered at iterations 7000 and 30000, then scored by the
metrics harness. Runs in-process, on `device` (None means CUDA).
"""

from __future__ import annotations

import os
from typing import List, Optional

from wast3d_tpu_torch.device import DeviceLike

MIPNERF360_OUTDOOR = ["bicycle", "flowers", "garden", "stump", "treehill"]
MIPNERF360_INDOOR = ["room", "counter", "kitchen", "bonsai"]
TANKS_AND_TEMPLES = ["truck", "train"]
DEEP_BLENDING = ["drjohnson", "playroom"]

EVAL_ITERATIONS = (7000, 30000)


def run_training(source: str, model_path: str, images: str = "images",
                 resolution: int = -1, iterations: int = 30000,
                 quiet: bool = True, *, device: DeviceLike = None, **train_kwargs):
    """`train_scene` with the eval split, saving at `EVAL_ITERATIONS` (those
    up to `iterations`, and the last). `train_kwargs` go to `train_scene`
    as they are (an `opt_cfg`, `settings`, ...). Returns the Trainer."""
    from wast3d_tpu_torch.train.driver import train_scene

    return train_scene(
        source_path=source, model_path=model_path, images=images,
        resolution=resolution, iterations=iterations, eval_split=True,
        save_iterations=list(EVAL_ITERATIONS), quiet=quiet, device=device,
        **train_kwargs)


def full_eval(
    mipnerf360_dir: Optional[str] = None,
    tanksandtemples_dir: Optional[str] = None,
    deepblending_dir: Optional[str] = None,
    output_dir: str = "./eval",
    skip_training: bool = False,
    skip_rendering: bool = False,
    skip_metrics: bool = False,
    scenes: Optional[List[str]] = None,
    *,
    device: DeviceLike = None,
) -> dict:
    from wast3d_tpu_torch.eval.metrics import evaluate
    from wast3d_tpu_torch.eval.render_sets import render_sets

    jobs = []  # (scene_name, source_path, images_arg, resolution)
    if mipnerf360_dir:
        for s in MIPNERF360_OUTDOOR:
            jobs.append((s, os.path.join(mipnerf360_dir, s), "images_4", -1))
        for s in MIPNERF360_INDOOR:
            jobs.append((s, os.path.join(mipnerf360_dir, s), "images_2", -1))
    if tanksandtemples_dir:
        for s in TANKS_AND_TEMPLES:
            jobs.append((s, os.path.join(tanksandtemples_dir, s), "images", -1))
    if deepblending_dir:
        for s in DEEP_BLENDING:
            jobs.append((s, os.path.join(deepblending_dir, s), "images", -1))
    if scenes:
        jobs = [j for j in jobs if j[0] in scenes]

    model_paths = []
    for name, source, images, resolution in jobs:
        model_path = os.path.join(output_dir, name)
        model_paths.append(model_path)
        if not skip_training:
            run_training(source, model_path, images, resolution, device=device)
        if not skip_rendering:
            for it in EVAL_ITERATIONS:
                render_sets(model_path, source, iteration=it, skip_train=True,
                            device=device)
    if not skip_metrics:
        return evaluate(model_paths, device=device)
    return {}
