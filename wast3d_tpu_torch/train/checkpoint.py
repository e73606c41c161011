"""Checkpoints and the PLY layout of a model directory.

Port of `wast3d_tpu/train/checkpoint.py`. A checkpoint holds what the JAX
package's does (the six parameter tensors, mask, SH degrees, densification
statistics, Adam moments and step count, spatial_lr_scale, iteration), so
training resumes where it stopped. The card's machine has no orbax, so the
format is `torch.save` of a dict of plain CPU tensors and numbers, written
to the file `path`; the two packages cannot read each other's checkpoints.
The PLY written by `save_point_cloud` is byte-identical to the JAX
package's for the same scene.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from wast3d_tpu_torch.device import DeviceLike, resolve_device
from wast3d_tpu_torch.scene.gaussians import FIELDS, GaussianScene
from wast3d_tpu_torch.scene.ply import save_ply
from wast3d_tpu_torch.train.densify import DensifyStats
from wast3d_tpu_torch.train.optim import AdamState
from wast3d_tpu_torch.train.reconstruct import TrainState


def save_checkpoint(path: str, state: TrainState, spatial_lr_scale: float = 1.0) -> None:
    def host(t):
        return t.detach().cpu()

    tree = {
        "scene": {f: host(getattr(state.scene, f)) for f in FIELDS},
        "meta": {"active_sh_degree": state.scene.active_sh_degree,
                 "max_sh_degree": state.scene.max_sh_degree,
                 "spatial_lr_scale": float(spatial_lr_scale),
                 "step": int(state.step)},
        "opt": {"mu": {k: host(v) for k, v in state.opt_state.mu.items()},
                "nu": {k: host(v) for k, v in state.opt_state.nu.items()},
                "count": int(state.opt_state.count)},
        "stats": {k: host(v) for k, v in state.stats._asdict().items()},
    }
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(tree, path)


def load_checkpoint(path: str, device: DeviceLike = None) -> Tuple[TrainState, float]:
    dev = resolve_device(device)
    tree = torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)
    meta = tree["meta"]
    scene = GaussianScene(
        **{f: tree["scene"][f].to(dev) for f in FIELDS},
        active_sh_degree=int(meta["active_sh_degree"]),
        max_sh_degree=int(meta["max_sh_degree"]))
    opt = AdamState(mu={k: v.to(dev) for k, v in tree["opt"]["mu"].items()},
                    nu={k: v.to(dev) for k, v in tree["opt"]["nu"].items()},
                    count=int(tree["opt"]["count"]))
    stats = DensifyStats(**{k: v.to(dev) for k, v in tree["stats"].items()})
    return TrainState(scene, opt, stats, int(meta["step"])), float(meta["spatial_lr_scale"])


def save_point_cloud(model_path: str, iteration: int, scene: GaussianScene) -> str:
    """`<model_path>/point_cloud/iteration_<i>/point_cloud.ply`."""
    out = os.path.join(model_path, "point_cloud", f"iteration_{iteration}",
                       "point_cloud.ply")
    save_ply(scene, out)
    return out


def find_max_iteration(model_path: str) -> Optional[int]:
    """Largest N of `<model_path>/point_cloud/iteration_N`, or None."""
    pc_dir = os.path.join(model_path, "point_cloud")
    if not os.path.isdir(pc_dir):
        return None
    iters = [int(d.split("_")[-1]) for d in os.listdir(pc_dir)
             if d.startswith("iteration_")]
    return max(iters) if iters else None
