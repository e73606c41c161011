"""Configuration: the reference's parameter groups and the `cfg_args` file.

Port of `wast3d_tpu/config.py` for training: `ModelConfig`,
`PipelineConfig` and `OptimizationConfig` with the same field names and
defaults, so command lines and saved `cfg_args` stay interchangeable with
the JAX package and the reference. `ModelConfig.data_device` keeps the JAX
package's default "tpu": the port reads any value but "cpu" as "keep the
ground-truth images on the training device".
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from dataclasses import dataclass, fields
from typing import Any, Optional


@dataclass(frozen=True)
class ModelConfig:
    sh_degree: int = 3
    source_path: str = ""
    model_path: str = ""
    images: str = "images"
    resolution: int = -1
    white_background: bool = False
    data_device: str = "tpu"
    eval: bool = False


@dataclass(frozen=True)
class PipelineConfig:
    convert_SHs_python: bool = False
    compute_cov3D_python: bool = False
    debug: bool = False


@dataclass(frozen=True)
class OptimizationConfig:
    iterations: int = 30_000
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    percent_dense: float = 0.1
    lambda_dssim: float = 0.2
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 30_000
    densify_grad_threshold: float = 0.0002


# Fields with single-letter shorthands in the reference CLI.
_SHORTHANDS = {
    "source_path": "-s",
    "model_path": "-m",
    "images": "-i",
    "resolution": "-r",
    "white_background": "-w",
}


def add_config_args(parser: argparse.ArgumentParser, *configs: Any) -> None:
    """Register each dataclass field as a --flag with its default."""
    for cfg in configs:
        for f in fields(cfg):
            names = [f"--{f.name}"]
            if f.name in _SHORTHANDS:
                names.append(_SHORTHANDS[f.name])
            default = getattr(cfg, f.name)
            if isinstance(default, bool):
                parser.add_argument(*names, action="store_true", default=default)
            else:
                parser.add_argument(*names, type=type(default), default=default)


def extract_config(cls, args: argparse.Namespace):
    """Build a config dataclass from parsed args."""
    cfg = cls(**{f.name: getattr(args, f.name) for f in fields(cls)
                 if hasattr(args, f.name)})
    if getattr(cfg, "source_path", ""):
        cfg = dataclasses.replace(cfg, source_path=os.path.abspath(cfg.source_path))
    return cfg


def save_cfg_args(model_cfg: ModelConfig, model_path: str) -> None:
    """Write `<model_path>/cfg_args` as a `Namespace(...)` literal."""
    os.makedirs(model_path, exist_ok=True)
    with open(os.path.join(model_path, "cfg_args"), "w") as f:
        f.write(str(argparse.Namespace(**dataclasses.asdict(model_cfg))))


def load_cfg_args(model_path: str) -> Optional[argparse.Namespace]:
    """Read `<model_path>/cfg_args`, a `Namespace(...)` literal (the format
    the reference writes and eval()s), or None when there is none."""
    path = os.path.join(model_path, "cfg_args")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        text = f.read()
    return eval(text, {"Namespace": argparse.Namespace})  # noqa: S307
