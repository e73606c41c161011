"""Configuration: the reference's parameter groups and the `cfg_args` file.

Port of `wast3d_tpu/config.py` for training and stylization: `ModelConfig`,
`PipelineConfig`, `OptimizationConfig` and `StylizeConfig` with the same
field names and defaults, so command lines and saved `cfg_args` stay
interchangeable with the JAX package and the reference. `ModelConfig.data_device` keeps the JAX
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


@dataclass(frozen=True)
class StylizeConfig:
    """WaSt-3D stylization knobs (notebook 11 defaults), as in the JAX
    package: content clusters, outlier quantile and subsample (cells 5-6),
    ball radius factor and minimum ball size (cells 21-22), descriptor
    scales, Adam steps / lr and loss weights (cell 28), merge scale factor
    (cell 36).

    `desc_kernel`: take K4/K5 (`stylize/desc_kernel.py`) for padded patches
    of 2048 points or more on CUDA; it costs an [Mp, Mp] uint8 pair code.
    `pallas_interpret` is accepted so that command lines stay the same and
    has no effect in the port (there is no Pallas interpreter here)."""

    num_content_clusters: int = 80
    outlier_quantile: float = 0.975
    outlier_knn: int = 30
    ball_radius_factor: float = 0.45
    min_ball_points: int = 40
    fit_steps: int = 1000
    fit_lr: float = 1e-3
    global_knn: int = 2000
    global_stride: int = 20
    local_knn: int = 100
    domain_knn: int = 20
    w_global: float = 1.0
    w_local: float = 2e2
    w_domain: float = 3e1
    w_coverage: float = 0.0  # loss_domain_coverage weight (multi-cluster notebook)
    merge_scale_factor: float = 0.885
    ball_capacity: int = 2048  # padded domain points per coverage ball
    max_balls: int = 512
    desc_block: int = 2048  # descriptor-loss column block (memory knob)
    desc_kernel: bool = True
    pallas_interpret: bool = False  # no effect in the port


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
