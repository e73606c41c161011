"""CLI: photometric reconstruction training.

`python -m wast3d_tpu_torch.cli.train -s <source> -m <model_path> [...]
[--device cuda|cpu]`

The flags of `wast3d_tpu.cli.train` (the reference `train.py` flags, from
the same config groups), plus `--device` as `cli.render` has.
`--sphere_mode {isotropic,anisotropic,anisotropic_simple}` trains a style
scene with the sphere regularisers (`train/spheres.py`), built as the JAX
CLI builds them. Differences:
- `--renderer` takes JAX's "pallas" (the hand-written kernels, the
  default), "tiled" (their plain PyTorch versions) and "oracle" (the
  per-pixel oracle, `ops/rasterizer/oracle.py`: plain PyTorch, O(N·H·W),
  for small test scenes), and the port's aliases "cuda" and "torch";
- `--ip` / `--port` start the SIBR live viewer (`viewer/network_gui.py`),
  as in the JAX CLI: each iteration with a request pending renders one
  frame through K1 before its step; if the port is taken the CLI prints
  "network_gui disabled" and trains on;
- `--debug_from`, `--detect_anomaly` and `--test_iterations` are accepted
  and do nothing, as in the JAX package.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from wast3d_tpu_torch.config import (
    ModelConfig,
    OptimizationConfig,
    PipelineConfig,
    SphereConfig,
    add_config_args,
    extract_config,
)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="wast3d_tpu_torch training")
    add_config_args(parser, ModelConfig(), OptimizationConfig(), PipelineConfig())
    parser.add_argument("--ip", type=str, default="127.0.0.1",
                        help="address of the SIBR live viewer's listener")
    parser.add_argument("--port", type=int, default=6009,
                        help="port of the SIBR live viewer's listener")
    parser.add_argument("--debug_from", type=int, default=-1)
    parser.add_argument("--detect_anomaly", action="store_true", default=False)
    parser.add_argument("--test_iterations", nargs="+", type=int,
                        default=[7_000, 30_000])
    parser.add_argument("--save_iterations", nargs="+", type=int,
                        default=[7_000, 30_000])
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--checkpoint_iterations", nargs="+", type=int, default=[])
    parser.add_argument("--start_checkpoint", type=str, default=None)
    parser.add_argument("--sphere_mode", type=str, default="none",
                        choices=["none", "isotropic", "anisotropic",
                                 "anisotropic_simple"])
    parser.add_argument("--renderer", type=str, default="pallas",
                        choices=["pallas", "tiled", "oracle", "cuda", "torch"])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    return parser


def sphere_config(mode: str) -> Optional[SphereConfig]:
    """The `SphereConfig` of a `--sphere_mode`, as `wast3d_tpu.cli.train`
    builds it (None for "none")."""
    if mode == "isotropic":
        return SphereConfig()
    if mode in ("anisotropic", "anisotropic_simple"):
        return SphereConfig(anisotropic=True, anisotropy_ratio=1.3, lambda_anisotropy=0.1,
                            lambda_min_scale=0.5 if mode == "anisotropic" else 0.0)
    return None


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    model = extract_config(ModelConfig, args)
    opt = extract_config(OptimizationConfig, args)

    from wast3d_tpu_torch.ops.rasterizer.api import RasterizeSettings
    from wast3d_tpu_torch.train.driver import train_scene
    from wast3d_tpu_torch.viewer import network_gui

    gui = network_gui.maybe_start(args.ip, args.port)
    try:
        train_scene(
            source_path=model.source_path,
            model_path=model.model_path,
            images=model.images,
            resolution=model.resolution,
            iterations=opt.iterations,
            eval_split=model.eval,
            white_background=model.white_background,
            sh_degree=model.sh_degree,
            save_iterations=args.save_iterations,
            checkpoint_iterations=args.checkpoint_iterations,
            start_checkpoint=args.start_checkpoint,
            opt_cfg=opt,
            sphere_cfg=sphere_config(args.sphere_mode),
            settings=RasterizeSettings(renderer=args.renderer),
            seed=args.seed,
            quiet=args.quiet,
            gui=gui,
            data_device=model.data_device,
            device=args.device,
        )
    finally:
        if gui:
            gui.stop()


if __name__ == "__main__":
    main()
