"""CLI: photometric reconstruction training.

`python -m wast3d_tpu_torch.cli.train -s <source> -m <model_path> [...]
[--device cuda|cpu]`

The flags of `wast3d_tpu.cli.train` (the reference `train.py` flags, from
the same config groups), plus `--device` as `cli.render` has. Differences:
- `--renderer` takes "cuda" (the hand-written kernels, the default) or
  "torch" (their plain PyTorch versions);
- `--sphere_mode` other than "none" raises `NotImplementedError`: the
  sphere regularisers are not ported yet (ROADMAP.md, queue 1 item 12);
- `--ip` / `--port` are accepted and no viewer starts (queue 1 item 18);
  `--debug_from`, `--detect_anomaly` and `--test_iterations` are accepted
  and do nothing, as in the JAX package.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from wast3d_tpu_torch.config import (
    ModelConfig,
    OptimizationConfig,
    PipelineConfig,
    add_config_args,
    extract_config,
)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="wast3d_tpu_torch training")
    add_config_args(parser, ModelConfig(), OptimizationConfig(), PipelineConfig())
    parser.add_argument("--ip", type=str, default="127.0.0.1",
                        help="accepted; no viewer starts")
    parser.add_argument("--port", type=int, default=6009,
                        help="accepted; no viewer starts")
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
    parser.add_argument("--renderer", type=str, default="cuda",
                        choices=["cuda", "torch"])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    return parser


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    if args.sphere_mode != "none":
        raise NotImplementedError(
            f"--sphere_mode {args.sphere_mode}: the sphere regularisers are not "
            "ported yet: see ROADMAP.md, queue 1 item 12")
    model = extract_config(ModelConfig, args)
    opt = extract_config(OptimizationConfig, args)

    from wast3d_tpu_torch.ops.rasterizer.api import RasterizeSettings
    from wast3d_tpu_torch.train.driver import train_scene

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
        settings=RasterizeSettings(renderer=args.renderer),
        seed=args.seed,
        quiet=args.quiet,
        data_device=model.data_device,
        device=args.device,
    )


if __name__ == "__main__":
    main()
