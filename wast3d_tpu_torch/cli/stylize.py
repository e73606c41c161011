"""CLI: scene-to-scene stylization (the notebook-11 pipeline as a command).

`python -m wast3d_tpu_torch.cli.stylize --content <ply> --style_cluster <npz>
--output <ply> [--device cuda|cpu]`

The flags of `wast3d_tpu.cli.stylize`, with every `StylizeConfig` field,
plus `--device`. `--devices` above 1 (sharding the ball fit over several
devices) raises `NotImplementedError`: `parallel/` is not ported yet
(ROADMAP.md, queue 1).
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from wast3d_tpu_torch.config import StylizeConfig, add_config_args, extract_config


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="wast3d_tpu_torch stylization")
    parser.add_argument("--content", required=True, type=str,
                        help="content scene PLY (trained 3DGS)")
    parser.add_argument("--style_cluster", required=True, type=str,
                        help="style patch npz (from cli.save_clusters)")
    parser.add_argument("--output", required=True, type=str)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--max_style_points", type=int, default=16384)
    parser.add_argument("--devices", type=int, default=1,
                        help="devices to shard the ball fit over; only 1 is ported")
    add_config_args(parser, StylizeConfig())
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    return parser


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    if args.devices > 1:
        raise NotImplementedError(
            f"--devices {args.devices}: sharding the ball fit over several devices "
            "needs parallel/, which is not ported yet: see ROADMAP.md, queue 1 (parallel/)")
    from wast3d_tpu_torch.stylize.pipeline import stylize_from_files

    stylize_from_files(
        args.content, args.style_cluster, args.output,
        cfg=extract_config(StylizeConfig, args), device=args.device, seed=args.seed,
        batch_size=args.batch_size, verbose=True, max_style_points=args.max_style_points)


if __name__ == "__main__":
    main()
