"""CLI: scene-to-scene stylization (the notebook-11 pipeline as a command).

`python -m wast3d_tpu_torch.cli.stylize --content <ply> --style_cluster <npz>
--output <ply> [--device cuda|cpu]`

The flags of `wast3d_tpu.cli.stylize`, with every `StylizeConfig` field,
plus `--device`. `--devices N` above 1 splits the ball fit over N ranks
(`make_mesh(N, data=N)`, as JAX does): N local processes, one per card for
CUDA (nccl) or on the host for the CPU (gloo), or under `torchrun` the
ranks it started (`parallel.multihost.launch`). Rank 0 writes the PLY and
the log.
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
                        help="shard the ball-fit axis over this many ranks (1 = one device)")
    add_config_args(parser, StylizeConfig())
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    return parser


def stylize(args: argparse.Namespace) -> None:
    """One rank's work (the whole of it without `--devices`)."""
    from wast3d_tpu_torch.parallel import multihost
    from wast3d_tpu_torch.stylize.pipeline import stylize_from_files

    mesh, device = None, args.device
    if args.devices > 1:
        mesh = multihost.global_mesh(data=args.devices)
        device = multihost.rank_device(args.device)
    stylize_from_files(
        args.content, args.style_cluster, args.output,
        cfg=extract_config(StylizeConfig, args), device=device, seed=args.seed,
        batch_size=args.batch_size, verbose=multihost.is_coordinator(),
        max_style_points=args.max_style_points, mesh=mesh)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    if args.devices > 1:
        from wast3d_tpu_torch.parallel.multihost import launch

        launch(stylize, args.devices, args.device, (args,))
    else:
        stylize(args)


if __name__ == "__main__":
    main()
