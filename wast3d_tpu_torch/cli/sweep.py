"""CLI: style sweep (one content scene x many style clusters).

`python -m wast3d_tpu_torch.cli.sweep --content <ply> --style_clusters a.npz
b.npz --output_dir out/ [--device cuda|cpu]` writes
`out/stylized_<name>.ply` for each style cluster `<name>.npz`.

The flags of `wast3d_tpu.cli.sweep`, with every `StylizeConfig` field, plus
`--device`. `--data_axis N` splits the styles over N ranks
(`make_mesh(N, data=N)`, as JAX does), 0 meaning every visible card (or the
world under `torchrun`; one process for the CPU): the ranks start as in
`cli.stylize` (`parallel.multihost.launch`), and rank 0 writes the PLYs.
JAX's XLA compile cache has no counterpart here.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

from wast3d_tpu_torch.config import StylizeConfig, add_config_args, extract_config


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="wast3d_tpu_torch style sweep")
    parser.add_argument("--content", required=True, type=str)
    parser.add_argument("--style_clusters", required=True, nargs="+", type=str)
    parser.add_argument("--output_dir", required=True, type=str)
    parser.add_argument("--data_axis", type=int, default=0,
                        help="mesh data-axis size (0 = all devices)")
    parser.add_argument("--max_style_points", type=int, default=16384)
    parser.add_argument("--seed", type=int, default=0)
    add_config_args(parser, StylizeConfig())
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    return parser


def data_axis(requested: int, device: str) -> int:
    """`--data_axis`, with 0 meaning every visible device: the world under
    torchrun, else the host's cards for CUDA and one process for the CPU."""
    import torch

    from wast3d_tpu_torch.parallel.multihost import under_torchrun

    if requested:
        return requested
    if under_torchrun():
        return int(os.environ["WORLD_SIZE"])

    return torch.cuda.device_count() if torch.device(device).type == "cuda" else 1


def sweep(args: argparse.Namespace, data: int) -> None:
    """One rank's work (the whole of it with one rank)."""
    from wast3d_tpu_torch.parallel import multihost
    from wast3d_tpu_torch.scene.ply import load_ply, save_ply
    from wast3d_tpu_torch.stylize.cluster import load_cluster
    from wast3d_tpu_torch.stylize.sweep import stylize_sweep

    mesh, device = None, args.device
    if data > 1:
        mesh = multihost.global_mesh(data=data)
        device = multihost.rank_device(args.device)
    content = load_ply(args.content, device=device)
    patches = [load_cluster(p) for p in args.style_clusters]
    outs = stylize_sweep(content, patches, cfg=extract_config(StylizeConfig, args),
                         seed=args.seed, max_style_points=args.max_style_points,
                         verbose=multihost.is_coordinator(), device=device, mesh=mesh)
    if outs is None:
        return
    os.makedirs(args.output_dir, exist_ok=True)
    for path, scene in zip(args.style_clusters, outs):
        name = os.path.splitext(os.path.basename(path))[0]
        out = os.path.join(args.output_dir, f"stylized_{name}.ply")
        save_ply(scene, out)
        print(f"-> {out}")


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    from wast3d_tpu_torch.utils.cache import enable

    enable()
    data = data_axis(args.data_axis, args.device)
    if data > 1:
        from wast3d_tpu_torch.parallel.multihost import launch

        launch(sweep, data, args.device, (args, data))
    else:
        sweep(args, data)


if __name__ == "__main__":
    main()
