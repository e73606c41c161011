"""CLI: style sweep (one content scene x many style clusters).

`python -m wast3d_tpu_torch.cli.sweep --content <ply> --style_clusters a.npz
b.npz --output_dir out/ [--device cuda|cpu]` writes
`out/stylized_<name>.ply` for each style cluster `<name>.npz`.

The flags of `wast3d_tpu.cli.sweep`, with every `StylizeConfig` field, plus
`--device`. The port runs every style on the one device: `--data_axis` 0
or 1 does that, and above 1 (sharding the styles over a mesh's data axis)
raises `NotImplementedError`, as `parallel/` is not ported yet (ROADMAP.md,
queue 1). JAX's XLA compile cache has no counterpart here.
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
                        help="mesh data-axis size; only 0 or 1 (one device) is ported")
    parser.add_argument("--max_style_points", type=int, default=16384)
    parser.add_argument("--seed", type=int, default=0)
    add_config_args(parser, StylizeConfig())
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    return parser


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    if args.data_axis > 1:
        raise NotImplementedError(
            f"--data_axis {args.data_axis}: sharding the styles over several devices "
            "needs parallel/, which is not ported yet: see ROADMAP.md, queue 1 (parallel/)")
    from wast3d_tpu_torch.scene.ply import load_ply, save_ply
    from wast3d_tpu_torch.stylize.cluster import load_cluster
    from wast3d_tpu_torch.stylize.sweep import stylize_sweep

    content = load_ply(args.content, device=args.device)
    patches = [load_cluster(p) for p in args.style_clusters]
    outs = stylize_sweep(content, patches, cfg=extract_config(StylizeConfig, args),
                         seed=args.seed, max_style_points=args.max_style_points,
                         verbose=True, device=args.device)
    os.makedirs(args.output_dir, exist_ok=True)
    for path, scene in zip(args.style_clusters, outs):
        name = os.path.splitext(os.path.basename(path))[0]
        out = os.path.join(args.output_dir, f"stylized_{name}.ply")
        save_ply(scene, out)
        print(f"-> {out}")


if __name__ == "__main__":
    main()
