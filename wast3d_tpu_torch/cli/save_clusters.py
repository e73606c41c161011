"""CLI: K-means cluster a trained style scene and export patch npz files.

`python -m wast3d_tpu_torch.cli.save_clusters --ckpt_path <ply or checkpoint>
--output_dir <dir> [--num_clusters 100] [--n_init 20] [--seed 0]
[--device cuda|cpu]`

The flags of `wast3d_tpu.cli.save_clusters` (the reference's
`aux_save_clusters_clean.py`), plus `--device`. `--ckpt_path` is a PLY or
a checkpoint file written by the port's training (`torch.save`; the port
does not read orbax directories).
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="export style clusters")
    parser.add_argument("--ckpt_path", required=True, type=str,
                        help="scene PLY or the port's checkpoint file")
    parser.add_argument("--output_dir", required=True, type=str)
    parser.add_argument("--num_clusters", type=int, default=100)
    parser.add_argument("--n_init", type=int, default=20)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    return parser


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    from wast3d_tpu_torch.utils.cache import enable

    enable()
    from wast3d_tpu_torch.device import resolve_device
    from wast3d_tpu_torch.stylize.cluster import export_clusters

    device = resolve_device(args.device)

    if args.ckpt_path.endswith(".ply"):
        from wast3d_tpu_torch.scene.ply import load_ply

        scene = load_ply(args.ckpt_path, device=device)
    else:
        from wast3d_tpu_torch.train.checkpoint import load_checkpoint

        scene = load_checkpoint(args.ckpt_path, device=device)[0].scene
    paths = export_clusters(scene, args.output_dir, args.num_clusters,
                            n_init=args.n_init, seed=args.seed)
    print(f"wrote {len(paths)} clusters to {args.output_dir}")


if __name__ == "__main__":
    main()
