"""CLI: full benchmark sweep (train / render / metrics over scene lists).

`python -m wast3d_tpu_torch.cli.full_eval -m360 <dir> [-tat <dir>] [-db <dir>]
[-o ./eval] [--skip_training] [--skip_rendering] [--skip_metrics]
[--scenes ...] [--device cuda|cpu]`: the flags of
`wast3d_tpu.cli.full_eval` (the reference `full_eval.py`), plus `--device`.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="wast3d_tpu_torch full evaluation")
    parser.add_argument("--mipnerf360", "-m360", type=str, default=None)
    parser.add_argument("--tanksandtemples", "-tat", type=str, default=None)
    parser.add_argument("--deepblending", "-db", type=str, default=None)
    parser.add_argument("--output_path", "-o", type=str, default="./eval")
    parser.add_argument("--skip_training", action="store_true")
    parser.add_argument("--skip_rendering", action="store_true")
    parser.add_argument("--skip_metrics", action="store_true")
    parser.add_argument("--scenes", nargs="*", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    return parser


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = build_parser().parse_args(argv)
    from wast3d_tpu_torch.eval.full_eval import full_eval

    results = full_eval(
        mipnerf360_dir=args.mipnerf360,
        tanksandtemples_dir=args.tanksandtemples,
        deepblending_dir=args.deepblending,
        output_dir=args.output_path,
        skip_training=args.skip_training,
        skip_rendering=args.skip_rendering,
        skip_metrics=args.skip_metrics,
        scenes=args.scenes,
        device=args.device,
    )
    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
