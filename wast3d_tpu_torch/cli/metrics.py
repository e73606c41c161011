"""CLI: metrics over rendered sets.

`python -m wast3d_tpu_torch.cli.metrics -m <model_path> [...] [--split test]
[--device cuda|cpu]`: the flags of `wast3d_tpu.cli.metrics` (the reference
`metrics.py:95-103`), plus `--device`. Writes each model's `results.json`
and `per_view.json` and prints the results.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="wast3d_tpu_torch metrics")
    parser.add_argument("--model_paths", "-m", nargs="+", type=str, required=True)
    parser.add_argument("--split", type=str, default="test")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    return parser


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = build_parser().parse_args(argv)
    from wast3d_tpu_torch.eval.metrics import evaluate

    results = evaluate(args.model_paths, split=args.split, device=args.device)
    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
