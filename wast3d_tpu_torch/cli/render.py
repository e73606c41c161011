"""CLI: batch-render train/test sets from a trained model.

`python -m wast3d_tpu_torch.cli.render -m <model_path> [-s <source>]
[--iteration N] [--device cuda|cpu]`. The same flags as
`wast3d_tpu.cli.render`; the source path comes from the model's `cfg_args`
when `-s` is not given. `--fast` (the default, as in the JAX package)
renders with the bf16 tier of the blend (K1f), `--no-fast` with the exact
f32 kernel (K1). `--batch B` renders the views in groups of B through
`render_sets.render_batch` (the same images for any B); `--autoplan` is
accepted and does nothing: the port's binning has no static capacities, so
the tuner (`ops/rasterizer/autoplan.py`) is not called
(see `eval/render_sets.py`).
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from wast3d_tpu_torch.config import load_cfg_args


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description="wast3d_tpu_torch render")
    parser.add_argument("--model_path", "-m", type=str, required=True)
    parser.add_argument("--source_path", "-s", type=str, default=None)
    parser.add_argument("--iteration", type=int, default=-1)
    parser.add_argument("--skip_train", action="store_true")
    parser.add_argument("--skip_test", action="store_true")
    parser.add_argument("--resolution", "-r", type=int, default=-1)
    parser.add_argument("--white_background", "-w", action="store_true")
    parser.add_argument("--fast", action=argparse.BooleanOptionalAction,
                        default=True,
                        help="bf16 serving tier of the blend kernel (K1f, "
                             "default on as in the JAX package; --no-fast "
                             "for the exact f32 kernel)")
    parser.add_argument("--batch", type=int, default=1,
                        help="views per render_batch call (the images do "
                             "not depend on it)")
    parser.add_argument("--autoplan", action=argparse.BooleanOptionalAction,
                        default=True,
                        help="accepted and does nothing: binning has no "
                             "static capacities to tune, so the tuner is "
                             "not called")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    source = args.source_path
    white_bg = args.white_background
    cfg = load_cfg_args(args.model_path)
    if cfg is not None:
        source = source or getattr(cfg, "source_path", None)
        white_bg = white_bg or getattr(cfg, "white_background", False)
    if not source:
        parser.error("--source_path required (no cfg_args found)")

    from wast3d_tpu_torch.eval.render_sets import render_sets
    from wast3d_tpu_torch.ops.rasterizer import api

    render_sets(
        args.model_path, source, iteration=args.iteration,
        skip_train=args.skip_train, skip_test=args.skip_test,
        white_background=white_bg, resolution=args.resolution,
        settings=api.RasterizeSettings(renderer="pallas", dup_capacity=1 << 21,
                                      fast_chain=args.fast),
        batch=args.batch, autoplan=args.autoplan, device=args.device,
    )


if __name__ == "__main__":
    main()
