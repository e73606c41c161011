"""CLI: interactive web viewer for a trained model.

`python -m wast3d_tpu_torch.cli.view -m <model_path> [--iteration N]
[--port P] [--device cuda|cpu]`

The flags of `wast3d_tpu.cli.view`, plus `--device`. Any browser is the
client (drag = orbit, wheel = zoom; `viewer/web.py`). Frames render on the
card: in the bf16 tier (K1f) by default, with `--no-fast` in the f32 tier
(K1); `--renderer tiled` takes the plain versions. `--dup-capacity` is
accepted and read by nothing: the port's binning has no static
capacities.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="wast3d_tpu_torch web viewer")
    ap.add_argument("--model_path", "-m", required=True)
    ap.add_argument("--iteration", type=int, default=-1)
    ap.add_argument("--port", type=int, default=8090)
    ap.add_argument("--renderer", default="pallas", choices=["pallas", "tiled"])
    ap.add_argument("--fast", action=argparse.BooleanOptionalAction, default=True,
                    help="bf16 serving tier of the blend (K1f, default on as in the "
                         "JAX package; --no-fast for the exact f32 kernel K1)")
    ap.add_argument("--dup-capacity", type=int, default=1 << 21,
                    help="accepted; the port's binning has no capacities")
    ap.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = build_parser().parse_args(argv)

    from wast3d_tpu_torch.device import resolve_device
    from wast3d_tpu_torch.ops.rasterizer import api
    from wast3d_tpu_torch.scene.ply import load_ply
    from wast3d_tpu_torch.train.checkpoint import find_max_iteration
    from wast3d_tpu_torch.viewer.web import serve_scene

    device = resolve_device(args.device)
    it = args.iteration
    if it == -1:
        it = find_max_iteration(args.model_path)
        if it is None:
            raise SystemExit(f"no point_cloud/iteration_* under {args.model_path}")
    ply = os.path.join(args.model_path, "point_cloud", f"iteration_{it}", "point_cloud.ply")
    scene = load_ply(ply, device=device)
    settings = api.RasterizeSettings(renderer=args.renderer, dup_capacity=args.dup_capacity,
                                     fast_chain=args.fast)
    print(f"loaded {ply}", flush=True)
    serve_scene(scene, port=args.port, settings=settings, device=device)


if __name__ == "__main__":
    main()
