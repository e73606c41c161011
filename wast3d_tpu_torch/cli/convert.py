"""CLI: COLMAP preprocessing pipeline (feature extract/match/map/undistort).

`python -m wast3d_tpu_torch.cli.convert -s <scene> [--resize] [...]`

The port's own copy of `wast3d_tpu.cli.convert`, with its flags, command
lines and exits: it drives the external `colmap` (and optionally
ImageMagick `magick`) binaries to turn a raw `input/` image folder into
the sparse/undistorted layout the loaders expect (`sparse/0/*`, with the
half/quarter/eighth resized image sets under `--resize`). It uses no
device. If the colmap binary is absent the command explains instead of
failing mid-way."""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
from typing import Optional, Sequence


def _run(cmd: list) -> None:
    print("+", " ".join(cmd))
    res = subprocess.run(cmd)
    if res.returncode != 0:
        sys.exit(f"command failed ({res.returncode}): {' '.join(cmd)}")


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description="COLMAP conversion")
    parser.add_argument("--source_path", "-s", required=True, type=str)
    parser.add_argument("--no_gpu", action="store_true")
    parser.add_argument("--skip_matching", action="store_true")
    parser.add_argument("--camera", default="OPENCV", type=str)
    parser.add_argument("--colmap_executable", default="", type=str)
    parser.add_argument("--resize", action="store_true")
    parser.add_argument("--magick_executable", default="", type=str)
    args = parser.parse_args(argv)

    colmap = args.colmap_executable or shutil.which("colmap")
    if not colmap:
        sys.exit(
            "colmap binary not found. Install COLMAP or pass "
            "--colmap_executable. (This step runs on the host; the "
            "training pipeline consumes its sparse/ output.)"
        )
    use_gpu = "0" if args.no_gpu else "1"
    src = args.source_path

    if not args.skip_matching:
        os.makedirs(os.path.join(src, "distorted", "sparse"), exist_ok=True)
        _run([colmap, "feature_extractor",
              "--database_path", f"{src}/distorted/database.db",
              "--image_path", f"{src}/input",
              "--ImageReader.single_camera", "1",
              "--ImageReader.camera_model", args.camera,
              "--SiftExtraction.use_gpu", use_gpu])
        _run([colmap, "exhaustive_matcher",
              "--database_path", f"{src}/distorted/database.db",
              "--SiftMatching.use_gpu", use_gpu])
        _run([colmap, "mapper",
              "--database_path", f"{src}/distorted/database.db",
              "--image_path", f"{src}/input",
              "--output_path", f"{src}/distorted/sparse",
              "--Mapper.ba_global_function_tolerance=0.000001"])

    _run([colmap, "image_undistorter",
          "--image_path", f"{src}/input",
          "--input_path", f"{src}/distorted/sparse/0",
          "--output_path", src,
          "--output_type", "COLMAP"])

    # Move sparse/* -> sparse/0/* (reference convert.py file shuffle).
    sparse = os.path.join(src, "sparse")
    os.makedirs(os.path.join(sparse, "0"), exist_ok=True)
    for f in os.listdir(sparse):
        if f == "0":
            continue
        shutil.move(os.path.join(sparse, f), os.path.join(sparse, "0", f))

    if args.resize:
        magick = args.magick_executable or shutil.which("magick") or shutil.which("convert")
        if not magick:
            sys.exit("ImageMagick not found for --resize")
        for name, pct in (("images_2", "50%"), ("images_4", "25%"), ("images_8", "12.5%")):
            out = os.path.join(src, name)
            os.makedirs(out, exist_ok=True)
            for f in os.listdir(os.path.join(src, "images")):
                sp = os.path.join(src, "images", f)
                dp = os.path.join(out, f)
                shutil.copy2(sp, dp)
                _run([magick, "mogrify", "-resize", pct, dp])
    print("Done.")


if __name__ == "__main__":
    main()
