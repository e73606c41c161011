#!/usr/bin/env python3
"""Hold the port's readers of old-style JPEG TIFF and of PIL's plugin formats
(BLP ... XVThumb, `utils/image_plugins.py`) to PIL on damaged files.

    python3 tools/plugin_flip_census.py [--per-file N] [--only PREFIX]

Needs PIL, so it runs where the tests run, not on the card. For each
committed file of these formats under `tests/format_fixtures/` it makes N
damaged copies with the seeds of `tests/test_torch_image_plugins.py`'s
census (seed: the sum of the file name's bytes; copy k: a truncation when
k % 3 == 2, else one or two byte flips), decodes each with
`np.asarray(PIL.Image.open(...))` and with `utils/image_io.decode_image`,
and counts: equal arrays, both refuse, arrays that differ, only PIL
decodes, only the port decodes. The test runs N = 90. Prints one JSON
object, with the first few disagreements (file, copy); exits 1 when the
last three counts are not all 0.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import sys
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
SUFFIXES = (".blp", ".dib", ".dcx", ".fits", ".fli", ".flc", ".ftc", ".ftu", ".gbr", ".im",
            ".imt", ".iim", ".mcidas", ".msp", ".pxr", ".spider", ".xbm", ".xpm", ".xvthumb")


def census_files():
    formats = ROOT / "tests" / "format_fixtures"
    return sorted([p for p in formats.iterdir() if p.suffix in SUFFIXES]
                  + list(formats.glob("ojpeg_*.tif")))


def damaged(path: Path, per_file: int):
    """The census's damaged copies of `path`, in order."""
    base = path.read_bytes()
    rng = np.random.default_rng(sum(path.name.encode()))
    for k in range(per_file):
        blob = bytearray(base)
        if k % 3 == 2:
            blob = blob[:int(rng.integers(1, len(blob)))]
        else:
            for _ in range(1 + k % 2):
                blob[int(rng.integers(0, len(blob)))] = int(rng.integers(0, 256))
        yield bytes(blob)


def main(argv=None) -> int:
    from PIL import Image

    from wast3d_tpu_torch.utils import image_io

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--per-file", type=int, default=90, help="damaged copies of each file")
    ap.add_argument("--only", default="", help="only the files whose name starts so")
    args = ap.parse_args(argv)
    counts = dict.fromkeys(("same", "both_refuse", "differ", "only_pil", "only_port"), 0)
    apart = []
    for path in census_files():
        if not path.name.startswith(args.only):
            continue
        for k, blob in enumerate(damaged(path, args.per_file)):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                try:
                    ref = np.asarray(Image.open(io.BytesIO(blob)))
                except Exception:
                    ref = None
            try:
                got = image_io.decode_image(blob, path.name)
            except ValueError:
                got = None
            key = ("both_refuse" if ref is None and got is None else "only_port" if ref is None
                   else "only_pil" if got is None
                   else "same" if ref.dtype == got.dtype and ref.shape == got.shape
                   and ref.tobytes() == got.tobytes() else "differ")
            counts[key] += 1
            if key in ("differ", "only_pil", "only_port") and len(apart) < 20:
                apart.append([path.name, k, key])
    print(json.dumps({"per_file": args.per_file, "files": sum(counts.values()), **counts,
                      "apart": apart}))
    return int(counts["differ"] + counts["only_pil"] + counts["only_port"] > 0)


if __name__ == "__main__":
    sys.exit(main())
