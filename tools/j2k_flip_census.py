#!/usr/bin/env python3
"""Hold the port's JPEG 2000 reader to PIL's (OpenJPEG 2.5.4) on damaged
files.

    python3 tools/j2k_flip_census.py [--seed S] [--flips N]

Needs PIL, so it runs where the tests run, not on the card. For each of
its probes (small JP2 and J2K files of the committed fixtures' kinds:
lossless and 9/7 with quality layers, tiles, precincts, SOP / EPH, the
lazy / reset / termination / causal / segmentation code-block styles) it
flips one bit at N seeded places, decodes each damaged file with
`np.asarray(PIL.Image.open(f))` and with `utils/image_io.decode_image`,
and counts: equal arrays, both refuse, arrays that differ, only PIL
decodes, only the port decodes. Prints one JSON object, with the first
few disagreements (probe, byte, bit); exits 1 when the last three counts
are not all 0.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def probes():
    """(name, bytes) of the census's files."""
    from PIL import Image

    from tools import image_writers as iw

    y, x = np.mgrid[0:40, 0:56]
    rgb = np.stack([128 + 100 * np.sin(x / 7), 128 + 90 * np.cos(y / 5),
                    128 + 60 * np.sin((x + y) / 9)], -1).astype(np.uint8)

    def pil(**kw):
        buf = io.BytesIO()
        Image.fromarray(rgb).save(buf, "JPEG2000", **kw)
        return buf.getvalue()

    planes = [rgb[..., c].astype(np.int32) for c in range(3)]
    return [("lossless", pil()),
            ("irreversible_layers", pil(irreversible=True, quality_mode="rates",
                                        quality_layers=[40, 10, 2])),
            ("tiled_rpcl", pil(no_jp2=True, tile_size=(32, 32), progression="RPCL",
                               precinct_size=(32, 32))),
            ("sop_eph", iw.j2k_bytes(planes, sop=True, eph=True, rates=(30, 0))),
            ("styles", iw.j2k_bytes(planes, style=1 | 2 | 4 | 8 | 32, rates=(20, 0))),
            ("pterm_irr", iw.j2k_bytes(planes, style=16, irreversible=True))]


def main(argv=None) -> int:
    from PIL import Image

    from wast3d_tpu_torch.utils import image_io

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--flips", type=int, default=300, help="damaged files per probe")
    args = ap.parse_args(argv)
    rng = np.random.default_rng(args.seed)
    counts = dict.fromkeys(("same", "both_refuse", "differ", "only_pil", "only_port"), 0)
    apart = []
    for name, blob in probes():
        for _ in range(args.flips):
            at, bit = int(rng.integers(0, len(blob))), int(rng.integers(0, 8))
            damaged = bytearray(blob)
            damaged[at] ^= 1 << bit
            damaged = bytes(damaged)
            try:
                ref = np.asarray(Image.open(io.BytesIO(damaged)))
            except Exception:
                ref = None
            try:
                got = image_io.decode_image(damaged, name)
            except ValueError:
                got = None
            key = ("both_refuse" if ref is None and got is None else "only_port" if ref is None
                   else "only_pil" if got is None
                   else "same" if ref.dtype == got.dtype and ref.shape == got.shape
                   and ref.tobytes() == got.tobytes() else "differ")
            counts[key] += 1
            if key in ("differ", "only_pil", "only_port") and len(apart) < 20:
                apart.append([name, key, at, bit])
    print(json.dumps({"seed": args.seed, "files": sum(counts.values()), **counts,
                      "apart": apart}))
    return int(counts["differ"] + counts["only_pil"] + counts["only_port"] > 0)


if __name__ == "__main__":
    sys.exit(main())
