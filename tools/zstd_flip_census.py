#!/usr/bin/env python3
"""Hold the port's Zstandard decoder to libzstd on damaged frames.

    python3 tools/zstd_flip_census.py [--seed S] [--flips N]

Needs the `zstandard` package (libzstd 1.5.7, the library PIL's libtiff
links here), so it runs where the tests run, not on the card. For each of
five seeded inputs (a random walk, text of a small vocabulary, a skewed
byte distribution, a Dirichlet-weighted alphabet and a noisy image) at
five compression levels it flips one or two random bits of the frame N
times, decodes each damaged frame with `zstandard`'s streaming decoder
and with `native.zstd_decode` (the port's, as libtiff fills a strip of the
input's size), and counts: both decode to the same bytes, both refuse,
their bytes differ, only libzstd decodes, only the port decodes. Prints
one JSON object; exits 1 when the last three are not all 0.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def inputs(rng):
    """(name, bytes) of the census's seeded inputs."""
    words = [bytes(rng.integers(97, 123, rng.integers(2, 9), dtype=np.uint8)) for _ in range(200)]
    skew = np.r_[np.full(16, 0.06), np.full(240, 0.04 / 240)]
    image = (rng.integers(0, 3, (300, 400, 3)) * 50 + np.arange(400)[None, :, None] // 4)
    return [("walk", (np.cumsum(rng.integers(-3, 4, 200000)) % 256).astype(np.uint8).tobytes()),
            ("text", b" ".join(words[i] for i in rng.integers(0, 200, 30000))),
            ("skewed", bytes(rng.choice(np.arange(256, dtype=np.uint8), 150000, p=skew))),
            ("dirichlet", bytes(rng.choice(np.arange(256, dtype=np.uint8), 100000,
                                           p=rng.dirichlet(np.full(256, 0.05))))),
            ("image", image.astype(np.uint8).tobytes())]


def main(argv=None) -> int:
    import zstandard

    from wast3d_tpu_torch import native

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--flips", type=int, default=150, help="damaged frames per input and level")
    args = ap.parse_args(argv)
    rng = np.random.default_rng(args.seed)
    counts = dict.fromkeys(("same", "both_refuse", "differ", "only_libzstd", "only_port"), 0)
    for _, data in inputs(rng):
        for level in (1, 3, 9, 19, -3):
            frame = zstandard.ZstdCompressor(level=level).compress(data)
            for _ in range(args.flips):
                blob = bytearray(frame)
                for _ in range(int(rng.integers(1, 3))):
                    blob[int(rng.integers(0, len(blob)))] ^= 1 << int(rng.integers(0, 8))
                blob = bytes(blob)
                try:
                    ref = zstandard.ZstdDecompressor().decompressobj().decompress(blob)
                    ref = ref[:len(data)] if len(ref) >= len(data) else None
                except zstandard.ZstdError:
                    ref = None
                try:
                    got = native.zstd_decode(blob, len(data)).tobytes()
                    got = got if len(got) == len(data) else None
                except ValueError:
                    got = None
                key = ("both_refuse" if ref is None and got is None else "only_port" if ref is None
                       else "only_libzstd" if got is None else "same" if ref == got else "differ")
                counts[key] += 1
    print(json.dumps({"seed": args.seed, "frames": sum(counts.values()), **counts}))
    return int(counts["differ"] + counts["only_libzstd"] + counts["only_port"] > 0)


if __name__ == "__main__":
    sys.exit(main())
