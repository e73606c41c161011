"""Exhaustive single-bit census of damaged JPEGs: the port's reader against PIL.

Every bit of each probe file is flipped, one at a time, and the file is read
by PIL (`np.asarray(PIL.Image.open(f))`) and by the port
(`wast3d_tpu_torch.utils.image_io.decode_image`). Each flip is counted by the
segment its bit lies in (SOI, APPn, DQT, SOF, DHT, DRI, SOS, the
entropy-coded data, RSTn, EOI) and by outcome:

- `equal`: both decode, to the same dtype, shape and bytes;
- `both raise`;
- `port != PIL`: both decode, to different arrays;
- `PIL raises, port decodes`;
- `port raises, PIL decodes`.

The port's contract is to raise a `ValueError` naming the file or to return
PIL's array, so the third and fourth columns are breaches; the fifth is one
only where the flip lies in entropy-coded data.

    python tools/jpeg_flip_census.py [--workers N] [--json OUT] [files...]

With no files it reads the six committed probe files in
`tests/format_fixtures/` (a 4:2:0 baseline, a 4:4:4 baseline with a
restart interval, a progressive 4:2:0; an arithmetic-coded 4:2:0 with a
restart interval and DAC, an arithmetic-coded progressive 4:2:0, a
lossless RGB file with a restart interval). It prints one table a file and
exits 1 if a breach was found. It needs PIL, so it runs in a development
environment, not on the card's machine; nothing in the port imports it.
"""

from __future__ import annotations

import argparse
import io
import json
import multiprocessing
import os
import sys
import warnings
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, List, Tuple

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBES = ("jpeg_probe_420.jpg", "jpeg_probe_444_restart.jpg", "jpeg_probe_420_progressive.jpg",
          "jpeg_probe_arith_restart.jpg", "jpeg_probe_arith_progressive.jpg",
          "jpeg_probe_lossless_restart.jpg")
OUTCOMES = ("equal", "both raise", "port != PIL", "PIL raises, port decodes",
            "port raises, PIL decodes")
ROWS = ("entropy-coded data", "RSTn", "DHT", "DAC", "DQT", "SOF", "SOS", "DRI", "APPn", "SOI",
        "EOI")
NAME = "census.jpg"


def segments(blob: bytes) -> List[str]:
    """The segment each byte of a well-formed JPEG belongs to (ROWS)."""
    where = ["SOI"] * len(blob)
    pos = 2
    while pos + 1 < len(blob):
        m = blob[pos + 1]
        if m == 0xD9:
            where[pos:pos + 2] = ["EOI"] * 2
            break
        length = (blob[pos + 2] << 8) | blob[pos + 3]
        kind = {0xC4: "DHT", 0xCC: "DAC", 0xDB: "DQT", 0xDD: "DRI", 0xDA: "SOS"}.get(m)
        kind = kind or ("SOF" if 0xC0 <= m <= 0xCF else "APPn")
        end = pos + 2 + length
        where[pos:end] = [kind] * (end - pos)
        pos = end
        if m == 0xDA:  # entropy-coded data up to the next marker other than RSTn
            while pos + 1 < len(blob):
                if blob[pos] == 0xFF and blob[pos + 1] not in (0x00, 0xFF):
                    if 0xD0 <= blob[pos + 1] <= 0xD7:
                        where[pos:pos + 2] = ["RSTn"] * 2
                        pos += 2
                        continue
                    break
                where[pos] = "entropy-coded data"
                pos += 1
    return where


def _pil(blob: bytes):
    from PIL import Image

    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return np.asarray(Image.open(io.BytesIO(blob)))
    except Exception:
        return None


def _port(blob: bytes):
    from wast3d_tpu_torch.utils import image_io

    try:
        return image_io.decode_image(blob, NAME)
    except ValueError as e:
        if not str(e).startswith(NAME + ": "):
            return f"unnamed: {e}"
        return None


def _classify(blob: bytes) -> int:
    want, got = _pil(blob), _port(blob)
    if isinstance(got, str):
        raise AssertionError(got)
    if want is None:
        return 1 if got is None else 3
    if got is None:
        return 4
    same = want.dtype == got.dtype and want.shape == got.shape and want.tobytes() == got.tobytes()
    return 0 if same else 2


def _flips(args: Tuple[bytes, int, int]) -> List[int]:
    blob, lo, hi = args
    out = []
    for bit in range(lo, hi):
        f = bytearray(blob)
        f[bit // 8] ^= 0x80 >> (bit % 8)
        out.append(_classify(bytes(f)))
    return out


def census(blob: bytes, workers: int) -> Tuple[Dict[str, List[int]], Dict[str, List[int]]]:
    """{row: counts of each outcome}, {outcome name: the flipped bits that
    breach the contract}."""
    n = len(blob) * 8
    step = -(-n // (workers * 8))
    jobs = [(blob, lo, min(lo + step, n)) for lo in range(0, n, step)]
    if workers > 1:
        with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as ex:
            results = [r for part in ex.map(_flips, jobs) for r in part]
    else:
        results = [r for job in jobs for r in _flips(job)]
    where = segments(blob)
    table = {row: [0] * len(OUTCOMES) for row in ROWS}
    breaches = {OUTCOMES[k]: [] for k in (2, 3, 4)}
    for bit, r in enumerate(results):
        row = where[bit // 8]
        table[row][r] += 1
        if r in (2, 3) or (r == 4 and row == "entropy-coded data"):
            breaches[OUTCOMES[r]].append(bit)
    return table, breaches


def render(name: str, blob: bytes, table: Dict[str, List[int]]) -> str:
    where = segments(blob)
    lines = [f"{name} ({len(blob)} bytes, {len(blob) * 8} flips)",
             "| where the flipped bit lies | " + " | ".join(OUTCOMES) + " |",
             "|---" * (len(OUTCOMES) + 1) + "|"]
    total = [0] * len(OUTCOMES)
    for row in ROWS:
        counts = table[row]
        if not any(counts):
            continue
        total = [a + b for a, b in zip(total, counts)]
        lines.append(f"| {row} ({where.count(row)} B) | " + " | ".join(map(str, counts)) + " |")
    lines.append("| **total** | " + " | ".join(map(str, total)) + " |")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("files", nargs="*")
    ap.add_argument("--workers", type=int, default=min(4, os.cpu_count() or 1))
    ap.add_argument("--json", help="write each file's table and breaching bits here")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    files = args.files or [os.path.join(ROOT, "tests", "format_fixtures", p) for p in PROBES]
    report, bad = {}, False
    for path in files:
        with open(path, "rb") as f:
            blob = f.read()
        table, breaches = census(blob, args.workers)
        print(render(os.path.basename(path), blob, table), flush=True)
        print(flush=True)
        report[os.path.basename(path)] = {"table": table, "breaches": breaches}
        bad |= any(breaches.values())
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
