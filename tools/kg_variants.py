#!/usr/bin/env python3
"""Kg's kernel and other forms of it, timed on one CUDA card.

    python3 tools/kg_variants.py [--out <file.json>]

"port" is the port's own kernel (`wast3d_tpu_torch/csrc/pack_gather.cu`,
`w3d_pack_gather` in the port's library). Every other variant is
`tools/kg_variants.cu` built with the port's `nvcc` flags and the macros in
`VARIANTS` into a library of its own (one `nvcc` a variant, all started
together), and launched through that library's `kgv_pack_gather` (the
cooperative design, as the port's) or `kgv_pack_gather_recompute` (the
design without packed rows). All run on `chip_smoke.py`'s inputs for Kg:
the 200k shell at 800² (K = 673,197). Each must give the plain version's
rows bit for bit. For each: CUDA-event ms a call over 50 calls and
`torch.profiler` busy ms a call, in turns (the list forward, then
backward, twice), so that a drift of the card's clocks shows. `host_us`
splits the host's time to issue one call of the port's wrapper
(`pack_gather`) into its parts, each timed alone over 200 calls. The last
line printed is the JSON also written to `--out`.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

SOURCE = ROOT / "tools" / "kg_variants.cu"
# name -> (design, the macros of tools/kg_variants.cu); "port" is the port's
# library. The tool's "cooperative" is the port's kernel in the tool's copy.
VARIANTS = {
    "port": ("port", {}),
    "cooperative": ("cooperative", {}),
    "recompute": ("recompute", {}),
    # One thread writes a whole 32-byte row (lanes 32 bytes apart).
    "cooperative_whole_rows": ("cooperative", {"KGV_HALF_ROWS": 0}),
    "recompute_whole_rows": ("recompute", {"KGV_HALF_ROWS": 0}),
    "cooperative_no_l2_hints": ("cooperative", {"KGV_L2_HINTS": 0}),
    # The cooperative design's first form: rows packed in depth order (the
    # fields gathered at random in phase 1), read at packed[rank].
    "cooperative_depth_order_pack": ("cooperative", {"KGV_DEPTH_ORDER_PACK": 1}),
    # Duplicates in flight a thread in phase 2.
    "cooperative_two_chains": ("cooperative", {"KGV_CHAINS": 2}),
    "cooperative_four_chains": ("cooperative", {"KGV_CHAINS": 4}),
}


def build(tmp: Path, names=None) -> dict:
    """name -> loaded library of that variant, for `names` (every variant
    by default; "port" is the port's own library)."""
    import ctypes

    from wast3d_tpu_torch import _build

    names = list(VARIANTS if names is None else names)
    coop_args = _build.SIGNATURES["w3d_pack_gather"]
    # The recompute entry takes the cooperative one's arguments without the
    # scratch pointer.
    recompute_args = (coop_args[0][:8] + coop_args[0][9:], coop_args[1])

    def one(name):
        if VARIANTS[name][0] == "port":
            return _build.load_library()
        lib = tmp / f"lib_kg_{name}.so"
        macros = [f"-D{k}={v}" for k, v in VARIANTS[name][1].items()]
        _build._compile([_build.nvcc_path(), *_build.NVCC_FLAGS, *macros, "-shared", "-o",
                         str(lib), str(SOURCE)])
        loaded = ctypes.CDLL(str(lib))
        for fn, sig in (("kgv_pack_gather", coop_args),
                        ("kgv_pack_gather_recompute", recompute_args)):
            getattr(loaded, fn).argtypes, getattr(loaded, fn).restype = sig
        return loaded

    with ThreadPoolExecutor(len(names)) as pool:
        return dict(zip(names, pool.map(one, names)))


def launcher(lib, design, args):
    """A call of `lib`'s design on Kg's inputs `args`, as the port's wrapper
    makes it (rows and scratch from torch's caching allocator)."""
    import torch

    from wast3d_tpu_torch.ops.rasterizer.pack_gather import PACKED_ROW_BYTES

    ts, width = args[:8], args[8]
    n, k = ts[0].shape[0], ts[6].shape[0]
    dev = ts[0].device
    ptrs = [t.contiguous().data_ptr() for t in ts]
    grid_x = (width + 15) // 16

    def call():
        rows = torch.empty((k, 16), dtype=torch.bfloat16, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        if design == "recompute":
            err = lib.kgv_pack_gather_recompute(*ptrs, rows.data_ptr(), n, k, grid_x,
                                                dev.index, stream)
        else:
            fn = lib.w3d_pack_gather if design == "port" else lib.kgv_pack_gather
            packed = torch.empty(((n + 1) * PACKED_ROW_BYTES,), dtype=torch.uint8, device=dev)
            err = fn(*ptrs, packed.data_ptr(), rows.data_ptr(), n, k, grid_x, dev.index, stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return rows

    return call


def host_split_us(args, reps=200):
    """Microseconds a call: the wrapper's check, its pointer list, its one
    allocation (output and scratch rows; and two allocations in its place),
    the current stream, the ctypes launch alone, and the whole wrapper."""
    import time

    import torch

    from wast3d_tpu_torch import _build
    from wast3d_tpu_torch.ops.rasterizer import pack_gather as pg

    ts, width = args[:8], args[8]
    n, k = ts[0].shape[0], ts[6].shape[0]
    dev = ts[0].device
    lib = _build.load_library()
    rows = torch.empty((k, 16), dtype=torch.bfloat16, device=dev)
    packed = torch.empty(((n + 1) * pg.PACKED_ROW_BYTES,), dtype=torch.uint8, device=dev)
    ptrs = [t.data_ptr() for t in ts]
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    grid_x = (width + 15) // 16
    parts = {
        "check": lambda: pg._well_formed(ts),
        "pointers": lambda: [t.data_ptr() for t in
                             [t if t.is_contiguous() else t.contiguous() for t in ts]],
        "allocation": lambda: torch.empty((k + n + 1, 16), dtype=torch.bfloat16,
                                          device=dev)[:k],
        "two_allocations": lambda: (
            torch.empty((k, 16), dtype=torch.bfloat16, device=dev),
            torch.empty(((n + 1) * pg.PACKED_ROW_BYTES,), dtype=torch.uint8, device=dev)),
        "stream": lambda: torch._C._cuda_getCurrentRawStream(dev.index),
        "launch": lambda: lib.w3d_pack_gather(*ptrs, packed.data_ptr(), rows.data_ptr(), n, k,
                                              grid_x, dev.index, stream),
        "wrapper": lambda: pg.pack_gather(*args),
    }
    out = {}
    for name, fn in parts.items():
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        out[name] = (time.perf_counter() - t) / reps * 1e6
        torch.cuda.synchronize()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--turns", type=int, default=2)
    a = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from wast3d_tpu_torch.ops.rasterizer.pack_gather import pack_gather_reference

    if not torch.cuda.is_available():
        print("kg_variants: needs a CUDA card", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    args, _, _ = cs.kg_args(cs.make_scene(cs.bench_scene(cs.FULL_N), device),
                            cs.view_camera(cs.FULL_RES, cs.FULL_RES, device, eye=(0, 0, -3),
                                           fov=0.9))
    want = pack_gather_reference(*args).view(torch.int16)
    with tempfile.TemporaryDirectory(prefix="w3d_kg_variants_") as tmp:
        libs = build(Path(tmp))
        calls = {name: launcher(libs[name], VARIANTS[name][0], args) for name in VARIANTS}
        out = {name: {"bit_equal": torch.equal(fn().view(torch.int16), want)
                      and torch.equal(fn().view(torch.int16), want), "ms": [], "device_ms": []}
               for name, fn in calls.items()}
        order = list(VARIANTS)
        for turn in range(a.turns):
            for name in order + order[::-1]:
                out[name]["ms"].append(cs.cuda_time_ms(calls[name], 50))
                out[name]["device_ms"].append(cs.device_ms(calls[name])[1])
    for v in out.values():
        v["ms_median"] = statistics.median(v["ms"])
        v["device_ms_median"] = statistics.median(v["device_ms"])
    n, k = int(args[0].shape[0]), int(args[6].shape[0])
    host = [host_split_us(args) for _ in range(3)]
    result = {"device": cs.nvidia_smi_line(), "n_gaussians": n, "duplicates_K": k,
              "host_us": {part: [h[part] for h in host] for part in host[0]},
              "bound_ms": (sum(t.numel() * t.element_size() for t in args[:8])
                           + k * 32) / cs.HBM_BYTES_PER_S * 1e3,
              "variants": out}
    text = json.dumps(result)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        Path(a.out).write_text(text + "\n")
    print(text)
    bad = [name for name, v in out.items() if not v["bit_equal"]]
    if bad:
        print(f"kg_variants: not bit-equal to the plain version: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
