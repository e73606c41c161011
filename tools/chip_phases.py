"""Run named phases of the `chip_smoke.py` in the current directory, on one
CUDA card, so that an older checkout (whose `--only` lacks them) and the
current one can be compared in one chip call:

    cd <checkout> && python3 <repo>/tools/chip_phases.py full_width,train_entry_point
    cd <checkout> && python3 <repo>/tools/chip_phases.py train_full_width --device-times
    cd <checkout> && python3 <repo>/tools/chip_phases.py k1_bits --save-k1 <file.pt>

Phases: k1_bits, k2_bits, k2_cases, k3_cases, full_width, train_full_width,
train_entry_point, k4k5_full_width, stylize_entry_point (after building the
content domain), the bf16 tier's k1_fast_cases, k2_fast_cases,
full_width_fast and train_full_width_fast, quad_times, quad_sections and
sass. Each phase
prints its JSON line as in `chip_smoke.py`;
`k1_bits` and `k2_bits` (below) print SHA-256 hashes of K1's and K1f's
inputs and outputs and of K2's and K2f's outputs, and
`--save-k1 <file.pt>` also saves K1's 200k / 800x800 outputs there, so that
two checkouts' K1 can be compared bit for bit and by their largest
difference. `quad_times` times K1q beside K1 and K1fq beside K1f at 200k /
800x800, 1M and 4M (1296 x 832; K1f and K1fq on Kg's rows there), by
events and by device; `quad_sections` splits the same four kernels' warp
time at 200k into sections (a library built with the section timers of
`csrc/blend_fwd.cu`); `sass` dumps the built library's machine code
(`cuobjdump -sass`), counts each kernel's HMMA (tensor-core) instructions
and reports the four kernels' registers, shared memory and blocks an SM.
For parent against change, run them from each checkout in turns (parent,
change, change, parent) in one run on the card:

    for d in <parent> <change> <change> <parent>; do
        (cd $d && python3 <change>/tools/chip_phases.py k1_bits,k2_bits,quad_times)
    done `--device-times` also times, by `torch.profiler`, every call
that the phases time by CUDA events over 20 or more repetitions
(`cuda_time_ms` over the whole run, `cuda_times_ms` launch by launch), and
prints its device busy time beside the event time, numbered in call order.
"""

import functools
import hashlib
import json
import os
import statistics
import sys
import time

import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402  (the checkout's own, from the current directory)
from wast3d_tpu_torch import _build  # noqa: E402


def busy_ms(fn, reps=20):
    """Device busy time of one call of `fn`, by `torch.profiler`."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, cur = 0.0, None
    for a, b in spans:
        if cur is None or a > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    if cur is not None:
        busy += cur[1] - cur[0]
    return busy / reps / 1e3


def with_device_times(event_ms, event_times_ms):
    """`cuda_time_ms` and `cuda_times_ms` that also print the device busy
    time of every call timed over 20 or more repetitions."""
    calls = []

    def record(fn, ms, reps):
        if reps >= 20:
            calls.append({"call": len(calls), "event_ms": ms, "reps": reps,
                          "device_busy_ms": busy_ms(fn)})
            print(json.dumps({"device_time": calls[-1]}), flush=True)

    def total(fn, reps):
        ms = event_ms(fn, reps)
        record(fn, ms, reps)
        return ms

    def per_launch(fn, warmup, reps):
        times = event_times_ms(fn, warmup, reps)
        record(fn, statistics.median(times), reps)
        return times

    return total, per_launch


def sha256_of(tensors):
    """As `chip_smoke.sha256_of` (which an older checkout lacks), bf16
    tensors by their bits."""
    h = hashlib.sha256()
    for t in tensors:
        t = t.detach()
        if t.dtype == torch.bfloat16:  # numpy has no bfloat16: hash its bits
            t = t.view(torch.int16)
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def phase_k1_bits(device, save=None):
    """K1 (`blend_fwd`) once on the checkout's own `k1_cases` and on the
    200k / 800x800 frame's inputs, as `full_width` builds them, then K1f
    (`blend_fwd_fast`) on the bf16 tier's rows of the same cases (keys
    ending in `_bf16`); prints the hashes of each case's inputs and the
    kernel's three outputs. Uses only what every checkout's `chip_smoke.py`
    has since the bf16 tier was ported."""
    from wast3d_tpu_torch.ops.rasterizer.blend import blend_fwd, blend_fwd_fast

    t0 = time.perf_counter()
    scene = cs.make_scene(cs.bench_scene(cs.FULL_N), device)
    cam = cs.view_camera(cs.FULL_RES, cs.FULL_RES, device, eye=(0, 0, -3), fov=0.9)
    out = {}
    for fast, fwd in ((False, blend_fwd), (True, blend_fwd_fast)):
        bg, cases = cs.k1_cases(device, fast)
        cases["full_width"] = cs.kernel_inputs(scene, cam, fast=fast)
        for name, (rows, starts, ends, w, h, offsets) in cases.items():
            case_bg = torch.zeros(3, device=device) if name == "full_width" else bg
            k = fwd(rows, starts, ends, w, h, case_bg, offsets)
            torch.cuda.synchronize()
            inputs = [rows, starts, ends] + ([] if offsets is None else [offsets])
            out[f"{name}_bf16" if fast else name] = {
                "K": int(rows.shape[0]), "rows_sha256": sha256_of(inputs),
                "output_sha256": sha256_of(k)}
            if name == "full_width" and save and not fast:
                torch.save({f: t.cpu() for f, t in zip(("color", "depth", "final_T"), k)},
                           save)
    print(json.dumps({"phase": "k1_bits", "cases": out,
                      "seconds": time.perf_counter() - t0}), flush=True)


def phase_k2_bits(device):
    """K2 (`blend_bwd`) once on the checkout's own `k1_cases` (K1's output
    as the forward, `k2_cotangents` as the cotangents, background 0 and 1)
    and at the 200k / 800x800 frame's inputs, then K2f (`blend_bwd_fast`,
    on K1f's output) on the bf16 tier's rows of the same cases (keys ending
    in `_bf16`); prints the hashes of each case's output. Uses only what
    every checkout's `chip_smoke.py` has since the bf16 tier was ported."""
    from wast3d_tpu_torch.ops.rasterizer import blend

    t0 = time.perf_counter()
    scene = cs.make_scene(cs.bench_scene(cs.FULL_N), device)
    cam = cs.view_camera(cs.FULL_RES, cs.FULL_RES, device, eye=(0, 0, -3), fov=0.9)
    out = {}
    for fast in (False, True):
        fwd, bwd = ((blend.blend_fwd_fast, blend.blend_bwd_fast) if fast
                    else (blend.blend_fwd, blend.blend_bwd))
        _, cases = cs.k1_cases(device, fast)
        cases["full_width"] = cs.kernel_inputs(scene, cam, fast=fast)
        for bg_value in (0.0, 1.0):
            bg = torch.full((3,), bg_value, device=device)
            for i, (name, (rows, starts, ends, w, h, offsets)) in enumerate(cases.items()):
                k1 = fwd(rows, starts, ends, w, h, bg, offsets)
                grads = cs.k2_cotangents(h, w, device, seed=i)
                d = bwd(rows, starts, ends, w, h, bg, offsets, k1, grads)
                torch.cuda.synchronize()
                key = f"{name}_bg{int(bg_value)}" + ("_bf16" if fast else "")
                out[key] = {"K": int(rows.shape[0]), "output_sha256": sha256_of([d])}
    print(json.dumps({"phase": "k2_bits", "cases": out,
                      "seconds": time.perf_counter() - t0}), flush=True)


QUAD_SIZES = (("200k", 200_000, (800, 800)), ("1m", 1_000_000, (1296, 832)),
              ("4m", 4_000_000, (1296, 832)))


def phase_quad_times(device, reps=50):
    """K1q beside K1 and K1fq beside K1f on one frame's inputs at each of
    QUAD_SIZES (`bench_scene`, eye (0, 0, -3), fov 0.9, jitter off): the
    200k / 800x800 frame of `quad_routes` and the ladder's 1M and 4M
    frames at 1296 x 832, K1f and K1fq on Kg's rows there as the serving
    tier takes them. Each kernel's CUDA-event ms over `reps` calls and its
    device ms by `torch.profiler`, and each quad kernel's ratio to its
    direct twin. Uses only what every checkout's package has since the quad
    route was ported."""
    from wast3d_tpu_torch.ops.rasterizer import api, blend, render_path
    from wast3d_tpu_torch.ops.rasterizer.pack_gather import pack_gather

    t0 = time.perf_counter()
    out = {}
    for label, n, (w, h) in QUAD_SIZES:
        scene = cs.make_scene(cs.bench_scene(n), device)
        cam = cs.view_camera(w, h, device, eye=(0, 0, -3), fov=0.9)
        bg = torch.zeros(3, device=device)
        with torch.no_grad():
            prep = api.preprocess_scene(cam, scene)
            binning, rows = render_path.bin_and_pack(prep, w, h)
            if n == cs.FULL_N:
                fbin, frows = render_path.bin_and_pack(prep, w, h, fast=True)
            else:
                fbin, frows = binning, pack_gather(
                    prep.means2d, prep.conics, prep.opacities, prep.depths, prep.colors,
                    binning.depth_order, binning.rank, binning.tile_of_dup, w)
        kernels = {"K1": (blend.blend_fwd, rows, binning, "blend_fwd_kernel"),
                   "K1q": (blend.blend_fwd_quad, rows, binning, "blend_fwd_kernel"),
                   "K1f": (blend.blend_fwd_fast, frows, fbin, "blend_fwd_fast_kernel"),
                   "K1fq": (blend.blend_fwd_fast_quad, frows, fbin, "blend_fwd_fast_kernel")}
        size = {"n": n, "width": w, "height": h, "K": int(rows.shape[0])}
        for name, (fn, r, b, kname) in kernels.items():
            call = functools.partial(fn, r, b.tile_start, b.tile_end, w, h, bg)
            size[name] = {"ms": cs.cuda_time_ms(call, reps),
                          "device_ms": cs.kernel_device_ms(call, kname, reps)}
        for quad, direct in (("K1q", "K1"), ("K1fq", "K1f")):
            for key in ("ms", "device_ms"):
                size[f"{quad}_over_{direct}_{key}"] = size[quad][key] / size[direct][key]
        out[label] = size
        del scene, prep, binning, rows, fbin, frows
        torch.cuda.empty_cache()
    print(json.dumps({"phase": "quad_times", "sizes": out, "reps": reps,
                      "seconds": time.perf_counter() - t0}), flush=True)


SECTIONS = ("barrier and staging", "cull and list", "MMAs", "walk")


def phase_quad_sections(device):
    """Where K1, K1q, K1f and K1fq spend their warps' time, at the 200k /
    800x800 frame of `quad_times`: each kernel launched once from a library
    built with the section timers of `csrc/blend_fwd.cu` (-DW3D_SECTION_
    TIMERS, beside the default library) after a launch that warms it; per
    kernel the giga-cycles (clock64, lane 0 of every warp, summed) of each of
    SECTIONS and their total, and the longest span of a warp in
    kilo-cycles. The timers cost each section two clock reads and an add;
    the phase reports their times beside the default build's (device ms)."""
    import ctypes

    from wast3d_tpu_torch.ops.rasterizer import api, blend, render_path

    t0 = time.perf_counter()
    timed = _build.load_library(("W3D_SECTION_TIMERS",))
    timed.w3d_section_timers.argtypes = [ctypes.c_void_p, ctypes.c_int]
    timed.w3d_section_timers.restype = ctypes.c_int
    scene = cs.make_scene(cs.bench_scene(cs.FULL_N), device)
    w = h = cs.FULL_RES
    cam = cs.view_camera(w, h, device, eye=(0, 0, -3), fov=0.9)
    bg = torch.zeros(3, device=device)
    with torch.no_grad():
        prep = api.preprocess_scene(cam, scene)
        b32, rows = render_path.bin_and_pack(prep, w, h)
        bf, frows = render_path.bin_and_pack(prep, w, h, fast=True)
    kernels = (("K1", blend.blend_fwd, rows, b32), ("K1q", blend.blend_fwd_quad, rows, b32),
               ("K1f", blend.blend_fwd_fast, frows, bf),
               ("K1fq", blend.blend_fwd_fast_quad, frows, bf))
    default_ms = {}
    for name, fn, r, b in kernels:
        call = functools.partial(fn, r, b.tile_start, b.tile_end, w, h, bg)
        kname = "blend_fwd_fast_kernel" if name.startswith("K1f") else "blend_fwd_kernel"
        default_ms[name] = cs.kernel_device_ms(call, kname, 20)
    buf = (ctypes.c_ulonglong * 20)()
    out = {"sections": SECTIONS}
    default = _build.load_library
    _build.load_library = lambda *a: timed  # the wrappers launch the timed build
    try:
        for slot, (name, fn, r, b) in enumerate(kernels):
            call = functools.partial(fn, r, b.tile_start, b.tile_end, w, h, bg)
            kname = "blend_fwd_fast_kernel" if name.startswith("K1f") else "blend_fwd_kernel"
            timed_ms = cs.kernel_device_ms(call, kname, 20)
            torch.cuda.synchronize()
            errs = [timed.w3d_section_timers(buf, 1)]  # zeroed, then one launch
            call()
            torch.cuda.synchronize()
            errs.append(timed.w3d_section_timers(buf, 0))
            if any(errs):
                raise RuntimeError(f"section timers: CUDA errors {errs}")
            v = [buf[5 * slot + i] for i in range(4)]
            out[name] = {"gcycles": dict(zip(SECTIONS, (x / 1e9 for x in v))),
                         "total_gcycles": sum(v) / 1e9,
                         "longest_warp_kcycles": buf[5 * slot + 4] / 1e3,
                         "device_ms": default_ms[name], "timed_device_ms": timed_ms}
    finally:
        _build.load_library = default
    print(json.dumps({"phase": "quad_sections", **out,
                      "seconds": time.perf_counter() - t0}), flush=True)


# The dynamic shared memory a block of K1q and K1fq takes (csrc/blend_fwd.cu
# kQuadSmem, kFastQuadSmem: coefficient words, kept lists, slabs); K1 and K1f
# take none.
QUAD_DYNAMIC_SMEM = {"K1": 0, "K1q": 4 * 128 * 12 + 8 * 128 + 8 * 32 * 32 * 4,
                     "K1f": 0, "K1fq": 4 * 256 * 8 + 8 * 256 + 8 * 32 * 32 * 2}
# An H100 SM (sm_90): registers, their allocation unit a warp, threads,
# blocks and shared memory.
SM_REGS, REG_UNIT, SM_THREADS, SM_BLOCKS, SM_SMEM = 65536, 256, 2048, 32, 228 * 1024


def blocks_per_sm(regs, smem, threads=256):
    """Resident blocks of `threads` threads an H100 SM holds at `regs`
    registers a thread and `smem` bytes of shared memory a block, the 1 KB
    the runtime reserves a block included (`cuobjdump -res-usage` counts it
    in SHARED; ptxas's figure is 1 KB less)."""
    warps = threads // 32
    per_warp = -(-regs * 32 // REG_UNIT) * REG_UNIT
    return min(SM_REGS // (per_warp * warps), SM_THREADS // threads, SM_BLOCKS, SM_SMEM // smem)


def phase_sass(device):
    """The built library's machine code (`cuobjdump -sass`): each kernel's
    count of HMMA instructions (the tensor cores' `mma.sync`); raises unless
    K1q's and K1fq's kernels (`blend_fwd_kernel<.., true>` and
    `blend_fwd_fast_kernel<.., true>`, with the cull and without) each hold
    some. With `cuobjdump -res-usage`, the culled K1, K1q, K1f and K1fq's
    registers, static shared memory and the blocks an SM holds with their
    dynamic shared memory (`blocks_per_sm`). The dump goes beside the
    library (`<library>.sass.txt`)."""
    import re
    import shutil
    import subprocess

    t0 = time.perf_counter()
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    dump = subprocess.run([tool, "-sass", str(_build.library_path())], capture_output=True,
                          text=True, check=True).stdout
    with open(str(_build.library_path()) + ".sass.txt", "w") as f:
        f.write(dump)
    counts, name = {}, None
    for line in dump.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = 0
        elif name is not None and re.search(r"\bHMMA\b", line):
            counts[name] += 1
    # blend_fwd_kernel<kCull, kQuad>: mangled template arguments ...ILb?ELb?EE
    quad = {k: v for k, v in counts.items()
            if re.search(r"blend_fwd(_fast)?_kernelILb[01]ELb1EE", k)}
    if len(quad) != 4 or not all(quad.values()):
        raise AssertionError(f"quad kernels without HMMA: {quad}")
    usage = subprocess.run([tool, "-res-usage", str(_build.library_path())],
                           capture_output=True, text=True, check=True).stdout
    occupancy, name = {}, None
    for line in usage.splitlines():
        m = re.search(r"Function (\S+):", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"REG:(\d+) STACK:(\d+) SHARED:(\d+) LOCAL:(\d+)", line)
        k = re.search(r"blend_fwd(_fast)?_kernelILb1ELb([01])EE", name or "")
        if m and k:
            kernel = ("K1f" if k.group(1) else "K1") + ("q" if k.group(2) == "1" else "")
            regs, static = int(m.group(1)), int(m.group(3))
            dynamic = QUAD_DYNAMIC_SMEM[kernel]
            occupancy[kernel] = {"registers": regs, "static_smem_and_reserve": static,
                                 "dynamic_smem": dynamic, "stack": int(m.group(2)),
                                 "local": int(m.group(4)),
                                 "blocks_per_sm": blocks_per_sm(regs, static + dynamic)}
    print(json.dumps({"phase": "sass", "hmma": {k: v for k, v in counts.items() if v},
                      "quad_kernels_hmma": quad, "functions": len(counts),
                      "occupancy": occupancy, "seconds": time.perf_counter() - t0}), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_phases: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    if "--device-times" in sys.argv[2:]:
        cs.cuda_time_ms, cs.cuda_times_ms = with_device_times(cs.cuda_time_ms,
                                                               cs.cuda_times_ms)
    t0 = time.perf_counter()
    built = _build.build()
    _build.load_library()
    print(json.dumps({"phase": "build", "nvcc_s": built.seconds}), flush=True)
    save = sys.argv[sys.argv.index("--save-k1") + 1] if "--save-k1" in sys.argv else None
    phases = {"k1_bits": lambda dev: phase_k1_bits(dev, save), "k2_bits": phase_k2_bits,
              "k2_cases": cs.phase_k2_cases, "k3_cases": cs.phase_k3_cases,
              "full_width": cs.phase_full_width,
              "train_full_width": cs.phase_train_full_width,
              "train_entry_point": cs.phase_train_entry_point,
              "k4k5_full_width": cs.phase_k45_full_width,
              "k1_fast_cases": lambda dev: cs.phase_k1_cases(dev, fast=True),
              "k2_fast_cases": lambda dev: cs.phase_k2_cases(dev, fast=True),
              "full_width_fast": cs.phase_full_width_fast,
              "train_full_width_fast": cs.phase_train_full_width_fast,
              "stylize_entry_point": lambda dev: cs.phase_stylize_entry_point(
                  dev, cs.content_domain(dev)[1]),
              "quad_times": phase_quad_times, "quad_sections": phase_quad_sections,
              "sass": phase_sass}
    for name in sys.argv[1].split(","):
        phases[name](device)
    print(json.dumps({"total_seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
