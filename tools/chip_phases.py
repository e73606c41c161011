"""Run named phases of the `chip_smoke.py` in the current directory, on one
CUDA card, so that an older checkout (whose `--only` lacks them) and the
current one can be compared in one chip call:

    cd <checkout> && python3 <repo>/tools/chip_phases.py full_width,train_entry_point
    cd <checkout> && python3 <repo>/tools/chip_phases.py train_full_width --device-times
    cd <checkout> && python3 <repo>/tools/chip_phases.py k1_bits --save-k1 <file.pt>

Phases: k1_bits, k2_bits, k2_cases, k3_cases, full_width, train_full_width,
train_entry_point, k4k5_full_width, stylize_entry_point (after building the
content domain), and the bf16 tier's k1_fast_cases, k2_fast_cases,
full_width_fast and train_full_width_fast. Each phase prints its JSON line as in `chip_smoke.py`;
`k1_bits` and `k2_bits` (below) print SHA-256 hashes of K1's inputs and
outputs and of K2's outputs, and
`--save-k1 <file.pt>` also saves its 200k / 800x800 outputs there, so that
two checkouts' K1 can be compared bit for bit and by their largest
difference. `--device-times` also times, by `torch.profiler`, every call
that the phases time by CUDA events over 20 or more repetitions
(`cuda_time_ms` over the whole run, `cuda_times_ms` launch by launch), and
prints its device busy time beside the event time, numbered in call order.
"""

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
    """As `chip_smoke.sha256_of`, which an older checkout lacks."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def phase_k1_bits(device, save=None):
    """K1 (`blend_fwd`) once on the checkout's own `k1_cases` and on the
    200k / 800x800 frame's inputs, as `full_width` builds them; prints the
    hashes of each case's inputs and K1's three outputs. Uses only what
    every checkout's `chip_smoke.py` has since the port began."""
    from wast3d_tpu_torch.ops.rasterizer.blend import blend_fwd

    t0 = time.perf_counter()
    bg, cases = cs.k1_cases(device)
    scene = cs.make_scene(cs.bench_scene(cs.FULL_N), device)
    cam = cs.view_camera(cs.FULL_RES, cs.FULL_RES, device, eye=(0, 0, -3), fov=0.9)
    cases["full_width"] = cs.kernel_inputs(scene, cam)
    out = {}
    for name, (rows, starts, ends, w, h, offsets) in cases.items():
        case_bg = torch.zeros(3, device=device) if name == "full_width" else bg
        k = blend_fwd(rows, starts, ends, w, h, case_bg, offsets)
        torch.cuda.synchronize()
        inputs = [rows, starts, ends] + ([] if offsets is None else [offsets])
        out[name] = {"K": int(rows.shape[0]), "rows_sha256": sha256_of(inputs),
                     "output_sha256": sha256_of(k)}
        if name == "full_width" and save:
            torch.save({f: t.cpu() for f, t in zip(("color", "depth", "final_T"), k)}, save)
    print(json.dumps({"phase": "k1_bits", "cases": out,
                      "seconds": time.perf_counter() - t0}), flush=True)


def phase_k2_bits(device):
    """K2 (`blend_bwd`) once on the checkout's own `k1_cases` (K1's output
    as the forward, `k2_cotangents` as the cotangents, background 0 and 1)
    and at the 200k / 800x800 frame's inputs; prints the hashes of each
    case's output. Uses only what every checkout's `chip_smoke.py` has
    since K2 was ported."""
    from wast3d_tpu_torch.ops.rasterizer.blend import blend_bwd, blend_fwd

    t0 = time.perf_counter()
    _, cases = cs.k1_cases(device)
    scene = cs.make_scene(cs.bench_scene(cs.FULL_N), device)
    cam = cs.view_camera(cs.FULL_RES, cs.FULL_RES, device, eye=(0, 0, -3), fov=0.9)
    cases["full_width"] = cs.kernel_inputs(scene, cam)
    out = {}
    for bg_value in (0.0, 1.0):
        bg = torch.full((3,), bg_value, device=device)
        for i, (name, (rows, starts, ends, w, h, offsets)) in enumerate(cases.items()):
            fwd = blend_fwd(rows, starts, ends, w, h, bg, offsets)
            grads = cs.k2_cotangents(h, w, device, seed=i)
            d = blend_bwd(rows, starts, ends, w, h, bg, offsets, fwd, grads)
            torch.cuda.synchronize()
            out[f"{name}_bg{int(bg_value)}"] = {"K": int(rows.shape[0]),
                                                 "output_sha256": sha256_of([d])}
    print(json.dumps({"phase": "k2_bits", "cases": out,
                      "seconds": time.perf_counter() - t0}), flush=True)


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
                  dev, cs.content_domain(dev)[1])}
    for name in sys.argv[1].split(","):
        phases[name](device)
    print(json.dumps({"total_seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
