"""Run named phases of the `chip_smoke.py` in the current directory, on one
CUDA card, so that an older checkout (whose `--only` lacks them) and the
current one can be compared in one chip call:

    cd <checkout> && python3 <repo>/tools/chip_phases.py full_width,train_entry_point
    cd <checkout> && python3 <repo>/tools/chip_phases.py train_full_width --device-times

Phases: k3_cases, full_width, train_full_width, train_entry_point. Each
phase prints its JSON line as in `chip_smoke.py`. `--device-times` also
times, by `torch.profiler`, every call that the phases time by CUDA events
over 20 or more repetitions, and prints its device busy time beside the
event time, numbered in call order.
"""

import json
import os
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


def with_device_times(event_ms):
    calls = []

    def timed(fn, reps):
        ms = event_ms(fn, reps)
        if reps >= 20:
            calls.append({"call": len(calls), "event_ms": ms, "reps": reps,
                          "device_busy_ms": busy_ms(fn)})
            print(json.dumps({"device_time": calls[-1]}), flush=True)
        return ms

    return timed


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_phases: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    if "--device-times" in sys.argv[2:]:
        cs.cuda_time_ms = with_device_times(cs.cuda_time_ms)
    t0 = time.perf_counter()
    built = _build.build()
    _build.load_library()
    print(json.dumps({"phase": "build", "nvcc_s": built.seconds}), flush=True)
    phases = {"k3_cases": cs.phase_k3_cases, "full_width": cs.phase_full_width,
              "train_full_width": cs.phase_train_full_width,
              "train_entry_point": cs.phase_train_entry_point}
    for name in sys.argv[1].split(","):
        phases[name](device)
    print(json.dumps({"total_seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
