"""Tracing / profiling utilities.

Port of `wast3d_tpu/utils/profiling.py`:
- `StepTimer`: wall-time EMA per step and steps/sec (copied);
- `trace(log_dir)`: a `torch.profiler` context (CPU activity, and CUDA
  activity where a card is present) that writes a Chrome trace
  (`trace_<pid>_<n>.json`, viewable in Perfetto) into `log_dir`;
- `device_memory_stats(device=None)`: JAX's three keys from
  `torch.cuda.memory_stats` (allocated bytes now and at peak) and the
  card's total memory; `{}` for the CPU, as JAX gives for a device without
  statistics.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import time
from typing import Optional

import torch

from wast3d_tpu_torch.device import DeviceLike, resolve_device

_TRACES = itertools.count()


class StepTimer:
    def __init__(self, ema: float = 0.6):
        self._ema = ema
        self.iter_time = None  # EMA seconds/step
        self._last = None

    def tick(self) -> Optional[float]:
        now = time.perf_counter()
        if self._last is not None:
            dt = now - self._last
            self.iter_time = (
                dt if self.iter_time is None
                else self._ema * self.iter_time + (1 - self._ema) * dt
            )
        self._last = now
        return self.iter_time

    @property
    def steps_per_sec(self) -> Optional[float]:
        return None if not self.iter_time else 1.0 / self.iter_time


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block; on exit write its Chrome trace into `log_dir`.
    Yields the `torch.profiler.profile` object."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{next(_TRACES)}.json"))


def device_memory_stats(device: DeviceLike = None) -> dict:
    """{bytes_in_use, peak_bytes_in_use, bytes_limit} of a CUDA device
    (None means CUDA); {} for the CPU."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(dev)
    return {
        "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
        "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
        "bytes_limit": torch.cuda.get_device_properties(dev).total_memory,
    }
