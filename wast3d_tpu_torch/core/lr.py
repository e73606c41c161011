"""Learning-rate schedules.

Port of `wast3d_tpu/core/lr.py::expon_lr`, the reference's log-linear decay
with an optional sine-eased warm-up delay. The JAX schedule is traced on
the device in float32; this one runs on the host, in numpy float32, so the
two give the same value for the same step.
"""

from __future__ import annotations

import numpy as np


def expon_lr(
    lr_init: float,
    lr_final: float,
    lr_delay_steps: int = 0,
    lr_delay_mult: float = 1.0,
    max_steps: int = 1_000_000,
):
    """Returns schedule(step) -> lr (a Python float)."""
    f32 = np.float32
    if lr_init == 0.0 and lr_final == 0.0:
        return lambda step: 0.0

    def schedule(step) -> float:
        step = f32(step)
        if lr_delay_steps > 0:
            delay_rate = f32(lr_delay_mult) + (f32(1.0) - f32(lr_delay_mult)) * np.sin(
                f32(0.5 * np.pi) * np.clip(step / f32(lr_delay_steps), f32(0), f32(1)))
        else:
            delay_rate = f32(1.0)
        t = np.clip(step / f32(max_steps), f32(0), f32(1))
        log_lerp = np.exp(np.log(f32(lr_init)) * (f32(1) - t) + np.log(f32(lr_final)) * t)
        # Negative steps disable the parameter (the reference's step < 0 branch).
        return 0.0 if step < 0 else float(f32(delay_rate * log_lerp))

    return schedule
