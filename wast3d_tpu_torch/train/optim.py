"""Per-group Adam with the reference's hyperparameters.

Port of `wast3d_tpu/train/optim.py`: Adam with eps 1e-15 added outside the
square root and bias correction by one shared step count, over six groups
  xyz       position_lr_init * spatial_lr_scale, decayed log-linearly to
            position_lr_final * spatial_lr_scale (`core/lr.expon_lr`)
  f_dc      feature_lr
  f_rest    feature_lr / 20
  opacity   opacity_lr
  scaling   scaling_lr
  rotation  rotation_lr
Hand-written rather than `torch.optim.Adam` because densification does
surgery on the moments (new rows get zero moments, dropped rows go), and
to keep the JAX update's arithmetic order. The step count and the learning
rates live on the host, so the update never synchronises with the device.
`update` returns new tensors and leaves its inputs as they were, as the
JAX update does.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple

import numpy as np
import torch

from wast3d_tpu_torch.config import OptimizationConfig
from wast3d_tpu_torch.core.lr import expon_lr

BETA1 = 0.9
BETA2 = 0.999
EPS = 1e-15

PARAM_KEYS = ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation")


class AdamState(NamedTuple):
    mu: Dict[str, torch.Tensor]  # first moments, keyed like scene.params()
    nu: Dict[str, torch.Tensor]  # second moments
    count: int  # step count


class GaussianOptimizer(NamedTuple):
    init: Callable
    update: Callable
    lr_fns: Dict[str, Callable]


def make_optimizer(cfg: OptimizationConfig, spatial_lr_scale: float) -> GaussianOptimizer:
    xyz_sched = expon_lr(
        lr_init=cfg.position_lr_init * spatial_lr_scale,
        lr_final=cfg.position_lr_final * spatial_lr_scale,
        lr_delay_mult=cfg.position_lr_delay_mult,
        max_steps=cfg.position_lr_max_steps,
    )
    lr_fns = {
        "xyz": xyz_sched,
        "f_dc": lambda s: cfg.feature_lr,
        "f_rest": lambda s: cfg.feature_lr / 20.0,
        "opacity": lambda s: cfg.opacity_lr,
        "scaling": lambda s: cfg.scaling_lr,
        "rotation": lambda s: cfg.rotation_lr,
    }

    def init(params: Dict[str, torch.Tensor]) -> AdamState:
        return AdamState(mu={k: torch.zeros_like(v) for k, v in params.items()},
                         nu={k: torch.zeros_like(v) for k, v in params.items()},
                         count=0)

    def update(grads, state: AdamState, params, step=None):
        """One Adam step; `step` (default: the new count) drives the xyz
        learning-rate schedule."""
        count = state.count + 1
        sched_step = count if step is None else step
        f32 = np.float32
        b1c = float(f32(1.0) - f32(BETA1) ** f32(count))
        b2c = float(f32(1.0) - f32(BETA2) ** f32(count))
        new_mu, new_nu, new_params = {}, {}, {}
        with torch.no_grad():
            for k in params:
                g = grads[k]
                m = BETA1 * state.mu[k] + (1.0 - BETA1) * g
                v = BETA2 * state.nu[k] + (1.0 - BETA2) * g * g
                lr = float(lr_fns[k](sched_step))
                new_params[k] = params[k] - lr * (m / b1c) / (torch.sqrt(v / b2c) + EPS)
                new_mu[k] = m
                new_nu[k] = v
        return new_params, AdamState(mu=new_mu, nu=new_nu, count=count)

    return GaussianOptimizer(init=init, update=update, lr_fns=lr_fns)
