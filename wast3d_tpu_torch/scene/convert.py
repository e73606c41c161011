"""Carry a scene's weights across from the JAX package.

`scene_from_numpy` takes the fields of a `wast3d_tpu` GaussianScene as
numpy arrays (for example `{f: np.asarray(getattr(s, f)) for f in ...}`)
and returns the port's scene; `train_state_from_numpy` does the same for
a whole training state (scene, Adam moments, densification statistics,
step), and `target_descriptors_from_numpy` for the stylization's frozen
descriptor state (kNN ties at large k may order indices differently in
the two packages, so tests start both from one state). Nothing here
imports JAX: the caller does the conversion to numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from wast3d_tpu_torch.device import DeviceLike, resolve_device
from wast3d_tpu_torch.scene.gaussians import FIELDS, GaussianScene, from_arrays
from wast3d_tpu_torch.stylize.fit import TargetDescriptors
from wast3d_tpu_torch.train.densify import DensifyStats
from wast3d_tpu_torch.train.optim import AdamState
from wast3d_tpu_torch.train.reconstruct import TrainState


def scene_from_numpy(d: dict, device: DeviceLike = None) -> GaussianScene:
    """`d` holds the array fields of `FIELDS` plus the ints
    `active_sh_degree` and `max_sh_degree`."""
    return from_arrays(
        xyz=d["xyz"], features_dc=d["features_dc"],
        features_rest=d["features_rest"], scaling=d["scaling"],
        rotation=d["rotation"], opacity=d["opacity"], mask=d["mask"],
        max_sh_degree=int(d["max_sh_degree"]),
        active_sh_degree=int(d["active_sh_degree"]),
        device=device,
    )


def train_state_from_numpy(params: dict, mu: dict, nu: dict, count: int,
                           stats, step: int, mask, active_sh_degree: int = 0,
                           max_sh_degree: int = 3, device: DeviceLike = None) -> TrainState:
    """The port's `TrainState` from a JAX `TrainState` given as numpy:
    `params`, `mu` and `nu` keyed by the optimizer groups (`xyz`, `f_dc`,
    `f_rest`, `opacity`, `scaling`, `rotation`), `stats` the three arrays
    of `DensifyStats` (a tuple in field order, or a dict), `count` the Adam
    step count, `step` the train step and `mask` the validity mask. Every
    row of the JAX capacity is kept; masked-out rows stay masked."""
    dev = resolve_device(device)

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)

    scene = from_arrays(
        xyz=params["xyz"], features_dc=params["f_dc"], features_rest=params["f_rest"],
        scaling=params["scaling"], rotation=params["rotation"],
        opacity=params["opacity"], mask=mask, max_sh_degree=max_sh_degree,
        active_sh_degree=active_sh_degree, device=dev)
    if isinstance(stats, dict):
        stats = [stats[f] for f in DensifyStats._fields]
    return TrainState(
        scene=scene,
        opt_state=AdamState(mu={k: t(v) for k, v in mu.items()},
                            nu={k: t(v) for k, v in nu.items()}, count=int(count)),
        stats=DensifyStats(*(t(a) for a in stats)),
        step=int(step))


def target_descriptors_from_numpy(d: dict, device: DeviceLike = None) -> TargetDescriptors:
    """The port's `TargetDescriptors` from the fields of a JAX one given as
    numpy arrays (`pair_code` may be absent or None); indices become int64,
    the coefficients float32 values."""
    dev = resolve_device(device)

    def t(name, dtype):
        return torch.from_numpy(np.array(d[name], dtype=dtype)).to(dev)

    code = d.get("pair_code")
    return TargetDescriptors(
        idx_global=t("idx_global", np.int64), desc_global=t("desc_global", np.float32),
        idx_local=t("idx_local", np.int64), desc_local=t("desc_local", np.float32),
        points=t("points", np.float32),
        bits_global=t("bits_global", np.uint8), bits_local=t("bits_local", np.uint8),
        coef_global=float(np.float32(d["coef_global"])),
        coef_local=float(np.float32(d["coef_local"])),
        pair_code=None if code is None else t("pair_code", np.uint8))
