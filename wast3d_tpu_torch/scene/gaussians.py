"""GaussianScene: the parametric 3D Gaussian scene as torch tensors.

Port of `wast3d_tpu/scene/gaussians.py`: the same fields, activations and
`mask` / `active_sh_degree` semantics. The JAX scene pads to a static
capacity because XLA needs static shapes; the port keeps N exact and still
honours `mask` (a scene carried across from JAX may hold dead slots).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from wast3d_tpu_torch.core.transforms import covariance_from_scaling_rotation
from wast3d_tpu_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class GaussianScene:
    xyz: torch.Tensor  # [N, 3]
    features_dc: torch.Tensor  # [N, 1, 3]
    features_rest: torch.Tensor  # [N, K-1, 3]
    scaling: torch.Tensor  # [N, 3] log-space
    rotation: torch.Tensor  # [N, 4] unnormalised quaternion (w,x,y,z)
    opacity: torch.Tensor  # [N, 1] logit
    mask: torch.Tensor  # [N] bool validity
    active_sh_degree: int = 0
    max_sh_degree: int = 3

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    @property
    def device(self) -> torch.device:
        return self.xyz.device

    # ---- activations -------------------------------------------------
    @property
    def get_scaling(self) -> torch.Tensor:
        return torch.exp(self.scaling)

    @property
    def get_rotation(self) -> torch.Tensor:
        return self.rotation / torch.linalg.norm(self.rotation, dim=-1, keepdim=True)

    @property
    def get_xyz(self) -> torch.Tensor:
        return self.xyz

    @property
    def get_features(self) -> torch.Tensor:
        """[N, K, 3] concatenated SH coefficients."""
        return torch.cat([self.features_dc, self.features_rest], dim=1)

    @property
    def get_opacity(self) -> torch.Tensor:
        return torch.sigmoid(self.opacity)

    def get_covariance(self, scaling_modifier: float = 1.0) -> torch.Tensor:
        """[N, 6] packed world covariance."""
        return covariance_from_scaling_rotation(
            self.get_scaling, scaling_modifier, self.get_rotation)

    def replace(self, **changes) -> "GaussianScene":
        return dataclasses.replace(self, **changes)

    def to(self, device: torch.device) -> "GaussianScene":
        if self.device == torch.device(device):
            return self
        return self.replace(**{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)
        })


def from_arrays(
    xyz,
    features_dc,
    features_rest,
    scaling,
    rotation,
    opacity,
    max_sh_degree: int = 3,
    active_sh_degree: int = 0,
    mask: Optional[np.ndarray] = None,
    device: DeviceLike = None,
) -> GaussianScene:
    """Pack per-Gaussian numpy arrays (or tensors) into a scene on
    `device`; `mask` defaults to all valid."""
    dev = resolve_device(device)

    def f32(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)

    n = np.asarray(xyz).shape[0]
    m = np.ones(n, bool) if mask is None else np.asarray(mask, bool)
    return GaussianScene(
        xyz=f32(xyz),
        features_dc=f32(features_dc),
        features_rest=f32(features_rest),
        scaling=f32(scaling),
        rotation=f32(rotation),
        opacity=f32(opacity),
        mask=torch.from_numpy(m.copy()).to(dev),
        active_sh_degree=int(active_sh_degree),
        max_sh_degree=int(max_sh_degree),
    )
