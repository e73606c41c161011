"""GaussianScene: the parametric 3D Gaussian scene as torch tensors.

Port of `wast3d_tpu/scene/gaussians.py`: the same fields, activations and
`mask` / `active_sh_degree` semantics. The JAX scene pads to a static
capacity because XLA needs static shapes; the port keeps N exact and still
honours `mask` (a scene carried across from JAX may hold dead slots; the
first densify step removes them). `params` / `with_params` give the six
learnable tensors under the optimizer's group names.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from wast3d_tpu_torch.core.sh import num_sh_coeffs, rgb_to_sh
from wast3d_tpu_torch.core.transforms import covariance_from_scaling_rotation
from wast3d_tpu_torch.device import DeviceLike, resolve_device


FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
          "opacity", "mask")  # the per-Gaussian tensors, in this order


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

    @property
    def num_active(self) -> torch.Tensor:
        return torch.sum(self.mask)

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

    def one_up_sh_degree(self) -> "GaussianScene":
        if self.active_sh_degree < self.max_sh_degree:
            return self.replace(active_sh_degree=self.active_sh_degree + 1)
        return self

    def params(self) -> dict:
        """The six learnable tensors, keyed by the optimizer's group names."""
        return {"xyz": self.xyz, "f_dc": self.features_dc,
                "f_rest": self.features_rest, "opacity": self.opacity,
                "scaling": self.scaling, "rotation": self.rotation}

    def with_params(self, p: dict) -> "GaussianScene":
        return self.replace(xyz=p["xyz"], features_dc=p["f_dc"],
                            features_rest=p["f_rest"], opacity=p["opacity"],
                            scaling=p["scaling"], rotation=p["rotation"])

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


def from_point_cloud(points, colors, max_sh_degree: int = 3,
                     knn_mean_sq_dist=None, device: DeviceLike = None) -> GaussianScene:
    """Initialise from a point cloud as the reference's `create_from_pcd`
    does: DC features from RGB, the rest zero; isotropic log scale
    log(sqrt(mean squared distance to the 3 nearest neighbours)), identity
    rotations, opacity logit of 0.1."""
    from wast3d_tpu_torch.ops.knn import mean_sq_dist_to_3nn

    dev = resolve_device(device)
    points = np.asarray(points, np.float32)
    n = points.shape[0]
    if knn_mean_sq_dist is None:
        knn_mean_sq_dist = mean_sq_dist_to_3nn(
            torch.from_numpy(points).to(dev)).cpu().numpy()
    dist2 = np.maximum(np.asarray(knn_mean_sq_dist, np.float32), np.float32(1e-7))
    scales = np.log(np.sqrt(dist2))[:, None].repeat(3, axis=1)
    rots = np.zeros((n, 4), np.float32)
    rots[:, 0] = 1.0
    opac = np.log(np.float32(0.1) / (np.float32(1) - np.float32(0.1)))
    return from_arrays(
        xyz=points,
        features_dc=rgb_to_sh(np.asarray(colors, np.float32))[:, None, :],
        features_rest=np.zeros((n, num_sh_coeffs(max_sh_degree) - 1, 3), np.float32),
        scaling=scales, rotation=rots, opacity=np.full((n, 1), opac, np.float32),
        max_sh_degree=max_sh_degree, device=dev)


def compact(scene: GaussianScene) -> GaussianScene:
    """The scene without its masked-out rows."""
    keep = scene.mask
    if bool(keep.all()):
        return scene
    return scene.replace(**{f: getattr(scene, f)[keep] for f in FIELDS})
