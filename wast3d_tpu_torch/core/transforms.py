"""Quaternion / covariance / activation math for Gaussian scenes.

Port of `wast3d_tpu/core/transforms.py`: the same f32 formulas on torch
tensors. Quaternions are (w, x, y, z), w first.
"""

from __future__ import annotations

import torch


def inverse_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """logit."""
    return torch.log(x / (1.0 - x))


def quat_to_rotmat(q: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    """[N,4] (w,x,y,z) quaternions -> [N,3,3] rotation matrices."""
    if normalize:
        q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1.0 - 2.0 * (y * y + z * z)
    r01 = 2.0 * (x * y - w * z)
    r02 = 2.0 * (x * z + w * y)
    r10 = 2.0 * (x * y + w * z)
    r11 = 1.0 - 2.0 * (x * x + z * z)
    r12 = 2.0 * (y * z - w * x)
    r20 = 2.0 * (x * z - w * y)
    r21 = 2.0 * (y * z + w * x)
    r22 = 1.0 - 2.0 * (x * x + y * y)
    return torch.stack(
        [
            torch.stack([r00, r01, r02], dim=-1),
            torch.stack([r10, r11, r12], dim=-1),
            torch.stack([r20, r21, r22], dim=-1),
        ],
        dim=-2,
    )


def build_scaling_rotation(s: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """L = R @ diag(s) [N,3,3]; `s` is the activated scale [N,3]."""
    return quat_to_rotmat(q) * s[..., None, :]


def covariance_from_scaling_rotation(
    scaling: torch.Tensor, scaling_modifier: float, rotation: torch.Tensor
) -> torch.Tensor:
    """Sigma = L L^T with L = R diag(s), packed [N,6] as
    (xx, xy, xz, yy, yz, zz). `scaling` is the activated scale."""
    L = build_scaling_rotation(scaling_modifier * scaling, rotation)
    return strip_symmetric(L @ L.transpose(-1, -2))


def strip_symmetric(cov: torch.Tensor) -> torch.Tensor:
    """[N,3,3] symmetric -> [N,6] upper triangle (xx, xy, xz, yy, yz, zz)."""
    return torch.stack(
        [cov[..., 0, 0], cov[..., 0, 1], cov[..., 0, 2],
         cov[..., 1, 1], cov[..., 1, 2], cov[..., 2, 2]],
        dim=-1,
    )


def unpack_symmetric(packed: torch.Tensor) -> torch.Tensor:
    """[N,6] (xx, xy, xz, yy, yz, zz) -> [N,3,3] symmetric."""
    xx, xy, xz, yy, yz, zz = (packed[..., i] for i in range(6))
    return torch.stack(
        [
            torch.stack([xx, xy, xz], dim=-1),
            torch.stack([xy, yy, yz], dim=-1),
            torch.stack([xz, yz, zz], dim=-1),
        ],
        dim=-2,
    )
