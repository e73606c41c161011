"""Per-Gaussian rasterization preprocess: project, EWA cov2D, conic, cull.

Port of `wast3d_tpu/ops/rasterizer/preprocess.py` (the reference's
`preprocessCUDA`), the same f32 formulas in the same order, as plain torch
ops on the device of the inputs:

- near cull at view z <= 0.2,
- perspective divide with the +1e-7 w guard,
- EWA 2D covariance with the 1.3*tan_fov frustum clamp and +0.3 pixel
  dilation,
- conic from the 2x2 inverse; screen radius ceil(3 sqrt(lambda_max)) with
  the 0.1 discriminant floor,
- tight per-axis tile extents: the AABB of the alpha >= 1/255 ellipse
  intersected with the 3-sigma box, +1 pixel,
- ndc2Pix pixel mapping ((v+1)*S - 1)/2,
- SH -> RGB with +0.5 offset and clamp.

As in JAX, precomputed colours (`colors_precomp`, taken as given: no +0.5,
no clamp) stand in for the SH, and a precomputed packed covariance
(`cov3d_precomp`, [N, 6] as (xx, xy, xz, yy, yz, zz)) for the scales and
rotations; exactly one of each pair is given.

It is differentiable by autograd: gradients reach means, scales,
rotations (or the precomputed covariance), opacities and SH (or the
precomputed colours), and depth gradients reach the means through
the view matrix. Near-culled Gaussians take a safe depth of 1 inside the
EWA chain (as `det_safe` does for the determinant), so culled and masked
Gaussians get zero, not NaN, gradients; they are not drawn, so no output
that is drawn changes. Radii and tile extents are integers and are taken
from detached values.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from wast3d_tpu_torch.core.sh import eval_sh_color

NEAR_CULL_Z = 0.2
COV2D_DILATION = 0.3


class Preprocessed(NamedTuple):
    """Per-Gaussian screen-space quantities (all [N,...])."""

    means2d: torch.Tensor  # [N,2] pixel coords
    depths: torch.Tensor  # [N] view-space z
    conics: torch.Tensor  # [N,3] inverse 2D covariance (A, B, C)
    colors: torch.Tensor  # [N,3] RGB
    opacities: torch.Tensor  # [N]
    radii: torch.Tensor  # [N] int32 screen radius (0 = culled)
    valid: torch.Tensor  # [N] bool
    extent_x: torch.Tensor  # [N] int32 tight tile-coverage half-extent
    extent_y: torch.Tensor  # [N] int32


def preprocess(
    means3d: torch.Tensor,
    opacities: torch.Tensor,
    view_transform: torch.Tensor,
    full_proj_transform: torch.Tensor,
    camera_center: torch.Tensor,
    tan_fovx: float,
    tan_fovy: float,
    width: int,
    height: int,
    sh_degree: int = 0,
    shs: Optional[torch.Tensor] = None,
    colors_precomp: Optional[torch.Tensor] = None,
    scales: Optional[torch.Tensor] = None,
    rotations: Optional[torch.Tensor] = None,
    cov3d_precomp: Optional[torch.Tensor] = None,
    scaling_modifier: float = 1.0,
    mask: Optional[torch.Tensor] = None,
) -> Preprocessed:
    """Project N Gaussians into a camera. `scales`/`rotations` are the
    activated values (exp / normalised); `shs` is [N, K, 3]. Give `shs` or
    `colors_precomp` [N, 3], and `scales` with `rotations` or
    `cov3d_precomp` [N, 6] (JAX's argument order)."""
    if (shs is None) == (colors_precomp is None):
        raise ValueError("give exactly one of shs and colors_precomp")
    if (cov3d_precomp is None) == (scales is None or rotations is None):
        raise ValueError("give exactly one of (scales, rotations) and cov3d_precomp")
    n = means3d.shape[0]
    # focal lengths in float32, as the JAX camera computes them on device
    focal_x = float(np.float32(width) / (np.float32(2.0) * np.float32(tan_fovx)))
    focal_y = float(np.float32(height) / (np.float32(2.0) * np.float32(tan_fovy)))

    x, y, z = means3d[:, 0], means3d[:, 1], means3d[:, 2]
    V = view_transform  # transposed storage: p_view = p_hom @ V
    vx = x * V[0, 0] + y * V[1, 0] + z * V[2, 0] + V[3, 0]
    vy = x * V[0, 1] + y * V[1, 1] + z * V[2, 1] + V[3, 1]
    vz = x * V[0, 2] + y * V[1, 2] + z * V[2, 2] + V[3, 2]
    depths = vz

    Pm = full_proj_transform
    cx = x * Pm[0, 0] + y * Pm[1, 0] + z * Pm[2, 0] + Pm[3, 0]
    cy = x * Pm[0, 1] + y * Pm[1, 1] + z * Pm[2, 1] + Pm[3, 1]
    cw = x * Pm[0, 3] + y * Pm[1, 3] + z * Pm[2, 3] + Pm[3, 3]
    near_ok = depths > NEAR_CULL_Z
    one = torch.ones_like(cw)
    p_w = 1.0 / (torch.where(near_ok, cw, one) + 1e-7)
    mean_x = ((cx * p_w + 1.0) * width - 1.0) * 0.5
    mean_y = ((cy * p_w + 1.0) * height - 1.0) * 0.5
    means2d = torch.stack([mean_x, mean_y], dim=1)

    # 3D covariance Sigma = R S S^T R^T, componentwise.
    if cov3d_precomp is not None:
        sxx, sxy, sxz, syy, syz, szz = (cov3d_precomp[:, i] for i in range(6))
    else:
        qw, qx, qy, qz = (rotations[:, i] for i in range(4))
        sx, sy, sz = (scaling_modifier * scales[:, i] for i in range(3))
        r00 = 1.0 - 2.0 * (qy * qy + qz * qz)
        r01 = 2.0 * (qx * qy - qw * qz)
        r02 = 2.0 * (qx * qz + qw * qy)
        r10 = 2.0 * (qx * qy + qw * qz)
        r11 = 1.0 - 2.0 * (qx * qx + qz * qz)
        r12 = 2.0 * (qy * qz - qw * qx)
        r20 = 2.0 * (qx * qz - qw * qy)
        r21 = 2.0 * (qy * qz + qw * qx)
        r22 = 1.0 - 2.0 * (qx * qx + qy * qy)
        l00, l01, l02 = r00 * sx, r01 * sy, r02 * sz
        l10, l11, l12 = r10 * sx, r11 * sy, r12 * sz
        l20, l21, l22 = r20 * sx, r21 * sy, r22 * sz
        sxx = l00 * l00 + l01 * l01 + l02 * l02
        sxy = l00 * l10 + l01 * l11 + l02 * l12
        sxz = l00 * l20 + l01 * l21 + l02 * l22
        syy = l10 * l10 + l11 * l11 + l12 * l12
        syz = l10 * l20 + l11 * l21 + l12 * l22
        szz = l20 * l20 + l21 * l21 + l22 * l22

    # EWA projection: clamp view x/y to the dilated frustum.
    tz = torch.where(near_ok, depths, one)
    inv_z = 1.0 / tz
    lim_x = float(np.float32(1.3) * np.float32(tan_fovx))
    lim_y = float(np.float32(1.3) * np.float32(tan_fovy))
    tx = torch.clamp(vx * inv_z, -lim_x, lim_x) * tz
    ty = torch.clamp(vy * inv_z, -lim_y, lim_y) * tz
    inv_z2 = inv_z * inv_z

    j00 = focal_x * inv_z
    j02 = -focal_x * tx * inv_z2
    j11 = focal_y * inv_z
    j12 = -focal_y * ty * inv_z2
    # W[r][c] = V[c, r]; M = J W, cov2d = M Sigma M^T
    m00 = j00 * V[0, 0] + j02 * V[0, 2]
    m01 = j00 * V[1, 0] + j02 * V[1, 2]
    m02 = j00 * V[2, 0] + j02 * V[2, 2]
    m10 = j11 * V[0, 1] + j12 * V[0, 2]
    m11 = j11 * V[1, 1] + j12 * V[1, 2]
    m12 = j11 * V[2, 1] + j12 * V[2, 2]
    t00 = m00 * sxx + m01 * sxy + m02 * sxz
    t01 = m00 * sxy + m01 * syy + m02 * syz
    t02 = m00 * sxz + m01 * syz + m02 * szz
    t10 = m10 * sxx + m11 * sxy + m12 * sxz
    t11 = m10 * sxy + m11 * syy + m12 * syz
    t12 = m10 * sxz + m11 * syz + m12 * szz
    cxx = t00 * m00 + t01 * m01 + t02 * m02 + COV2D_DILATION
    cxy = t00 * m10 + t01 * m11 + t02 * m12
    cyy = t10 * m10 + t11 * m11 + t12 * m12 + COV2D_DILATION

    det = cxx * cyy - cxy * cxy
    det_safe = torch.where(det == 0.0, torch.ones_like(det), det)
    conics = torch.stack([cyy / det_safe, -cxy / det_safe, cxx / det_safe], dim=1)

    # Integer outputs only from here to the colours: no gradient.
    cxx, cyy, det = cxx.detach(), cyy.detach(), det.detach()
    mid = 0.5 * (cxx + cyy)
    lambda1 = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    radius_f = torch.ceil(3.0 * torch.sqrt(torch.clamp_min(lambda1, 0.0)))

    # Tight extents: a pixel contributes iff opa * exp(power) >= 1/255,
    # i.e. it lies in the ellipse q^T Sigma2D^-1 q <= 2 tau with
    # tau = ln(255 min(opa, 0.99)); AABB half-extents sqrt(2 tau Sigma_ii),
    # intersected with the 3-sigma box, +1 pixel for jitter and rounding.
    opa = opacities.reshape(n)
    opa_d = opa.detach()
    tau = torch.clamp_min(torch.log(255.0 * torch.clamp(opa_d, 0.0, 0.99)), 0.0)
    no_pix = opa_d * 255.0 <= 1.0
    zero = torch.zeros_like(radius_f)
    ext_x = torch.minimum(radius_f, torch.ceil(
        torch.sqrt(2.0 * tau * torch.clamp_min(cxx, 0.0)) + 1.0))
    ext_y = torch.minimum(radius_f, torch.ceil(
        torch.sqrt(2.0 * tau * torch.clamp_min(cyy, 0.0)) + 1.0))
    ext_x = torch.where(no_pix, zero, ext_x)
    ext_y = torch.where(no_pix, zero, ext_y)

    valid = near_ok & (det > 0.0)
    if mask is not None:
        valid = valid & mask

    if colors_precomp is not None:
        colors = colors_precomp
    else:
        dx = x - camera_center[0]
        dy = y - camera_center[1]
        dz = z - camera_center[2]
        inv_n = torch.rsqrt(dx * dx + dy * dy + dz * dz + 1e-20)
        dirs = torch.stack([dx * inv_n, dy * inv_n, dz * inv_n], dim=1)
        colors = eval_sh_color(sh_degree, shs.transpose(1, 2), dirs)

    return Preprocessed(
        means2d=means2d,
        depths=depths,
        conics=conics,
        colors=colors,
        opacities=opa,
        radii=torch.where(valid, radius_f, zero).to(torch.int32),
        valid=valid,
        extent_x=torch.where(valid, ext_x, zero).to(torch.int32),
        extent_y=torch.where(valid, ext_y, zero).to(torch.int32),
    )
