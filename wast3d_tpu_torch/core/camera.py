"""Camera model: view/projection matrices and the Camera record.

Port of `wast3d_tpu/core/camera.py`. The matrices are built in numpy
float64 exactly as the JAX code builds them, cast to float32, and only then
moved to the device, so both packages see bit-identical matrices. Matrices
are stored *transposed* (row-vector convention):
`p_view = (p_hom @ view_transform)[..., :3]`.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from wast3d_tpu_torch.device import DeviceLike, resolve_device


def fov2focal(fov: float, pixels: float) -> float:
    return pixels / (2.0 * math.tan(fov / 2.0))


def focal2fov(focal: float, pixels: float) -> float:
    return 2.0 * math.atan(pixels / (2.0 * focal))


def world_to_view(
    R: np.ndarray,
    t: np.ndarray,
    translate: np.ndarray = np.zeros(3),
    scale: float = 1.0,
) -> np.ndarray:
    """4x4 world->view matrix (float32). R is the COLMAP-convention rotation
    stored transposed, t the translation; translate/scale re-centre the
    scene (nerf++ normalisation)."""
    Rt = np.zeros((4, 4), dtype=np.float64)
    Rt[:3, :3] = R.T
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    c2w = np.linalg.inv(Rt)
    c2w[:3, 3] = (c2w[:3, 3] + translate) * scale
    return np.linalg.inv(c2w).astype(np.float32)


def projection_matrix(znear: float, zfar: float, fovx: float, fovy: float) -> np.ndarray:
    """OpenGL-style perspective projection with the reference's z row:
    P[2,2] = zfar/(zfar-znear), P[2,3] = -zfar*znear/(zfar-znear)."""
    tan_half_fovy = math.tan(fovy / 2.0)
    tan_half_fovx = math.tan(fovx / 2.0)
    top = tan_half_fovy * znear
    right = tan_half_fovx * znear
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = znear / right
    P[1, 1] = znear / top
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


@dataclasses.dataclass(frozen=True)
class Camera:
    """A render viewpoint. Tensors live on one device; sizes and angles are
    host scalars."""

    view_transform: torch.Tensor  # [4,4] world->view, transposed
    full_proj_transform: torch.Tensor  # [4,4] world->clip, transposed
    camera_center: torch.Tensor  # [3]
    fovx: float
    fovy: float
    znear: float
    zfar: float
    width: int
    height: int

    @property
    def device(self) -> torch.device:
        return self.view_transform.device

    # tan(fov/2) in float32, as the JAX camera computes it on device.
    @property
    def tan_fovx(self) -> float:
        return float(np.tan(np.float32(self.fovx) * np.float32(0.5)))

    @property
    def tan_fovy(self) -> float:
        return float(np.tan(np.float32(self.fovy) * np.float32(0.5)))

    def to(self, device: torch.device) -> "Camera":
        if self.device == torch.device(device):
            return self
        return dataclasses.replace(
            self,
            view_transform=self.view_transform.to(device),
            full_proj_transform=self.full_proj_transform.to(device),
            camera_center=self.camera_center.to(device),
        )


def make_camera(
    R: np.ndarray,
    t: np.ndarray,
    fovx: float,
    fovy: float,
    width: int,
    height: int,
    znear: float = 0.01,
    zfar: float = 100.0,
    translate: np.ndarray = np.zeros(3),
    scale: float = 1.0,
    device: DeviceLike = None,
) -> Camera:
    """Build a Camera: znear/zfar default 0.01/100, transposed matrix
    products, camera centre from the inverse view transform."""
    dev = resolve_device(device)
    w2v = world_to_view(R, t, translate, scale)
    view_t = w2v.T
    proj_t = projection_matrix(znear, zfar, fovx, fovy).T
    full_proj_t = view_t @ proj_t
    cam_center = np.linalg.inv(w2v)[:3, 3].astype(np.float32)
    return Camera(
        view_transform=torch.from_numpy(np.ascontiguousarray(view_t)).to(dev),
        full_proj_transform=torch.from_numpy(np.ascontiguousarray(full_proj_t)).to(dev),
        camera_center=torch.from_numpy(cam_center).to(dev),
        fovx=float(fovx),
        fovy=float(fovy),
        znear=float(znear),
        zfar=float(zfar),
        width=int(width),
        height=int(height),
    )


def look_at_camera(
    eye, target, up, fovx: float, fovy: float, width: int, height: int, **kwargs
) -> Camera:
    """Camera at `eye` whose +z looks at `target` (view-space depth is +z)."""
    eye = np.asarray(eye, dtype=np.float64)
    fwd = np.asarray(target, dtype=np.float64) - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, dtype=np.float64))
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    Rcw = np.stack([right, down, fwd], axis=0)
    t = -Rcw @ eye
    return make_camera(R=Rcw.T, t=t, fovx=fovx, fovy=fovy, width=width,
                       height=height, **kwargs)
