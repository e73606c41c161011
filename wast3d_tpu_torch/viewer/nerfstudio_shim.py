"""nerfstudio drop-in Model shim.

Port of `wast3d_tpu/viewer/nerfstudio_shim.py`: a trained WaSt3D / 3DGS
point cloud rendered inside the nerfstudio viewer. The standalone parts are
`ns_c2w_to_camera` (nerfstudio camera to the port's `Camera`),
`camera_intrinsics`, `depth_to_normals` (in torch, with JAX's central
differences and orientation) and `render_viewer_outputs` (the output dict
of `get_outputs_for_camera_ray_bundle`: clamped rgb, inverse depth, the
normals image), which renders through K1 by default. `make_model_classes()`
imports nerfstudio and builds the `ModelConfig` / `Model` subclasses around
them; without nerfstudio (the card's machine has none) it raises JAX's
ImportError.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from wast3d_tpu_torch.core.camera import Camera, focal2fov, make_camera
from wast3d_tpu_torch.device import DeviceLike
from wast3d_tpu_torch.ops.rasterizer import api
from wast3d_tpu_torch.train.checkpoint import find_max_iteration


def ns_c2w_to_camera(
    c2w: np.ndarray,
    fx: float,
    fy: float,
    width: int,
    height: int,
    orientation_transform: np.ndarray | None = None,
    device: DeviceLike = None,
) -> Camera:
    """nerfstudio camera -> rasterizer camera on `device`: pad c2w to 4x4,
    optional reorient, flip the OpenGL y/z columns to COLMAP, invert, store
    R transposed."""
    c2w = np.concatenate([np.asarray(c2w, np.float64), np.array([[0, 0, 0, 1.0]])], axis=0)
    if orientation_transform is not None:
        c2w = np.asarray(orientation_transform, np.float64) @ c2w
    c2w[:3, 1:3] *= -1
    w2c = np.linalg.inv(c2w)
    R = np.transpose(w2c[:3, :3])
    T = w2c[:3, 3]
    return make_camera(
        R=R.astype(np.float32),
        t=T.astype(np.float32),
        fovx=focal2fov(fx, width),
        fovy=focal2fov(fy, height),
        width=int(width),
        height=int(height),
        device=device,
    )


def camera_intrinsics(camera: Camera) -> torch.Tensor:
    """Pinhole K [3, 3] float32 on the camera's device."""
    fx = 0.5 * camera.width / np.tan(0.5 * float(camera.fovx))
    fy = 0.5 * camera.height / np.tan(0.5 * float(camera.fovy))
    return torch.tensor([[fx, 0, 0.5 * camera.width],
                         [0, fy, 0.5 * camera.height],
                         [0, 0, 1.0]], dtype=torch.float32, device=camera.device)


def _central(p: torch.Tensor, dim: int) -> torch.Tensor:
    """Central differences along `dim`, one-sided at the edges (the edge
    sample repeated), halved."""
    n = p.shape[dim]
    dev = p.device
    lead = torch.index_select(p, dim, torch.cat([torch.arange(1, n, device=dev),
                                                 torch.tensor([n - 1], device=dev)]))
    lag = torch.index_select(p, dim, torch.cat([torch.tensor([0], device=dev),
                                                torch.arange(0, n - 1, device=dev)]))
    return 0.5 * (lead - lag)


def depth_to_normals(depth: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Normals from a depth map: unproject to camera-space points,
    central-difference the point grid, normalise the cross product, turn it
    toward the camera (-z). Returns [H, W, 3] unit normals."""
    H, W = depth.shape
    uu = torch.arange(W, dtype=torch.float32, device=depth.device)[None, :]
    vv = torch.arange(H, dtype=torch.float32, device=depth.device)[:, None]
    x = (uu - K[0, 2]) / K[0, 0] * depth
    y = (vv - K[1, 2]) / K[1, 1] * depth
    pts = torch.stack([x, y, depth], dim=-1)
    n = torch.linalg.cross(_central(pts, 1), _central(pts, 0))
    n = torch.where(n[..., 2:3] > 0, -n, n)
    return n / (torch.linalg.norm(n, dim=-1, keepdim=True) + 1e-12)


def render_viewer_outputs(scene, camera: Camera, bg_color,
                          settings: api.RasterizeSettings | None = None,
                          device: DeviceLike = None) -> dict:
    """The viewer's output dict on `device`: clamped rgb as "rgb1", inverse
    depth (near-plane clamp depth < 2 -> 1e10 first) as "depth" [H, W, 1],
    and the normals-from-depth image as "rgb"."""
    settings = settings or api.RasterizeSettings(renderer="pallas")
    out = api.render(camera, scene, torch.as_tensor(bg_color, dtype=torch.float32),
                     settings=settings, device=device)
    depth = out["depth"]
    K = camera_intrinsics(camera.to(depth.device))
    normal_vis = (depth_to_normals(depth, K) + 1.0) / 2.0
    depth = torch.where(depth < 2.0, torch.full_like(depth, 1e10), depth)
    return {
        "rgb1": torch.clamp(out["render"], max=1.0),
        "depth": (1.0 / depth)[..., None],
        "rgb": normal_vis,
    }


def make_model_classes():
    """Build (WaSt3DSplattingModelConfig, WaSt3DSplattingModel) against an
    installed nerfstudio; raises ImportError with install guidance when
    nerfstudio is missing."""
    try:
        from dataclasses import dataclass, field
        from typing import Type

        from nerfstudio.models.base_model import Model, ModelConfig
    except ImportError as e:
        raise ImportError(
            "nerfstudio is required for the viewer Model shim: "
            "pip install nerfstudio, then call make_model_classes() again. "
            "The conversion/rendering math it wraps (ns_c2w_to_camera, "
            "render_viewer_outputs) works without it."
        ) from e

    from wast3d_tpu_torch.scene.ply import load_ply

    @dataclass
    class WaSt3DSplattingModelConfig(ModelConfig):
        _target: Type = field(default_factory=lambda: WaSt3DSplattingModel)
        background_color: str = "black"
        sh_degree: int = 3

    class WaSt3DSplattingModel(Model):
        """nerfstudio Model serving a trained WaSt3D point cloud through
        the port's rasterizer on the ray bundle's device."""

        def __init__(self, config, scene_box, num_train_data, model_path=None,
                     load_iteration=-1, orientation_transform=None, **kwargs):
            self.model_path = model_path
            self.load_iteration = load_iteration
            self.orientation_transform = (None if orientation_transform is None
                                          else np.asarray(orientation_transform))
            self.bg_color = ([0.0, 0.0, 0.0] if config.background_color == "black"
                             else [1.0, 1.0, 1.0])
            super().__init__(config, scene_box, num_train_data, **kwargs)

        def populate_modules(self):
            super().populate_modules()
            if self.load_iteration == -1:
                self.load_iteration = find_max_iteration(self.model_path)
            self.gaussian_scene = load_ply(
                os.path.join(self.model_path, "point_cloud",
                             f"iteration_{self.load_iteration}", "point_cloud.ply"),
                max_sh_degree=self.config.sh_degree, device="cpu")

        @torch.no_grad()
        def get_outputs_for_camera_ray_bundle(self, camera_ray_bundle):
            ns_cam = camera_ray_bundle.camera
            dev = camera_ray_bundle.origins.device
            cam = ns_c2w_to_camera(
                ns_cam.camera_to_worlds.cpu().numpy(), float(ns_cam.fx), float(ns_cam.fy),
                int(ns_cam.width), int(ns_cam.height),
                orientation_transform=self.orientation_transform, device=dev)
            self.gaussian_scene = self.gaussian_scene.to(dev)  # once, then kept there
            return render_viewer_outputs(self.gaussian_scene, cam, self.bg_color, device=dev)

    return WaSt3DSplattingModelConfig, WaSt3DSplattingModel
