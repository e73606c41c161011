"""Camera paths: keyframe loading, spiral orbits, and frame rendering.

Port of `wast3d_tpu/eval/camera_path.py`: nerfstudio-style keyframe paths
(the reference's `scripts/camera_path_{hotdog,sphere}.json`) interpolated
per segment, the spiral orbit of the nerfstudio dataset readers, and
numbered PNG frames rendered through `api.render` (assembling a video is a
host ffmpeg concern). Cameras are the port's `Camera`s, which carry no
`uid`; frames are numbered by their place in the list.
"""

from __future__ import annotations

import json
import math
import os
from typing import List, Optional

import numpy as np
import torch

from wast3d_tpu_torch.core.camera import Camera, look_at_camera, make_camera
from wast3d_tpu_torch.device import DeviceLike, resolve_device


def _c2w_to_camera(c2w: np.ndarray, fov_deg: float, width: int, height: int,
                   device: DeviceLike = None) -> Camera:
    """A column-major nerfstudio keyframe matrix (OpenGL-style: the camera
    looks along -z, y up) as a Camera, flipped to the COLMAP convention as
    the Blender loader does."""
    c2w = c2w.copy()
    c2w[:3, 1:3] *= -1
    w2c = np.linalg.inv(c2w)
    fov = math.radians(fov_deg)
    return make_camera(R=w2c[:3, :3].T, t=w2c[:3, 3], fovx=fov, fovy=fov, width=width,
                       height=height, device=device)


def load_camera_path(path: str, width: int = 800, height: int = 800,
                     frames_per_segment: int = 24,
                     device: DeviceLike = None) -> List[Camera]:
    """Load a keyframe JSON and interpolate `frames_per_segment` cameras
    per segment (linear position, rotation block projected back onto the
    rotations by SVD), ending on the last keyframe."""
    with open(path) as f:
        data = json.load(f)
    keyframes, fovs = [], []
    for kf in data["keyframes"]:
        keyframes.append(np.array(json.loads(kf["matrix"]), dtype=np.float64).reshape(4, 4).T)
        fovs.append(float(kf.get("fov", 50.0)))
    cams = []
    for i in range(len(keyframes) - 1):
        a, b = keyframes[i], keyframes[i + 1]
        for t in np.linspace(0, 1, frames_per_segment, endpoint=False):
            m = (1 - t) * a + t * b
            u, _, vt = np.linalg.svd(m[:3, :3])
            m[:3, :3] = u @ vt
            fov = (1 - t) * fovs[i] + t * fovs[i + 1]
            cams.append(_c2w_to_camera(m, fov, width, height, device))
    cams.append(_c2w_to_camera(keyframes[-1], fovs[-1], width, height, device))
    return cams


def spiral_path(center: np.ndarray, radius: float, height_offset: float,
                num_frames: int = 120, fov: float = 0.8, width: int = 800,
                height: int = 800, revolutions: float = 2.0,
                device: DeviceLike = None) -> List[Camera]:
    """A spiral orbit around `center` (the LLFF / DTU spiral of the
    nerfstudio readers): `revolutions` turns at `radius`, rising and falling
    by `height_offset` once over the path."""
    cams = []
    for i in range(num_frames):
        t = i / num_frames
        ang = 2 * math.pi * revolutions * t
        eye = np.asarray(center, np.float64) + np.array([
            radius * math.cos(ang),
            height_offset * math.sin(2 * math.pi * t),
            radius * math.sin(ang),
        ])
        cams.append(look_at_camera(eye=eye, target=center, up=[0, -1, 0], fovx=fov,
                                   fovy=fov, width=width, height=height, device=device))
    return cams


def render_path(scene, cameras: List[Camera], out_dir: str, bg_color=None,
                settings=None, save_depth: bool = False,
                device: DeviceLike = None) -> List[str]:
    """Render a camera path to numbered PNGs (`00000.png`, ...; with
    `save_depth` also `00000_depth.png`, depth scaled to [0, 1] per frame)
    on `device` (None means CUDA). The default settings are
    `RasterizeSettings()`: K1, the f32 tier, as JAX's default renderer is
    its f32 `tiled` path. Returns the frames' paths."""
    from wast3d_tpu_torch.eval.render_sets import save_image
    from wast3d_tpu_torch.ops.rasterizer import api

    dev = resolve_device(device)
    bg = torch.zeros(3) if bg_color is None else torch.as_tensor(bg_color, dtype=torch.float32)
    settings = settings or api.RasterizeSettings()
    scene = scene.to(dev)
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    with torch.no_grad():
        for i, cam in enumerate(cameras):
            out = api.render(cam, scene, bg, settings=settings, device=dev)
            p = os.path.join(out_dir, f"{i:05d}.png")
            save_image(p, out["render"].cpu().numpy())
            paths.append(p)
            if save_depth:
                d = out["depth"].cpu().numpy()
                dn = (d - d.min()) / (np.ptp(d) + 1e-9)
                save_image(os.path.join(out_dir, f"{i:05d}_depth.png"), np.stack([dn] * 3, -1))
    return paths
