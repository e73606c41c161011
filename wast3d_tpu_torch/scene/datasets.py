"""Scene/dataset loading: COLMAP + NeRF-synthetic (Blender) + dispatch.

Port of `wast3d_tpu/scene/datasets.py`: the same COLMAP (binary with text
fallback, llffhold=8 eval split) and Blender readers (OpenGL->COLMAP axis
flip, alpha composite over the background, random 100k-point cube when no
points3d.ply), nerf++ normalisation and resolution policy, with PIL's
pixels and without PIL: every image goes through `utils/image_io.read_image`
(PNG at every depth and colour type, JPEG, BMP, TIFF, WebP, GIF; dispatched
on the file's signature), which gives `np.asarray(PIL.Image.open(path))` bit
for bit. `build_cameras` rounds a ground truth to uint8 and resizes it as
PIL's default `Image.resize` does (bicubic; images with alpha
premultiplied), through the native `png.resize_native`, then divides by
255, as the JAX package does.
"""

from __future__ import annotations

import json
import os
from typing import List, NamedTuple, Optional, Tuple

import numpy as np

from wast3d_tpu_torch.core.camera import (
    Camera, focal2fov, fov2focal, make_camera, world_to_view)
from wast3d_tpu_torch.core.sh import sh_to_rgb
from wast3d_tpu_torch.device import DeviceLike
from wast3d_tpu_torch.scene import colmap as cm
from wast3d_tpu_torch.scene.ply import parse_header
from wast3d_tpu_torch.utils import png
from wast3d_tpu_torch.utils.image_io import read_image


class BasicPointCloud(NamedTuple):
    points: np.ndarray
    colors: np.ndarray
    normals: np.ndarray


class CameraInfo(NamedTuple):
    uid: int
    R: np.ndarray
    T: np.ndarray
    fovx: float
    fovy: float
    image: "np.ndarray"  # [H,W,3] float32 in [0,1]
    image_name: str
    width: int
    height: int


class SceneInfo(NamedTuple):
    point_cloud: Optional[BasicPointCloud]
    train_cameras: List[CameraInfo]
    test_cameras: List[CameraInfo]
    nerf_normalization: dict
    ply_path: str


def nerfpp_norm(cam_infos: List[CameraInfo]) -> dict:
    """translate = -mean(camera centres); radius = 1.1 * max distance."""
    centers = np.stack(
        [np.linalg.inv(world_to_view(c.R, c.T))[:3, 3] for c in cam_infos], axis=0)
    avg = centers.mean(axis=0)
    diagonal = np.linalg.norm(centers - avg, axis=1).max()
    return {"translate": -avg, "radius": float(diagonal * 1.1)}


def _load_image(path: str) -> np.ndarray:
    return np.asarray(read_image(path), dtype=np.float32) / 255.0


def fetch_ply_points(path: str) -> BasicPointCloud:
    """Read an xyz/rgb/normal points PLY."""
    with open(path, "rb") as f:
        blob = f.read()
    n, props, offset = parse_header(blob)
    rec = np.frombuffer(blob, dtype=np.dtype(props), count=n, offset=offset)
    pts = np.stack([rec["x"], rec["y"], rec["z"]], axis=1).astype(np.float64)
    if "red" in rec.dtype.names:
        colors = np.stack([rec["red"], rec["green"], rec["blue"]], axis=1) / 255.0
    else:
        colors = np.ones_like(pts) * 0.5
    if "nx" in rec.dtype.names:
        normals = np.stack([rec["nx"], rec["ny"], rec["nz"]], axis=1)
    else:
        normals = np.zeros_like(pts)
    return BasicPointCloud(points=pts, colors=colors, normals=normals)


def store_ply_points(path: str, xyz: np.ndarray, rgb: np.ndarray) -> None:
    """Write an xyz/normal/rgb points PLY."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    n = len(xyz)
    header = [
        "ply", "format binary_little_endian 1.0", f"element vertex {n}",
        "property float x", "property float y", "property float z",
        "property float nx", "property float ny", "property float nz",
        "property uchar red", "property uchar green", "property uchar blue",
        "end_header",
    ]
    rec = np.empty(n, dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                             ("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4"),
                             ("red", "u1"), ("green", "u1"), ("blue", "u1")])
    rec["x"], rec["y"], rec["z"] = xyz.T.astype(np.float32)
    rec["nx"] = rec["ny"] = rec["nz"] = 0
    rec["red"], rec["green"], rec["blue"] = rgb.T.astype(np.uint8)
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(rec.tobytes())


def read_colmap_scene(path: str, images_dir: str = "images",
                      eval_split: bool = False, llffhold: int = 8) -> SceneInfo:
    sparse = os.path.join(path, "sparse", "0")
    try:
        cams = cm.read_cameras_binary(os.path.join(sparse, "cameras.bin"))
        imgs = cm.read_images_binary(os.path.join(sparse, "images.bin"))
    except FileNotFoundError:
        cams = cm.read_cameras_text(os.path.join(sparse, "cameras.txt"))
        imgs = cm.read_images_text(os.path.join(sparse, "images.txt"))

    cam_infos = []
    folder = os.path.join(path, images_dir)
    for key in sorted(imgs.keys(), key=lambda k: imgs[k].name):
        extr = imgs[key]
        intr = cams[extr.camera_id]
        if intr.model == "SIMPLE_PINHOLE":
            fovx = focal2fov(intr.params[0], intr.width)
            fovy = focal2fov(intr.params[0], intr.height)
        elif intr.model == "PINHOLE":
            fovx = focal2fov(intr.params[0], intr.width)
            fovy = focal2fov(intr.params[1], intr.height)
        else:
            raise ValueError(
                f"COLMAP model {intr.model} unsupported: undistort first "
                "(only PINHOLE / SIMPLE_PINHOLE)")
        R = cm.qvec2rotmat(extr.qvec).T  # stored transposed like the reference
        T = np.array(extr.tvec)
        img_path = os.path.join(folder, os.path.basename(extr.name))
        image = _load_image(img_path) if os.path.exists(img_path) else None
        cam_infos.append(CameraInfo(
            uid=intr.id, R=R, T=T, fovx=fovx, fovy=fovy, image=image,
            image_name=os.path.splitext(os.path.basename(extr.name))[0],
            width=intr.width, height=intr.height))

    if eval_split:
        train = [c for i, c in enumerate(cam_infos) if i % llffhold != 0]
        test = [c for i, c in enumerate(cam_infos) if i % llffhold == 0]
    else:
        train, test = cam_infos, []
    norm = nerfpp_norm(train)

    ply_path = os.path.join(sparse, "points3D.ply")
    if not os.path.exists(ply_path):
        try:
            xyz, rgb, _ = cm.read_points3d_binary(os.path.join(sparse, "points3D.bin"))
        except FileNotFoundError:
            xyz, rgb, _ = cm.read_points3d_text(os.path.join(sparse, "points3D.txt"))
        store_ply_points(ply_path, xyz, rgb)
    return SceneInfo(fetch_ply_points(ply_path), train, test, norm, ply_path)


def read_blender_scene(path: str, white_background: bool = False,
                       eval_split: bool = False,
                       extension: str = ".png") -> SceneInfo:
    def read_transforms(fname):
        infos = []
        with open(os.path.join(path, fname)) as f:
            contents = json.load(f)
        fovx = contents["camera_angle_x"]
        for idx, frame in enumerate(contents["frames"]):
            img_path = os.path.join(path, frame["file_path"] + extension)
            c2w = np.array(frame["transform_matrix"], dtype=np.float64)
            c2w[:3, 1:3] *= -1  # OpenGL -> COLMAP axes
            w2c = np.linalg.inv(c2w)
            rgba = _load_image(img_path)
            if rgba.ndim == 2:
                rgba = np.stack([rgba] * 3 + [np.ones_like(rgba)], axis=-1)
            if rgba.shape[-1] == 3:
                rgba = np.concatenate([rgba, np.ones_like(rgba[..., :1])], -1)
            bg = np.ones(3) if white_background else np.zeros(3)
            rgb = rgba[..., :3] * rgba[..., 3:4] + bg * (1 - rgba[..., 3:4])
            h, w = rgb.shape[:2]
            infos.append(CameraInfo(
                uid=idx, R=w2c[:3, :3].T, T=w2c[:3, 3], fovx=fovx,
                fovy=focal2fov(fov2focal(fovx, w), h),
                image=rgb.astype(np.float32),
                image_name=os.path.splitext(os.path.basename(img_path))[0],
                width=w, height=h))
        return infos

    train = read_transforms("transforms_train.json")
    test_path = os.path.join(path, "transforms_test.json")
    test = read_transforms("transforms_test.json") if os.path.exists(test_path) else []
    if not eval_split:
        train, test = train + test, []
    norm = nerfpp_norm(train)

    ply_path = os.path.join(path, "points3d.ply")
    if not os.path.exists(ply_path):
        num_pts = 100_000
        xyz = np.random.random((num_pts, 3)) * 2.6 - 1.3
        shs = np.random.random((num_pts, 3)) / 255.0
        store_ply_points(ply_path, xyz, sh_to_rgb(shs) * 255)
    return SceneInfo(fetch_ply_points(ply_path), train, test, norm, ply_path)


def load_scene_info(path: str, images: str = "images",
                    white_background: bool = False,
                    eval_split: bool = False) -> SceneInfo:
    if os.path.exists(os.path.join(path, "sparse")):
        return read_colmap_scene(path, images, eval_split)
    if os.path.exists(os.path.join(path, "transforms_train.json")):
        return read_blender_scene(path, white_background, eval_split)
    raise ValueError(f"Could not recognize scene type at {path}")


def _resolve_resolution(width: int, height: int, resolution: int) -> Tuple[int, int]:
    """-1 keeps native size but caps width at 1600; >0 divides."""
    if resolution in (-1, 1):
        if resolution == -1 and width > 1600:
            scale = width / 1600.0
            return round(width / scale), round(height / scale)
        return width, height
    return round(width / resolution), round(height / resolution)


def build_cameras(
    infos: List[CameraInfo],
    resolution: int = -1,
    translate: Optional[np.ndarray] = None,
    scale: float = 1.0,
    device: DeviceLike = None,
) -> List[Tuple[Camera, Optional[np.ndarray]]]:
    """CameraInfo -> (Camera on `device`, ground-truth image [H,W,3] float32
    in [0,1] on the host, or None)."""
    out = []
    for info in infos:
        w, h = _resolve_resolution(info.width, info.height, resolution)
        img = info.image
        if img is not None and (img.shape[1] != w or img.shape[0] != h):
            q = (np.clip(img, 0, 1) * 255).astype(np.uint8)
            img = np.asarray(png.resize_native(q, w, h), dtype=np.float32) / 255.0
        cam = make_camera(
            R=info.R, t=info.T, fovx=info.fovx, fovy=info.fovy, width=w, height=h,
            translate=translate if translate is not None else np.zeros(3),
            scale=scale, device=device)
        gt = None if img is None else np.clip(np.asarray(img, np.float32), 0.0, 1.0)
        out.append((cam, gt))
    return out
