"""COLMAP sparse-reconstruction parsers (binary + text), pure numpy.

Copy of `wast3d_tpu/scene/colmap.py` (the port imports nothing of the JAX
package), readers only and without its native C++ fast path:
cameras.bin/.txt, images.bin/.txt, points3D.bin/.txt.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, NamedTuple

import numpy as np

# COLMAP camera models: id -> (name, num_params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}


class ColmapCamera(NamedTuple):
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


class ColmapImage(NamedTuple):
    id: int
    qvec: np.ndarray  # [4] (w,x,y,z)
    tvec: np.ndarray  # [3]
    camera_id: int
    name: str


def qvec2rotmat(qvec: np.ndarray) -> np.ndarray:
    """COLMAP (w,x,y,z) quaternion -> rotation matrix."""
    w, x, y, z = qvec
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def _read(f, fmt):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, f.read(size))


def read_cameras_binary(path: str) -> Dict[int, ColmapCamera]:
    cams = {}
    with open(path, "rb") as f:
        (num,) = _read(f, "<Q")
        for _ in range(num):
            cam_id, model_id, w, h = _read(f, "<iiQQ")
            name, n_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, f"<{n_params}d"))
            cams[cam_id] = ColmapCamera(cam_id, name, int(w), int(h), params)
    return cams


def read_images_binary(path: str) -> Dict[int, ColmapImage]:
    imgs = {}
    with open(path, "rb") as f:
        (num,) = _read(f, "<Q")
        for _ in range(num):
            img_id = _read(f, "<i")[0]
            qvec = np.array(_read(f, "<4d"))
            tvec = np.array(_read(f, "<3d"))
            cam_id = _read(f, "<i")[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (n_pts,) = _read(f, "<Q")
            f.seek(24 * n_pts, os.SEEK_CUR)  # skip 2D points (x,y f64 + id i64)
            imgs[img_id] = ColmapImage(img_id, qvec, tvec, cam_id, name.decode("utf-8"))
    return imgs


def read_points3d_binary(path: str):
    """Returns (xyz [N,3] f64, rgb [N,3] u8, error [N])."""
    with open(path, "rb") as f:
        (num,) = _read(f, "<Q")
        xyz = np.empty((num, 3))
        rgb = np.empty((num, 3), np.uint8)
        err = np.empty(num)
        for i in range(num):
            _id = _read(f, "<Q")[0]
            xyz[i] = _read(f, "<3d")
            rgb[i] = _read(f, "<3B")
            err[i] = _read(f, "<d")[0]
            (track_len,) = _read(f, "<Q")
            f.seek(8 * track_len, os.SEEK_CUR)
    return xyz, rgb, err


def read_cameras_text(path: str) -> Dict[int, ColmapCamera]:
    cams = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            cam_id = int(parts[0])
            model = parts[1]
            w, h = int(parts[2]), int(parts[3])
            params = np.array([float(p) for p in parts[4:]])
            cams[cam_id] = ColmapCamera(cam_id, model, w, h, params)
    return cams


def read_images_text(path: str) -> Dict[int, ColmapImage]:
    imgs = {}
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip() and not ln.startswith("#")]
    # Two lines per image: meta line + 2D points line.
    for meta in lines[::2]:
        parts = meta.split()
        img_id = int(parts[0])
        qvec = np.array([float(x) for x in parts[1:5]])
        tvec = np.array([float(x) for x in parts[5:8]])
        cam_id = int(parts[8])
        name = parts[9]
        imgs[img_id] = ColmapImage(img_id, qvec, tvec, cam_id, name)
    return imgs


def read_points3d_text(path: str):
    xyzs, rgbs, errs = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            xyzs.append([float(x) for x in parts[1:4]])
            rgbs.append([int(x) for x in parts[4:7]])
            errs.append(float(parts[7]))
    return (
        np.array(xyzs, np.float64),
        np.array(rgbs, np.uint8),
        np.array(errs, np.float64),
    )
