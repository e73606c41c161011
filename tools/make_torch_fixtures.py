#!/usr/bin/env python3
"""Write the port's committed test fixtures under `tests/torch_fixtures/`.

    python3 tools/make_torch_fixtures.py

Needs PIL (it writes the JPEGs and records PIL's decode of each), so it runs
where the tests run, not on the card. It writes, from seeds:

- `colmap_jpeg/`: a COLMAP scene of 6 views at 200x150 around a procedural
  scene of coloured Gaussians; `images/view_<i>.jpg` (quality 90, PIL's
  default 4:2:0) are renders of that scene by the port's plain renderer on
  the CPU, and `sparse/0/{cameras,images,points3D}.bin` come from the port's
  COLMAP writers (PINHOLE cameras; points: the Gaussians' centres and
  colours, jittered);
- `jpeg/`: a 1296x832 render (the size of a 360-scene `images_4` view) at
  quality 85, 4:2:0, and a 250x131 crop at quality 95, 4:4:4;
- `pil_decode/<name>.png`: PIL's decode of every JPEG above, for the card,
  which has no PIL.
"""

from __future__ import annotations

import io
import os
import shutil
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "torch_fixtures")
VIEWS, W, H = 6, 200, 150
FOCAL = 180.0


def procedural_scene(n=3000, seed=7):
    from wast3d_tpu_torch.core.sh import rgb_to_sh
    from wast3d_tpu_torch.scene.gaussians import from_arrays

    rng = np.random.default_rng(seed)
    xyz = rng.normal(size=(n, 3)) * np.array([0.8, 0.5, 0.8])
    rgb = 0.5 + 0.4 * np.stack([np.sin(2 * xyz[:, 0]), np.cos(3 * xyz[:, 1]),
                                np.sin(xyz[:, 2] + 1)], 1)
    return from_arrays(
        xyz=xyz, features_dc=rgb_to_sh(rgb.astype(np.float32))[:, None, :],
        features_rest=np.zeros((n, 15, 3), np.float32),
        scaling=np.log(rng.uniform(0.02, 0.08, (n, 3))),
        rotation=np.tile([[1.0, 0, 0, 0]], (n, 1)),
        opacity=np.log(0.8 / 0.2) * np.ones((n, 1)), device="cpu"), xyz, rgb


def rotmat2qvec(R):
    """COLMAP's rotmat2qvec: (w, x, y, z) with w >= 0."""
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = R.flat
    K = np.array([[Rxx - Ryy - Rzz, 0, 0, 0],
                  [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
                  [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
                  [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz]]) / 3.0
    vals, vecs = np.linalg.eigh(K)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    return -q if q[0] < 0 else q


def look_at(eye):
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(fwd, [0.0, -1.0, 0.0])
    right /= np.linalg.norm(right)
    return np.stack([right, np.cross(fwd, right), fwd])  # world -> camera rows


def render(scene, R_wc, t, w, h, focal):
    from wast3d_tpu_torch.core.camera import focal2fov, make_camera
    from wast3d_tpu_torch.ops.rasterizer import api

    cam = make_camera(R=R_wc.T, t=t, fovx=focal2fov(focal, w), fovy=focal2fov(focal, h),
                      width=w, height=h, device="cpu")
    with torch.no_grad():
        out = api.render(cam, scene, torch.tensor([0.1, 0.1, 0.15]), device="cpu",
                         settings=api.RasterizeSettings(renderer="tiled"))
    return (np.clip(out["render"].numpy(), 0, 1) * 255 + 0.5).astype(np.uint8)


def save_jpeg(path, img, decodes, **kw):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kw)
    with open(path, "wb") as f:
        f.write(buf.getvalue())
    name = os.path.splitext(os.path.basename(path))[0]
    write_png_up(os.path.join(decodes, name + ".png"), np.asarray(Image.open(path)))


def write_png_up(path, img):
    """An 8-bit RGB or grey PNG whose rows all use the Up filter (type 2),
    at zlib level 9: about half the bytes of `utils/png.write_png`'s
    unfiltered rows on these images, and `utils/png.read_png` undoes it a
    whole row at a time (it walks Paeth rows, which PIL's encoder picks,
    pixel by pixel)."""
    import struct
    import zlib

    img = img if img.ndim == 3 else img[:, :, None]
    h, w, c = img.shape
    rows = img.reshape(h, w * c).astype(np.int16)
    up = (rows - np.concatenate([np.zeros((1, w * c), np.int16), rows[:-1]])) & 0xFF
    raw = np.concatenate([np.full((h, 1), 2, np.uint8), up.astype(np.uint8)], axis=1)

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, {1: 0, 3: 2}[c], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(raw.tobytes(), 9)) + chunk(b"IEND", b""))


def main() -> int:
    from wast3d_tpu_torch.scene import colmap as cm

    shutil.rmtree(OUT, ignore_errors=True)
    src = os.path.join(OUT, "colmap_jpeg")
    sparse, images = os.path.join(src, "sparse", "0"), os.path.join(src, "images")
    decodes, jpeg = os.path.join(OUT, "pil_decode"), os.path.join(OUT, "jpeg")
    for d in (sparse, images, decodes, jpeg):
        os.makedirs(d)
    scene, xyz, rgb = procedural_scene()
    cams = {1: cm.ColmapCamera(1, "PINHOLE", W, H, np.array([FOCAL, FOCAL, W / 2, H / 2]))}
    imgs = {}
    for i in range(VIEWS):
        a = 2 * np.pi * i / VIEWS
        eye = np.array([3.2 * np.sin(a), -0.6, -3.2 * np.cos(a)])
        R_wc = look_at(eye)
        q = rotmat2qvec(R_wc)
        R_wc = cm.qvec2rotmat(q)  # exactly what the loader rebuilds
        t = -R_wc @ eye
        name = f"view_{i}.jpg"
        imgs[i + 1] = cm.ColmapImage(i + 1, q, t, 1, name)
        save_jpeg(os.path.join(images, name), render(scene, R_wc, t, W, H, FOCAL), decodes,
                  quality=90)
    cm.write_cameras_binary(cams, os.path.join(sparse, "cameras.bin"))
    cm.write_images_binary(imgs, os.path.join(sparse, "images.bin"))
    rng = np.random.default_rng(8)
    keep = rng.permutation(len(xyz))[:2000]
    cm.write_points3d_binary(xyz[keep] + rng.normal(scale=0.02, size=(2000, 3)),
                             np.clip(rgb[keep] * 255, 0, 255).astype(np.uint8),
                             os.path.join(sparse, "points3D.bin"))

    eye = np.array([2.0, -0.8, -2.6])
    R_wc = look_at(eye)
    big = render(scene, R_wc, -R_wc @ eye, 1296, 832, 1100.0)
    save_jpeg(os.path.join(jpeg, "scene_1296x832_420.jpg"), big, decodes, quality=85,
              subsampling=2)
    save_jpeg(os.path.join(jpeg, "crop_250x131_444.jpg"), big[300:431, 500:750], decodes,
              quality=95, subsampling=0)
    total = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(OUT) for f in fs)
    print(f"wrote {OUT}: {total} bytes")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main())
