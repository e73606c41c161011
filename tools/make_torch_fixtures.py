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
  which has no PIL;
- progressive twins (PIL's `progressive=True`, the same quality and
  sampling, so the same coefficients): `jpeg/<name>_progressive.jpg` of the
  two JPEGs above (the crop's with restart markers every 3 blocks) and
  `colmap_jpeg/images_progressive/view_<i>.jpg`; PIL decodes each to its
  twin's pixels (checked here), so `pil_decode/<name>.png` is its decode;
- `png/`: an Adam7 RGBA PNG at 67x45 and an all-Paeth RGBA PNG at 200x150
  (`utils/png.encode_png`; PIL does not write either), crops of the render
  with a procedural alpha, and `pil_decode/<name>.png`, PIL's decode of
  each;
- `resize/`: PIL's default resize (bicubic) of the 1296x832 JPEG's decode
  to 648x416 and 432x277, and of a 1700x96 strip (the decode with its first
  404 columns appended, first 96 rows) to 1600x90, the size
  `build_cameras` gives a 1700-wide image at `-r -1`.
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


def save_jpeg(path, img, decodes, progressive=None, twin_kw=None, **kw):
    """A baseline JPEG and PIL's decode of it; with `progressive` (a path),
    its progressive twin too (`twin_kw` added to its options), checked to
    decode to the same pixels."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kw)
    with open(path, "wb") as f:
        f.write(buf.getvalue())
    name = os.path.splitext(os.path.basename(path))[0]
    decoded = np.asarray(Image.open(path))
    write_png_up(os.path.join(decodes, name + ".png"), decoded)
    if progressive:
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "JPEG", progressive=True, **kw, **(twin_kw or {}))
        with open(progressive, "wb") as f:
            f.write(buf.getvalue())
        if not np.array_equal(np.asarray(Image.open(progressive)), decoded):
            raise AssertionError(f"{progressive}: PIL's decode differs from its twin's")
    return decoded


def alpha_channel(h, w):
    """A procedural alpha with 0 and 255 runs and ramps between them."""
    y, x = np.mgrid[0:h, 0:w]
    a = 127.5 + 160 * np.sin(x / 9.0) * np.cos(y / 7.0)
    return np.clip(a, 0, 255).astype(np.uint8)


def write_png_up(path, img):
    """An 8-bit grey, grey+alpha, RGB or RGBA PNG whose rows all use the Up
    filter (type 2), at zlib level 9: about half the bytes of
    `utils/png.write_png`'s unfiltered rows on these images."""
    import struct
    import zlib

    img = img if img.ndim == 3 else img[:, :, None]
    h, w, c = img.shape  # grey, grey+alpha, RGB or RGBA
    rows = img.reshape(h, w * c).astype(np.int16)
    up = (rows - np.concatenate([np.zeros((1, w * c), np.int16), rows[:-1]])) & 0xFF
    raw = np.concatenate([np.full((h, 1), 2, np.uint8), up.astype(np.uint8)], axis=1)

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, {1: 0, 2: 4, 3: 2, 4: 6}[c], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(raw.tobytes(), 9)) + chunk(b"IEND", b""))


def main() -> int:
    from PIL import Image, ImageFile

    from wast3d_tpu_torch.scene import colmap as cm
    from wast3d_tpu_torch.utils.png import encode_png

    ImageFile.MAXBLOCK = 1 << 22  # PIL's progressive encoder needs the room
    shutil.rmtree(OUT, ignore_errors=True)
    src = os.path.join(OUT, "colmap_jpeg")
    sparse, images = os.path.join(src, "sparse", "0"), os.path.join(src, "images")
    progressive = os.path.join(src, "images_progressive")
    decodes, jpeg = os.path.join(OUT, "pil_decode"), os.path.join(OUT, "jpeg")
    pngs, resized = os.path.join(OUT, "png"), os.path.join(OUT, "resize")
    for d in (sparse, images, progressive, decodes, jpeg, pngs, resized):
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
                  progressive=os.path.join(progressive, name), quality=90)
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
    decoded = save_jpeg(os.path.join(jpeg, "scene_1296x832_420.jpg"), big, decodes,
                        progressive=os.path.join(jpeg, "scene_1296x832_420_progressive.jpg"),
                        quality=85, subsampling=2)
    save_jpeg(os.path.join(jpeg, "crop_250x131_444.jpg"), big[300:431, 500:750], decodes,
              progressive=os.path.join(jpeg, "crop_250x131_444_progressive.jpg"),
              twin_kw=dict(restart_marker_blocks=3), quality=95, subsampling=0)

    for name, crop, kw in (("adam7_rgba_67x45", big[400:445, 600:667], dict(interlace=True)),
                           ("paeth_rgba_200x150", big[200:350, 300:500], dict(filter_type=4))):
        rgba = np.concatenate([crop, alpha_channel(*crop.shape[:2])[..., None]], axis=2)
        path = os.path.join(pngs, name + ".png")
        with open(path, "wb") as f:
            f.write(encode_png(rgba, **kw))
        write_png_up(os.path.join(decodes, name + ".png"), np.asarray(Image.open(path)))
    wide = np.concatenate([decoded, decoded[:, :404]], axis=1)[:96]
    for name, img, size in (("scene_648x416", decoded, (648, 416)),
                            ("scene_432x277", decoded, (432, 277)),
                            ("wide_1600x90", wide, (1600, 90))):
        write_png_up(os.path.join(resized, name + ".png"),
                     np.asarray(Image.fromarray(img).resize(size)))
    total = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(OUT) for f in fs)
    print(f"wrote {OUT}: {total} bytes")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main())
