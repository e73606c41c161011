"""Port parity: scene I/O of `wast3d_tpu_torch` against `wast3d_tpu`.

PLY load/save, the JAX->port weight conversion, the PIL-free PNG codec
against PIL, and the Blender/COLMAP dataset loaders. Exact comparisons
unless stated: both sides run the same numpy code on the same bytes."""

import io
import os
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from tests.test_datasets_eval import _make_blender_fixture, _make_colmap_fixture
from tests.test_rasterizer import _random_scene
from wast3d_tpu.scene import datasets as jds
from wast3d_tpu.scene import ply as jply
from wast3d_tpu_torch.core.camera import look_at_camera
from wast3d_tpu_torch.scene import datasets as tds
from wast3d_tpu_torch.scene import ply as tply
from wast3d_tpu_torch.scene.convert import FIELDS, scene_from_numpy
from wast3d_tpu_torch.utils import png

GOLD = os.path.join(os.path.dirname(__file__), "golden")


def port_scene(jax_scene):
    """The port's copy of a JAX scene, on the CPU."""
    d = {f: np.asarray(getattr(jax_scene, f)) for f in FIELDS}
    d["active_sh_degree"] = jax_scene.active_sh_degree
    d["max_sh_degree"] = jax_scene.max_sh_degree
    return scene_from_numpy(d, device="cpu")


def port_cam(w=64, h=64, fov=0.8, eye=(0, 0, -5)):
    """`tests.test_rasterizer._cam` on the port's side."""
    return look_at_camera(eye=list(eye), target=[0, 0, 0], up=[0, -1, 0],
                          fovx=fov, fovy=fov, width=w, height=h, device="cpu")


def test_load_ply_golden_matches_jax():
    path = os.path.join(GOLD, "scene.ply")
    j = jply.load_ply(path)
    t = tply.load_ply(path, device="cpu")
    n = t.capacity
    assert t.active_sh_degree == j.active_sh_degree == 3
    assert int(np.asarray(j.mask).sum()) == n
    for f in ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity"):
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f))[:n])


@pytest.mark.parametrize("seed", [0, 1])
def test_save_ply_byte_identical(tmp_path, seed):
    j = _random_scene(n=150, seed=seed)  # capacity-padded: dead slots must drop
    jp, tp = str(tmp_path / "j.ply"), str(tmp_path / "t.ply")
    jply.save_ply(j, jp)
    tply.save_ply(port_scene(j), tp)
    with open(jp, "rb") as a, open(tp, "rb") as b:
        assert a.read() == b.read()
    back = tply.load_ply(tp, device="cpu")
    assert back.capacity == 150


def test_scene_from_numpy_roundtrip():
    j = _random_scene(n=100, seed=5)
    t = port_scene(j)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)))
    assert (t.active_sh_degree, t.max_sh_degree) == (j.active_sh_degree, j.max_sh_degree)
    np.testing.assert_allclose(t.get_opacity.numpy(), np.asarray(j.get_opacity), atol=1e-6)
    np.testing.assert_allclose(t.get_rotation.numpy(), np.asarray(j.get_rotation), atol=1e-6)
    np.testing.assert_allclose(t.get_scaling.numpy(), np.asarray(j.get_scaling), atol=1e-6)
    np.testing.assert_allclose(t.get_covariance(1.0).numpy(),
                               np.asarray(j.get_covariance(1.0)), atol=1e-6)


@pytest.mark.parametrize("mode,channels", [("RGB", 3), ("RGBA", 4), ("L", 1)])
def test_png_against_pil(tmp_path, mode, channels):
    rng = np.random.default_rng(channels)
    x = np.linspace(0, 255, 48)
    smooth = np.stack([np.add.outer(x, x) / 2] * channels, -1)
    noisy = rng.integers(0, 256, smooth.shape)
    img = np.where(rng.uniform(size=smooth.shape) < 0.3, noisy, smooth).astype(np.uint8)
    img = img[..., 0] if channels == 1 else img
    # port writer -> PIL reader
    p = str(tmp_path / "port.png")
    png.write_png(p, img)
    np.testing.assert_array_equal(np.asarray(Image.open(p)), img)
    # PIL writer (adaptive row filters) -> port reader
    buf = io.BytesIO()
    Image.fromarray(img, mode).save(buf, format="PNG")
    np.testing.assert_array_equal(png.decode_png(buf.getvalue()), img)


def test_png_average_filter_and_rejects():
    """Filter type 3 (Average), which PIL's writer rarely picks, on a
    hand-filtered RGB image; and the formats the reader refuses."""
    img = np.random.default_rng(9).integers(0, 256, (5, 7, 3)).astype(np.int32)
    rows = []
    prior = np.zeros(21, np.int32)
    for y in range(5):
        cur = img[y].reshape(-1)
        left = np.concatenate([np.zeros(3, np.int32), cur[:-3]])
        rows.append(bytes([3]) + (((cur - (left + prior) // 2) & 0xFF).astype(np.uint8)).tobytes())
        prior = cur

    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + struct.pack(
            ">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    blob = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", 7, 5, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))
    np.testing.assert_array_equal(png.decode_png(blob), img)
    assert np.array_equal(np.asarray(Image.open(io.BytesIO(blob))), img)
    bad = blob.replace(struct.pack(">IIBBBBB", 7, 5, 8, 2, 0, 0, 0),
                       struct.pack(">IIBBBBB", 7, 5, 16, 2, 0, 0, 0))
    with pytest.raises(ValueError):
        png.decode_png(bad)
    with pytest.raises(ValueError):
        png.decode_png(b"not a png")


def test_resize():
    """`png.resize` gives PIL's default resize (bicubic) bytes: whole-factor
    and odd shrinks, an upscale, and one axis alone."""
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (48, 36, 3)).astype(np.uint8)
    for w, h in ((18, 24), (13, 29), (50, 61), (36, 20), (7, 48)):
        want = np.asarray(Image.fromarray(img).resize((w, h)))
        np.testing.assert_array_equal(png.resize(img, w, h), want)
    np.testing.assert_array_equal(png.resize(img, 36, 48), img)  # same size: a copy


def _assert_same_cameras(tc, jc):
    assert len(tc) == len(jc)
    for (t, tgt), (j, jgt) in zip(tc, jc):
        np.testing.assert_allclose(t.view_transform.numpy(), np.asarray(j.view_transform), atol=1e-6)
        np.testing.assert_allclose(t.full_proj_transform.numpy(),
                                   np.asarray(j.full_proj_transform), atol=1e-6)
        # the JAX camera keeps its angles as float32 scalars
        assert (t.width, t.height) == (j.width, j.height)
        assert np.float32(t.fovx) == j.fovx and np.float32(t.fovy) == j.fovy
        np.testing.assert_array_equal(tgt, np.asarray(jgt))


@pytest.mark.parametrize("white", [False, True])
def test_blender_dataset_matches_jax(tmp_path, white):
    root = str(tmp_path / "blender")
    _make_blender_fixture(root)
    j = jds.load_scene_info(root, white_background=white)  # writes points3d.ply
    t = tds.load_scene_info(root, white_background=white)  # reads it back
    np.testing.assert_allclose(t.nerf_normalization["translate"],
                               j.nerf_normalization["translate"])
    assert t.nerf_normalization["radius"] == j.nerf_normalization["radius"]
    np.testing.assert_array_equal(t.point_cloud.points, j.point_cloud.points)
    assert [c.image_name for c in t.train_cameras] == [c.image_name for c in j.train_cameras]
    _assert_same_cameras(tds.build_cameras(t.train_cameras, device="cpu"),
                         jds.build_cameras(j.train_cameras))


def test_colmap_dataset_matches_jax(tmp_path):
    root = str(tmp_path / "colmap")
    _make_colmap_fixture(root)
    j = jds.load_scene_info(root, eval_split=True)
    t = tds.load_scene_info(root, eval_split=True)
    assert len(t.train_cameras) == len(j.train_cameras)
    assert len(t.test_cameras) == len(j.test_cameras)
    np.testing.assert_array_equal(t.point_cloud.points, j.point_cloud.points)
    _assert_same_cameras(tds.build_cameras(t.train_cameras, device="cpu"),
                         jds.build_cameras(j.train_cameras))
    # resolution 2 halves each side with PIL's filter, as JAX does
    half = tds.build_cameras(t.train_cameras, resolution=2, device="cpu")
    assert half[0][0].width == 32 and half[0][1].shape == (24, 32, 3)
    _assert_same_cameras(half, jds.build_cameras(j.train_cameras, resolution=2))
