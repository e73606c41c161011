"""The port's host IO (`wast3d_tpu_torch/native`, `scene/{ply,colmap,
datasets}.py`, `cli.convert`) against the JAX package and PIL on the CPU.

The native library builds with `g++` into `_build/` (a private temporary
directory, then `os.replace`), and two processes that build it at once both
load it. Its PLY and COLMAP readers agree bit for bit with the port's numpy
path and with JAX's native library on the same files, JAX's non-float and
`end_header`-comment cases included. The COLMAP writers give JAX's bytes.
The JPEG decoder is held to PIL on files PIL writes here (4:2:0, 4:2:2,
4:4:4, grayscale; 1x1, 17x9, 250x131; restart markers; progressive files
are `test_torch_images.py`'s) and on the committed baseline fixtures: max |port - PIL| <= 2 and mean <= 0.05 in uint8 units;
the share of equal pixels is printed (the target is 100%). `load_scene_info`
on the committed COLMAP + JPEG fixture agrees with JAX's. `cli.convert`
runs the command lines of JAX's `cli.convert` against a fake `colmap`.
"""

import io
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from tests.test_rasterizer import _random_scene
from tests.test_torch_scene import port_scene
from wast3d_tpu import native as jnative
from wast3d_tpu.scene import colmap as jcm
from wast3d_tpu.scene import datasets as jds
from wast3d_tpu_torch import _build, native
from wast3d_tpu_torch.scene import colmap as tcm
from wast3d_tpu_torch.scene import datasets as tds
from wast3d_tpu_torch.scene import ply as tply
from wast3d_tpu_torch.utils.png import read_png

ROOT = Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "torch_fixtures"
JPEG_MAX, JPEG_MEAN = 2, 0.05


def _numpy_path(fn, *args):
    os.environ["WAST3D_NO_NATIVE"] = "1"
    native._tried, native._lib = False, None
    try:
        return fn(*args)
    finally:
        del os.environ["WAST3D_NO_NATIVE"]
        native._tried, native._lib = False, None


def _jax_native():
    """JAX's native library, loaded (its in-place build may race another
    process's: load again after it has finished)."""
    for _ in range(10):
        jnative._tried, jnative._lib = False, None
        if jnative.available():
            return jnative
        time.sleep(0.5)
    raise AssertionError("JAX's native library did not load")


# ---- the build -----------------------------------------------------------------

def test_native_builds_into_the_build_dir():
    assert native.available()
    path = Path(native.library()._name)
    assert path.parent == _build.BUILD_DIR and path.name.startswith("libw3d_io-")
    assert path == _build.native_library_path()
    compiles, link = _build.native_commands(Path("/x/lib.so"))
    assert {"-O3", "-shared", "-fPIC"} <= set(link) and link[link.index("-o") + 1] == "/x/lib.so"
    assert [Path(c[-1]).name for c in compiles] == ["image.cpp", "io.cpp", "j2k.cpp", "jpeg.cpp",
                                                     "plugins.cpp", "raster.cpp", "webp.cpp",
                                                     "zstd.cpp"]
    assert all({"-O3", "-fPIC", "-c"} <= set(c) for c in compiles)
    assert [Path(c) for c in link[-8:]] == [Path(c[c.index("-o") + 1]) for c in compiles]
    assert not (ROOT / "wast3d_tpu_torch" / "native" / "_w3d_io.so").exists()


def test_two_processes_building_at_once_both_load(tmp_path):
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from wast3d_tpu_torch.utils import cache; cache.enable(sys.argv[2]); "
            "from wast3d_tpu_torch import native; lib = native.library(); "
            "print(lib._name, native.decode_jpeg(open(sys.argv[3], 'rb').read()).shape)")
    jpg = str(FIXTURES / "colmap_jpeg" / "images" / "view_0.jpg")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(ROOT), str(tmp_path), jpg],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    libs = sorted(tmp_path.glob("*.so"))
    assert len(libs) == 1 and all(o[0].split()[0] == str(libs[0]) for o in outs)
    assert all("(150, 200, 3)" in o[0] for o in outs)
    assert [p for p in tmp_path.iterdir() if p.is_dir()] == []  # temporary directories gone


# ---- PLY and COLMAP ----------------------------------------------------------------

def test_ply_roundtrip_matches_numpy_and_jax(tmp_path):
    path = str(tmp_path / "x.ply")
    tply.save_ply(port_scene(_random_scene(123)), path)
    data, rows, cols = native.read_ply_f32(path)
    assert (rows, cols) == (123, 62)
    jdata, jrows, jcols = _jax_native().read_ply_f32(path)
    assert (jrows, jcols) == (rows, cols) and np.array_equal(data, jdata)
    fast = tply.load_ply_arrays(path)
    slow = _numpy_path(tply.load_ply_arrays, path)
    for k in fast:
        assert fast[k].dtype == slow[k].dtype and np.array_equal(fast[k], slow[k]), k


def test_ply_writer_matches_jax(tmp_path):
    data = np.arange(24, dtype=np.float32).reshape(6, 4)
    header = ("ply\nformat binary_little_endian 1.0\nelement vertex 6\n"
              + "".join(f"property float p{i}\n" for i in range(4)) + "end_header\n")
    a, b = str(tmp_path / "a.ply"), str(tmp_path / "b.ply")
    assert native.write_ply_f32(a, header, data) and _jax_native().write_ply_f32(b, header, data)
    assert Path(a).read_bytes() == Path(b).read_bytes()
    rd, rows, cols = native.read_ply_f32(a)
    assert np.array_equal(rd, data)


def test_non_float_ply_declines_as_jaxs_does(tmp_path):
    rng = np.random.default_rng(1)
    path = str(tmp_path / "pts.ply")
    tds.store_ply_points(path, rng.normal(size=(10, 3)), rng.uniform(0, 255, (10, 3)))
    assert native.read_ply_f32(path) is None and _jax_native().read_ply_f32(path) is None
    a, b = tds.fetch_ply_points(path), jds.fetch_ply_points(path)
    for x, y in zip(a, b):
        assert np.array_equal(x, y)


def test_header_comment_containing_end_header(tmp_path):
    data = np.arange(12, dtype=np.float32).reshape(4, 3)
    hdr = ("ply\nformat binary_little_endian 1.0\ncomment see end_header docs\n"
           "element vertex 4\nproperty float x\nproperty float y\nproperty float z\n"
           "end_header\n")
    path = str(tmp_path / "c.ply")
    Path(path).write_bytes(hdr.encode() + data.tobytes())
    out, rows, cols = native.read_ply_f32(path)
    jout, _, _ = _jax_native().read_ply_f32(path)
    assert (rows, cols) == (4, 3) and np.array_equal(out, data) and np.array_equal(out, jout)


def test_colmap_points_native_numpy_and_jax(tmp_path):
    rng = np.random.default_rng(0)
    xyz, rgb = rng.normal(size=(77, 3)), rng.integers(0, 255, (77, 3))
    path = str(tmp_path / "points3D.bin")
    tcm.write_points3d_binary(xyz, rgb, path)
    fast = native.read_colmap_points3d(path)
    jfast = _jax_native().read_colmap_points3d(path)
    assert np.array_equal(fast[0], xyz) and np.array_equal(fast[1], rgb.astype(np.uint8))
    assert all(np.array_equal(a, b) for a, b in zip(fast, jfast))
    a = tcm.read_points3d_binary(path)
    b = _numpy_path(tcm.read_points3d_binary, path)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_colmap_writers_give_jaxs_bytes_and_round_trip(tmp_path):
    rng = np.random.default_rng(3)
    cams = {1: ("PINHOLE", 64, 48, [50.0, 51.0, 32.0, 24.0]),
            2: ("SIMPLE_RADIAL", 80, 60, [70.0, 40.0, 30.0, 0.01])}
    imgs = {i: (rng.normal(size=4), rng.normal(size=3), 1 + i % 2, f"im{i}.jpg")
            for i in range(1, 5)}
    xyz, rgb = rng.normal(size=(30, 3)), rng.integers(0, 255, (30, 3))
    for mod, sub in ((tcm, "t"), (jcm, "j")):
        d = tmp_path / sub
        d.mkdir()
        mod.write_cameras_binary({k: mod.ColmapCamera(k, m, w, h, np.array(p))
                                  for k, (m, w, h, p) in cams.items()}, str(d / "cameras.bin"))
        mod.write_images_binary({k: mod.ColmapImage(k, q, t, c, n)
                                 for k, (q, t, c, n) in imgs.items()}, str(d / "images.bin"))
        mod.write_points3d_binary(xyz, rgb, str(d / "points3D.bin"))
    for f in ("cameras.bin", "images.bin", "points3D.bin"):
        assert (tmp_path / "t" / f).read_bytes() == (tmp_path / "j" / f).read_bytes(), f
    back = tcm.read_cameras_binary(str(tmp_path / "t" / "cameras.bin"))
    assert {k: (c.model, c.width, c.height, list(c.params)) for k, c in back.items()} == {
        k: (m, w, h, p) for k, (m, w, h, p) in cams.items()}
    ims = tcm.read_images_binary(str(tmp_path / "t" / "images.bin"))
    for k, (q, t, c, n) in imgs.items():
        assert np.array_equal(ims[k].qvec, q) and np.array_equal(ims[k].tvec, t)
        assert (ims[k].camera_id, ims[k].name) == (c, n)
    pts = tcm.read_points3d_binary(str(tmp_path / "t" / "points3D.bin"))
    assert np.array_equal(pts[0], xyz) and np.array_equal(pts[1], rgb.astype(np.uint8))


# ---- the JPEG decoder against PIL ------------------------------------------------

def _image(h, w, seed):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([np.sin(x / 7.0 + seed) * 100 + 128, np.cos(y / 5.0) * 90 + 128,
                     ((x + y) % 64) * 4.0], -1)
    return np.clip(base + rng.normal(0, 25, (h, w, 3)), 0, 255).astype(np.uint8)


def _against_pil(data, name):
    want = np.asarray(Image.open(io.BytesIO(data)))
    got = native.decode_jpeg(data, name)
    assert got.dtype == np.uint8 and got.shape == want.shape, (got.shape, want.shape)
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    print(f"{name}: max {d.max()}, mean {d.mean():.4f}, equal {100 * (d == 0).mean():.2f}%")
    assert d.max() <= JPEG_MAX and d.mean() <= JPEG_MEAN, (d.max(), d.mean())


KINDS = {"420_q75": dict(quality=75, subsampling=2), "422_q90": dict(quality=90, subsampling=1),
         "444_q95": dict(quality=95, subsampling=0), "grey_q85": dict(quality=85)}


@pytest.mark.parametrize("size", [(1, 1), (9, 17), (131, 250)], ids=lambda s: f"{s[1]}x{s[0]}")
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_jpeg_decoder_against_pil(kind, size):
    img = _image(*size, seed=size[0] + size[1])
    if kind.startswith("grey"):
        img = img[..., 0]
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **KINDS[kind])
    _against_pil(buf.getvalue(), f"{kind} {size[1]}x{size[0]}")


@pytest.mark.parametrize("restart", [dict(restart_marker_blocks=1),
                                     dict(restart_marker_blocks=5, subsampling=1),
                                     dict(restart_marker_rows=1, subsampling=0)],
                         ids=["blocks1_420", "blocks5_422", "rows1_444"])
def test_jpeg_decoder_with_restart_markers(restart):
    buf = io.BytesIO()
    Image.fromarray(_image(131, 250, seed=7)).save(buf, "JPEG", quality=80, **restart)
    assert b"\xff\xdd" in buf.getvalue() and b"\xff\xd0" in buf.getvalue()
    _against_pil(buf.getvalue(), f"restart {restart}")


# Baseline files; their progressive twins are `test_torch_images.py`'s.
BASELINE = sorted(p for p in FIXTURES.rglob("*.jpg")
                  if "progressive" not in p.stem and "progressive" not in p.parent.name)


@pytest.mark.parametrize("jpg", BASELINE, ids=lambda p: p.name)
def test_jpeg_fixtures_against_pils_committed_decode(jpg):
    want = read_png(str(FIXTURES / "pil_decode" / (jpg.stem + ".png")))
    assert np.array_equal(want, np.asarray(Image.open(jpg)))  # the PNG is PIL's decode
    got = native.read_jpeg(str(jpg))
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    print(f"{jpg.name}: max {d.max()}, mean {d.mean():.4f}, equal {100 * (d == 0).mean():.2f}%")
    assert d.max() <= JPEG_MAX and d.mean() <= JPEG_MEAN


def test_progressive_and_other_kinds_raise_naming_file_and_marker(tmp_path):
    """Progressive and CMYK files decode (to PIL's pixels: CMYK as PIL's
    inverted "CMYK;I"); a frame relabelled SOF9 decodes its data as
    arithmetic-coded, to PIL's pixels; kinds libjpeg-turbo does not decode
    (arithmetic-coded lossless, SOF11) and other files raise, naming the
    file and the marker."""
    buf = io.BytesIO()
    Image.fromarray(_image(40, 40, 1)).save(buf, "JPEG", progressive=True)
    path = tmp_path / "prog.jpg"
    path.write_bytes(buf.getvalue())
    assert np.array_equal(native.read_jpeg(str(path)), np.asarray(Image.open(path)))
    cmyk = io.BytesIO()
    Image.fromarray(_image(16, 16, 2)).convert("CMYK").save(cmyk, "JPEG")
    want = np.asarray(Image.open(io.BytesIO(cmyk.getvalue())))
    got = native.decode_jpeg(cmyk.getvalue(), "cmyk.jpg")
    assert got.dtype == want.dtype and got.shape == want.shape == (16, 16, 4)
    assert np.array_equal(got, want)
    arithmetic = cmyk.getvalue().replace(b"\xff\xc0", b"\xff\xc9", 1)  # SOF9
    want = np.asarray(Image.open(io.BytesIO(arithmetic)))
    assert np.array_equal(native.decode_jpeg(arithmetic, "cmyk.jpg"), want)
    lossless_arithmetic = cmyk.getvalue().replace(b"\xff\xc0", b"\xff\xcb", 1)  # SOF11
    with pytest.raises(ValueError, match=r"cmyk\.jpg: arithmetic-coded lossless.*SOF11"):
        native.decode_jpeg(lossless_arithmetic, "cmyk.jpg")
    with pytest.raises(ValueError, match="not a JPEG"):
        native.decode_jpeg(b"\x89PNG\r\n", "x.jpg")


# ---- datasets, cli.convert ----------------------------------------------------------

def test_load_scene_info_on_the_colmap_jpeg_fixture_matches_jax(tmp_path):
    src = tmp_path / "colmap_jpeg"
    shutil.copytree(FIXTURES / "colmap_jpeg", src)
    a = tds.load_scene_info(str(src), eval_split=True)
    b = jds.load_scene_info(str(src), eval_split=True)
    assert len(a.train_cameras) == len(b.train_cameras) == 5 and len(a.test_cameras) == 1
    for x, y in zip(a.train_cameras + a.test_cameras, b.train_cameras + b.test_cameras):
        assert (x.uid, x.image_name, x.width, x.height, x.fovx, x.fovy) == (
            y.uid, y.image_name, y.width, y.height, y.fovx, y.fovy)
        assert np.array_equal(x.R, y.R) and np.array_equal(x.T, y.T)
        d = np.abs(np.round(x.image * 255) - np.round(y.image * 255))
        assert x.image.shape == y.image.shape == (150, 200, 3)
        assert d.max() <= JPEG_MAX and d.mean() <= JPEG_MEAN
    np.testing.assert_equal(a.nerf_normalization, b.nerf_normalization)
    assert np.array_equal(a.point_cloud.points, b.point_cloud.points)
    assert np.array_equal(a.point_cloud.colors, b.point_cloud.colors)


FAKE = """#!/bin/sh
echo "$(basename "$0") $*" >> "{log}"
out=""
prev=""
for a in "$@"; do
  if [ "$prev" = "--output_path" ]; then out="$a"; fi
  prev="$a"
done
case "$1" in
  image_undistorter) mkdir -p "$out/sparse" && for f in cameras.bin images.bin points3D.bin; do
    echo x > "$out/sparse/$f"; done ;;
esac
exit 0
"""


def _convert(mod, tmp, argv, monkeypatch):
    src = tmp / "scene"
    (src / "input").mkdir(parents=True)
    (src / "images").mkdir()
    (src / "images" / "a.jpg").write_bytes(b"x")
    log = tmp / "log.txt"
    for tool in ("colmap", "magick"):
        fake = tmp / tool
        fake.write_text(FAKE.format(log=log))
        fake.chmod(0o755)
    args = ["-s", str(src), "--colmap_executable", str(tmp / "colmap"),
            "--magick_executable", str(tmp / "magick"), *argv]
    if mod.__name__.startswith("wast3d_tpu_torch"):
        mod.main(args)
    else:
        monkeypatch.setattr(sys, "argv", ["convert", *args])
        mod.main()
    lines = log.read_text().replace(str(tmp), "<tmp>").splitlines()
    layout = sorted(str(p.relative_to(src)) for p in src.rglob("*"))
    return lines, layout


@pytest.mark.parametrize("argv", [[], ["--no_gpu", "--camera", "PINHOLE"],
                                  ["--skip_matching", "--resize"]],
                         ids=["default", "no_gpu", "skip_resize"])
def test_cli_convert_runs_jaxs_command_lines(tmp_path, monkeypatch, argv):
    from wast3d_tpu.cli import convert as jconvert
    from wast3d_tpu_torch.cli import convert as tconvert

    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    want = _convert(jconvert, tmp_path / "j", argv, monkeypatch)
    got = _convert(tconvert, tmp_path / "t", argv, monkeypatch)
    assert got == want and want[0]
    assert "sparse/0/cameras.bin" in got[1]


def test_cli_convert_without_colmap_exits_as_jaxs(tmp_path, monkeypatch):
    from wast3d_tpu.cli import convert as jconvert
    from wast3d_tpu_torch.cli import convert as tconvert

    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(SystemExit) as t:
        tconvert.main(["-s", str(tmp_path)])
    monkeypatch.setattr(sys, "argv", ["convert", "-s", str(tmp_path)])
    with pytest.raises(SystemExit) as j:
        jconvert.main()
    assert t.value.code == j.value.code and "colmap binary not found" in t.value.code
