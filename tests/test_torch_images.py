"""Dataset images read and resized as the JAX package reads them (PIL), on
the CPU: `utils/png.py` (resize, PNG unfiltering and Adam7),
`native/image.cpp`, the progressive path of `native/jpeg.cpp`, and
`scene/datasets.py` on top of them.

Every comparison is exact (uint8 bytes, or float32 ground truths bit for
bit): PIL's bicubic resize is integer arithmetic after weights computed in
double, PNG decoding is lossless, and a complete progressive JPEG decodes to
its baseline twin's pixels (libjpeg smooths blocks only while coefficients
are unrefined; such files give PIL's smoothed pixels). The committed fixtures
(`tools/make_torch_fixtures.py`) carry PIL's bytes for the card, which has
no PIL; here they are also checked against PIL itself.
"""

import io
import shutil
from pathlib import Path

import numpy as np
import pytest
from PIL import Image, ImageFile

from wast3d_tpu.scene import datasets as jds
from wast3d_tpu_torch import native
from wast3d_tpu_torch.scene import datasets as tds
from wast3d_tpu_torch.utils import png

ROOT = Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "torch_fixtures"
ImageFile.MAXBLOCK = 1 << 22  # PIL's progressive encoder needs the room on small noisy images


def _image(h, w, c=3, seed=0):
    """Smooth colour with noise: the kind of content cameras give."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(x / 7 + seed), 128 + 90 * np.cos(y / 5),
                     128 + 60 * np.sin((x + y) / 9), 128 + 127 * np.cos(x / 11)], -1)[..., :c]
    img = np.clip(base + rng.normal(0, 25, base.shape), 0, 255).astype(np.uint8)
    return img[..., 0] if c == 1 else img


def _scene_decode():
    return png.read_png(str(FIXTURES / "pil_decode" / "scene_1296x832_420.png"))


# ---- resize ---------------------------------------------------------------------------

def _ground_truths(image, resolution):
    """(the port's, JAX's) `build_cameras` ground truth of one camera."""
    h, w = image.shape[:2]
    common = dict(uid=0, R=np.eye(3), T=np.zeros(3), fovx=0.9, fovy=0.7, image=image,
                  image_name="v", width=w, height=h)
    (_, t), = tds.build_cameras([tds.CameraInfo(**common)], resolution, device="cpu")
    (_, j), = jds.build_cameras([jds.CameraInfo(**common)], resolution)
    return t, np.asarray(j)


@pytest.mark.parametrize("channels", [1, 3], ids=["grey", "rgb"])
@pytest.mark.parametrize("resolution", [2, 3, 8])
def test_build_cameras_ground_truth_equals_jaxs(resolution, channels):
    img = _scene_decode().astype(np.float32) / 255.0
    img = img[..., 0] if channels == 1 else img
    t, j = _ground_truths(img, resolution)
    assert t.dtype == j.dtype == np.float32 and t.shape == j.shape
    assert t.shape[:2] == (round(832 / resolution), round(1296 / resolution))
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("channels", [1, 2, 3, 4], ids=["grey", "grey_alpha", "rgb", "rgba"])
def test_build_cameras_caps_width_as_jax_at_minus_one(channels):
    """-r -1 on a 1700 px wide image: 1600 px wide, PIL's filter; alpha
    images go through PIL's premultiplied route."""
    img = _image(60, 1700, max(channels, 1), seed=channels).astype(np.float32) / 255.0
    t, j = _ground_truths(img, -1)
    assert t.shape[:2] == (56, 1600)
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("size,out", [((37, 53), (20, 91)), ((5, 7), (17, 3)),
                                      ((64, 64), (64, 31)), ((1, 1), (4, 2)),
                                      ((83, 131), (83, 400)), ((203, 9), (29, 9))],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_native_resize_equals_numpy_and_pil(size, out, channels):
    img = _image(*size, c=channels, seed=size[0] * channels)
    want = np.asarray(Image.fromarray(img).resize((out[1], out[0])))
    np.testing.assert_array_equal(png.resize(img, out[1], out[0]), want)
    np.testing.assert_array_equal(png.resize_native(img, out[1], out[0]), want)


@pytest.mark.parametrize("name,size", [("scene_648x416", (648, 416)),
                                       ("scene_432x277", (432, 277)),
                                       ("wide_1600x90", (1600, 90))])
def test_committed_resizes_are_pils(name, size):
    img = _scene_decode()
    if name.startswith("wide"):
        img = np.concatenate([img, img[:, :404]], axis=1)[:96]
    want = png.read_png(str(FIXTURES / "resize" / f"{name}.png"))
    np.testing.assert_array_equal(want, np.asarray(Image.fromarray(img).resize(size)))
    np.testing.assert_array_equal(png.resize_native(img, *size), want)
    np.testing.assert_array_equal(png.resize(img, *size), want)


# ---- progressive JPEG -------------------------------------------------------------------

KINDS = {"444": dict(subsampling=0), "422": dict(subsampling=1), "420": dict(subsampling=2),
         "grey": {}, "420_restart": dict(subsampling=2, restart_marker_blocks=2),
         "444_restart_rows": dict(subsampling=0, restart_marker_rows=1)}


def _jpeg(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


@pytest.mark.parametrize("size", [(131, 250), (9, 17)], ids=lambda s: f"{s[1]}x{s[0]}")
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_progressive_jpeg_equals_pil_and_its_baseline_twin(kind, size):
    img = _image(*size, c=1 if kind == "grey" else 3, seed=size[1])
    prog = _jpeg(img, quality=85, progressive=True, **KINDS[kind])
    assert b"\xff\xc2" in prog
    got = native.decode_jpeg(prog, kind)
    np.testing.assert_array_equal(got, np.asarray(Image.open(io.BytesIO(prog))))
    np.testing.assert_array_equal(got, native.decode_jpeg(_jpeg(img, quality=85,
                                                                 **KINDS[kind])))


def test_progressive_jpeg_with_unrefined_scans_or_cut_short_raises():
    """Scans cut out before EOI leave coefficients unsent or unrefined:
    libjpeg smooths their blocks and the port gives PIL's array; a file cut
    short (no EOI) raises, as in PIL."""
    img = _image(64, 80, seed=3)
    data = _jpeg(img, quality=90, progressive=True)
    sos = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]
    assert len(sos) >= 6
    for keep in (1, len(sos) // 2, len(sos) - 1):  # scans cut out before EOI
        cut = data[:sos[keep]] + b"\xff\xd9"
        np.testing.assert_array_equal(native.decode_jpeg(cut, "cut.jpg"),
                                      np.asarray(Image.open(io.BytesIO(cut))))
    with pytest.raises(ValueError, match=r"half\.jpg.*truncated"):
        native.decode_jpeg(data[:len(data) // 2], "half.jpg")
    with pytest.raises(OSError, match="truncated"):  # as PIL does by default
        Image.open(io.BytesIO(data[:len(data) // 2])).load()


PROGRESSIVE = sorted(FIXTURES.rglob("*_progressive.jpg")) + sorted(
    (FIXTURES / "colmap_jpeg" / "images_progressive").glob("*.jpg"))


@pytest.mark.parametrize("jpg", PROGRESSIVE, ids=lambda p: f"{p.parent.name}/{p.name}")
def test_committed_progressive_fixtures_decode_to_their_twins(jpg):
    twin = jpg.stem.removesuffix("_progressive")
    want = png.read_png(str(FIXTURES / "pil_decode" / f"{twin}.png"))
    np.testing.assert_array_equal(np.asarray(Image.open(jpg)), want)
    np.testing.assert_array_equal(native.read_jpeg(str(jpg)), want)


# ---- PNG ----------------------------------------------------------------------------------

@pytest.mark.parametrize("size", [(1, 1), (3, 5), (45, 67)], ids=lambda s: f"{s[1]}x{s[0]}")
@pytest.mark.parametrize("channels", [1, 2, 3, 4], ids=["grey", "grey_alpha", "rgb", "rgba"])
def test_adam7_png_equals_pil(channels, size):
    img = _image(*size, c=channels, seed=sum(size))
    blob = png.encode_png(img, filter_type=4, interlace=True)
    assert Image.open(io.BytesIO(blob)).info.get("interlace") == 1
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(blob))), img)
    np.testing.assert_array_equal(png.decode_png(blob), img)
    np.testing.assert_array_equal(png.decode_png_reference(blob), img)


@pytest.mark.parametrize("ftype", [3, 4], ids=["average", "paeth"])
@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_average_and_paeth_rows_native_python_and_pil(ftype, channels):
    img = _image(23, 41, c=channels, seed=ftype)
    blob = png.encode_png(img, filter_type=ftype)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(blob))), img)
    np.testing.assert_array_equal(png.decode_png(blob), img)
    np.testing.assert_array_equal(png.decode_png_reference(blob), img)


@pytest.mark.parametrize("name", ["adam7_rgba_67x45", "paeth_rgba_200x150"])
def test_committed_png_fixtures_equal_pils_decode(name):
    path = FIXTURES / "png" / f"{name}.png"
    want = png.read_png(str(FIXTURES / "pil_decode" / f"{name}.png"))
    np.testing.assert_array_equal(np.asarray(Image.open(path)), want)
    np.testing.assert_array_equal(png.read_png(str(path)), want)
    assert want.shape[2] == 4 and 0 < (want[..., 3] == 0).mean() < 1


def test_bad_png_data_raises_naming_the_file():
    blob = png.encode_png(_image(6, 5), filter_type=2)
    w, h, c, interlaced, raw = png.parse_png(blob)
    with pytest.raises(ValueError, match=r"x\.png.*too short"):
        native.png_unfilter(raw[:-3], h, w, c, interlaced, "x.png")
    bad = raw.copy()
    bad[0] = 7
    with pytest.raises(ValueError, match=r"x\.png.*filter type 7"):
        native.png_unfilter(bad, h, w, c, interlaced, "x.png")


# ---- datasets -----------------------------------------------------------------------------

def _assert_same_infos(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert (x.uid, x.image_name, x.width, x.height) == (y.uid, y.image_name, y.width,
                                                             y.height)
        assert x.image.dtype == y.image.dtype
        np.testing.assert_array_equal(x.image, y.image)


def test_blender_dataset_of_paeth_and_adam7_pngs_equals_jaxs(tmp_path):
    import json

    root = tmp_path / "blender"
    root.mkdir()
    frames = []
    for i in range(3):
        c2w = np.eye(4)
        c2w[:3, 3] = [np.sin(i), 0.2, -4 + 0.1 * i]
        frames.append({"file_path": f"./r_{i}", "transform_matrix": c2w.tolist()})
        rgba = _image(36, 44, c=4, seed=i)
        (root / f"r_{i}.png").write_bytes(png.encode_png(rgba, filter_type=4,
                                                         interlace=i == 1))
    (root / "transforms_train.json").write_text(json.dumps({"camera_angle_x": 0.8,
                                                            "frames": frames}))
    j = jds.load_scene_info(str(root))  # writes points3d.ply
    t = tds.load_scene_info(str(root))
    _assert_same_infos(t.train_cameras, j.train_cameras)
    for res in (2, 3):
        for (_, tg), (_, jg) in zip(tds.build_cameras(t.train_cameras, res, device="cpu"),
                                    jds.build_cameras(j.train_cameras, res)):
            np.testing.assert_array_equal(tg, np.asarray(jg))


def test_progressive_colmap_fixture_equals_jaxs_and_the_baseline_copy(tmp_path):
    src = tmp_path / "colmap_jpeg"
    shutil.copytree(FIXTURES / "colmap_jpeg", src)
    t = tds.load_scene_info(str(src), images="images_progressive", eval_split=True)
    j = jds.load_scene_info(str(src), images="images_progressive", eval_split=True)
    base = tds.load_scene_info(str(src), eval_split=True)
    _assert_same_infos(t.train_cameras + t.test_cameras, j.train_cameras + j.test_cameras)
    _assert_same_infos(t.train_cameras + t.test_cameras,
                       base.train_cameras + base.test_cameras)
    for (_, tg), (_, jg) in zip(tds.build_cameras(t.train_cameras, 2, device="cpu"),
                                jds.build_cameras(j.train_cameras, 2)):
        np.testing.assert_array_equal(tg, np.asarray(jg))
