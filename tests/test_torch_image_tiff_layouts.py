"""The TIFF that capture and GIS tools write, read by the port without PIL
(`utils/image_io.decode_tiff`): tiles (edge tiles cropped), separate planes
in strips and tiles, fill order 2, bilevel, palette, CMYK, 32-bit float with
the floating-point predictor, 32-bit and signed 16-bit integers, JPEG in RGB
and in YCbCr, and the Orientation tag.

Every comparison is exact: `read_image` / `decode_image` against
`np.asarray(PIL.Image.open(f))` in dtype, shape and bytes. Generated files
come from `tools/image_writers.tiff_bytes`; a file PIL refuses must raise a
`ValueError` naming the file. The committed fixtures (`tif_*` under
`tests/format_fixtures/`) come from `tools/make_torch_fixtures.py --raster`.
"""

import io
import shutil
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from tests.test_torch_image_formats import _assert_pils, _assert_same, _image
from tools import image_writers as iw
from wast3d_tpu.scene import datasets as jds
from wast3d_tpu_torch import native
from wast3d_tpu_torch.scene import colmap as cm
from wast3d_tpu_torch.scene import datasets as tds
from wast3d_tpu_torch.utils import image_io

ROOT = Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "torch_fixtures"
FORMATS = ROOT / "tests" / "format_fixtures"
NEW = sorted(p for p in FORMATS.glob("tif_*.tif")
             if p.stem.startswith(("tif_tiled", "tif_planar", "tif_fill2", "tif_bilevel",
                                   "tif_pal", "tif_grey4", "tif_cmyk", "tif_f32", "tif_i32",
                                   "tif_u32", "tif_i16s", "tif_jpeg", "tif_orientation")))


def _pil(blob):
    try:
        return np.asarray(Image.open(io.BytesIO(blob)))
    except Exception:
        return None


def _same_as_pil(blob, name="case.img"):
    """The port's array equals PIL's, or both refuse the file (the port with a
    ValueError naming it)."""
    want = _pil(blob)
    if want is None:
        with pytest.raises(ValueError, match=rf"^{name}: "):
            image_io.decode_image(blob, name)
        return False
    _assert_same(image_io.decode_image(blob, name), want)
    return True


# ---- committed fixtures ---------------------------------------------------------------

@pytest.mark.parametrize("path", NEW, ids=lambda p: p.name)
def test_tiff_fixture_is_pils_array(path):
    want = np.asarray(Image.open(path))
    _assert_same(np.load(path.with_suffix(".npy")), want)
    _assert_same(image_io.read_image(str(path)), want)


def test_tiff_fixtures_cover_every_layout_and_kind():
    seen = set()
    for p in NEW:
        _, tags, _ = image_io._tiff_tags(p.read_bytes(), p.name)
        one = {k: v[0] for k, v in tags.items() if k != 347 and len(v) >= 1}
        compression, planar = one.get(259, 1), one.get(284, 1)
        seen.add(("tiles" if 322 in tags else "strips", planar, compression != 1))
        seen.add(("compression", compression, one.get(317, 1)))
        seen.add(("photometric", one.get(262), tags[258][0], one.get(339, 1)))
        seen |= {("fill", one.get(266, 1)), ("byte order", p.read_bytes()[:2]),
                 ("tables", 347 in tags), ("orientation", one.get(274, 1))}
    for need in [(layout, planar, packed) for layout in ("tiles", "strips") for planar in (1, 2)
                 for packed in (False, True)] + [
            ("compression", 5, 2), ("compression", 8, 3), ("compression", 5, 3),
            ("compression", 32773, 1), ("compression", 32946, 1), ("compression", 7, 1),
            ("photometric", 0, 1, 1), ("photometric", 1, 1, 1), ("photometric", 3, 1, 1),
            ("photometric", 3, 2, 1), ("photometric", 3, 4, 1), ("photometric", 3, 8, 1),
            ("photometric", 5, 8, 1), ("photometric", 5, 16, 1), ("photometric", 1, 32, 3),
            ("photometric", 1, 32, 2), ("photometric", 1, 32, 1), ("photometric", 1, 16, 2),
            ("photometric", 6, 8, 1), ("photometric", 2, 8, 1), ("fill", 2),
            ("byte order", b"MM"), ("tables", True), ("tables", False), ("orientation", 6)]:
        assert need in seen, need
    assert len(NEW) >= 35


def test_dataset_size_jpeg_tiff_is_pils_array():
    """The committed 1296x832 JPEG-in-TIFF (YCbCr 4:2:0, 256x256 tiles)
    against PIL and the SHA-256 the card holds it to."""
    import hashlib
    import json

    path = FIXTURES / "tiff" / "scene_1296x832_jpeg_ycbcr420_tiled.tif"
    want = np.asarray(Image.open(path))
    got = image_io.read_image(str(path))
    _assert_same(got, want)
    record = json.loads((FIXTURES / "pil_decode"
                         / "scene_1296x832_jpeg_ycbcr420_tiled_tif.json").read_text())
    assert record == {"dtype": "uint8", "shape": [832, 1296, 3],
                      "sha256": hashlib.sha256(got.tobytes()).hexdigest()}


# ---- layouts and sample kinds against PIL ---------------------------------------------

def _kinds():
    rng = np.random.default_rng(21)
    h, w = 21, 35
    a8 = (np.cumsum(rng.integers(0, 40, (h, w, 6)), axis=1) % 256).astype(np.uint8)
    a16 = rng.integers(0, 65536, (h, w, 4)).astype(np.uint16)
    f = rng.normal(0, 1e3, (h, w)).astype(np.float32)
    i32 = rng.integers(-2 ** 31, 2 ** 31, (h, w)).astype(np.int32)
    cmap = rng.integers(0, 65536, 768)
    return {
        "L": (a8[..., 0], 1, {}), "L_white": (a8[..., 0], 0, {}),
        "LA": (a8[..., :2], 1, dict(extra_samples=(2,))), "RGB": (a8[..., :3], 2, {}),
        "RGBA": (a8[..., :4], 2, dict(extra_samples=(2,))),
        "RGBa": (a8[..., :4], 2, dict(extra_samples=(1,))),
        "RGBA_no_extra": (a8[..., :4], 2, {}), "RGBX": (a8[..., :4], 2, dict(extra_samples=(0,))),
        "RGBXX": (a8[..., :5], 2, dict(extra_samples=(0, 0))),
        "RGBaX": (a8[..., :5], 2, dict(extra_samples=(1, 0))),
        "I16": (a16[..., 0], 1, {}), "RGB16": (a16[..., :3], 2, {}),
        "RGBa16": (a16, 2, dict(extra_samples=(1,))),
        "bilevel": (a8[..., 0] & 1, 1, dict(bits=1)),
        "bilevel_white": (a8[..., 0] & 1, 0, dict(bits=1)),
        "grey2": (a8[..., 0] & 3, 1, dict(bits=2)),
        "grey4_white": (a8[..., 0] & 15, 0, dict(bits=4)),
        "P1": (a8[..., 0] & 1, 3, dict(bits=1, colormap=cmap[:6])),
        "P2": (a8[..., 0] & 3, 3, dict(bits=2, colormap=cmap[:12])),
        "P4": (a8[..., 0] & 15, 3, dict(bits=4, colormap=cmap[:48])),
        "P8": (a8[..., 0], 3, dict(colormap=cmap)),
        "PA": (a8[..., :2], 3, dict(colormap=cmap, extra_samples=(2,))),
        "CMYK": (a8[..., :4], 5, {}), "CMYKX": (a8[..., :5], 5, dict(extra_samples=(0,))),
        "CMYK16": (a16, 5, {}),
        "F": (f, 1, dict(sample_format=3)), "F_white": (f, 0, dict(sample_format=3)),
        "I32": (i32, 1, dict(sample_format=2)), "U32": (i32.view(np.uint32), 1, {}),
        "I16S": ((i32 >> 16).astype(np.int16), 1, dict(sample_format=2)),
        "L_sample_format_2": (a8[..., 0], 1, dict(sample_format=2)),
    }


KINDS = _kinds()
LAYOUTS = {"strips": dict(rows_per_strip=6), "tiles": dict(tile=(16, 16)),
           "planar_strips": dict(rows_per_strip=6, planar=2),
           "planar_tiles": dict(tile=(16, 16), planar=2)}


@pytest.mark.parametrize("kind", list(KINDS))
def test_tiff_layouts_and_sample_kinds_equal_pil(kind):
    """Each sample kind in strips and tiles, chunky and separate, under every
    compression and predictor, in either byte order and fill order: the
    port's array is PIL's, or both refuse the file."""
    vals, photometric, kw = KINDS[kind]
    decoded = 0
    for compression, predictor in ((1, 1), (32773, 1), (5, 2), (8, 1), (32946, 2), (8, 3)):
        for layout, lkw in LAYOUTS.items():
            for byteorder in "<>":
                for fill in (1, 2):
                    blob = iw.tiff_bytes(vals, photometric, compression=compression,
                                         predictor=predictor, byteorder=byteorder,
                                         fill_order=fill, **lkw, **kw)
                    decoded += _same_as_pil(blob)
    assert decoded > 0


@pytest.mark.parametrize("orientation", range(1, 9))
def test_tiff_orientation_equals_pil(orientation):
    img = _image(11, 17, 3, seed=orientation)
    for kw in ({}, dict(compression=5, tile=(16, 16)), dict(compression=7)):
        blob = iw.tiff_bytes(img if kw.get("compression") != 7 else iw.rgb_to_ycc(img),
                             6 if kw.get("compression") == 7 else 2,
                             tags=[(274, 3, [orientation])], **kw)
        assert _same_as_pil(blob)


# ---- JPEG inside TIFF -----------------------------------------------------------------

SAMPLINGS = {"420": ((2, 2), (1, 1), (1, 1)), "422": ((2, 1), (1, 1), (1, 1)),
             "444": ((1, 1),) * 3, "440": ((1, 2), (1, 1), (1, 1)),
             "411": ((4, 1), (1, 1), (1, 1)), "chroma_h2": ((1, 1), (2, 1), (1, 1))}


@pytest.mark.parametrize("sampling", list(SAMPLINGS))
def test_jpeg_ycbcr_tiff_equals_pil(sampling, tmp_path):
    """YCbCr JPEG strips and tiles, with JPEGTables or tables in each stream,
    with and without YCbCrSubsampling (and with a wrong one): libjpeg's
    upsampling and colour through the port's decoder, edge tiles cropped,
    a last strip shorter than the rest."""
    samp = SAMPLINGS[sampling]
    decoded = 0
    for h, w in ((45, 70), (16, 16), (1, 1), (33, 17)):
        ycc = iw.rgb_to_ycc(_image(h, w, 3, seed=h + w))
        for layout in (dict(tile=(32, 16)), dict(tile=(16, 16)), dict(rows_per_strip=16),
                       dict(rows_per_strip=8), {}):
            for tables in (True, False):
                for sub in (None, samp[0], (2, 2)):
                    blob = iw.tiff_bytes(ycc, 6, compression=7, **layout,
                                         jpeg=dict(sampling=samp, quality=80, tables=tables,
                                                   subsampling=sub))
                    decoded += _same_as_pil(blob)
    if sampling == "chroma_h2":  # libtiff: only the first component may be subsampled
        assert decoded == 0
        return
    assert decoded >= 40
    _assert_pils(iw.tiff_bytes(iw.rgb_to_ycc(_image(40, 50, 3)), 6, compression=7,
                               tile=(16, 16), jpeg=dict(sampling=samp)), tmp_path, ".tif")


@pytest.mark.parametrize("photometric,channels", [(2, 3), (1, 1), (0, 1), (5, 4), (2, 4)],
                         ids=["rgb", "grey", "grey_white", "cmyk", "rgba"])
def test_jpeg_tiff_of_other_colour_spaces_equals_pil(photometric, channels):
    """RGB, grey and CMYK JPEG streams come out as coded (libtiff's
    JCS_UNKNOWN), chunky or one plane a stream."""
    img = _image(29, 41, 4, seed=photometric)[..., :channels]
    for layout in (dict(tile=(16, 16)), dict(rows_per_strip=8)):
        for planar in (1, 2):
            for tables in (True, False):
                kw = dict(extra_samples=(2,)) if channels == 4 and photometric == 2 else {}
                blob = iw.tiff_bytes(img, photometric, compression=7, planar=planar, **layout,
                                     jpeg=dict(quality=85, tables=tables), **kw)
                assert _same_as_pil(blob)
    bad = iw.tiff_bytes(img, photometric, compression=7, jpeg=dict(
        sampling=((2, 2),) + ((1, 1),) * (channels - 1)))
    assert not _same_as_pil(bad)  # libtiff: only YCbCr may be subsampled


def test_jpeg_tiffs_libtiff_refuses_raise_naming_the_file():
    ycc = iw.rgb_to_ycc(_image(20, 24, 3))
    planar = iw.tiff_bytes(ycc, 6, compression=7, planar=2, rows_per_strip=8)
    with pytest.raises(ValueError, match=r"^p\.tif: TIFF PhotometricInterpretation \(tag 262\) "
                                         r"= 6 \(YCbCr\) with Compression 7, PlanarConfigur"):
        image_io.decode_image(planar, "p.tif")
    lzw_ycc = iw.tiff_bytes(ycc, 6, compression=5, ycbcr_subsampling=(1, 4))
    assert _pil(lzw_ycc) is None  # libtiff's RGBA reader has no 1x4 routine
    with pytest.raises(ValueError, match=r"^y\.tif: .*YCbCr"):
        image_io.decode_image(lzw_ycc, "y.tif")
    wrong = iw.tiff_bytes(ycc, 6, compression=7, tile=(16, 16),
                          jpeg=dict(sampling=SAMPLINGS["444"], subsampling=(2, 2)))
    assert _pil(wrong) is None
    with pytest.raises(ValueError, match=r"^w\.tif: JPEG sampling factors"):
        image_io.decode_image(wrong, "w.tif")


# ---- what the reader refuses ----------------------------------------------------------

@pytest.mark.parametrize("edit,match", [
    (dict(compression=6), r"Compression \(tag 259\) = 6"),
    (dict(compression=3), r"Compression \(tag 259\) = 3"),
    (dict(tags=[(339, 3, [3, 3, 3])]), r"SampleFormat \(tag 339\) = \(3, 3, 3\)"),
    (dict(compression=5, predictor=3), r"Predictor \(tag 317\) = 3"),
    (dict(planar=3), r"PlanarConfiguration \(tag 284\) = 3"),
    (dict(compression=5, tags=[(322, 3, [16])]),
     r"TileWidth \(tag 322\) = 16 without TileLength"),
    (dict(tags=[(262, 3, [2])]), r"PhotometricInterpretation \(tag 262\) twice"),
    (dict(tags=[(266, 1, [1])]), r"FillOrder \(tag 266\) of type 1"),
    (dict(tags=[(274, 7, b"\x06\x00")]), r"Orientation \(tag 274\) of type 7"),
])
def test_tiffs_outside_the_reader_name_the_tag(edit, match):
    blob = iw.tiff_bytes(_image(8, 8), 2, **edit)
    with pytest.raises(ValueError, match=rf"^x\.tif: TIFF {match}"):
        image_io.decode_image(blob, "x.tif")


def test_tiff_past_pils_pixel_limit_raises_before_decoding():
    blob = bytearray(iw.tiff_bytes(np.zeros((2, 2), np.uint8), 1, compression=5))
    at = blob.index((256).to_bytes(2, "little") + b"\x04\x00\x01\x00\x00\x00")
    blob[at + 8:at + 12] = (70000).to_bytes(4, "little")
    blob[at + 20:at + 24] = (70000).to_bytes(4, "little")
    with pytest.raises(ValueError, match=r"^big\.tif: 70000x70000 is more pixels than PIL"):
        image_io.decode_image(bytes(blob), "big.tif")


# ---- native stages against their plain versions ---------------------------------------

def test_native_lzw_follows_libtiff_and_its_plain_version():
    """Clear first, codes past the table and a table run past 5119 entries
    are errors (as libtiff's LZWDecode); decoding stops at the size asked."""
    rng = np.random.default_rng(8)
    data = bytes((np.cumsum(rng.integers(0, 3, 20000)) % 256).astype(np.uint8))
    lzw = iw.lzw_encode(data)

    def outcome(fn):
        try:
            return fn().tobytes()
        except ValueError as e:
            return str(e).removeprefix("<bytes>: ")

    cases = [lzw, lzw[:1] + bytes([lzw[1] ^ 0x80]) + lzw[2:], bytes([0]) + lzw[1:]]
    bits = iw._Bits()  # Clear, then 4900 literals: the table runs past 5119
    bits.put(256, 9)
    width, count = 9, 258
    for i in range(4900):
        bits.put(i % 200, width)
        count += i > 0
        if count > (1 << width) - 2 and width < 12:
            width += 1
    cases.append(bits.packed(0))
    for i in range(200):
        b = bytearray(lzw[:600])
        b[int(rng.integers(0, 600))] ^= 1 << int(rng.integers(0, 8))
        cases.append(bytes(b))
    failed = 0
    for blob in cases:
        for n in (10, 5000, 20000):
            got = outcome(lambda: native.lzw_decode(blob, n))
            assert got == outcome(lambda: image_io.lzw_reference(blob, n))
            failed += isinstance(got, str)
    assert failed > 0
    assert "Clear" in outcome(lambda: native.lzw_decode(bytes([0]) + lzw[1:], 10))
    assert "overflows" in outcome(lambda: native.lzw_decode(cases[3], 5000))


def test_native_jpeg_colour_spaces():
    """`decode_jpeg(colour=...)`: 0 follows the file's markers, 1 converts
    YCbCr whatever they say, 2 gives the components as coded (no CMYK
    inversion)."""
    img = _image(16, 24, 4, seed=3)
    jfif = iw.jpeg_bytes(img[..., :3], ((1, 1),) * 3, quality=95)
    adobe_rgb = iw.jpeg_bytes(img[..., :3], ((1, 1),) * 3, quality=95, adobe_transform=0)
    _assert_same(native.decode_jpeg(adobe_rgb, colour=1), native.decode_jpeg(jfif))
    _assert_same(native.decode_jpeg(jfif, colour=2), native.decode_jpeg(adobe_rgb))
    cmyk = iw.jpeg_bytes(img, ((1, 1),) * 4, quality=95, adobe_transform=0)
    _assert_same(native.decode_jpeg(cmyk, colour=2), 255 - native.decode_jpeg(cmyk))
    assert native.jpeg_frame(iw.jpeg_bytes(img[..., :3], SAMPLINGS["411"])) == (
        24, 16, ((4, 1), (1, 1), (1, 1)))


# ---- datasets -------------------------------------------------------------------------

def test_colmap_scene_of_tiled_jpeg_tiffs_equals_jaxs(tmp_path):
    """The COLMAP fixture with its views as tiled JPEG-YCbCr (4:2:0) TIFFs:
    the same cameras and ground truths as JAX's `build_cameras`."""
    src = tmp_path / "colmap_tiff"
    shutil.copytree(FIXTURES / "colmap_jpeg", src)
    (src / "images_tiff").mkdir()
    for jpg in sorted((src / "images").glob("*.jpg")):
        view = native.read_jpeg(str(jpg))
        (src / "images_tiff" / f"{jpg.stem}.tif").write_bytes(iw.tiff_bytes(
            iw.rgb_to_ycc(view), 6, compression=7, tile=(64, 64),
            jpeg=dict(sampling=SAMPLINGS["420"], subsampling=(2, 2))))
    sparse = src / "sparse" / "0"
    imgs = cm.read_images_binary(str(sparse / "images.bin"))
    cm.write_images_binary({k: v._replace(name=v.name.replace(".jpg", ".tif"))
                            for k, v in imgs.items()}, str(sparse / "images.bin"))
    t = tds.read_colmap_scene(str(src), "images_tiff", eval_split=True)
    j = jds.read_colmap_scene(str(src), "images_tiff", eval_split=True)
    cams = t.train_cameras + t.test_cameras
    assert len(cams) == 6
    for x, y in zip(cams, j.train_cameras + j.test_cameras):
        assert (x.image_name, x.width, x.height) == (y.image_name, y.width, y.height)
        assert x.image.dtype == y.image.dtype and x.image.tobytes() == y.image.tobytes()
    for res in (1, 2):
        for (_, tg), (_, jg) in zip(tds.build_cameras(t.train_cameras, res, device="cpu"),
                                    jds.build_cameras(j.train_cameras, res)):
            assert tg.tobytes() == np.asarray(jg).tobytes()
