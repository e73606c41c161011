"""Every image the JAX package reads through PIL, read by the port without
PIL (`utils/image_io.py`): PNG at every colour type and bit depth, JPEG at
every integral sampling and with 4 components, BMP and TIFF.

Every comparison is exact: `read_image` against `np.asarray(Image.open(f))`
in dtype, shape and bytes; the port's `scene/datasets._load_image` against
JAX's bit for bit; each native routine against its plain version. The
committed fixtures under `tests/format_fixtures/` (with PIL's arrays as
`.npy`, for the card) come from `tools/make_torch_fixtures.py --formats`; the generated cases are written here by
`tools/image_writers.py`, the files PIL reads but will not write.
"""

import io
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from tools import image_writers as iw
from wast3d_tpu.eval import metrics as jmetrics
from wast3d_tpu.scene import datasets as jds
from wast3d_tpu_torch import native
from wast3d_tpu_torch.eval import metrics as tmetrics
from wast3d_tpu_torch.scene import datasets as tds
from wast3d_tpu_torch.utils import image_io, png

ROOT = Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "torch_fixtures"
FORMATS = ROOT / "tests" / "format_fixtures"
COMMITTED = sorted(p for p in FORMATS.iterdir() if p.is_file() and p.suffix != ".npy")


def _image(h, w, c=3, seed=0):
    """Smooth colour with noise, uint8."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(x / 7 + seed), 128 + 90 * np.cos(y / 5),
                     128 + 60 * np.sin((x + y) / 9), 128 + 127 * np.cos(x / 11)], -1)[..., :c]
    img = np.clip(base + rng.normal(0, 25, base.shape), 0, 255).astype(np.uint8)
    return img[..., 0] if c == 1 else img


def _assert_same(got, want):
    assert (got.dtype, got.shape) == (want.dtype, want.shape)
    assert got.tobytes() == want.tobytes()


def _assert_pils(blob, tmp_path, suffix):
    """read_image and both `_load_image`s on `blob` against PIL."""
    want = np.asarray(Image.open(io.BytesIO(blob)))
    _assert_same(image_io.decode_image(blob, "case"), want)
    path = tmp_path / f"case{suffix}"
    path.write_bytes(blob)
    _assert_same(image_io.read_image(str(path)), want)
    t, j = tds._load_image(str(path)), jds._load_image(str(path))
    assert t.dtype == j.dtype == np.float32 and t.tobytes() == j.tobytes()


# ---- committed fixtures -------------------------------------------------------------

@pytest.mark.parametrize("path", COMMITTED, ids=lambda p: p.name)
def test_committed_fixture_is_pils_array(path):
    want = np.asarray(Image.open(path))
    _assert_same(np.load(path.with_suffix(".npy")), want)  # the card's copy is current
    _assert_same(image_io.read_image(str(path)), want)
    t, j = tds._load_image(str(path)), jds._load_image(str(path))
    assert t.tobytes() == j.tobytes()


def test_committed_fixtures_cover_every_family():
    names = [p.stem for p in COMMITTED]
    for prefix in ("png_grey1", "png_grey2", "png_grey4", "png_grey16", "png_rgb16",
                   "png_rgba16", "png_la16", "png_pal1", "png_pal2", "png_pal4", "png_pal8",
                   "png_rgb_trns", "png_rgba_bad_idat_crc", "jpeg_440", "jpeg_411", "jpeg_cmyk",
                   "jpeg_ycck", "bmp_pal", "bmp_rle8", "bmp_rle4", "bmp_rgb24", "bmp_bgra32",
                   "tif_l_", "tif_la_", "tif_rgb_", "tif_rgba_", "tif_i16", "tif_rgb16",
                   "tif_rgba16"):
        assert any(n.startswith(prefix) for n in names), prefix
    for p in COMMITTED:  # each at most 64 x 48
        h, w = np.load(p.with_suffix(".npy")).shape[:2]
        assert h <= 48 and w <= 64, p.name


# ---- PNG ------------------------------------------------------------------------------

PNG_CASES = [(ct, d) for ct, ds in png._DEPTHS.items() for d in ds]


@pytest.mark.parametrize("interlace", [False, True], ids=["flat", "adam7"])
@pytest.mark.parametrize("ctype,bits", PNG_CASES, ids=lambda v: str(v))
def test_png_every_colour_type_and_depth_equals_pil(ctype, bits, interlace, tmp_path):
    rng = np.random.default_rng(ctype * 100 + bits)
    c = png._CHANNELS[ctype]
    for (h, w), ftype in (((1, 1), 0), ((9, 1), 4), ((1, 13), 1), ((11, 13), 3), ((23, 17), 4)):
        vals = rng.integers(0, 1 << bits, (h, w, c)).astype(np.uint16 if bits == 16 else np.uint8)
        kw = {}
        if ctype == 3:
            kw = dict(palette=rng.integers(0, 256, (1 << bits, 3)), trns=b"\x00\x80\x10")
        blob = iw.png_bytes(vals, bits, ctype, interlace=interlace, filter_type=ftype,
                            idat_parts=2, **kw)
        _assert_pils(blob, tmp_path, ".png")
        _assert_same(png.decode_png_reference(blob), np.asarray(Image.open(io.BytesIO(blob))))


def test_png_ancillary_chunks_and_idat_crc_leave_the_array_alone(tmp_path):
    img = _image(10, 12, 3, seed=4)
    plain = png.decode_png(iw.png_bytes(img, 8, 2))
    for kw in (dict(trns=b"\x00\x01\x00\x02\x00\x03"),
               dict(extra=[(b"gAMA", b"\x00\x00\xb1\x8f"), (b"tEXt", b"k\x00v")]),
               dict(bad_idat_crc=True, idat_parts=3)):
        blob = iw.png_bytes(img, 8, 2, **kw)
        _assert_pils(blob, tmp_path, ".png")
        _assert_same(png.decode_png(blob), plain)
    bad = bytearray(iw.png_bytes(img, 8, 2))
    bad[29] ^= 1  # IHDR's CRC: PIL refuses the file, and so does the port
    with pytest.raises(OSError):
        Image.open(io.BytesIO(bytes(bad)))
    with pytest.raises(ValueError, match=r"bad\.png.*checksum.*IHDR"):
        image_io.decode_image(bytes(bad), "bad.png")


def test_png_writer_16_bit_round_trips_through_pil():
    img = np.random.default_rng(3).integers(0, 65536, (7, 9, 4)).astype(np.uint16)
    blob = png.encode_png(img, filter_type=4)
    _assert_same(png.decode_png(blob), (img >> 8).astype(np.uint8))
    _assert_same(np.asarray(Image.open(io.BytesIO(png.encode_png(img[..., 0])))), img[..., 0])


# ---- JPEG -----------------------------------------------------------------------------

SAMPLINGS = {
    "444": ((1, 1), (1, 1), (1, 1)), "422": ((2, 1), (1, 1), (1, 1)),
    "420": ((2, 2), (1, 1), (1, 1)), "440": ((1, 2), (1, 1), (1, 1)),
    "411": ((4, 1), (1, 1), (1, 1)), "410": ((4, 2), (1, 1), (1, 1)),
    "h3v1": ((3, 1), (1, 1), (1, 1)), "h1v3": ((1, 3), (1, 1), (1, 1)),
    "h1v4": ((1, 4), (1, 1), (1, 1)), "h2v4": ((2, 4), (1, 1), (1, 1)),
    "mixed": ((2, 2), (2, 1), (1, 2)), "chroma_h2": ((1, 1), (2, 1), (1, 1)),
}


@pytest.mark.parametrize("size", [(48, 64), (17, 23), (1, 9), (13, 1)],
                         ids=lambda s: f"{s[1]}x{s[0]}")
@pytest.mark.parametrize("name", sorted(SAMPLINGS))
def test_jpeg_sampling_equals_pil(name, size, tmp_path):
    img = _image(*size, seed=size[0] + len(name))
    blob = iw.jpeg_bytes(iw.rgb_to_ycc(img), SAMPLINGS[name], quality=88)
    _assert_pils(blob, tmp_path, ".jpg")


@pytest.mark.parametrize("kind", ["cmyk", "cmyk_no_adobe", "ycck", "ycck_420", "ycck_440",
                                  "adobe_unknown_transform", "rgb_adobe", "ycc_adobe"])
def test_four_component_and_adobe_jpegs_equal_pil(kind, tmp_path):
    img = _image(21, 38, 4, seed=len(kind))
    ycck = np.concatenate([iw.rgb_to_ycc(img[..., :3]), img[..., 3:]], -1)
    samples, sampling, adobe = {
        "cmyk": (img, ((1, 1),) * 4, 0),
        "cmyk_no_adobe": (img, ((2, 1), (1, 1), (1, 1), (2, 1)), None),
        "ycck": (ycck, ((1, 1),) * 4, 2),
        "ycck_420": (ycck, ((2, 2), (1, 1), (1, 1), (2, 2)), 2),
        "ycck_440": (ycck, ((1, 2), (1, 1), (1, 1), (1, 2)), 2),
        "adobe_unknown_transform": (ycck, ((1, 1),) * 4, 1),
        "rgb_adobe": (img[..., :3], ((1, 1),) * 3, 0),
        "ycc_adobe": (ycck[..., :3], ((2, 1), (1, 1), (1, 1)), 1)}[kind]
    _assert_pils(iw.jpeg_bytes(samples, sampling, quality=85, adobe_transform=adobe),
                 tmp_path, ".jpg")


def test_progressive_cmyk_jpeg_from_pil_equals_pil(tmp_path):
    buf = io.BytesIO()
    Image.fromarray(_image(30, 41, seed=5)).convert("CMYK").save(buf, "JPEG", quality=80,
                                                                  progressive=True)
    assert b"\xff\xc2" in buf.getvalue()
    _assert_pils(buf.getvalue(), tmp_path, ".jpg")


@pytest.mark.parametrize("case", ["fractional", "mcu_too_large"])
def test_jpeg_samplings_libjpeg_refuses_raise_as_in_pil(case):
    if case == "mcu_too_large":  # 16 + 4 + 1 blocks in an MCU; libjpeg takes 10
        blob = iw.jpeg_bytes(iw.rgb_to_ycc(_image(32, 32)), ((4, 4), (2, 2), (1, 1)))
        match = "too large for an interleaved scan"
    else:  # Y 2x1 and Cb 3x1 in the frame: 3 / 2 is no integral ratio
        blob = bytearray(iw.jpeg_bytes(iw.rgb_to_ycc(_image(16, 48)), ((3, 1), (1, 1), (1, 1))))
        sof = blob.index(b"\xff\xc0")
        blob[sof + 11], blob[sof + 14] = 0x21, 0x31
        blob, match = bytes(blob), "fractional sampling"
    with pytest.raises(OSError):
        np.asarray(Image.open(io.BytesIO(blob)))
    with pytest.raises(ValueError, match=match):
        native.decode_jpeg(blob, "odd.jpg")


@pytest.mark.parametrize("rv", [1, 2, 3, 4])
@pytest.mark.parametrize("rh", [1, 2, 3, 4])
def test_native_upsampling_equals_its_plain_version(rh, rv):
    rng = np.random.default_rng(rh * 10 + rv)
    for h, w in ((1, 1), (1, 2), (2, 3), (5, 7), (16, 9)):
        plane = rng.integers(0, 256, (h, w)).astype(np.uint8)
        for oh, ow in ((h * rv, w * rh), (max(1, h * rv - rv + 1), max(1, w * rh - rh + 1))):
            _assert_same(native.jpeg_upsample(plane, rh, rv, ow, oh),
                         image_io.jpeg_upsample_reference(plane, rh, rv, ow, oh))


# ---- BMP ------------------------------------------------------------------------------

def _bmp_cases():
    rng = np.random.default_rng(11)
    pal = rng.integers(0, 256, (256, 3))
    greys = np.repeat(np.arange(256)[:, None], 3, axis=1)
    out = []
    for h, w in ((1, 1), (7, 5), (9, 33)):
        idx = rng.integers(0, 256, (h, w))
        rgba = _image(h, w, 4, seed=w)
        for td in (False, True):
            s = f"{w}x{h}{'_topdown' if td else ''}"
            out += [
                (f"pal1_{s}", iw.bmp_bytes(idx & 1, 1, pal[:2], top_down=td)),
                (f"bw1_{s}", iw.bmp_bytes(idx & 1, 1, greys[[0, 255]], top_down=td)),
                (f"pal4_{s}", iw.bmp_bytes(idx & 15, 4, pal[:16], top_down=td)),
                (f"pal8_{s}", iw.bmp_bytes(idx, 8, pal, top_down=td)),
                (f"grey8_{s}", iw.bmp_bytes(idx, 8, greys, top_down=td)),
                (f"rle8_{s}", iw.bmp_bytes(idx // 64 * 64, 8, pal, compression=1, top_down=td)),
                (f"rle4_{s}", iw.bmp_bytes(idx // 64, 4, pal[:16], compression=2,
                                           top_down=td)),
                (f"rgb555_{s}", iw.bmp_bytes(rgba[..., :3], 16, top_down=td)),
                (f"rgb565_{s}", iw.bmp_bytes(rgba[..., :3], 16, compression=3,
                                             masks=(0xF800, 0x7E0, 0x1F), top_down=td)),
                (f"rgb24_{s}", iw.bmp_bytes(rgba[..., :3], 24, top_down=td)),
                (f"rgbx32_{s}", iw.bmp_bytes(rgba, 32, top_down=td)),
                (f"bgra32_v4_{s}", iw.bmp_bytes(rgba, 32, compression=3, header_size=108,
                                                masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000),
                                                top_down=td)),
                (f"rgba32_v2_{s}", iw.bmp_bytes(rgba, 32, compression=3, header_size=56,
                                                masks=(0xFF, 0xFF00, 0xFF0000, 0xFF000000),
                                                top_down=td)),
                (f"bgrx32_bitfields_{s}", iw.bmp_bytes(rgba, 32, compression=3,
                                                       masks=(0xFF0000, 0xFF00, 0xFF)))]
    return out


BMP_CASES = _bmp_cases()


@pytest.mark.parametrize("name,blob", BMP_CASES, ids=[n for n, _ in BMP_CASES])
def test_bmp_equals_pil(name, blob, tmp_path):
    _assert_pils(blob, tmp_path, ".bmp")


@pytest.mark.parametrize("mode", ["1", "L", "P", "RGB", "RGBA"])
def test_bmp_from_pils_writer_equals_pil(mode, tmp_path):
    img = Image.fromarray(_image(13, 27, 4, seed=2))
    img = img.convert(mode) if mode != "P" else img.convert("RGB").quantize(9)
    buf = io.BytesIO()
    img.save(buf, "BMP")
    _assert_pils(buf.getvalue(), tmp_path, ".bmp")


def test_bmp_pillow_refuses_raise():
    rgba = _image(4, 5, 4)
    odd_masks = iw.bmp_bytes(rgba, 32, compression=3, masks=(0xFF00, 0xFF, 0xFF0000))
    identity_greys = iw.bmp_bytes(np.zeros((3, 9), np.uint8), 4,
                                  np.repeat(np.arange(16)[:, None], 3, axis=1))
    for blob, match in ((odd_masks, "bitfields"), (identity_greys, "hold no L row")):
        with pytest.raises(OSError):
            np.asarray(Image.open(io.BytesIO(blob)))
        with pytest.raises(ValueError, match=match):
            image_io.decode_image(blob, "odd.bmp")


@pytest.mark.parametrize("rle4", [False, True], ids=["rle8", "rle4"])
def test_native_bmp_runs_equal_their_plain_version(rle4):
    rng = np.random.default_rng(int(rle4))
    for h, w in ((1, 1), (6, 11), (9, 40)):
        idx = (rng.integers(0, 16 if rle4 else 256, (h, w)) // 3 * 3).astype(np.uint8)
        blob = iw.bmp_bytes(idx, 4 if rle4 else 8, rng.integers(0, 256, (256, 3))[:16 if rle4
                                                                                 else 256],
                            compression=2 if rle4 else 1)
        start = int.from_bytes(blob[10:14], "little")
        _assert_same(native.bmp_rle(blob, start, w, h, rle4),
                     image_io.bmp_rle_reference(blob, start, w, h, rle4))
        # a delta (Pillow reads two bytes more than the format has), an early
        # end of line, a run past the row, an absolute run (RLE4 reads half
        # its bytes), then a run and an end of line a row and an end of
        # bitmap: the native runs, the plain ones and PIL's agree
        odd = (blob[:start] + bytes([4, 7, 0, 2, 1, 1, 1, 0, 2, 3, 0, 0, 200, 5, 0, 4, 1, 2, 3, 4])
               + bytes([w, 9, 0, 0]) * h + b"\x00\x01")

        def outcome(fn):
            try:
                return fn().tobytes()
            except (ValueError, OSError):
                return "refused"

        got = outcome(lambda: native.bmp_rle(odd, start, w, h, rle4))
        assert got != "refused"
        assert got == outcome(lambda: image_io.bmp_rle_reference(odd, start, w, h, rle4))
        assert outcome(lambda: image_io.decode_image(odd)) == outcome(
            lambda: np.asarray(Image.open(io.BytesIO(odd))))


@pytest.mark.parametrize("bits", [1, 2, 4])
def test_native_unpacking_equals_its_plain_version(bits):
    rows = np.random.default_rng(bits).integers(0, 256, (7, 5)).astype(np.uint8)
    for w in (1, 5 * 8 // bits - 1, 5 * 8 // bits):
        _assert_same(native.unpack_bits(rows, w, bits), png._unpack(rows, w, bits))


# ---- TIFF -----------------------------------------------------------------------------

def _tiff_cases():
    rng = np.random.default_rng(12)
    out = []
    for h, w in ((1, 1), (9, 13)):
        a8 = (np.cumsum(rng.integers(0, 9, (h, w, 4)), axis=1) % 256).astype(np.uint8)
        a16 = rng.integers(0, 65536, (h, w, 4)).astype(np.uint16)
        for comp, pred in ((1, 1), (32773, 1), (5, 1), (5, 2), (8, 2), (32946, 1)):
            for bo in "<>":
                kw = dict(compression=comp, predictor=pred, byteorder=bo, rows_per_strip=4)
                s = f"{w}x{h}_c{comp}_p{pred}_{'II' if bo == '<' else 'MM'}"
                out += [(f"l_{s}", iw.tiff_bytes(a8[..., 0], 1, **kw)),
                        (f"l_white_{s}", iw.tiff_bytes(a8[..., 0], 0, **kw)),
                        (f"la_{s}", iw.tiff_bytes(a8[..., :2], 1, extra_samples=(2,), **kw)),
                        (f"rgb_{s}", iw.tiff_bytes(a8[..., :3], 2, **kw)),
                        (f"i16_{s}", iw.tiff_bytes(a16[..., 0], 1, **kw)),
                        (f"rgb16_{s}", iw.tiff_bytes(a16[..., :3], 2, **kw))]
                for ex in ((), (0,), (1,), (2,)):
                    out += [(f"rgba{ex}_{s}", iw.tiff_bytes(a8, 2, extra_samples=ex, **kw)),
                            (f"rgba16{ex}_{s}", iw.tiff_bytes(a16, 2, extra_samples=ex, **kw))]
    return out


TIFF_CASES = _tiff_cases()


@pytest.mark.parametrize("name,blob", TIFF_CASES, ids=[n for n, _ in TIFF_CASES])
def test_tiff_equals_pil(name, blob, tmp_path):
    _assert_pils(blob, tmp_path, ".tif")


@pytest.mark.parametrize("compression", ["raw", "packbits", "tiff_lzw", "tiff_deflate",
                                         "tiff_adobe_deflate"])
def test_tiff_from_pils_writer_equals_pil(compression, tmp_path):
    for mode in ("L", "LA", "RGB", "RGBA", "I;16"):
        img = _image(11, 21, 4, seed=3)
        pil = (Image.fromarray((img[..., 0].astype(np.uint16) * 257)) if mode == "I;16"
               else Image.fromarray(img).convert(mode))
        buf = io.BytesIO()
        pil.save(buf, "TIFF", compression=compression)
        _assert_pils(buf.getvalue(), tmp_path, ".tif")


@pytest.mark.parametrize("tag,value,match", [
    (259, 4, "Compression"), (317, 3, "Predictor"), (284, 3, "PlanarConfiguration"),
    (339, 3, "SampleFormat"), (322, 16, "TileWidth")])
def test_tiff_outside_the_reader_names_the_tag(tag, value, match):
    blob = iw.tiff_bytes(_image(8, 8), 2, compression=5, predictor=2,
                         tags=[] if tag in (259, 317, 284) else
                         [(tag, 3, [value] * (3 if tag == 339 else 1))])
    if tag in (259, 317, 284):  # rewrite the existing entry's value
        entry = blob.index(tag.to_bytes(2, "little") + b"\x03\x00\x01\x00\x00\x00")
        blob = blob[:entry + 8] + value.to_bytes(2, "little") + blob[entry + 10:]
    with pytest.raises(ValueError, match=rf"x\.tif: TIFF {match} \(tag {tag}\) = .*{value}"):
        image_io.decode_image(blob, "x.tif")


def test_native_lzw_and_packbits_equal_their_plain_versions():
    rng = np.random.default_rng(5)
    for n in (0, 1, 7, 5000, 60000):  # 60000 bytes pass the 4094-entry table reset
        data = bytes((np.cumsum(rng.integers(0, 4, n)) % 256).astype(np.uint8))
        lzw, pb = iw.lzw_encode(data), iw.packbits_encode(data)
        for decoded in (native.lzw_decode(lzw, n), image_io.lzw_reference(lzw, n),
                        native.packbits_decode(pb, n), image_io.packbits_reference(pb, n)):
            assert decoded.tobytes() == data
        assert native.lzw_decode(lzw, n // 2).tobytes() == data[:n // 2]
    with pytest.raises(ValueError, match="LSB-first"):
        native.lzw_decode(b"\x00\x01\x02", 8)


def test_unknown_signatures_raise_naming_file_and_bytes():
    for blob in (b"8BPS\x00\x01\x00\x00", b"RIFF\x00\x00\x00\x00WAVE", b"RIFF\x00\x00\x00\x00WEBP", b""):
        with pytest.raises(ValueError, match=r"x\.img: .*starts with"):
            image_io.decode_image(blob, "x.img")


# ---- datasets and metrics -------------------------------------------------------------

def _assert_same_infos(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert (x.uid, x.image_name, x.width, x.height) == (y.uid, y.image_name, y.width,
                                                             y.height)
        assert x.image.dtype == y.image.dtype and x.image.tobytes() == y.image.tobytes()


def test_blender_scene_of_16_bit_rgba_pngs_equals_jaxs(tmp_path):
    root = tmp_path / "blender16"
    root.mkdir()
    frames = []
    rng = np.random.default_rng(6)
    for i in range(3):
        c2w = np.eye(4)
        c2w[:3, 3] = [np.sin(i), 0.2, -4 + 0.1 * i]
        frames.append({"file_path": f"./r_{i}", "transform_matrix": c2w.tolist()})
        rgba = _image(30, 36, 4, seed=i).astype(np.uint16) * 257 + rng.integers(0, 257,
                                                                              (30, 36, 4))
        (root / f"r_{i}.png").write_bytes(iw.png_bytes(rgba.astype(np.uint16), 16, 6,
                                                       interlace=i == 1, filter_type=4))
    (root / "transforms_train.json").write_text(json.dumps({"camera_angle_x": 0.8,
                                                            "frames": frames}))
    j = jds.read_blender_scene(str(root))  # writes points3d.ply
    t = tds.read_blender_scene(str(root))
    _assert_same_infos(t.train_cameras, j.train_cameras)
    for res in (1, 2):
        for (_, tg), (_, jg) in zip(tds.build_cameras(t.train_cameras, res, device="cpu"),
                                    jds.build_cameras(j.train_cameras, res)):
            assert tg.tobytes() == np.asarray(jg).tobytes()


def test_colmap_scene_of_440_jpegs_equals_jaxs(tmp_path):
    src = tmp_path / "colmap_jpeg"
    shutil.copytree(FIXTURES / "colmap_jpeg", src)
    shutil.copytree(FORMATS / "colmap_440", src / "images_440",
                    ignore=shutil.ignore_patterns("*.npy"))
    t = tds.read_colmap_scene(str(src), "images_440", eval_split=True)
    j = jds.read_colmap_scene(str(src), "images_440", eval_split=True)
    _assert_same_infos(t.train_cameras + t.test_cameras, j.train_cameras + j.test_cameras)
    for cam in t.train_cameras + t.test_cameras:  # the card's copies of PIL's decode
        want = np.load(FORMATS / "colmap_440" / f"{cam.image_name}.npy")
        assert cam.image.tobytes() == (want.astype(np.float32) / 255.0).tobytes()
    for (_, tg), (_, jg) in zip(tds.build_cameras(t.train_cameras, 2, device="cpu"),
                                jds.build_cameras(j.train_cameras, 2)):
        assert tg.tobytes() == np.asarray(jg).tobytes()


def _same_reads(renders, gt):
    a, b = tmetrics._read_images(str(renders), str(gt)), jmetrics._read_images(str(renders),
                                                                              str(gt))
    assert a[2] == b[2]
    for x, y in zip(a[0] + a[1], b[0] + b[1]):
        assert x.dtype == y.dtype == np.float32 and x.tobytes() == y.tobytes()
    return a


def test_metrics_read_a_jpeg_method_directory_as_jax_does():
    d = FORMATS / "metrics_jpeg"
    renders, gts, names = _same_reads(d / "renders", d / "gt")
    assert names == ["00000.jpg", "00001.jpg"]
    for r, g, n in zip(renders, gts, names):
        for got, kind in ((r, "renders"), (g, "gt")):
            want = np.load(d / "pil" / f"{kind}_{n[:-4]}.npy")
            assert got.tobytes() == (want.astype(np.float32)[..., :3] / 255.0).tobytes()


def test_metrics_read_a_png_named_jpg_and_other_formats_as_jax_does(tmp_path):
    """Files are dispatched on their signature: a PNG named .jpg, a TIFF
    named .png, a BMP named .jpeg."""
    renders, gt = tmp_path / "renders", tmp_path / "gt"
    renders.mkdir()
    gt.mkdir()
    img = _image(24, 32, 4, seed=9)
    buf = io.BytesIO()
    Image.fromarray(img[..., :3]).save(buf, "BMP")
    for i, (r, g) in enumerate(((png.encode_png(img), iw.tiff_bytes(img, 2, compression=5,
                                                                    extra_samples=(2,))),
                                (buf.getvalue(), png.encode_png(img[..., :3])))):
        name = ("a.jpg", "b.jpeg")[i]
        (renders / name).write_bytes(r)
        (gt / name).write_bytes(g)
    _same_reads(renders, gt)
