"""Netpbm, TGA and QOI read by the port without PIL (`utils/image_io.py`,
`native/image.cpp`), and the reader's dispatch in PIL's order.

Every comparison is exact: `decode_image` / `read_image` against
`np.asarray(PIL.Image.open(f))` in dtype, shape and bytes; a file PIL
refuses must raise a `ValueError` naming the file. Generated files come from
`tools/image_writers` (`pnm_bytes`, `tga_bytes`, `qoi_bytes`, and PIL's own
writers); the committed fixtures (`pnm_*`, `tga_*`, `qoi_*` and
`metrics_tga_ppm/` under `tests/format_fixtures/`) from
`tools/make_torch_fixtures.py --raster`. The native byte loops (TGA run
lengths, QOI) are held to their plain versions. Truncated and bit-flipped
files are decoded in a child process, so that a crash fails one test and
not a worker.
"""

import io
import json
import shutil
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from tests.test_torch_image_formats import _assert_same, _image, _same_reads
from tests.test_torch_image_tiff_layouts import _same_as_pil
from tools import image_writers as iw
from wast3d_tpu.eval import metrics as jmetrics
from wast3d_tpu.scene import datasets as jds
from wast3d_tpu_torch import native
from wast3d_tpu_torch.eval import metrics as tmetrics
from wast3d_tpu_torch.scene import colmap as cm
from wast3d_tpu_torch.scene import datasets as tds
from wast3d_tpu_torch.utils import image_io

ROOT = Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "torch_fixtures"
FORMATS = ROOT / "tests" / "format_fixtures"
NEW = sorted(p for p in FORMATS.iterdir() if p.suffix in (".pbm", ".pgm", ".ppm", ".pfm",
                                                            ".tga", ".qoi"))


def _pil_bytes(arr, fmt, **kw):
    buf = io.BytesIO()
    (arr if isinstance(arr, Image.Image) else Image.fromarray(arr)).save(buf, fmt, **kw)
    return buf.getvalue()


# ---- committed fixtures ---------------------------------------------------------------

@pytest.mark.parametrize("path", NEW + sorted((FORMATS / "metrics_tga_ppm").glob("*/0*")),
                         ids=lambda p: str(p.relative_to(FORMATS)))
def test_fixture_is_pils_array(path):
    want = np.asarray(Image.open(path))
    npy = path.with_suffix(".npy")
    if not npy.exists():
        npy = path.parent.parent / "pil" / f"{path.parent.name}_{path.stem}.npy"
    _assert_same(np.load(npy), want)
    _assert_same(image_io.read_image(str(path)), want)
    t, j = tds._load_image(str(path)), jds._load_image(str(path))
    assert t.dtype == j.dtype == np.float32 and t.tobytes() == j.tobytes()


def test_fixtures_cover_every_kind():
    names = {p.stem for p in NEW}
    for want in ("pnm_p1", "pnm_p2", "pnm_p3", "pnm_p4", "pnm_p5", "pnm_p6", "pnm_p5_65535",
                 "pnm_p6_65535", "pnm_pf_little", "pnm_pf_big", "tga_t1_cmap24_first",
                 "tga_t2_24", "tga_t2_32_right_to_left", "tga_t2_16", "tga_t3_8_id",
                 "tga_t3_16", "tga_t3_1", "tga_t9_rle_cmap", "tga_t10_rle_24_rows",
                 "tga_t10_rle_24_literals_across", "tga_t11_rle_8", "qoi_rgb", "qoi_rgba"):
        assert want in names, want
    dtypes = {np.load(p.with_suffix(".npy")).dtype.str for p in NEW}
    assert {"|b1", "|u1", "<i4", "<f4"} <= dtypes
    types = {p.read_bytes()[2] for p in NEW if p.suffix == ".tga"}
    assert types == {1, 2, 3, 9, 10, 11}
    ops = set()
    for p in NEW:
        if p.suffix == ".qoi":
            ops |= {b >> 6 if b < 0xFE else b for b in p.read_bytes()[14:-8]}
    assert ops >= {0, 1, 2, 3, 0xFE, 0xFF}


# ---- Netpbm ---------------------------------------------------------------------------

@pytest.mark.parametrize("maxval", [1, 2, 15, 100, 255, 256, 1000, 4095, 65534, 65535])
def test_pnm_every_maxval_equals_pil(maxval):
    rng = np.random.default_rng(maxval)
    for h, w in ((1, 1), (3, 9), (17, 23)):
        grey, rgb = rng.integers(0, maxval + 1, (h, w)), rng.integers(0, maxval + 1, (h, w, 3))
        for magic, v in ((b"P2", grey), (b"P5", grey), (b"P3", rgb), (b"P6", rgb)):
            for sep in (b" ", b"\n", b"\t  \r\n"):
                assert _same_as_pil(iw.pnm_bytes(v, magic, maxval, ascii_sep=sep,
                                                 comment=b" made here" if h > 1 else b""))


def test_pnm_bits_and_floats_equal_pil():
    rng = np.random.default_rng(3)
    for h, w in ((1, 1), (3, 9), (17, 23), (2, 8)):
        bits = rng.integers(0, 2, (h, w))
        for magic in (b"P1", b"P4"):
            assert _same_as_pil(iw.pnm_bytes(bits, magic))
        assert _same_as_pil(iw.pnm_bytes(bits, b"P1", ascii_sep=b""))
        f = rng.normal(0, 10, (h, w)).astype(np.float32)
        for scale in (-1.0, 1.0, -0.5, 2.0):  # the sign picks the byte order
            assert _same_as_pil(iw.pnm_bytes(f, b"Pf", scale=scale))
    img = _image(13, 17, 3)
    for mode, arr in (("1", img[..., 0] > 128), ("L", img[..., 0]), ("RGB", img),
                      ("I;16", img[..., 0].astype(np.uint16) * 257),
                      ("F", img[..., 0].astype(np.float32) / 7)):
        assert _same_as_pil(_pil_bytes(arr, "PPM"))


HEADERS = [b"P5 5 4 255\n", b"P5\n#c\n5 4\n255\n", b"P5\n5#x\n 4 255 ", b"P5 5\r4\r255\r",
           b"P5 +5 4 255\n", b"P5 5 4 0255\n", b"P5\t5\x0b4\x0c255\t", b"P5 5 4 1_0\n",
           b"P5 5 4 255#c\n", b"P5 05 004 255\n", b"P5 5 4 25500000000\n", b"P5 5 4 65536\n",
           b"P5 0 4 255\n", b"P5 -5 4 255\n", b"P7 5 4 255\n", b"PF 5 4 -1\n",
           b"PyP 5 4 255\n", b"PyRGBA 5 1 255\n", b"P0CMYK 5 1 255\n", b"PyCMYK 5 1 255\n",
           b"Pf 5 1 0\n", b"Pf 5 1 nan\n", b"Pf 5 1 -1e0\n", b"P5 5 4", b"P5 5 4 \n"]


@pytest.mark.parametrize("header", HEADERS, ids=range(len(HEADERS)))
def test_pnm_headers_parse_as_pils(header):
    """Comments inside tokens, every whitespace, signs and underscores in
    numbers (Python's int), PIL's own magic numbers, and the headers PIL
    refuses."""
    data = bytes(range(7, 7 + 5 * 4 * 4 * 2 % 256)) * 3
    _same_as_pil(header + data)


@pytest.mark.parametrize("body", [
    b"P2 3 2 255\n1 2#x\n3 4\n#hello 5\n5 6 7", b"P2 3 2 255\n1 2#x\n3 4 5 6 7",
    b"P1 3 2\n1#c\n0 1 0\n01 junk", b"P1 3 2\n101010junk", b"P1 3 2\n1 0 1 2 0 1",
    b"P2 3 2 255\n1 2 3 4 5 256", b"P2 3 2 255\n1 2 3 4 5 -1", b"P3 1 1 255\n1 2 3 x y",
    b"P3 1 1 255\n1 2", b"P2 2 1 65535\n65535 32768", b"P2 2 1 7\n+7 0_3",
    b"P3 1 1 255\n1 2 12345678901", b"P2 2 1 255\n1 2#end\n"], ids=range(13))
def test_pnm_plain_data_as_pil_reads_it(body):
    _same_as_pil(body)


def test_pnm_comment_running_to_the_end_raises():
    """PIL's plain decoder loops forever on a comment that runs to the end of
    the file after a cut token; the port raises."""
    with pytest.raises(ValueError, match=r"^x\.pgm: not enough image data"):
        image_io.decode_image(b"P2 2 1 255\n1#no end", "x.pgm")


def test_pnm_plain_reads_across_blocks_as_pil():
    """PIL's plain decoder reads 1 MiB at a time: a token cut by the block's
    end (stitched to its rest), a comment running over the block's end
    (dropped, joining the token around it), and junk after the last sample in
    a block never read."""
    block = image_io._SAFEBLOCK
    m = block // 4 - 1
    fill = b"100 " * 1000 + b"255"
    for cut in (b"100 " * m + b"   1" + b"7 ",  # "1" ends the first block
                b"100 " * (m - 1) + b"  1#cut comment\n7 "):  # "#" 5 bytes before its end
        body = cut + fill
        tokens = len(body.replace(b"#cut comment\n", b"").split())
        assert _same_as_pil(b"P2 %d 1 255\n" % tokens + body)
    assert _same_as_pil(b"P1 %d 1\n" % block + b"0" * block + b" junk")
    assert not _same_as_pil(b"P1 9 1\n" + b"0" * 9 + b" junk")  # junk in the same block


# ---- TGA ------------------------------------------------------------------------------

@pytest.mark.parametrize("map_depth", [16, 24, 32])
def test_tga_colour_mapped_equals_pil(map_depth):
    rng = np.random.default_rng(map_depth)
    pal = rng.integers(0, 256, (300, 4)).astype(np.uint8)
    for h, w in ((1, 1), (3, 9), (17, 23)):
        idx = rng.integers(0, 200, (h, w)).astype(np.uint8)
        idx[:, :w // 2] = 7
        for image_type in (1, 9, 3, 11):
            for first, size in ((0, 200), (5, 200), (0, 256), (56, 200), (0, 300)):
                for id_field in (b"", b"an id", b"x" * 255):
                    for top, rtl in ((False, False), (True, True)):
                        _same_as_pil(iw.tga_bytes(
                            idx, image_type, 8, pal[:size, :map_depth // 8], first_entry=first,
                            map_depth=map_depth, id_field=id_field, top_down=top,
                            right_to_left=rtl, rows_per_packet_run=1))


@pytest.mark.parametrize("image_type,depth", [(2, 24), (2, 32), (2, 16), (3, 8), (3, 16),
                                              (3, 1), (2, 8), (1, 16), (3, 24)])
def test_tga_true_colour_and_grey_equal_pil(image_type, depth):
    """Raw and run-length (packets within rows; literals across rows; a
    repeat across rows, which PIL refuses), both origins, 128- and 3-pixel
    packets."""
    rng = np.random.default_rng(depth)
    decoded = 0
    for h, w in ((1, 1), (3, 9), (17, 23)):
        px = rng.integers(0, 256, (h, w, max(depth // 8, 1))).astype(np.uint8)
        px[h // 2:] = 9
        if depth == 1:
            px = np.packbits(px[..., 0] > 100, axis=1)
        for rle in ((0, 8) if depth != 1 else (0,)):
            for across in (None, 1):
                for top in (False, True):
                    for packet in (128, 3):
                        decoded += _same_as_pil(iw.tga_bytes(
                            px, image_type + rle, depth, top_down=top, max_packet=packet,
                            rows_per_packet_run=across))
    assert (decoded > 0) == ((image_type, depth) not in ((2, 8), (1, 16), (3, 24)))


def test_tga_from_pils_writer_equals_pil():
    img = _image(17, 23, 4, seed=2)
    for mode in ("L", "LA", "RGB", "RGBA", "P", "1"):
        im = (Image.fromarray(img[..., :3]).quantize(17) if mode == "P"
              else Image.fromarray(img).convert(mode))
        for kw in ({}, dict(rle=True), dict(orientation=1), dict(rle=True, id_section=b"abc")):
            decoded = _same_as_pil(_pil_bytes(im, "TGA", **kw))
            assert decoded or (mode == "1" and "rle" in kw)  # PIL cannot read its own


def test_tga_16_bit_and_alpha_bits_equal_pil():
    """BGRA;15Z: 5-bit channels scaled as x * 255 // 31, the top bit an
    inverted alpha; the descriptor's alpha depth does not change it."""
    v = np.arange(65536, dtype="<u2").reshape(256, 256)
    for descriptor in (0, 1, 8):
        assert _same_as_pil(iw.tga_bytes(v.view(np.uint8).reshape(256, 256, 2), 2, 16,
                                         descriptor=descriptor))


# ---- QOI ------------------------------------------------------------------------------

OP_SETS = [("run", "index", "diff", "luma", "rgb", "rgba"), ("rgba",), ("rgb", "rgba"),
           ("diff", "rgba"), ("luma", "rgba"), ("index", "rgba"), ("run", "rgba")]


@pytest.mark.parametrize("ops", OP_SETS, ids=["-".join(o) for o in OP_SETS])
def test_qoi_every_op_equals_pil(ops):
    rng = np.random.default_rng(len(ops))
    for h, w in ((1, 1), (3, 9), (17, 23), (40, 70)):
        for c in (3, 4):
            px = rng.integers(0, 256, (h, w, c)).astype(np.uint8)
            px[:h // 2, :w // 2] = px[0, 0]
            px[h // 2:, ::3] = px[h // 2:, ::3] // 64 * 64
            smooth = np.cumsum(rng.integers(-2, 2, (h, w, c)), axis=1).astype(np.uint8)
            for arr in (px, smooth):
                for channels in (None, 3, 4, 7):
                    assert _same_as_pil(iw.qoi_bytes(arr, channels, ops))
            assert _same_as_pil(_pil_bytes(px, "QOI"))


def test_qoi_hand_made_streams_equal_pil():
    """An index of a slot never written (0, 0, 0, 0), a run before any pixel,
    a run past the last pixel, an RGBA op in an RGB file (its alpha enters
    the hash), no end marker."""
    head = b"qoif" + struct.pack(">IIBB", 3, 2, 3, 0)
    for ops in (b"\x05\xc5", b"\xc1\x07\x40\x7f\xfe\x01\x02\x03\xc3",
                b"\xff\x10\x20\x30\x00\x35\x35\xfe\x10\x20\x30\x35\xe0\xc5",
                b"\x80\x88\xa0\x08\xc9", b"\xfe\x01\x02"):
        for channels in (3, 4):
            blob = head[:12] + bytes([channels, 0]) + ops
            _same_as_pil(blob)
            _same_as_pil(blob + b"\x00" * 7 + b"\x01")


# ---- dispatch, limits -----------------------------------------------------------------

def test_dispatch_follows_pils_order():
    """Netpbm (P and one of 0123456fy) and QOI by signature; TGA, which has
    none, only after every format with one, so a file another of PIL's
    formats claims is not read as a TGA, and a file whose reader declines
    it (CUR without cursors, ICO without entries, PCX of no size) goes on to
    TGA as in PIL; files PIL opens with no reader here raise naming the file
    and its first bytes. Each blob ends as PIL's open ends: the same array,
    or a ValueError naming the file."""
    tga = iw.tga_bytes(_image(4, 5, 3), 2, 24)
    assert tga[:4] == b"\x00\x00\x02\x00"  # CUR's signature: PIL's CUR reader declines it
    assert _same_as_pil(tga)
    for blob in (b"\x00\x00\x02\x00\x01\x00" + tga[6:], b"\x0a" + tga[1:],
                 b"\x00\x00\x01\x00" + tga[4:], b"8BPS\x00\x01" + tga[6:], b"P7 1 1 255\n",
                 b"qoif\x00\x00", b"DDS \x7c\x00"):
        want = None
        try:
            want = np.asarray(Image.open(io.BytesIO(blob)))
        except Exception:
            pass
        if want is None:
            with pytest.raises(ValueError, match=r"^x\.img: "):
                image_io.decode_image(blob, "x.img")
        else:
            got = image_io.decode_image(blob, "x.img")
            assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    with pytest.raises(ValueError, match=r"^x\.img: not an image this reader knows .*TGA.*"
                                         r"starts with b'8BPS"):
        image_io.decode_image(b"8BPS\x00\x01" + tga[6:], "x.img")


def test_new_readers_check_pils_pixel_limit_before_decoding():
    for blob in (b"P5 50000 50000 255\n", b"P1 50000 50000\n", b"Pf 50000 50000 -1\n",
                 b"qoif" + struct.pack(">IIBB", 50000, 50000, 3, 0),
                 struct.pack("<BBBHHBHHHHBB", 0, 0, 2, 0, 0, 0, 0, 0, 50000, 50000, 24, 0)):
        with pytest.raises(Image.DecompressionBombError):
            Image.open(io.BytesIO(blob))
        with pytest.raises(ValueError, match=r"^big: 50000x50000 is more pixels than PIL"):
            image_io.decode_image(blob, "big")


# ---- native stages against their plain versions ---------------------------------------

def test_native_tga_rle_equals_its_plain_version():
    rng = np.random.default_rng(9)

    def outcome(fn):
        try:
            return fn().tobytes()
        except ValueError as e:
            return str(e).removeprefix("<bytes>: ")

    for depth in (1, 2, 3, 4):
        for rows, row_px in ((1, 1), (5, 7), (9, 40)):
            px = rng.integers(0, 4, (rows * row_px, depth)).astype(np.uint8)
            for packet in (128, 5):
                for per_row in (True, False):
                    data = (b"".join(iw.tga_rle(r, packet) for r in px.reshape(rows, row_px, -1))
                            if per_row else iw.tga_rle(px, packet))
                    for blob in (data, data[:len(data) // 2], data + b"\xff" * 9):
                        assert (outcome(lambda: native.tga_rle(blob, depth, row_px * depth, rows))
                                == outcome(lambda: image_io.tga_rle_reference(
                                    blob, depth, row_px * depth, rows)))
    data = rng.integers(0, 256, 3000).astype(np.uint8).tobytes()  # random packets
    for depth in (1, 3, 4):
        assert (outcome(lambda: native.tga_rle(data, depth, 30 * depth, 20))
                == outcome(lambda: image_io.tga_rle_reference(data, depth, 30 * depth, 20)))


def test_native_qoi_equals_its_plain_version():
    rng = np.random.default_rng(10)
    for h, w in ((1, 1), (7, 9), (40, 33)):
        for c in (3, 4):
            px = rng.integers(0, 256, (h, w, c)).astype(np.uint8)
            px[::2] = px[0, 0]
            blob = iw.qoi_bytes(px)[14:]
            for channels in (3, 4):
                for data in (blob, rng.integers(0, 256, 4 * h * w).astype(np.uint8).tobytes()):
                    def outcome(fn):
                        try:
                            return fn().tobytes()
                        except ValueError as e:
                            return str(e).removeprefix("<bytes>: ").split(" (")[0]
                    assert (outcome(lambda: native.qoi_decode(data, w, h, channels))
                            == outcome(lambda: image_io.qoi_reference(data, w, h, channels)))
            _assert_same(native.qoi_decode(blob, w, h, c), px)


# ---- datasets and metrics -------------------------------------------------------------

def test_colmap_scene_of_rle_tga_views_equals_jaxs(tmp_path):
    src = tmp_path / "colmap_tga"
    shutil.copytree(FIXTURES / "colmap_jpeg", src)
    (src / "images_tga").mkdir()
    for i, jpg in enumerate(sorted((src / "images").glob("*.jpg"))):
        view = native.read_jpeg(str(jpg))
        (src / "images_tga" / f"{jpg.stem}.tga").write_bytes(iw.tga_bytes(
            np.ascontiguousarray(view[..., ::-1]), 10, 24, top_down=i % 2 == 1,
            rows_per_packet_run=1))
    sparse = src / "sparse" / "0"
    imgs = cm.read_images_binary(str(sparse / "images.bin"))
    cm.write_images_binary({k: v._replace(name=v.name.replace(".jpg", ".tga"))
                            for k, v in imgs.items()}, str(sparse / "images.bin"))
    t = tds.read_colmap_scene(str(src), "images_tga", eval_split=True)
    j = jds.read_colmap_scene(str(src), "images_tga", eval_split=True)
    cams = t.train_cameras + t.test_cameras
    assert len(cams) == 6
    for x, y in zip(cams, j.train_cameras + j.test_cameras):
        assert (x.image_name, x.width, x.height) == (y.image_name, y.width, y.height)
        assert x.image.tobytes() == y.image.tobytes()
        view = native.read_jpeg(str(src / "images" / f"{x.image_name}.jpg"))
        assert x.image.tobytes() == (view.astype(np.float32) / 255.0).tobytes()  # lossless
    for (_, tg), (_, jg) in zip(tds.build_cameras(t.train_cameras, 2, device="cpu"),
                                jds.build_cameras(j.train_cameras, 2)):
        assert tg.tobytes() == np.asarray(jg).tobytes()


def test_metrics_on_a_tga_and_ppm_method_directory_equal_jaxs(tmp_path):
    d = FORMATS / "metrics_tga_ppm"
    renders, gts, names = _same_reads(d / "renders", d / "gt")
    assert names == ["00000.tga", "00001.ppm"]
    for r, g, n in zip(renders, gts, names):
        for got, kind in ((r, "renders"), (g, "gt")):
            want = np.load(d / "pil" / f"{kind}_{n[:5]}.npy")
            assert got.tobytes() == (want.astype(np.float32)[..., :3] / 255.0).tobytes()
    method = tmp_path / "test" / "ours_7"
    for sub in ("renders", "gt"):
        shutil.copytree(d / sub, method / sub)
    t = tmetrics.evaluate_dir(str(method), device="cpu")
    j = jmetrics.evaluate_dir(str(method))
    tol = {"PSNR": 1e-4, "SSIM": 1e-5, "LPIPS_PROXY": 1e-5}
    for key, limit in tol.items():
        assert abs(t["mean"][key] - j["mean"][key]) <= limit, key
        for view, v in j["per_view"][key].items():
            assert abs(t["per_view"][key][view] - v) <= limit, (key, view)


# ---- truncation and corruption --------------------------------------------------------

_FUZZ = r"""
import io, json, sys
import numpy as np
from PIL import Image
sys.path.insert(0, sys.argv[1])
from wast3d_tpu_torch.utils import image_io

def pil(blob):
    try:
        return np.asarray(Image.open(io.BytesIO(blob)))
    except Exception:
        return None

files = [open(p, "rb").read() for p in sys.argv[2:]]
cases = [f[:n] for f in files for n in range(len(f))]
rng = np.random.default_rng(20)
for i in range(600):
    f = bytearray(files[i % len(files)])
    for _ in range(1 + i % 3):
        f[int(rng.integers(0, len(f)))] ^= 1 << int(rng.integers(0, 8))
    cases.append(bytes(f))
out = {"cases": len(cases), "raised": 0, "decoded": 0, "differ": [], "bad": []}
for k, blob in enumerate(cases):
    try:
        got = image_io.decode_image(blob, "fuzz.img")
    except ValueError as e:
        out["raised"] += 1
        if not str(e).startswith("fuzz.img: "):
            out["bad"].append(str(e))
        continue
    except Exception as e:
        out["bad"].append(repr(e))
        continue
    out["decoded"] += 1
    want = pil(blob)
    if (want is None or want.dtype != got.dtype or want.shape != got.shape
            or want.tobytes() != got.tobytes()):
        out["differ"].append(k)
print(json.dumps(out))
"""


def test_truncated_and_flipped_files_raise_or_decode_as_pil():
    """Every prefix of three files (a tiled TIFF of separate planes, LZW and
    predictor 2; a colour-mapped run-length TGA with an ID field; a QOI with
    every op) and 600 seeded flips of one to three bits in them: each raises
    a ValueError naming the file or decodes to PIL's array, in a child
    process with a time limit."""
    files = [FORMATS / n for n in ("tif_planar_rgba_tiles_lzw_pred.tif",
                                   "tga_t9_rle_cmap.tga", "qoi_rgba.qoi")]
    out = subprocess.run([sys.executable, "-c", _FUZZ, str(ROOT), *map(str, files)],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["bad"] == [] and got["differ"] == [], got
    assert got["raised"] > 0.9 * sum(len(f.read_bytes()) for f in files)
    assert got["decoded"] > 100
