"""The TIFF that PIL reads through libtiff and the port read before this file
raised on: CCITT bilevel (RLE, Group 3 1-D and 2-D, Group 4), LZMA,
BigTIFF, YCbCr outside JPEG (libtiff's RGBA reader: every subsampling it
has a routine for, separate planes, ReferenceBlackWhite and
YCbCrCoefficients), CIELab and 12-bit grey; on the CPU, each against
`np.asarray(PIL.Image.open(f))` in dtype, shape and bytes, and the native
loops (`native/image.cpp`) against their plain versions in
`utils/image_io.py`. The CCITT strips are PIL's own (libtiff's encoder);
the rest come from `tools/image_writers.tiff_bytes`. The kinds PIL still
refuses raise a ValueError naming the file and the tag.
"""

import io
from pathlib import Path

import numpy as np
import pytest
from PIL import Image, TiffImagePlugin

from tools import image_writers as iw
from wast3d_tpu_torch import native
from wast3d_tpu_torch.utils import image_io

ROOT = Path(__file__).resolve().parent.parent
FORMATS = ROOT / "tests" / "format_fixtures"
NEW = sorted(p for p in FORMATS.glob("tif_*.tif")
             if p.stem.startswith(("tif_ccitt", "tif_lzma", "tif_bigtiff", "tif_ycbcr", "tif_lab",
                                   "tif_i12")))


def _image(h, w, c=3, seed=0):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(x / 7 + seed), 128 + 90 * np.cos(y / 5),
                     128 + 60 * np.sin((x + y) / 9)], -1)[..., :c]
    return np.clip(base + rng.normal(0, 25, base.shape), 0, 255).astype(np.uint8)


def _pil(blob):
    try:
        return np.asarray(Image.open(io.BytesIO(blob)))
    except Exception:
        return None


def _same_as_pil(blob, name="case.tif"):
    """The port's array equals PIL's, or both refuse (the port naming the file)."""
    want = _pil(blob)
    if want is None:
        with pytest.raises(ValueError, match=rf"^{name}: "):
            image_io.decode_image(blob, name)
        return False
    got = image_io.decode_image(blob, name)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    return True


@pytest.mark.parametrize("path", NEW, ids=lambda p: p.name)
def test_committed_codec_fixtures_are_pils(path):
    want = np.load(path.with_suffix(".npy"))
    got = image_io.read_image(str(path))
    assert got.dtype == want.dtype and got.shape == want.shape and got.tobytes() == want.tobytes()
    assert _same_as_pil(path.read_bytes())


def test_the_fixtures_cover_every_codec():
    names = {p.stem for p in NEW}
    for prefix in ("tif_ccitt_rle", "tif_ccitt_g3_1d", "tif_ccitt_g3_2d", "tif_ccitt_g4",
                   "tif_lzma", "tif_bigtiff", "tif_ycbcr_11", "tif_ycbcr_12", "tif_ycbcr_21",
                   "tif_ycbcr_22", "tif_ycbcr_41", "tif_ycbcr_42", "tif_ycbcr_44",
                   "tif_ycbcr_planar", "tif_lab", "tif_i12"):
        assert any(n.startswith(prefix) for n in names), prefix


# ---- CCITT ------------------------------------------------------------------------------

def _ccitt_strips(bits, compression, rows, t4=0):
    info = TiffImagePlugin.ImageFileDirectory_v2()
    if t4:
        info[292] = t4
    out = []
    for y in range(0, bits.shape[0], rows):
        buf = io.BytesIO()
        Image.fromarray(bits[y:y + rows]).save(buf, "TIFF", compression=compression,
                                               tiffinfo=info)
        img = Image.open(io.BytesIO(buf.getvalue()))
        out.append(buf.getvalue()[img.tag_v2[273][0]:][:img.tag_v2[279][0]])
    return out


CCITT = {"rle": ("tiff_ccitt", 2, 0), "g3_1d": ("group3", 3, 0), "g3_2d": ("group3", 3, 1),
         "g3_2d_fill": ("group3", 3, 5), "g4": ("group4", 4, 0)}


def _bitmaps():
    rng = np.random.default_rng(3)
    noise = rng.random((37, 53)) < 0.3
    blocks = np.zeros((40, 200), bool)
    blocks[10:20, 40:100] = True
    blocks[:, -3:] = True
    text = (np.add.outer(np.arange(30) // 3, np.arange(1700) // 5) % 4 == 0) ^ (
        rng.random((30, 1700)) < 0.05)  # runs past 64 and past 1728
    tail = np.zeros((8, 8), bool)
    tail[2:4, 1:4] = True
    tail[:, -3:] = True  # RLE: the last row ends in libtiff's zero padding
    return {"noise": noise, "blocks": blocks, "text": text, "tail": tail}


@pytest.mark.parametrize("kind", sorted(CCITT))
def test_ccitt_equals_pil(kind):
    """PIL's coding of each strip (one strip, and strips of 7 rows), under
    both photometrics and both fill orders: the port's array is PIL's, and
    the native decoder equals its plain version on every strip."""
    comp, code, t4 = CCITT[kind]
    for name, bits in _bitmaps().items():
        for rows in (bits.shape[0], 7):
            strips = _ccitt_strips(bits, comp, rows, t4)
            for photo, fill in ((0, 1), (1, 2), (1, 1)):
                blob = iw.tiff_bytes(bits.astype(np.uint8), photo, compression=code, bits=1,
                                     rows_per_strip=rows, encoded=strips, fill_order=fill,
                                     tags=[(292, 4, [t4])] if t4 else [])
                assert _same_as_pil(blob), (name, rows, photo, fill)
            if bits.shape[1] > 200:
                continue  # the plain version walks bits in Python
            for y, strip in zip(range(0, bits.shape[0], rows), strips):
                n = min(rows, bits.shape[0] - y)
                np.testing.assert_array_equal(
                    native.ccitt_decode(strip, code, t4, bits.shape[1], n),
                    image_io.ccitt_reference(strip, code, t4, bits.shape[1], n))


def test_rle_last_row_is_libtifs():
    """libtiff pads its accumulator with zero bits at the end of the data and
    counts them when it realigns a Modified Huffman row: an RLE strip whose
    last code needed padding leaves the next row white, as PIL shows it."""
    bits = _bitmaps()["tail"]
    strip = _ccitt_strips(bits, "tiff_ccitt", 8)[0]
    blob = iw.tiff_bytes(bits.astype(np.uint8), 1, compression=2, bits=1, encoded=[strip])
    got = image_io.decode_image(blob, "tail.tif")
    np.testing.assert_array_equal(got, _pil(blob))
    assert not got[-1].any() and np.array_equal(got[:-1], bits[:-1])


def test_ccitt_outside_what_libtiff_reads_raises():
    """CCITT on 8-bit or 3-sample data raises naming Compression, as PIL
    refuses it; a strip whose codes break off raises naming the file."""
    img = _image(8, 8)
    for c in (2, 3, 4):
        blob = iw.tiff_bytes(img, 2, compression=c, encoded=[b"\x00" * 16])
        assert _pil(blob) is None
        with pytest.raises(ValueError, match=r"^c\.tif: TIFF Compression \(tag 259\) = "):
            image_io.decode_image(blob, "c.tif")
    bits = _bitmaps()["noise"]
    strip = _ccitt_strips(bits, "group4", bits.shape[0])[0]
    blob = iw.tiff_bytes(bits.astype(np.uint8), 0, compression=4, bits=1,
                         encoded=[strip[:len(strip) // 3]])
    with pytest.raises(ValueError, match=r"^c\.tif: .*CCITT"):
        image_io.decode_image(blob, "c.tif")


# ---- LZMA and BigTIFF ---------------------------------------------------------------------

@pytest.mark.parametrize("bigtiff", [False, True], ids=["classic", "bigtiff"])
@pytest.mark.parametrize("compression", [1, 5, 8, 34925])
def test_lzma_and_bigtiff_equal_pil(compression, bigtiff):
    rgb, grey = _image(21, 30, seed=compression), _image(21, 30, 1, seed=7)
    for blob in (iw.tiff_bytes(rgb, 2, compression=compression, bigtiff=bigtiff,
                               rows_per_strip=4),
                 iw.tiff_bytes(rgb, 2, compression=compression, bigtiff=bigtiff, tile=(16, 16)),
                 iw.tiff_bytes(rgb, 2, compression=compression, bigtiff=bigtiff, planar=2),
                 iw.tiff_bytes(rgb, 2, compression=compression, bigtiff=bigtiff, predictor=2),
                 iw.tiff_bytes(grey.astype(np.uint16) * 250, 1, compression=compression,
                               bigtiff=bigtiff, predictor=2)):
        assert _same_as_pil(blob)


def test_bigtiff_big_endian_and_bad_lzma_raise():
    """PIL takes a big-endian BigTIFF for a classic TIFF and fails; an LZMA
    strip that is not an .xz stream fails in libtiff."""
    rgb = _image(9, 10)
    mm = iw.tiff_bytes(rgb, 2, bigtiff=True, byteorder=">")
    assert _pil(mm) is None
    with pytest.raises(ValueError, match=r"^b\.tif: big-endian BigTIFF"):
        image_io.decode_image(mm, "b.tif")
    bad = iw.tiff_bytes(rgb, 2, compression=34925, encoded=[b"\xfd7zXZ\x00" + b"\x00" * 40])
    assert _pil(bad) is None
    with pytest.raises(ValueError, match=r"^b\.tif: bad LZMA"):
        image_io.decode_image(bad, "b.tif")


# ---- YCbCr ------------------------------------------------------------------------------

SUBSAMPLINGS = [(1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4)]


@pytest.mark.parametrize("sub", SUBSAMPLINGS, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("compression", [5, 8, 34925])
def test_ycbcr_every_subsampling_equals_pil(compression, sub):
    """Chunky data units through libtiff's RGBA reader: odd sizes (edge
    units cut), strips of 4, 8 and the whole image (4x4 units an odd number
    across: libtiff's short read keeps the last strip's chroma)."""
    for size in ((13, 11), (16, 16), (9, 21)):
        ycc = iw.rgb_to_ycc(_image(*size, seed=size[0] + sub[0]))
        for rows in (4, 8, size[0]):
            assert _same_as_pil(iw.tiff_bytes(ycc, 6, compression=compression,
                                              ycbcr_subsampling=sub, rows_per_strip=rows))


def test_ycbcr_tags_planes_and_defaults_equal_pil():
    """ReferenceBlackWhite and YCbCrCoefficients through TIFFYCbCrToRGBInit's
    float arithmetic, no YCbCrSubsampling tag (libtiff's 2x2), separate
    planes compressed (converted) and uncompressed (PIL's raw planes), and
    an Orientation tag."""
    ycc = iw.rgb_to_ycc(_image(14, 18, seed=4))
    cases = [iw.tiff_bytes(ycc, 6, compression=5, ycbcr_subsampling=(2, 2), tags=[
                 (532, 5, [15, 1, 235, 1, 128, 1, 240, 1, 128, 1, 240, 1]),
                 (529, 5, [2126, 10000, 7152, 10000, 722, 10000])]),
             iw.tiff_bytes(ycc, 6, compression=8, tags=[(532, 5, [0, 1, 255, 1, 0, 1, 255, 1,
                                                                 0, 1, 255, 1])]),
             iw.tiff_bytes(ycc, 6, compression=5),
             iw.tiff_bytes(ycc, 6, compression=8, planar=2, ycbcr_subsampling=(1, 1)),
             iw.tiff_bytes(ycc, 6, compression=1, planar=2, ycbcr_subsampling=(1, 1)),
             iw.tiff_bytes(ycc, 6, compression=5, ycbcr_subsampling=(4, 2), tags=[(274, 3, [6])])]
    for blob in cases:
        assert _same_as_pil(blob)


def test_ycbcr_pil_refuses_raises_naming_the_tag():
    """libtiff's RGBA reader has no routine for 1x4 or 2x4 units or for
    subsampled separate planes; Pillow's raw decoder reads uncompressed
    chunky YCbCr as 4 bytes a pixel and runs out."""
    ycc = iw.rgb_to_ycc(_image(12, 12, seed=5))
    for sub, planar, tag in (((1, 4), 1, 530), ((2, 4), 1, 530), ((2, 2), 2, 530)):
        blob = iw.tiff_bytes(ycc, 6, compression=5, ycbcr_subsampling=sub, planar=planar)
        assert _pil(blob) is None
        with pytest.raises(ValueError, match=rf"^y\.tif: TIFF YCbCrSubsampling \(tag {tag}\)"):
            image_io.decode_image(blob, "y.tif")
    chunky = iw.tiff_bytes(ycc, 6, ycbcr_subsampling=(2, 2))
    assert _pil(chunky) is None
    with pytest.raises(ValueError, match=r"^y\.tif: .*truncated.*\(tag 262\) = 6"):
        image_io.decode_image(chunky, "y.tif")


def test_native_ycbcr_conversion_equals_its_plain_version():
    rng = np.random.default_rng(6)
    for luma, refbw in (((0.299, 0.587, 0.114), (0, 255, 128, 255, 128, 255)),
                        ((0.2126, 0.7152, 0.0722), (16, 235, 128, 240, 128, 240)),
                        ((0.5, 0.25, 0.25), (3.5, 250.25, 100, 200, 0, 255))):
        tables = image_io.ycbcr_tables(np.float32(luma), np.float32(refbw))
        for sh, sv in SUBSAMPLINGS:
            w, rows = 23, 13
            units = rng.integers(0, 256, -(-rows // sv) * -(-w // sh) * (sh * sv + 2)).astype(
                np.uint8)
            np.testing.assert_array_equal(
                native.ycbcr_to_rgb(units, sh, sv, w, rows, tables),
                image_io.ycbcr_to_rgb_reference(units, sh, sv, w, rows, tables))


# ---- CIELab, 12-bit grey, and what PIL refuses ----------------------------------------------

@pytest.mark.parametrize("compression", [1, 5, 8, 34925])
def test_cielab_and_12_bit_grey_equal_pil(compression):
    """CIELab (PIL's LAB: chunky samples as stored, separate a and b planes
    with their sign bit flipped) and 12-bit grey (PIL's I;16 values), at
    odd widths; a big-endian 12-bit file PIL does not read."""
    lab = iw.rgb_to_ycc(_image(11, 15, seed=compression))
    for planar in (1, 2):
        assert _same_as_pil(iw.tiff_bytes(lab, 8, compression=compression, planar=planar,
                                          rows_per_strip=4))
    grey = np.random.default_rng(compression).integers(0, 4096, (9, 13)).astype(np.uint16)
    for w in (13, 12, 1):
        assert _same_as_pil(iw.tiff_bytes(grey[:, :w], 1, compression=compression, bits=12,
                                          rows_per_strip=5))
    assert not _same_as_pil(iw.tiff_bytes(grey, 1, compression=compression, bits=12,
                                          byteorder=">"))


@pytest.mark.parametrize("compression,tag", [(50000, 259), (50001, 259), (6, 259)])
def test_codecs_still_refused_name_the_tag(compression, tag):
    """Old-style JPEG waits for a later slice; WebP-in-TIFF PIL refuses as
    well: each raises naming Compression. ZSTD is read now
    (tests/test_torch_image_zstd.py): a strip of zeros is no Zstandard
    frame, and raises naming the file, as PIL raises."""
    blob = iw.tiff_bytes(_image(8, 8), 2, encoded=[b"\x00" * 64], compression=compression)
    match = (r"^z\.tif: bad ZSTD data \(magic number 0x00000000\)" if compression == 50000
             else rf"^z\.tif: TIFF Compression \(tag {tag}\) = {compression}")
    assert not _same_as_pil(blob, "z.tif")
    with pytest.raises(ValueError, match=match):
        image_io.decode_image(blob, "z.tif")
