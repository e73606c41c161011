"""ZSTD TIFF (Compression 50000) and YCbCr in tiles outside JPEG, which the
port's reader refused before: on the CPU, each file against
`np.asarray(PIL.Image.open(f))` in dtype, shape and bytes (PIL's libtiff
over libzstd 1.5.7), and the native Zstandard decoder (`native/zstd.cpp`)
bit-equal to its plain version (`utils/zstd.zstd_reference`) on every
frame of the committed fixtures, which together meet every block, literals,
Huffman-weights and sequence-table kind of RFC 8878, and on damaged frames.
Frames stay at a few KB, so the plain decoder is quick.
"""

import io
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from tools import image_writers as iw
from wast3d_tpu_torch import native
from wast3d_tpu_torch.utils import image_io, zstd

ROOT = Path(__file__).resolve().parent.parent
FORMATS = ROOT / "tests" / "format_fixtures"
ZSTD_FILES = sorted(FORMATS.glob("tif_zstd_*.tif"))
TILED_YCBCR = sorted(FORMATS.glob("tif_ycbcr_tiled_*.tif"))
# What `zstd_reference(..., seen)` names: every kind the format has.
MODES = ({"raw block", "rle block", "compressed block", "raw literals", "rle literals",
          "huffman literals, 1 stream", "huffman literals, 4 streams",
          "treeless literals, 1 stream", "treeless literals, 4 streams", "direct weights",
          "fse weights", "no sequences", "checksum"}
         | {f"{k} {m}" for k in ("ll", "of", "ml") for m in ("predefined", "rle", "fse", "repeat")})


def _image(h, w, c=3, seed=0):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(x / 7 + seed), 128 + 90 * np.cos(y / 5),
                     128 + 60 * np.sin((x + y) / 9)], -1)[..., :c]
    img = np.clip(base + rng.normal(0, 25, base.shape), 0, 255).astype(np.uint8)
    return img[..., 0] if c == 1 else img


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


def _pil_zstd(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "TIFF", compression="zstd", **kw)
    return buf.getvalue()


def _frames(blob):
    """Each strip's or tile's bytes of a TIFF."""
    _, tags, _ = image_io._tiff_tags(blob, "f")
    offsets, counts = tags.get(273) or tags.get(324), tags.get(279) or tags.get(325)
    return [blob[o:o + c] for o, c in zip(offsets, counts)]


def _zstd_frames(path):
    blob = path.read_bytes()
    return _frames(blob) if image_io._one(image_io._tiff_tags(blob, "f")[1], 259) == 50000 else []


# ---- committed fixtures -----------------------------------------------------------------

@pytest.mark.parametrize("path", ZSTD_FILES + TILED_YCBCR, ids=lambda p: p.name)
def test_committed_fixture_is_pils(path):
    want = np.load(path.with_suffix(".npy"))
    got = image_io.read_image(str(path))
    assert got.dtype == want.dtype and got.shape == want.shape and got.tobytes() == want.tobytes()
    assert _same_as_pil(path.read_bytes(), path.name)


def test_fixtures_meet_every_mode_of_the_format():
    seen = set()
    for path in ZSTD_FILES + TILED_YCBCR:
        for frame in _zstd_frames(path):
            zstd.zstd_reference(frame, 1 << 20, seen)
    assert MODES <= seen, sorted(MODES - seen)
    names = {p.stem for p in ZSTD_FILES + TILED_YCBCR}
    for want in ("tif_zstd_rgb", "tif_zstd_rgb_strips", "tif_zstd_l", "tif_zstd_i16_pred2",
                 "tif_zstd_f32_pred3", "tif_zstd_tiles", "tif_zstd_planar", "tif_ycbcr_tiled_22",
                 "tif_ycbcr_tiled_44", "tif_ycbcr_tiled_planar"):
        assert any(n.startswith(want) for n in names), want


@pytest.mark.parametrize("path", [p for p in ZSTD_FILES + TILED_YCBCR if _zstd_frames(p)],
                         ids=lambda p: p.name)
def test_native_zstd_equals_plain_on_every_frame(path):
    for frame in _zstd_frames(path):
        a, b = native.zstd_decode(frame, 1 << 20), zstd.zstd_reference(frame, 1 << 20)
        assert a.dtype == b.dtype == np.uint8 and a.tobytes() == b.tobytes()
        cut = max(1, a.size // 3)  # libtiff's buffer full before the frame's end
        assert native.zstd_decode(frame, cut).tobytes() == zstd.zstd_reference(frame, cut).tobytes()


# ---- layouts ----------------------------------------------------------------------------

def _layouts():
    rgb, grey = _image(45, 61), _image(45, 61, 1)
    depth = rgb.astype(np.float32).mean(axis=2) / np.float32(7) - np.float32(5)
    return {
        "pil_rgb": lambda: _pil_zstd(rgb),
        "pil_rgb_strips_of_4": lambda: _pil_zstd(rgb, tiffinfo={278: 4}),
        "pil_l_predictor2": lambda: _pil_zstd(grey, tiffinfo={317: 2}),
        "pil_i16_predictor2": lambda: _pil_zstd(grey.astype(np.uint16) * 251, tiffinfo={317: 2}),
        "pil_f32_predictor3": lambda: _pil_zstd(depth, tiffinfo={317: 3}),
        "pil_rgba": lambda: _pil_zstd(np.dstack([rgb, grey])),
        "tiles_partial": lambda: iw.tiff_bytes(rgb, 2, compression=50000, tile=(16, 32)),
        "tiles_predictor2_16bit": lambda: iw.tiff_bytes(rgb.astype(np.uint16) * 3, 2,
                                                        compression=50000, tile=(32, 16),
                                                        predictor=2),
        "planes_in_strips": lambda: iw.tiff_bytes(rgb, 2, compression=50000, planar=2,
                                                  rows_per_strip=7),
        "planes_in_tiles": lambda: iw.tiff_bytes(rgb, 2, compression=50000, planar=2,
                                                 tile=(16, 16)),
        "big_endian_predictor2": lambda: iw.tiff_bytes(rgb.astype(np.uint16) * 257, 2,
                                                       compression=50000, byteorder=">",
                                                       predictor=2),
        "float_tiles_predictor3": lambda: iw.tiff_bytes(depth, 1, compression=50000,
                                                        predictor=3, sample_format=3,
                                                        tile=(16, 16)),
        "one_strip_many_blocks": lambda: iw.tiff_bytes(rgb, 2, compression=50000,
                                                       zstd=dict(level=19, window_log=10)),
        "palette": lambda: iw.tiff_bytes(grey >> 4, 3, compression=50000, bits=4,
                                         colormap=np.arange(48) * 1000),
    }


@pytest.mark.parametrize("name", sorted(_layouts()))
def test_zstd_layout_equals_pil(name):
    assert _same_as_pil(_layouts()[name]())


@pytest.mark.parametrize("comp", [5, 8, 32773, 50000])
@pytest.mark.parametrize("sub", [(1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_tiled_ycbcr_equals_pil(sub, comp):
    """TIFFReadRGBATile's data units inside each tile, edge tiles cropped."""
    ycc = iw.rgb_to_ycc(_image(45, 61, seed=sum(sub)))
    for tile in ((16, 16), (32, 16)):
        assert _same_as_pil(iw.tiff_bytes(ycc, 6, compression=comp, ycbcr_subsampling=sub,
                                          tile=tile))


def test_tiled_ycbcr_pil_refuses_names_the_tag():
    """Separate planes subsampled: libtiff's RGBA reader has no routine."""
    blob = iw.tiff_bytes(iw.rgb_to_ycc(_image(16, 16)), 6, compression=8, planar=2,
                         ycbcr_subsampling=(2, 2), tile=(16, 16))
    assert _pil(blob) is None
    with pytest.raises(ValueError, match=r"^y\.tif: TIFF YCbCrSubsampling \(tag 530\)"):
        image_io.decode_image(blob, "y.tif")


# ---- damaged frames ---------------------------------------------------------------------

def test_damaged_zstd_strips_raise_where_pil_raises():
    rng = np.random.default_rng(41)
    rgb = _image(32, 40)
    for base in (_pil_zstd(rgb, tiffinfo={278: 8}),
                 iw.tiff_bytes(rgb, 2, compression=50000, zstd=dict(level=19, window_log=10))):
        frames = _frames(base)
        start = base.index(frames[0])
        for k in range(24):
            blob = bytearray(base)
            at = int(rng.integers(start, start + sum(map(len, frames))))
            if k % 4 == 3:  # a frame cut short: the rest of the file zeroed
                blob[at:] = bytes(len(blob) - at)
            else:
                blob[at] ^= 1 << int(rng.integers(0, 8))
            _same_as_pil(bytes(blob), "d.tif")


def test_native_zstd_equals_plain_on_damaged_frames():
    import zstandard

    rng = np.random.default_rng(43)
    data = (np.cumsum(rng.integers(-3, 4, 3000)) % 256).astype(np.uint8).tobytes()
    for level in (1, 19):
        frame = zstandard.ZstdCompressor(level=level, write_checksum=True).compress(data)
        for _ in range(40):
            blob = bytearray(frame)
            blob[int(rng.integers(0, len(blob)))] ^= 1 << int(rng.integers(0, 8))
            cut = bytes(blob[:int(rng.integers(1, len(blob) + 1))])
            for case in (bytes(blob), cut):
                outcomes = []
                for fn in (native.zstd_decode, zstd.zstd_reference):
                    try:
                        outcomes.append(fn(case, len(data)).tobytes())
                    except ValueError:
                        outcomes.append("raised")
                assert outcomes[0] == outcomes[1]


def test_frames_libtiff_stops_on_or_refuses():
    """A skippable frame first ends the strip (short), a second frame is never
    read, a wrong checksum or a dictionary raises, a checksum cut off is
    never read: each as PIL."""
    import zstandard

    rgb = _image(8, 10)
    raw = rgb.tobytes()
    frame = zstandard.ZstdCompressor(level=3).compress(raw)
    checked = zstandard.ZstdCompressor(level=3, write_checksum=True).compress(raw)
    skip = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(4, "little") + b"hello"
    dict_frame = bytearray(iw.zstd_frame([("raw", raw)]))
    dict_frame[4] |= 1  # Dictionary_ID_flag 1
    dict_frame[6:6] = b"\x07"
    cases = {"skippable_first": (skip + frame, False), "frame_then_junk": (frame + b"junk", True),
             "two_frames": (zstandard.ZstdCompressor().compress(raw[:100])
                            + zstandard.ZstdCompressor().compress(raw[100:]), False),
             "checksum": (checked, True), "bad_checksum": (checked[:-1] + b"\x00", False),
             "checksum_cut": (checked[:-2], True), "dictionary": (bytes(dict_frame), False),
             "hand_built": (iw.zstd_frame([("rle_literals", 9, 40), ("raw", raw[40:])],
                                          checksum=True), True)}
    for name, (strip, reads) in cases.items():
        assert _same_as_pil(iw.tiff_bytes(rgb, 2, compression=50000, encoded=[strip])) == reads, name
