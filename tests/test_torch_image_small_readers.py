"""ICO / CUR, DDS (every pixel format PIL reads, BC1-BC7 included), PSD, SGI,
PCX and Sun raster, which the port's reader refused before: on the CPU,
each file against `np.asarray(PIL.Image.open(f))` in dtype, shape and
bytes, each native byte loop (`native/raster.cpp`: BCn, PackBits rows, SGI,
PCX and Sun run lengths) against its plain version in
`utils/image_formats.py`, damaged files raising where PIL raises, and the
formats still left (BLP, AVIF, ...) refused naming the file and its
bytes. Seeded random 16-byte blocks are all valid BCn blocks, so random
DDS payloads hold every mode, partition and p-bit against PIL.
"""

import io
import shutil
import struct
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from tools import image_writers as iw
from wast3d_tpu_torch import native
from wast3d_tpu_torch.scene import colmap as cm
from wast3d_tpu_torch.scene import datasets as tds
from wast3d_tpu_torch.utils import image_formats as fmt
from wast3d_tpu_torch.utils import image_io

ROOT = Path(__file__).resolve().parent.parent
FORMATS = ROOT / "tests" / "format_fixtures"
FIXTURES = ROOT / "tests" / "torch_fixtures"
READERS = sorted(p for p in FORMATS.iterdir()
                 if p.suffix in (".ico", ".cur", ".dds", ".psd", ".sgi", ".pcx", ".ras"))


def _image(h, w, c=3, seed=0):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(x / 7 + seed), 128 + 90 * np.cos(y / 5),
                     128 + 60 * np.sin((x + y) / 9), 128 + 127 * np.cos(x / 11)], -1)[..., :c]
    img = np.clip(base + rng.normal(0, 25, base.shape), 0, 255).astype(np.uint8)
    return img[..., 0] if c == 1 else img


def _pil(blob):
    try:
        return np.asarray(Image.open(io.BytesIO(blob)))
    except Exception:
        return None


def _same_as_pil(blob, name="case.img"):
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


def _pil_bytes(img, kind, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, kind, **kw)
    return buf.getvalue()


def _outcome(fn):
    try:
        return fn().tobytes()
    except ValueError:
        return "raised"


# ---- committed fixtures -----------------------------------------------------------------

@pytest.mark.parametrize("path", READERS, ids=lambda p: p.name)
def test_committed_fixture_is_pils(path):
    want = np.load(path.with_suffix(".npy"))
    got = image_io.read_image(str(path))
    assert got.dtype == want.dtype and got.shape == want.shape and got.tobytes() == want.tobytes()
    assert _same_as_pil(path.read_bytes(), path.name)


def test_fixtures_cover_every_reader_and_mode():
    names = {p.stem for p in READERS}
    for want in ("ico_pil_png", "ico_dib32", "ico_dib8", "ico_dib4", "ico_dib1", "ico_entries",
                 "cur_dib1", "cur_dib8", "cur_dib24", "cur_dib32", "dds_pil_dxt1", "dds_pil_bc5",
                 "dds_pil_la", "dds_dxt1", "dds_dxt3", "dds_dxt5", "dds_bc4u", "dds_ati1",
                 "dds_bc5u", "dds_bc5s", "dds_dxgi_bc6h_uf16", "dds_dxgi_bc6h_sf16",
                 "dds_dxgi_bc7", "dds_argb8888", "dds_rgb565", "dds_l8", "dds_p8",
                 "dds_dxgi_rgba8", "psd_rgb_raw", "psd_rgb_packbits", "psd_rgba", "psd_cmyk",
                 "psd_lab", "psd_p", "psd_1", "sgi_pil", "sgi_rle_rgba", "sgi_rle16",
                 "sgi_raw16", "pcx_pil_1", "pcx_pil_p", "pcx_1bit_2planes", "pcx_1bit_4planes",
                 "sun_1", "sun_4p", "sun_8p", "sun_24_t2", "sun_32_t3"):
        assert any(n.startswith(want) for n in names), want
    modes = {str(np.load(p.with_suffix(".npy")).dtype) + str(np.load(p.with_suffix(".npy")).shape[2:])
             for p in READERS}
    assert {"bool()", "uint8()", "uint8(2,)", "uint8(3,)", "uint8(4,)"} <= modes


# ---- DDS and BCn --------------------------------------------------------------------------

BCN = [(1, False, "DXT1"), (2, False, "DXT3"), (3, False, "DXT5"), (4, False, "BC4U"),
       (5, False, "BC5U"), (5, True, "BC5S"), (6, False, 95), (6, True, 96), (7, False, 98)]


def _blocks(n, count, rng):
    payload = rng.integers(0, 256, count * (8 if n in (1, 4) else 16), dtype=np.uint8)
    if n == 6:  # every BC6H mode, the reserved ones too
        modes = np.array([0, 1, 2, 6, 10, 14, 18, 22, 26, 30, 3, 7, 11, 15, 19, 23, 27, 31])
        m = modes[rng.integers(0, len(modes), count)]
        b0 = payload[::16].astype(int)
        payload[::16] = np.where(m < 2, (b0 & ~3) | m, (b0 & ~31) | m)
    if n == 7:  # every BC7 mode, and the empty one
        m = rng.integers(0, 9, count)
        payload[::16] = np.where(m == 8, 0, ((payload[::16].astype(int) << 1 | 1) << m) & 255)
    return payload.tobytes()


@pytest.mark.parametrize("n,signed,kind", BCN, ids=lambda v: str(v))
def test_dds_bcn_of_random_blocks_equals_pil(n, signed, kind):
    rng = np.random.default_rng(50 + n + 10 * signed)
    for w, h in ((64, 48), (13, 9), (1, 1)):
        count = (-(-w // 4)) * (-(-h // 4))
        kw = dict(dxgi=kind) if isinstance(kind, int) else dict(fourcc=kind)
        assert _same_as_pil(iw.dds_bytes(w, h, _blocks(n, count, rng), **kw))


@pytest.mark.parametrize("n,signed,kind", BCN, ids=lambda v: str(v))
def test_native_bcn_equals_plain(n, signed, kind):
    rng = np.random.default_rng(60 + n + 10 * signed)
    for w, h in ((24, 16), (13, 9)):
        data = _blocks(n, (-(-w // 4)) * (-(-h // 4)), rng)
        whole = native.bcn_decode(data, n, signed, w, h)
        assert whole.tobytes() == fmt.bcn_reference(data, n, signed, w, h).tobytes()
        with pytest.raises(ValueError, match="image file is truncated"):
            native.bcn_decode(data[:-1], n, signed, w, h)
        with pytest.raises(ValueError, match="image file is truncated"):
            fmt.bcn_reference(data[:-1], n, signed, w, h)


@pytest.mark.parametrize("case", ["dxgi_bc1_srgb", "dxgi_bc4_snorm", "dxt2", "bc4s", "header_123",
                                  "short_header", "rgb_truncated", "bcn_truncated", "zero_size"])
def test_dds_pil_refuses_raise_or_decline_as_pil(case):
    rng = np.random.default_rng(70)
    rgb = _image(4, 4, 4)
    blob = {"dxgi_bc1_srgb": iw.dds_bytes(4, 4, bytes(8), dxgi=72),
            "dxgi_bc4_snorm": iw.dds_bytes(4, 4, bytes(8), dxgi=81),
            "dxt2": iw.dds_bytes(4, 4, bytes(16), fourcc="DXT2"),
            "bc4s": iw.dds_bytes(4, 4, bytes(8), fourcc="BC4S"),
            "header_123": b"DDS " + struct.pack("<I", 123) + bytes(200),
            "short_header": iw.dds_bytes(4, 4, b"")[:90],
            "rgb_truncated": iw.dds_bytes(4, 4, rgb.tobytes()[:-3], dxgi=28),
            "bcn_truncated": iw.dds_bytes(8, 8, _blocks(7, 3, rng), dxgi=98),
            "zero_size": iw.dds_bytes(0, 4, bytes(16), fourcc="DXT1")}[case]
    assert not _same_as_pil(blob, "x.dds")


def test_dds_bit_masks_equal_pil():
    rng = np.random.default_rng(71)
    w, h = 7, 5
    for bitcount, flags, masks in ((32, 0x41, (0xff, 0xff00, 0xff0000, 0xff000000)),
                                   (24, 0x40, (0xff0000, 0xff00, 0xff)),
                                   (16, 0x40, (0xf800, 0x7e0, 0x1f)),
                                   (16, 0x41, (0xf00, 0xf0, 0xf, 0xf000)),
                                   (16, 0x41, (0x5, 0xf0, 0, 0x300)), (8, 0x40, (0xe0, 0x1c, 0x3))):
        data = rng.integers(0, 256, w * h * bitcount // 8, dtype=np.uint8).tobytes()
        for d in (data, data[:-3]):  # past the end: what is there, then zeros
            assert _same_as_pil(iw.dds_bytes(w, h, d, pf_flags=flags, bitcount=bitcount,
                                             masks=masks))


# ---- ICO / CUR ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [1, 4, 8, 24, 32])
def test_ico_and_cur_dib_entries_equal_pil(bits):
    rng = np.random.default_rng(bits)
    img = _image(16, 24, 4 if bits == 32 else 3 if bits == 24 else 1, seed=bits)
    if bits <= 8:
        img = (img.astype(int) % (1 << bits)).astype(np.uint8)
    pal = rng.integers(0, 256, (1 << bits, 3)) if bits <= 8 else None
    mask = _image(16, 24, 1, seed=9) > 140
    dib = iw.dib_bytes(img, bits, and_mask=mask, palette=pal)
    assert _same_as_pil(iw.icon_bytes([(dib, 24, 16, bits, 0 if pal is None else len(pal) % 256)]))
    _same_as_pil(iw.icon_bytes([(dib, 24, 16, 32, 0)]))  # a 32-bit entry: byte 3 as alpha
    assert _same_as_pil(iw.icon_bytes([(dib, 24, 16, 3, 4)], cursor=True))
    assert _same_as_pil(iw.icon_bytes([(dib, 24, 16, 3, 4), (dib, 24, 16, 9, 9)], cursor=True))


def test_ico_picks_pils_entry():
    """Largest width x height first, then the lowest colour depth, then file
    order; a size byte of 0 is 256; a PNG entry decodes as PNG."""
    rng = np.random.default_rng(3)
    small = iw.dib_bytes(_image(16, 16, 1), 8, palette=rng.integers(0, 256, (256, 3)))
    big8 = iw.dib_bytes(_image(32, 32, 1, seed=2), 8, palette=rng.integers(0, 256, (256, 3)))
    big32 = iw.dib_bytes(_image(32, 32, 4, seed=3), 32)
    png = _pil_bytes(_image(32, 32, 4, seed=4), "PNG")
    for entries in ([(small, 16, 16, 8, 0), (big32, 32, 32, 32, 0), (big8, 32, 32, 8, 0)],
                    [(big32, 32, 32, 32, 0), (png, 32, 32, 32, 0)],
                    [(png, 32, 32, 32, 0), (big32, 32, 32, 32, 0)],
                    [(small, 16, 16, 0, 16), (big8, 16, 16, 0, 2)],
                    [(iw.dib_bytes(_image(8, 256, 1), 8, palette=rng.integers(0, 256, (256, 3))),
                      256, 8, 8, 0), (big32, 32, 32, 32, 0)]):
        assert _same_as_pil(iw.icon_bytes(entries))
    assert _same_as_pil(_pil_bytes(_image(48, 48, 4), "ICO", sizes=[(16, 16), (48, 48)]))


def test_icon_headers_pil_declines_go_on_to_tga():
    tga = iw.tga_bytes(_image(4, 5, 3), 2, 24)
    for blob in (b"\x00\x00\x01\x00\x00\x00" + tga[6:], b"\x00\x00\x02\x00\x00\x00" + tga[6:],
                 b"\x00\x00\x01\x00\x02\x00" + bytes(10), b"\x00\x00\x02\x00\x01\x00" + bytes(5)):
        _same_as_pil(blob, "x.img")


# ---- PSD, SGI, PCX, Sun ----------------------------------------------------------------------

@pytest.mark.parametrize("comp", [0, 1], ids=["raw", "packbits"])
@pytest.mark.parametrize("mode", ["RGB", "RGBA", "RGB5", "CMYK", "LAB", "L", "P", "1", "duotone",
                                  "16bit", "2channels"])
def test_psd_modes_equal_pil(mode, comp):
    rgba = _image(21, 27, 4, seed=5)
    planes = {"RGB": rgba[..., :3], "RGBA": rgba, "RGB5": np.dstack([rgba, rgba[..., :1]]),
              "CMYK": rgba, "LAB": rgba[..., :3], "L": rgba[..., :1], "P": rgba[..., :1],
              "1": (rgba[..., :1] > 120).astype(np.uint8), "duotone": rgba[..., :1],
              "16bit": rgba[..., :3], "2channels": rgba[..., :2]}[mode].transpose(2, 0, 1)
    kind = {"RGBA": "RGB", "RGB5": "RGB", "duotone": 8, "16bit": "RGB", "2channels": "RGB"}.get(
        mode, mode)
    blob = iw.psd_bytes(planes, kind, comp, bits=1 if mode == "1" else 16 if mode == "16bit" else 8,
                        palette=np.zeros((256, 3)) if mode == "P" else None)
    assert _same_as_pil(blob) == (mode not in ("16bit", "2channels"))


@pytest.mark.parametrize("rle", [False, True], ids=["verbatim", "rle"])
@pytest.mark.parametrize("kind", ["L8", "RGB8", "RGBA8", "L16", "RGB16", "RGBA16"])
def test_sgi_equals_pil(kind, rle):
    c = {"L": 1, "RGB": 3, "RGBA": 4}[kind[:-1].rstrip("1")]
    img = _image(13, 17, c, seed=c)
    if kind.endswith("16"):
        img = img.astype(np.uint16) * 257 + 5
    assert _same_as_pil(iw.sgi_bytes(img, rle))


@pytest.mark.parametrize("width", [3, 26, 27, 40])
def test_pcx_equals_pil(width):
    rng = np.random.default_rng(width)
    img = _image(9, width, 3, seed=width)
    grey = img[..., 1]
    for blob in (iw.pcx_bytes(img, 8, 3), iw.pcx_bytes(grey, 8, 1),
                 iw.pcx_bytes(grey, 8, 1, palette=rng.integers(0, 256, (256, 3))),
                 iw.pcx_bytes(grey, 8, 1, palette=np.repeat(np.arange(256)[:, None], 3, 1)),
                 iw.pcx_bytes(grey & 1, 1, 1), iw.pcx_bytes(grey & 3, 1, 2),
                 iw.pcx_bytes(grey & 15, 1, 4), _pil_bytes(img, "PCX"),
                 _pil_bytes(grey > 100, "PCX")):
        assert _same_as_pil(blob)
    _same_as_pil(iw.pcx_bytes(img, 8, 3, stride=width + 2))  # not PIL's stride: runs may overrun


@pytest.mark.parametrize("ftype", [0, 1, 2, 3])
@pytest.mark.parametrize("depth", [1, 4, 8, 24, 32])
def test_sun_equals_pil(depth, ftype):
    rng = np.random.default_rng(depth)
    img = _image(9, 13, {24: 3, 32: 4}.get(depth, 1), seed=depth)
    if depth < 8:
        img = img >> (8 - depth)
    assert _same_as_pil(iw.sun_bytes(img, depth, ftype))
    if depth in (4, 8):
        assert _same_as_pil(iw.sun_bytes(img, depth, ftype,
                                         palette=rng.integers(0, 256, (1 << depth, 3))))


# ---- native loops against their plain versions ------------------------------------------------

def test_native_run_lengths_equal_their_plain_versions():
    rng = np.random.default_rng(80)
    for _ in range(150):
        rows, row = int(rng.integers(1, 6)), int(rng.integers(1, 12))
        data = rng.integers(0, 256, int(rng.integers(0, 60)), dtype=np.uint8).tobytes()
        for a, b in ((lambda: native.packbits_rows(data, row, rows),
                      lambda: fmt.packbits_rows_reference(data, row, rows)),
                     (lambda: native.sun_rle(data, row, rows),
                      lambda: fmt.sun_rle_reference(data, row, rows)),
                     (lambda: native.pcx_rle(data, row, max(1, row - 2), 8, rows),
                      lambda: fmt.pcx_rle_reference(data, row, max(1, row - 2), 8, rows)),
                     (lambda: native.pcx_rle(data, row, 9, 4, rows),
                      lambda: fmt.pcx_rle_reference(data, row, 9, 4, rows))):
            assert _outcome(a) == _outcome(b)
        values = rng.integers(0, 4, rows * row, dtype=np.uint8).tobytes()
        coded = b"".join(iw.packbits_encode(values[i * row:(i + 1) * row]) for i in range(rows))
        assert native.packbits_rows(coded, row, rows).tobytes() == values
        assert fmt.packbits_rows_reference(coded, row, rows).tobytes() == values
        assert native.sun_rle(iw.sun_rle(values), row, rows).tobytes() == values


def test_native_sgi_runs_equal_their_plain_version():
    rng = np.random.default_rng(81)
    for trial in range(120):
        h, w = int(rng.integers(1, 6)), int(rng.integers(1, 9))
        c, bpc = int(rng.choice([1, 3, 4])), int(rng.choice([1, 2]))
        img = rng.integers(0, 3, (h, w, c)).astype(np.uint8 if bpc == 1 else np.uint16)
        blob = bytearray(iw.sgi_bytes(img))
        for _ in range(trial % 3):
            blob[int(rng.integers(512, len(blob)))] = int(rng.integers(0, 256))
        if trial % 5 == 0:
            blob = blob[:-int(rng.integers(1, 5))]
        blob = bytes(blob)
        assert (_outcome(lambda: native.sgi_rle(blob, w, h, c, bpc))
                == _outcome(lambda: fmt.sgi_rle_reference(blob, w, h, c, bpc)))


# ---- damaged files, dispatch, what is still refused ----------------------------------------

def test_damaged_files_raise_where_pil_raises():
    rng = np.random.default_rng(90)
    img = (rng.integers(0, 4, (5, 7, 4)) * 60).astype(np.uint8)
    dib = iw.dib_bytes(img[..., 0], 8, palette=rng.integers(0, 256, (256, 3)),
                       and_mask=img[..., 1] > 100)
    bases = [iw.sgi_bytes(img[..., :3]), iw.sgi_bytes(img.astype(np.uint16) * 257),
             iw.pcx_bytes(img[..., :3], 8, 3), iw.sun_bytes(img[..., :3], 24, 2),
             iw.psd_bytes(img.transpose(2, 0, 1), "RGB", 1),
             iw.dds_bytes(8, 8, rng.integers(0, 256, 64, dtype=np.uint8).tobytes(), dxgi=98),
             iw.icon_bytes([(dib, 7, 5, 8, 0)]), iw.icon_bytes([(dib, 7, 5, 1, 1)], cursor=True)]
    for base in bases:
        for k in range(30):
            blob = bytearray(base)
            if k % 3 == 1:
                blob = blob[:int(rng.integers(4, len(blob)))]
            else:
                blob[int(rng.integers(4, len(blob)))] = int(rng.integers(0, 256))
            _same_as_pil(bytes(blob), "d.img")


def test_formats_still_left_raise_naming_file_and_bytes():
    """AVIF waits for AV1's tables (JPEG 2000 and ICNS are read:
    tests/test_torch_image_jpeg2000.py); it raises naming the file and its
    first bytes, as does an ICNS file that PIL's plugin declines (no
    entries). The BLP2 and FTEX headers of zeros, which used to stand for
    formats still to come, are read now: each gives PIL's outcome (both
    refuse: BLP2 of size 0 is declined by every format, FTEX of no formats
    fails PIL's assertion)."""
    for blob in (b"icns\x00\x00\x01\x00" + bytes(64), b"\x00\x00\x00\x1cftypavif" + bytes(64)):
        with pytest.raises(ValueError, match=r"^x\.img: not an image this reader knows .*Sun "
                                             r"raster.*XVThumb\); it starts with"):
            image_io.decode_image(blob, "x.img")
    for blob in (b"BLP2" + bytes(64), b"FTEX" + bytes(64)):
        assert _pil(blob) is None
        assert not _same_as_pil(blob, "x.img")


def test_colmap_scene_of_reader_views_equals_jaxs(tmp_path):
    """The six COLMAP views as a ZSTD TIFF, a tiled YCbCr ZSTD TIFF, PSD, SGI,
    PCX and Sun raster: both packages' scenes and cameras alike, each view
    the card's copy of PIL's decode."""
    from wast3d_tpu.scene import datasets as jds

    src = tmp_path / "colmap"
    shutil.copytree(FIXTURES / "colmap_jpeg", src)
    views = FORMATS / "colmap_readers"
    shutil.copytree(views, src / "images_readers", ignore=shutil.ignore_patterns("*.npy"))
    names = {p.stem: p.name for p in views.iterdir() if p.suffix != ".npy"}
    path = str(src / "sparse" / "0" / "images.bin")
    cm.write_images_binary({k: v._replace(name=names[Path(v.name).stem])
                            for k, v in cm.read_images_binary(path).items()}, path)
    t = tds.read_colmap_scene(str(src), "images_readers", eval_split=True)
    j = jds.read_colmap_scene(str(src), "images_readers", eval_split=True)
    cams_t, cams_j = t.train_cameras + t.test_cameras, j.train_cameras + j.test_cameras
    assert len(cams_t) == len(cams_j) == 6
    for a, b in zip(cams_t, cams_j):
        assert (a.image_name, a.width, a.height) == (b.image_name, b.width, b.height)
        assert a.image.dtype == b.image.dtype and a.image.tobytes() == b.image.tobytes()
        want = np.load(views / f"{a.image_name}.npy")
        assert a.image.tobytes() == (want.astype(np.float32) / 255.0).tobytes()


def test_metrics_read_a_zstd_and_psd_method_directory_as_jax_does():
    from wast3d_tpu.eval import metrics as jmetrics
    from wast3d_tpu_torch.eval import metrics as tmetrics

    method = FORMATS / "metrics_zstd_psd"
    a = tmetrics._read_images(str(method / "renders"), str(method / "gt"))
    b = jmetrics._read_images(str(method / "renders"), str(method / "gt"))
    assert a[2] == b[2] == ["00000.tif", "00001.psd"]
    for x, y in zip(a[0] + a[1], b[0] + b[1]):
        assert x.dtype == y.dtype == np.float32 and x.tobytes() == y.tobytes()
