"""BLP, DIB, DCX, FITS, FLI / FLC, FTEX, GBR, IM, IMT, IPTC, McIdas, MSP, PCD,
PIXAR, SPIDER, XBM, XPM and XVThumb, which the port's reader refused
before (`utils/image_plugins.py`), and the formats PIL opens and cannot
decode here (EPS, MPEG, HDF5, BUFR, GRIB, WMF) or that wait for their tables
(AVIF): on the CPU, each file against `np.asarray(PIL.Image.open(f))` in
dtype, shape and bytes, or both refusing (the port with `ValueError`
naming the file); each native loop (`native/plugins.cpp`: FLI chunks, MSP
runs, PCD, XBM hex, XPM keys, IM's n-bit samples) against its plain
version; the committed fixtures; a seeded census of truncations and byte
flips; and the COLMAP scene of six such views through both packages.

What the probes of PIL 12.1.0 found, which the reader copies:
- BLP1 JPEG comes out with red and blue swapped (PIL's RGB bytes read back
  as "BGR"), alpha 255; BLP2 DXT colours are 5-6-5 without bit
  replication, and a width that is not a multiple of 4 shears the rows.
- FITS reads 16- and 32-bit samples little-endian and -64 as the first four
  bytes of each double; BZERO / BSCALE change nothing.
- PCD's channels are PIL's PhotoYCC -> RGB tables (`PCD_TABLES`, read out
  of its unpacker), chroma replicated 2 x 2.
- XBM's bits are least significant first; bit 1 is white (True).
- IM's rows are bottom-up; "RLB" and "LA" + "PA;L" have no unpacker (PIL
  raises).
"""

import io
import struct
import warnings
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from tools import image_writers as iw
from wast3d_tpu_torch import native
from wast3d_tpu_torch.utils import image_io
from wast3d_tpu_torch.utils import image_plugins as ip

ROOT = Path(__file__).resolve().parent.parent
FORMATS = ROOT / "tests" / "format_fixtures"
FIXTURES = ROOT / "tests" / "torch_fixtures"
SUFFIXES = (".blp", ".dib", ".dcx", ".fits", ".fli", ".flc", ".ftc", ".ftu", ".gbr", ".im",
            ".imt", ".iim", ".mcidas", ".msp", ".pxr", ".spider", ".xbm", ".xpm", ".xvthumb")
PLUGINS = sorted(p for p in FORMATS.iterdir() if p.suffix in SUFFIXES)


def _image(h, w, c=3, seed=0):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(x / 7 + seed), 128 + 90 * np.cos(y / 5),
                     128 + 60 * np.sin((x + y) / 9), 128 + 127 * np.cos(x / 11)], -1)[..., :c]
    img = np.clip(base + rng.normal(0, 25, base.shape), 0, 255).astype(np.uint8)
    return img[..., 0] if c == 1 else img


def _pil(blob):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
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


def _pil_bytes(img, fmt, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, fmt, **kw)
    return buf.getvalue()


def _pil_image_bytes(im, fmt, **kw):
    buf = io.BytesIO()
    im.save(buf, fmt, **kw)
    return buf.getvalue()


def _outcome(fn):
    try:
        out = fn()
        return out if isinstance(out, bytes) else (
            out[0].tobytes(), out[1]) if isinstance(out, tuple) else out.tobytes()
    except ValueError:
        return "raised"


# ---- the cases: every variant of every format ----------------------------------------------

def _jpeg_split(blob):
    at = blob.index(b"\xff\xda")
    return blob[:at], blob[at:]


def plugin_cases(seed=0, h=24, w=30):
    """{name: blob} of every variant this file holds to PIL (small sizes)."""
    rng = np.random.default_rng(seed)
    rgb, grey, rgba = _image(h, w, 3, seed), _image(h, w, 1, seed + 1), _image(h, w, 4, seed + 2)
    idx = rng.integers(0, 256, (h, w)).astype(np.uint8)
    pal = rng.integers(0, 256, (256, 4)).astype(np.uint8)
    cases = {}
    # DIB, through PIL's own writer and headers PIL does not write
    cases["dib_pil_rgb"] = _pil_bytes(rgb, "DIB")
    cases["dib_pil_p"] = _pil_image_bytes(Image.fromarray(rgb).quantize(60), "DIB")
    cases["dib_pal8"] = iw.bmp_bytes(idx, 8, palette=pal[:, :3])[14:]
    cases["dib_rgb24"] = iw.bmp_bytes(rgb, 24)[14:]
    cases["dib_pal4"] = iw.bmp_bytes(idx % 16, 4, palette=pal[:16, :3])[14:]
    cases["dib_rle8"] = iw.bmp_bytes(idx % 7, 8, palette=pal[:, :3], compression=1)[14:]
    cases["dib_bitfields565"] = iw.bmp_bytes(rgb, 16, masks=(0xF800, 0x7E0, 0x1F))[14:]
    # BLP
    jpeg = _pil_bytes(rgb, "JPEG", quality=90)
    head, rest = _jpeg_split(jpeg)
    cases["blp1_jpeg"] = iw.blp_bytes(1, w, h, rest, compression=0, encoding=5, jpeg_header=head)
    cases["blp1_jpeg_alpha_gap"] = iw.blp_bytes(1, w, h, rest, compression=0, encoding=5,
                                                jpeg_header=head, alpha=8, gap=7)
    grey_jpeg = _pil_bytes(grey, "JPEG", quality=85)
    head_g, rest_g = _jpeg_split(grey_jpeg)
    cases["blp1_jpeg_grey"] = iw.blp_bytes(1, w, h, rest_g, compression=0, encoding=5,
                                           jpeg_header=head_g)
    cmyk = iw.jpeg_bytes(rgba, [(1, 1)] * 4, adobe_transform=0)
    head_c, rest_c = _jpeg_split(cmyk)
    cases["blp1_jpeg_cmyk"] = iw.blp_bytes(1, w, h, rest_c, compression=0, encoding=5,
                                           jpeg_header=head_c)
    cases["blp1_palette"] = iw.blp_bytes(1, w, h, idx.tobytes(), palette=pal, encoding=4)
    cases["blp1_palette_alpha"] = iw.blp_bytes(1, w, h, idx.tobytes(), palette=pal, encoding=5,
                                               alpha=8)
    cases["blp2_palette"] = iw.blp_bytes(2, w, h, idx.tobytes(), palette=pal, encoding=1)
    cases["blp2_palette_alpha"] = iw.blp_bytes(2, w, h, idx.tobytes(), palette=pal, encoding=1,
                                               alpha=8, gap=5)
    for ae, size in ((0, 8), (1, 16), (7, 16)):
        blocks = rng.integers(0, 256, (-(-w // 4)) * (-(-h // 4)) * size, dtype=np.uint8)
        for a in (0, 8):
            cases[f"blp2_dxt_ae{ae}_a{a}"] = iw.blp_bytes(2, w, h, blocks.tobytes(), encoding=2,
                                                          alpha=a, alpha_encoding=ae)
    cases["blp2_raw_bgra"] = iw.blp_bytes(2, w, h, rgba.tobytes(), encoding=3, alpha=8)
    quant = Image.fromarray(rgb).quantize(50)
    cases["blp2_pil"] = _pil_image_bytes(quant, "BLP")
    cases["blp1_pil"] = _pil_image_bytes(quant, "BLP", blp_version="BLP1")
    # DCX
    pages = [_pil_bytes(rgb, "PCX"), _pil_bytes(idx, "PCX")]
    cases["dcx_rgb"] = iw.dcx_bytes(pages)
    cases["dcx_p"] = iw.dcx_bytes(pages[::-1])
    # FITS
    cases["fits_8"] = iw.fits_bytes(grey, 8)
    cases["fits_16"] = iw.fits_bytes(grey.astype(np.int16) * 200 - 3000, 16,
                                     cards=["BZERO   =                32768", "BSCALE  = 1"])
    cases["fits_32"] = iw.fits_bytes(grey.astype(np.int32) * 70000 - 5, 32)
    cases["fits_m32"] = iw.fits_bytes(grey.astype(np.float32) / 7 - 3, -32)
    cases["fits_m64"] = iw.fits_bytes(grey.astype(np.float64) / 3, -64)
    cases["fits_naxis1"] = iw.fits_bytes(grey[0], 8)
    cases["fits_naxis3"] = iw.fits_bytes(np.stack([grey, grey[::-1]]), 8)
    cases["fits_comment"] = iw.fits_bytes(grey, 8, cards=["COMMENT made / for the tests",
                                                          "OBJECT  = 'x / y'  / a comment"])
    cases["fits_naxis0"] = iw.fits_bytes(np.zeros(0, np.uint8), 8, naxis=0)
    words = rng.integers(0, 2 ** 31, (h, w))
    for zbitpix in (8, 16, 32, -32):  # -32: PIL's decoder takes no byte of each word
        cases[f"fits_gzip_{zbitpix}"] = iw.fits_gzip_bytes(words, zbitpix)
    # FLI / FLC
    palette = rng.integers(0, 256, (256, 3))
    cases["flc_brun"] = iw.fli_bytes(w, h, [(4, iw.fli_color(palette)), (15, iw.fli_brun(idx))])
    cases["fli_brun_runs"] = iw.fli_bytes(w, h, [(11, iw.fli_color(palette, six_bits=True)),
                                                 (15, iw.fli_brun(idx // 64 * 64))], flc=False)
    cases["flc_copy"] = iw.fli_bytes(w, h, [(16, idx.tobytes())], frames=3)
    cases["flc_lc"] = iw.fli_bytes(w, h, [(12, iw.fli_lc(idx, y0=3, skip=2))])
    cases["flc_lc_literal"] = iw.fli_bytes(w, h, [(13, b""), (12, iw.fli_lc(idx, run=False))])
    cases["flc_ss2"] = iw.fli_bytes(w, h, [(7, iw.fli_ss2(idx))])
    cases["flc_ss2_skip_odd"] = iw.fli_bytes(w - 1, h, [(7, iw.fli_ss2(idx[:, :w - 1], skip_lines=2,
                                                                       odd_last=True))])
    cases["flc_pstamp_black"] = iw.fli_bytes(w, h, [(18, b"\x00" * 6), (13, b""),
                                                    (15, iw.fli_brun(idx))])
    # FTEX
    blocks = rng.integers(0, 256, (-(-w // 4)) * (-(-h // 4)) * 8, dtype=np.uint8).tobytes()
    cases["ftex_dxt1"] = iw.ftex_bytes(w, h, 0, blocks)
    cases["ftex_rgb"] = iw.ftex_bytes(w, h, 1, rgb.tobytes())
    # GBR
    cases["gbr_v1_l"] = iw.gbr_bytes(grey, version=1)
    cases["gbr_v2_rgba"] = iw.gbr_bytes(rgba, version=2, comment=b"a longer comment")
    # IM
    rows = lambda a: np.ascontiguousarray(a[::-1])  # noqa: E731  (IM rows bottom-up)
    planes = lambda a: np.ascontiguousarray(rows(a).transpose(0, 2, 1))  # noqa: E731
    bits = grey > 128
    cases["im_pil_l"] = _pil_bytes(grey, "IM")
    cases["im_pil_rgb"] = _pil_bytes(rgb, "IM")
    cases["im_pil_rgba"] = _pil_bytes(rgba, "IM")
    cases["im_pil_1"] = _pil_bytes(bits, "IM")
    cases["im_pil_p"] = _pil_image_bytes(Image.fromarray(rgb).quantize(37), "IM")
    cases["im_pil_i16"] = _pil_bytes(grey.astype(np.uint16) * 250, "IM")
    cases["im_pil_f"] = _pil_bytes(grey.astype(np.float32) / 3, "IM")
    cases["im_pil_i"] = _pil_bytes(grey.astype(np.int32) * 70001 - 9, "IM")
    cases["im_rgb3"] = iw.im_bytes("RGB3 image", w, h, np.concatenate(
        [rows(rgb[..., c]).ravel() for c in (1, 0, 2)]).tobytes())
    cases["im_x24"] = iw.im_bytes("X 24 image", w, h, rows(rgb).tobytes())
    cases["im_cmyk"] = iw.im_bytes("CMYK image", w, h, planes(rgba).tobytes())
    cases["im_ycc"] = iw.im_bytes("YCC image", w, h, planes(rgb).tobytes())
    cases["im_rgbx"] = iw.im_bytes("RGBX image", w, h, planes(rgba).tobytes())
    cases["im_la"] = iw.im_bytes("LA image", w, h, planes(rgba[..., :2]).tobytes())
    cases["im_la_lut"] = iw.im_bytes("LA image", w, h, planes(rgba[..., :2]).tobytes(),
                                     lut=palette)
    cases["im_pa"] = iw.im_bytes("PA image", w, h, planes(rgba[..., :2]).tobytes())
    cases["im_pa_lut"] = iw.im_bytes("PA image", w, h, planes(rgba[..., :2]).tobytes(),
                                     lut=palette)
    cases["im_l_grey_lut"] = iw.im_bytes("Greyscale image", w, h, rows(grey).tobytes(),
                                         lut=np.repeat(np.arange(256)[:, None], 3, 1)[::-1])
    cases["im_l_colour_lut"] = iw.im_bytes("Grayscale image", w, h, rows(grey).tobytes(),
                                           lut=palette)
    cases["im_b2"] = iw.im_bytes("B2 image", w, h, np.packbits(
        np.unpackbits(rows(idx % 4)[..., None], axis=2)[..., 6:].reshape(h, -1), axis=1).tobytes())
    cases["im_b4_lut"] = iw.im_bytes("B4 image", w, h, rows(idx).tobytes(), lut=palette)
    cases["im_rlb"] = iw.im_bytes("RLB image", w, h, planes(rgb).tobytes())
    for t, dt in (("L 8", "u1"), ("L 8S", "i1"), ("L 16", "<u2"), ("L*16S", "<i2"),
                  ("L 32", "<u4"), ("L 32F", "<f4"), ("L 32 F", "<u4"), ("L 32 S", "<i4"),
                  ("L 32S", "<i4"), ("L 16L", "<u2"), ("L*16B", ">u2"), ("L*16", "<u2")):
        cases[f"im_{t.replace(' ', '_').replace('*', 's')}"] = iw.im_bytes(
            f"{t} image", w, h, rows(rng.integers(-200, 60000, (h, w))).astype(dt).tobytes())
    for n in (2, 5, 12, 24, 31):
        data = rng.integers(0, 256, (w * n + 7) // 8 * h + 4, dtype=np.uint8).tobytes()
        cases[f"im_bits{n}"] = iw.im_bytes(f"L*{n} image", w, h, data)
    cases["im_lines"] = iw.im_bytes("Greyscale image", w, h, rows(grey).tobytes(),
                                    lines=["Name: x", "Comment: a", "Comment: b", "Scale (x,y): 1,1",
                                           "File size (no of images): 1", "Date: today"])
    # IMT
    cases["imt"] = iw.imt_bytes(grey)
    # IPTC
    cases["iptc_l"] = iptc_l = iw.iptc_bytes(grey.tobytes(), w, h, parts=2)
    cases["iptc_rgb_band2"] = iw.iptc_bytes(grey.tobytes(), w, h, 3, 1, band=1)
    cases["iptc_cmyk_band4"] = iw.iptc_bytes(grey.tobytes(), w, h, 4, 1, band=3)
    cases["iptc_rgb_noband"] = iw.iptc_bytes(grey.tobytes(), w, h, 3, 1)
    cases["iptc_jpeg"] = iw.iptc_bytes(_pil_bytes(grey, "JPEG"), w, h, compression=5)
    cases["iptc_unknown_compression"] = iw.iptc_bytes(grey.tobytes(), w, h, compression=3)
    cases["iptc_short"] = iptc_l[:-40]
    # McIdas
    cases["mcidas_l"] = iw.mcidas_bytes(grey)
    cases["mcidas_i16"] = iw.mcidas_bytes(grey.astype(">u2") * 257, prefix=4)
    cases["mcidas_i32"] = iw.mcidas_bytes(grey.astype(">u4") * 16843009, offset=300)
    # MSP
    cases["msp_v1_pil"] = _pil_bytes(bits, "MSP")
    cases["msp_v2"] = iw.msp_bytes(bits)
    cases["msp_v2_runs"] = iw.msp_bytes(grey > 40, run_min=2)
    cases["msp_v1"] = iw.msp_bytes(bits, version=1)
    # PIXAR
    cases["pixar"] = iw.pixar_bytes(rgb)
    # SPIDER
    buf = io.BytesIO()
    Image.fromarray(grey.astype(np.float32) / 9).save(buf, "SPIDER")
    cases["spider_pil"] = buf.getvalue()
    cases["spider_be"] = np.frombuffer(buf.getvalue(), "<f4").astype(">f4").tobytes()
    # XBM
    cases["xbm_pil"] = _pil_bytes(bits, "XBM")
    cases["xbm_hotspot"] = _pil_bytes(bits, "XBM", hotspot=(3, 4))
    cases["xbm_upper"] = bytes(_pil_bytes(bits, "XBM")).replace(b"0x", b"0X").replace(b"0X",
                                                                                      b"0x", 1)
    # XPM
    cases["xpm_p1"] = iw.xpm_bytes(idx % 40, palette[:40], bpp=1)
    cases["xpm_p2_none"] = iw.xpm_bytes(idx % 90, palette[:90], bpp=2, none=91)
    cases["xpm_p2_nocomment"] = iw.xpm_bytes(idx, palette, bpp=2, pixels_comment=False)
    cases["xpm_rgb"] = iw.xpm_bytes(rng.integers(0, 300, (h, w)), rng.integers(0, 256, (300, 3)),
                                    bpp=2)
    cases["xpm_none_used"] = iw.xpm_bytes(idx % 4, palette[:4], bpp=1, none=2)
    # XVThumb
    cases["xvthumb"] = iw.xvthumb_bytes(idx)
    cases["xvthumb_no_comment"] = iw.xvthumb_bytes(idx, comments=())
    return cases


CASES = plugin_cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_variant_is_pils_array(name):
    ok = _same_as_pil(CASES[name], "v.img")
    refused = {"im_rlb", "im_pa", "iptc_unknown_compression", "iptc_short", "xpm_none_used",
               "xbm_upper", "fits_naxis0", "fits_gzip_-32", "blp2_raw_bgra"}
    assert ok == (name not in refused), name


# ---- committed fixtures -------------------------------------------------------------------

@pytest.mark.parametrize("path", PLUGINS, ids=lambda p: p.name)
def test_committed_fixture_is_pils(path):
    want = np.load(path.with_suffix(".npy"))
    got = image_io.read_image(str(path))
    assert got.dtype == want.dtype and got.shape == want.shape and got.tobytes() == want.tobytes()
    assert _same_as_pil(path.read_bytes(), path.name)


def test_fixtures_cover_every_format():
    names = {p.stem for p in PLUGINS} | {p.stem for p in FORMATS.glob("ojpeg_*.tif")}
    for want in ("dib_pil_rgb", "dib_pal8", "blp1_jpeg", "blp1_palette", "blp2_pil", "blp2_dxt1",
                 "blp2_dxt3", "blp2_dxt5", "dcx_pcx", "fits_8", "fits_16", "fits_m32", "fits_m64",
                 "flc_brun", "fli_ss2_lc", "ftex_dxt1", "ftex_rgb", "gbr_v2_rgba", "gbr_v1_l",
                 "im_pil_rgb", "im_pil_p", "im_rgb3", "im_pa_lut", "im_bits12", "im_l16b",
                 "imt_l", "iptc_l", "iptc_rgb_band2", "mcidas_i16", "msp_v1", "msp_v2", "pixar",
                 "spider", "xbm", "xpm_p", "xpm_rgb", "xvthumb", "ojpeg_interchange_420",
                 "ojpeg_interchange_422_strip", "ojpeg_tables_420", "ojpeg_tables_444_photo2",
                 "ojpeg_grey"):
        assert want in names, want


# ---- PhotoCD (768 x 512: built here, not committed) -----------------------------------------

@pytest.mark.parametrize("orientation", [0, 1, 2, 3])
def test_pcd_base_image_is_pils(orientation):
    rng = np.random.default_rng(80 + orientation)
    planes = (rng.integers(0, 256, (512, 768), dtype=np.uint8),
              rng.integers(0, 256, (256, 384), dtype=np.uint8),
              rng.integers(0, 256, (256, 384), dtype=np.uint8))
    blob = iw.pcd_bytes(*planes, orientation=orientation)
    assert _same_as_pil(blob, "p.pcd")
    assert not _same_as_pil(blob[:-1], "p.pcd")  # the last pair of rows cut short
    assert not _same_as_pil(blob[:2048 + 1000], "p.pcd")  # declined by PCD, then by the rest


def test_pcd_tables_are_pils_ycc_unpacker():
    """`PCD_TABLES` give PIL's "YCC;P" unpacker on every (y, c) with c1 = c2,
    and on a seeded sample of (y, c1, c2)."""
    y, c = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    rng = np.random.default_rng(81)
    trips = [np.stack([y, c, c], -1).reshape(-1, 3),
             rng.integers(0, 256, (65536, 3))]
    t = ip.PCD_TABLES.astype(np.int32)
    for trip in trips:
        want = np.asarray(Image.frombytes("RGB", (len(trip), 1), trip.astype(np.uint8).tobytes(),
                                          "raw", "YCC;P"))[0]
        yy, c1, c2 = trip.T
        got = np.clip(np.stack([t[0][yy] + t[1][c2], t[0][yy] + t[3][c2] + t[4][c1],
                                t[0][yy] + t[2][c1]], -1), 0, 255)
        assert np.array_equal(got, want)


# ---- each native loop against its plain version ---------------------------------------------

def _fli_frames():
    """(frame bytes, width, height) of every FLI case, and damaged ones."""
    out = []
    rng = np.random.default_rng(82)
    for name, blob in CASES.items():
        if name.startswith(("fli", "flc")):
            w, h = struct.unpack_from("<HH", blob, 8)
            start = 128 if struct.unpack_from("<H", blob, 132)[0] != 0xF100 else 144
            size = struct.unpack_from("<I", blob, start)[0]
            frame = blob[start:start + size]
            out.append((frame, w, h))
            for k in range(6):
                bad = bytearray(frame)
                bad[int(rng.integers(16, len(bad)))] = int(rng.integers(0, 256))
                out.append((bytes(bad) if k % 2 else bytes(bad[:int(rng.integers(8, len(bad)))]),
                            w, h))
    return out


def test_native_fli_equals_plain():
    frames = _fli_frames()
    assert len(frames) >= 56
    for frame, w, h in frames:
        start = np.random.default_rng(len(frame)).integers(0, 256, (h, w)).astype(np.uint8)
        assert (_outcome(lambda: native.fli_decode(frame, w, h, start.copy()))
                == _outcome(lambda: ip.fli_reference(frame, w, h, start)))


def test_native_msp_equals_plain():
    rng = np.random.default_rng(83)
    for trial in range(40):
        h, w = int(rng.integers(1, 9)), int(rng.integers(1, 40))
        blob = bytearray(iw.msp_bytes(rng.random((h, w)) < 0.3, run_min=int(rng.integers(2, 5))))
        if trial % 2:
            blob[int(rng.integers(32 + 2 * h, len(blob)))] = int(rng.integers(0, 256))
        if trial % 3 == 0:
            blob = blob[:-int(rng.integers(1, 4))]
        data, rowmap = bytes(blob[32 + 2 * h:]), np.frombuffer(bytes(blob[32:32 + 2 * h]), "<u2")
        cap = (w + 7) // 8 * h
        assert (_outcome(lambda: native.msp_rows(data, rowmap, w, cap))
                == _outcome(lambda: ip.msp_reference(data, rowmap, w, cap)))


def test_native_pcd_equals_plain():
    rng = np.random.default_rng(84)
    data = rng.integers(0, 256, 589824, dtype=np.uint8).tobytes()
    assert np.array_equal(native.pcd_decode(data, ip.PCD_TABLES), ip.pcd_reference(data))
    for cut in (1, 1000):
        assert (_outcome(lambda: native.pcd_decode(data[:-cut], ip.PCD_TABLES))
                == _outcome(lambda: ip.pcd_reference(data[:-cut])) == "raised")


def test_native_xbm_equals_plain():
    rng = np.random.default_rng(85)
    for trial in range(30):
        h, w = int(rng.integers(1, 9)), int(rng.integers(1, 30))
        text = bytes(rng.choice(list(b"0x1aAfFgG ,x"), int(rng.integers(0, 80))))
        assert (_outcome(lambda: native.xbm_decode(text, w, h))
                == _outcome(lambda: ip.xbm_reference(text, w, h)))
    body = _pil_bytes(_image(9, 13, 1) > 99, "XBM")
    body = body[body.index(b"{"):]
    assert np.array_equal(native.xbm_decode(body, 13, 9), ip.xbm_reference(body, 13, 9))


def test_native_xpm_equals_plain():
    rng = np.random.default_rng(86)
    for trial in range(30):
        bpp = int(rng.integers(1, 4))
        keys = list(dict.fromkeys(bytes(rng.choice(list(b"abc.#"), int(rng.integers(1, bpp + 1))))
                                  for _ in range(12)))
        lines = [b"".join(keys[int(i)] if len(keys[int(i)]) == bpp else b"x" * bpp
                          for i in rng.integers(0, len(keys), int(rng.integers(0, 6))))
                 for _ in range(int(rng.integers(1, 6)))]
        if trial % 3 == 0 and lines:
            lines[-1] = lines[-1][:-1]
        data = b"".join(lines)
        ends = np.cumsum([len(x) for x in lines])
        pixels = int(rng.integers(1, 20))
        assert (_outcome(lambda: native.xpm_lookup(data, ends, bpp, keys, pixels))
                == _outcome(lambda: ip.xpm_reference(data, ends, bpp, keys, pixels)))


@pytest.mark.parametrize("bits", [2, 3, 7, 9, 12, 17, 24, 31])
def test_native_bit_decode_equals_plain(bits):
    rng = np.random.default_rng(87 + bits)
    for w, h in ((1, 1), (5, 3), (13, 4)):
        data = rng.integers(0, 256, (w * bits + 7) // 8 * h + 8, dtype=np.uint8).tobytes()
        for fill, pad, sign, ystep in ((3, 8, 0, -1), (0, 8, 1, 1), (1, 0, 0, 1), (2, 8, 1, -1)):
            for d in (data, data[:len(data) // 2]):
                assert (_outcome(lambda: native.bit_decode(d, bits, w, h, pad, fill, sign, ystep))
                        == _outcome(lambda: ip.bit_reference(d, bits, w, h, pad, fill, sign,
                                                             ystep)))


# ---- what PIL refuses here, and what waits ---------------------------------------------------

@pytest.mark.parametrize("kind", ["EPS", "EPS binary", "MPEG", "HDF5", "BUFR", "ZCZC", "GRIB",
                                  "WMF", "EMF", "AVIF"])
def test_formats_pil_cannot_decode_here_raise_naming_the_file(kind):
    blob = {"EPS": b"%!PS-Adobe-3.0 EPSF-3.0\n%%BoundingBox: 0 0 4 4\n" + bytes(64),
            "EPS binary": b"\xc5\xd0\xd3\xc6" + struct.pack("<6I", 32, 40, 0, 0, 0, 0)
            + bytes(8) + b"%!PS-Adobe-3.0 EPSF-3.0\n%%BoundingBox: 0 0 4 4\n",
            "MPEG": b"\x00\x00\x01\xb3\x04\x00\x30\x13" + bytes(64),
            "HDF5": b"\x89HDF\r\n\x1a\n" + bytes(64),
            "BUFR": b"BUFR" + bytes(64), "ZCZC": b"ZCZC" + bytes(64),
            "GRIB": b"GRIB\x00\x00\x00\x01" + bytes(64),
            "WMF": b"\xd7\xcd\xc6\x9a\x00\x00" + struct.pack("<4hH", 0, 0, 64, 64, 1440)
            + bytes(6) + bytes(64),
            "EMF": b"\x01\x00\x00\x00" + struct.pack("<4i4i", 0, 0, 4, 4, 0, 0, 100, 100)
            + b" EMF" + bytes(64),
            "AVIF": b"\x00\x00\x00\x1cftypavif" + bytes(64)}[kind]
    assert _pil(blob) is None
    with pytest.raises(ValueError, match=r"^f\.img: "):
        image_io.decode_image(blob, "f.img")


def test_header_only_formats_claim_what_pils_order_lets_them():
    """IM, IMT, IPTC, PCD and SPIDER have no signature test: each runs its
    header checks on whatever reaches it, and what they decline goes on (to
    TGA, last of all). Files of the formats before them are theirs, and a
    TGA whose first line reads as an IM header is an IM file, as in PIL."""
    rgb = _image(6, 7)
    tga = iw.tga_bytes(rgb, 2, 24)
    assert _same_as_pil(tga, "t.img")
    im_like = b"Image type: RGB image\r\nImage size (x*y): 7*6\r\n\x1a" + rgb.tobytes() * 3
    assert _same_as_pil(im_like, "i.img")
    iptc_then_tga = b"\x1c\x03\x3c\x00\x02\x01\x00" + bytes(10)
    assert not _same_as_pil(iptc_then_tga, "p.img")
    spider_like = struct.pack(">27f", *([1.0] * 27))
    assert not _same_as_pil(spider_like + bytes(200), "s.img")


# ---- a census of damaged files ----------------------------------------------------------------

def test_census_of_flips_and_truncations_gives_pils_outcome():
    """90 seeded damaged copies of each of the 42 committed files of these
    formats (`tools/plugin_flip_census.py`'s: two thirds one or two byte
    flips, one third a truncation): 3,780 cases, each PIL's array or a
    `ValueError` naming the file where PIL raises. (The tool finds the
    same at 600 a file, 25,200 cases; the copies that once parted from PIL
    at more are the next test's cases.)"""
    from tools import plugin_flip_census as census

    files = census.census_files()
    assert len(files) == 42
    parted = set()
    for path in files:
        for k, blob in enumerate(census.damaged(path, 90)):
            want = _pil(blob)
            try:
                got = image_io.decode_image(blob, "c.img")
            except ValueError as e:
                assert str(e).startswith("c.img: ")
                got = None
            same = (want is None and got is None) or (
                want is not None and got is not None and got.dtype == want.dtype
                and got.shape == want.shape and got.tobytes() == want.tobytes())
            if not same:
                parted.add((path.name, k))
    assert not parted, sorted(parted)


# Damaged copies (file, copy, copies a file) that `tools/plugin_flip_census.py` once found apart
# from PIL at 600, 2,000 and 5,000 copies a file: old-style JPEG directory entries (counts, types,
# RowsPerStrip, ImageLength, table offsets, XMP's type), marker bytes of its header, its SOS cut
# short, and strip data.
ONCE_APART = [("ojpeg_interchange_420.tif", k) for k in (60, 232, 282, 514, 597, 1282, 1306, 1523,
                                                         1551)]
ONCE_APART += [("ojpeg_interchange_422_strip.tif", k) for k in (223, 382, 1714, 3216)]
ONCE_APART += [("ojpeg_tables_420.tif", k) for k in (516, 765, 769, 967, 1176, 1233, 1554, 1722,
                                                     3157)]
ONCE_APART += [("ojpeg_tables_444_photo2.tif", k) for k in (289, 336, 384, 576, 597, 1675)]
ONCE_APART += [("ojpeg_grey.tif", k) for k in (348, 471, 3615)]


@pytest.mark.parametrize("name,k", ONCE_APART, ids=[f"{n[:-4]}-{k}" for n, k in ONCE_APART])
def test_damaged_copies_once_apart_give_pils_outcome(name, k):
    from tools import plugin_flip_census as census

    blob = list(census.damaged(FORMATS / name, k + 1))[-1]
    _same_as_pil(blob, "c.tif")


def test_differences_left_from_pil_are_the_recorded_ones():
    """The two copies of 25,000 (5,000 a file of the old-style JPEG files)
    where the port still parts from PIL, as ROADMAP queue 3 records them: a
    file whose JPEGInterchangeFormat and one strip hold the same bytes, cut
    short (the first MCU row differs), and a directory whose entry count was
    damaged, which then holds ImageLength twice (libtiff keeps one, Pillow
    reads the other: the port refuses). A change to either outcome belongs
    in that record too."""
    from tools import plugin_flip_census as census

    cut = list(census.damaged(FORMATS / "ojpeg_interchange_422_strip.tif", 3864))[-1]
    want, got = _pil(cut), image_io.decode_image(cut, "c.tif")
    assert want.shape == got.shape == (48, 64, 3)
    assert np.flatnonzero((want != got).any(axis=(1, 2))).tolist() == list(range(8))
    twice = list(census.damaged(FORMATS / "ojpeg_tables_420.tif", 3992))[-1]
    assert _pil(twice).shape == (48, 64, 3)
    with pytest.raises(ValueError, match=r"^c\.tif: TIFF ImageLength \(tag 257\) twice"):
        image_io.decode_image(twice, "c.tif")


def test_short_reads_decline_only_while_the_file_opens():
    """A reader's struct.error or IndexError before `_opened` is PIL's
    decline (the next format is tried), after it the file's ValueError; a
    reader that a reader calls keeps its own account."""
    @ip._declines
    def decode_toy(blob, name):
        if blob[:1] == b"o":
            struct.unpack_from("<I", blob, 8)  # still opening
        ip._opened(2, 2, "L", name)
        if blob[:1] == b"n":
            assert decode_toy(b"o", name) is None
        return struct.unpack_from("<I", blob, 8)  # loading

    assert decode_toy(b"o", "t.img") is None
    for blob in (b"l", b"n"):
        with pytest.raises(ValueError, match=r"^t\.img: broken TOY data"):
            decode_toy(blob, "t.img")


def test_dispatch_chain_is_built_once():
    assert image_io._chain() is image_io._chain()


# ---- a COLMAP scene and a method directory of these formats, through both packages -----------

def test_colmap_scene_of_plugin_views_equals_jaxs(tmp_path):
    """The six COLMAP views as old-style JPEG TIFFs (the interchange and the
    table form), a BLP1 JPEG, a BLP2, an IM RGB and a PIXAR raster: JAX's
    reader (PIL) and the port's give the same cameras and images, each view
    PIL's committed decode."""
    import shutil

    from wast3d_tpu.scene import datasets as jds
    from wast3d_tpu_torch.scene import colmap as cm
    from wast3d_tpu_torch.scene import datasets as tds

    src = tmp_path / "colmap"
    shutil.copytree(FIXTURES / "colmap_jpeg", src)
    views = FORMATS / "colmap_plugins"
    shutil.copytree(views, src / "images_plugins", ignore=shutil.ignore_patterns("*.npy"))
    names = {p.stem: p.name for p in views.iterdir() if p.suffix != ".npy"}
    assert sorted(Path(n).suffix for n in names.values()) == [".blp", ".blp", ".im", ".pxr",
                                                              ".tif", ".tif"]
    path = str(src / "sparse" / "0" / "images.bin")
    cm.write_images_binary({k: v._replace(name=names[Path(v.name).stem])
                            for k, v in cm.read_images_binary(path).items()}, path)
    t = tds.read_colmap_scene(str(src), "images_plugins", eval_split=True)
    j = jds.read_colmap_scene(str(src), "images_plugins", eval_split=True)
    cams_t, cams_j = t.train_cameras + t.test_cameras, j.train_cameras + j.test_cameras
    assert len(cams_t) == len(cams_j) == 6
    for a, b in zip(cams_t, cams_j):
        assert (a.image_name, a.width, a.height) == (b.image_name, b.width, b.height)
        assert a.image.dtype == b.image.dtype and a.image.tobytes() == b.image.tobytes()
        want = np.load(views / f"{a.image_name}.npy")
        assert a.image.tobytes() == (want.astype(np.float32) / 255.0).tobytes()


def test_metrics_read_a_plugin_method_directory_as_jax_does():
    from wast3d_tpu.eval import metrics as jmetrics
    from wast3d_tpu_torch.eval import metrics as tmetrics

    method = FORMATS / "metrics_plugins"
    a = tmetrics._read_images(str(method / "renders"), str(method / "gt"))
    b = jmetrics._read_images(str(method / "renders"), str(method / "gt"))
    assert a[2] == b[2] == ["00000.tif", "00001.pxr"]
    for x, y in zip(a[0] + a[1], b[0] + b[1]):
        assert x.dtype == y.dtype == np.float32 and x.tobytes() == y.tobytes()
