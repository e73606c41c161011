"""Every image the JAX package reads through PIL, read without PIL.

`read_image(path)` / `decode_image(blob, name)` return exactly what
`np.asarray(PIL.Image.open(path))` returns (dtype, shape and values),
trying the formats in PIL's order (its preinit six, then `Image.ID`) on
the file's bytes, never on its extension:

- `\\x89PNG\\r\\n\\x1a\\n`: PNG, every colour type at every bit depth
  (`utils/png.decode_png`);
- `FF D8`: JPEG, Huffman-coded baseline or progressive, arithmetic-coded
  sequential or progressive (within PIL's 64 KiB read blocks, which
  libjpeg's arithmetic decoder cannot wait past), or lossless, 1, 3 or 4
  components, any integral sampling, after JpegImagePlugin's own walk over
  the markers (`_jpeg_walk`), damaged and partly refined files as
  libjpeg-turbo 3.1.3 reads them (`native.decode_jpeg`);
- `BM`: BMP (`decode_bmp`): BmpImagePlugin's modes (1/4/8-bit palettes as
  "P" indices, or "1" / "L" when the palette is black and white or the
  identity greys; 16-, 24- and 32-bit BI_RGB as RGB; BI_BITFIELDS layouts
  as RGB or RGBA), RLE8 / RLE4, bottom-up or top-down;
- `II*\\0` / `MM\\0*` / `II+\\0`: TIFF and BigTIFF (`decode_tiff`), the
  first image as Pillow reads it (its own raw decoder for uncompressed
  files, libtiff for the rest): strips or tiles (edge tiles cropped), chunky
  or separate planes, fill order 1 or 2; the modes of Pillow's OPEN_INFO:
  bilevel ("1", bools holding 0 / 255), 2- and 4-bit grey scaled to "L",
  8-bit L / LA / RGB(A) with their ExtraSamples variants, palette indices at
  1, 2, 4 and 8 bits ("P", "PA"), CMYK at 8 and 16 bits, CIELab ("LAB"),
  12- and 16-bit grey ("I;16", "I;16B"), signed 16-bit and 32-bit integers
  ("I"), 32-bit float ("F"), 16-bit RGB(A) as the high byte of each sample;
  compression none, PackBits, LZW, Deflate (8, 32946), LZMA (34925), ZSTD
  (50000: one Zstandard frame a strip or tile, `native.zstd_decode`, as
  libtiff's codec over libzstd 1.5.7 decodes it, damaged frames too), CCITT
  RLE / Group 3 / Group 4 (2, 3, 4: `native.ccitt_decode`) or JPEG (7:
  abbreviated streams after the JPEGTables, YCbCr turned to RGB by
  libjpeg's upsampling and colour tables, other colour spaces as coded) or
  old-style JPEG (6: `_tiff_ojpeg`, as libtiff 4.7.1's OJPEG codec builds
  its stream from JPEGInterchangeFormat or the table tags and strips,
  libjpeg's raw data units through TIFFYCbCrToRGB, its strip failures);
  YCbCr under any other compression through libtiff's RGBA reader (data
  units at 1x1-4x4 subsampling, in strips or, as TIFFReadRGBATile reads
  them, in tiles with the edge tiles cropped; TIFFYCbCrToRGB's tables:
  `native.ycbcr_to_rgb`); predictor 1, 2 or 3 (libtiff's floating-point predictor); the
  Orientation tag applied as PIL's exif_transpose does; and Pillow's and
  libtiff's quirks (a separate-planes file's band copies and unpacking,
  signed and float samples of big-endian compressed files left swapped);
- `RIFF` .... `WEBP` with a `VP8 `, `VP8L` or `VP8X` chunk: WebP
  (`decode_webp`), as PIL reads it through libwebp's WebPAnimDecoder: lossy
  (RGB, or RGBA with an ALPH chunk, raw or lossless, any filter), lossless
  (RGBA when its header says alpha is used), and frame 0 of an animation on
  its canvas (zeros outside the frame); RGBA exactly when WebPGetFeatures
  finds alpha (the lossless header's bit; else the VP8X flag, or an ALPH
  chunk, which the demuxer then drops if the flag is missing);
- `GIF87a` / `GIF89a`: GIF (`decode_gif`), the first image as GifImagePlugin
  loads it: palette indices ("P"), or grey levels ("L") when the colour
  table is the identity grey ramp or absent, on the logical screen (grown to
  hold the frame) filled with the transparent index, or 0, outside the frame;
- `P` and one of `0123456fy`: Netpbm (`decode_pnm`), as PpmImagePlugin
  reads it: P1-P6 ASCII and binary, comments and whitespace as its parser
  takes them, maxval up to 65535 (grey past 255 as "I", RGB scaled to 8
  bits), PIL's own P0CMYK / PyP / PyRGBA / PyCMYK, and Pf (PFM, "F": rows
  bottom-up, the scale's sign choosing the byte order);
- `qoif`: QOI (`decode_qoi`), RGB or RGBA by the header's channel count, as
  Pillow's QoiDecoder reads the ops;
- `FF 4F FF 51` (a J2K codestream) or the JP2 signature box: JPEG 2000
  (`utils/jpeg2000.decode_jpeg2000`), as Jpeg2KImagePlugin over OpenJPEG
  2.5.4 reads it: every Part 1 feature OpenJPEG decodes (tiles, five
  progressions, POC, layers, precincts, every code-block style, SOP / EPH,
  PPM / PPT, ROI, 5/3 and 9/7 bit for bit, RCT / ICT, subsampling, 1-16
  bits, signed), PIL's modes (L, I;16, LA, RGB, RGBA, P / PA from `pclr`,
  CMYK, sYCC through PIL's YCbCr -> RGB), a codestream cut short as
  OpenJPEG's strict mode takes it;
- `00 00 02 00`, `0A` (then version 0/2/3/5), `DDS `, `icns`,
  `00 00 01 00`, `8BPS`, `01 DA`, `59 A6 6A 95`: CUR, PCX, DDS (BC1-BC7
  too), ICNS (PNG, JPEG 2000 or 24-bit RGB entries with their masks), ICO,
  PSD, SGI and Sun raster, in PIL's order, each read as its PIL plugin
  reads it (`utils/image_formats.py`); a reader that declines a file (PIL's
  SyntaxError: a CUR without cursors, an ICO without entries, a PCX of no
  size, ...) lets it go on to the next format, as PIL does;
- TGA (`decode_tga`), which has no signature: tried where PIL tries it,
  with TgaImageFile's header checks: types 1/2/3 and their run-length
  forms 9/10/11 at 1, 8, 16, 24 and 32 bits, colour maps from a first entry
  index, the ID field, the origin and right-to-left bits, run-length
  literals that run across rows;
- DIB, BLP, DCX, FITS, FLI / FLC, FTEX, GBR, IM, IMT, IPTC, McIdas, MSP,
  PCD, PIXAR, SPIDER, XBM, XPM and XVThumb (`utils/image_plugins.py`),
  each at its place in PIL's order; IM, IMT, IPTC, PCD and SPIDER, which
  have no signature, run their header checks on whatever reaches them.

EPS, MPEG, HDF5, BUFR, GRIB and WMF, which PIL opens and cannot decode
here, raise `ValueError` naming the file, as does anything else (AVIF,
which waits for AV1's tables, with the file's first bytes). A TIFF
outside these names the tag and its value (YCbCr subsampling libtiff has
no routine for, 24-bit samples, tiled old-style JPEG, ...). A file of more pixels than PIL opens
(twice `PIL.Image.MAX_IMAGE_PIXELS`) raises before anything is allocated.
The byte loops are native (`native/image.cpp`, `native/jpeg.cpp`,
`native/webp.cpp`, `native/zstd.cpp`, `native/raster.cpp`, `native/j2k.cpp`,
with no fallback); numpy here turns samples into PIL's arrays. The plain versions
the tests hold the native routines to are here too (`bmp_rle_reference`,
`lzw_reference`, `packbits_reference`, `jpeg_upsample_reference`,
`jpeg_idct_reference`, `jpeg_undifference_reference`, `ccitt_reference`,
`ycbcr_to_rgb_reference`,
`gif_lzw_reference`, `vp8_idct_reference`, `yuv_to_rgba_reference`,
`tga_rle_reference`, `qoi_reference`), in `utils/png.py`, in
`utils/zstd.py` (`zstd_reference`), in `utils/image_formats.py`
(`bcn_reference`, `packbits_rows_reference`, `sgi_rle_reference`,
`pcx_rle_reference`, `sun_rle_reference`) and in `utils/jpeg2000.py`
(`t1_reference`, `idwt53_reference`, `idwt97_reference`, `mct_reference`).
"""

from __future__ import annotations

import bisect
import functools
import lzma
import struct
import zlib
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np

from wast3d_tpu_torch.utils import jpeg2000, png

_PNG = b"\x89PNG\r\n\x1a\n"
_WEBP_FIRST = (b"VP8 ", b"VP8L", b"VP8X")
# What PIL opens and this reader reads, for the message of anything else.
KNOWN = ("PNG, JPEG, BMP, DIB, GIF, Netpbm, BLP, CUR, PCX, DCX, DDS, FITS, FLI, FTEX, GBR, "
         "JPEG 2000, ICNS, ICO, IM, IMT, IPTC, McIdas, TIFF, MSP, PCD, PIXAR, PSD, QOI, SGI, "
         "SPIDER, Sun raster, TGA, WebP, XBM, XPM or XVThumb")


def _late(module, reader: str):
    """Another module's reader, looked up there at each call (a reader
    replaced there is the one called)."""
    return lambda blob, name: getattr(module, reader)(blob, name)


def _refusing(why: str):
    """A reader of a format PIL opens and cannot decode here: it raises `why`."""
    def refuse(blob: bytes, name: str):
        raise ValueError(f"{name}: {why}")
    return refuse


@functools.lru_cache(maxsize=None)
def _chain():
    """Image.ID's order after its first pass (BMP, DIB, GIF, JPEG, PPM, PNG):
    (signature test, reader) of each format; a reader that returns None
    declines the file (PIL's SyntaxError) and the next is tried. The five
    formats without a signature test (IM, IMT, IPTC, PCD, SPIDER) and TGA
    run their header checks on any bytes that reach them. The formats PIL
    opens and cannot decode here (no Ghostscript, no handler registered)
    raise; AVIF, which waits for AV1's tables, is not a format this reader
    knows."""
    from wast3d_tpu_torch.utils import image_formats as f, image_plugins as p

    anything = lambda b: True  # noqa: E731
    return ((lambda b: b[4:8] == b"ftyp" and b[8:12] in (b"avif", b"avis", b"mif1", b"msf1"),
             _unknown),
            (p.accepts_blp, _late(p, "decode_blp")),
            (lambda b: b[:4] in (b"BUFR", b"ZCZC"),
             _refusing("a BUFR file, which PIL opens and cannot load (no BUFR handler)")),
            (lambda b: b[:4] == b"\x00\x00\x02\x00", _late(f, "decode_cur")),
            (lambda b: b[:1] == b"\x0a" and b[1:2] in (b"\x00", b"\x02", b"\x03", b"\x05"),
             _late(f, "decode_pcx")),
            (p.accepts_dcx, _late(p, "decode_dcx")),
            (lambda b: b[:4] == b"DDS ", _late(f, "decode_dds")),
            (lambda b: b[:4] == b"%!PS" or b[:4] == b"\xc5\xd0\xd3\xc6",
             _refusing("an EPS file, which PIL opens and cannot load here (no Ghostscript)")),
            (p.accepts_fits, _late(p, "decode_fits")),
            (p.accepts_fli, _late(p, "decode_fli")),
            (p.accepts_ftex, _late(p, "decode_ftex")),
            (p.accepts_gbr, _late(p, "decode_gbr")),
            (lambda b: b[:4] == b"GRIB" and b[7:8] == b"\x01",
             _refusing("a GRIB file, which PIL opens and cannot load (no GRIB handler)")),
            (lambda b: b[:8] == b"\x89HDF\r\n\x1a\n",
             _refusing("an HDF5 file, which PIL opens and cannot load (no HDF5 handler)")),
            (lambda b: b[:4] == jpeg2000.J2K_SIGNATURE or b[:12] == jpeg2000.JP2_SIGNATURE,
             _late(jpeg2000, "decode_jpeg2000")),
            (lambda b: b[:4] == b"icns", _late(f, "decode_icns")),
            (lambda b: b[:4] == b"\x00\x00\x01\x00", _late(f, "decode_ico")),
            (anything, _late(p, "decode_im")),
            (anything, _late(p, "decode_imt")),
            (anything, _late(p, "decode_iptc")),
            (p.accepts_mcidas, _late(p, "decode_mcidas")),
            (lambda b: b[:4] == b"\x00\x00\x01\xb3",
             _refusing("an MPEG stream, which PIL identifies and cannot load")),
            (lambda b: b[:4] in (b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+"),
             decode_tiff),
            (lambda b: b[:4] in (b"II\x00*", b"MM*\x00"),
             _refusing("a TIFF header PIL accepts and never reads")),
            (p.accepts_msp, _late(p, "decode_msp")),
            (anything, _late(p, "decode_pcd")),
            (p.accepts_pixar, _late(p, "decode_pixar")),
            (lambda b: b[:4] == b"8BPS", _late(f, "decode_psd")),
            (lambda b: b[:4] == b"qoif", decode_qoi),
            (lambda b: b[:2] == b"\x01\xda", _late(f, "decode_sgi")),
            (anything, _late(p, "decode_spider")),
            (lambda b: b[:4] == b"\x59\xa6\x6a\x95", _late(f, "decode_sun")),
            (lambda b: _tga_header(b) is not None, decode_tga),
            (lambda b: b[:4] == b"RIFF" and b[8:12] == b"WEBP" and b[12:16] in _WEBP_FIRST,
             decode_webp),
            (lambda b: b[:6] == b"\xd7\xcd\xc6\x9a\x00\x00" or b[:4] == b"\x01\x00\x00\x00"
             and b[40:44] == b" EMF",
             _refusing("a Windows metafile, which PIL opens and cannot load here (no WMF "
                       "handler)")),
            (p.accepts_xbm, _late(p, "decode_xbm")),
            (p.accepts_xpm, _late(p, "decode_xpm")),
            (p.accepts_xvthumb, _late(p, "decode_xvthumb")))


def _unknown(blob: bytes, name: str):
    raise ValueError(f"{name}: not an image this reader knows ({KNOWN}); it starts with "
                     f"{blob[:8]!r}")


def read_image(path: str) -> np.ndarray:
    """`np.asarray(PIL.Image.open(path))`, without PIL."""
    with open(path, "rb") as f:
        return decode_image(f.read(), path)


def decode_image(blob: bytes, name: str = "<bytes>") -> np.ndarray:
    """`np.asarray(PIL.Image.open(io.BytesIO(blob)))`, without PIL; `name`
    names the file in errors. The formats are tried in PIL's order: the
    ones PIL loads first (BMP, DIB, GIF, JPEG, PPM, PNG), then the rest of
    Image.ID (`_chain`)."""
    from wast3d_tpu_torch import native
    from wast3d_tpu_torch.utils import image_plugins

    if blob[:2] == b"BM":
        return decode_bmp(blob, name)
    if image_plugins.accepts_dib(blob):
        out = image_plugins.decode_dib(blob, name)
        if out is not None:
            return out
    if blob[:6] in (b"GIF87a", b"GIF89a"):
        return decode_gif(blob, name)
    if blob[:2] == b"\xff\xd8":
        _jpeg_walk(blob, name)
        return native.decode_jpeg(blob, name)
    if blob[:1] == b"P" and blob[1:2] and blob[1] in b"0123456fy":
        return decode_pnm(blob, name)
    if blob[:8] == _PNG:
        return png.decode_png(blob, name)
    for accepts, reader in _chain():
        if accepts(blob):
            out = reader(blob, name)
            if out is not None:
                return out
    _unknown(blob, name)


# PIL refuses (DecompressionBombError) more pixels than twice MAX_IMAGE_PIXELS.
MAX_PIXELS = 2 * (1024 * 1024 * 1024 // 4 // 3)


def _check_pixels(width: int, height: int, name: str) -> None:
    if width * height > MAX_PIXELS:
        raise ValueError(f"{name}: {width}x{height} is more pixels than PIL opens "
                         f"({MAX_PIXELS})")


# ---- JPEG: JpegImagePlugin's walk over the markers ------------------------------------

# The markers JpegImagePlugin knows, by what its handler reads: a segment it
# skips, an APPn, a DQT, a SOF (DHP too), or nothing (no segment).
_JPEG_SOF = set(range(0xC0, 0xD0)) - {0xC4, 0xC8, 0xCC} | {0xDE}
_JPEG_SEGMENT = {0xC4, 0xCC, 0xDA, 0xDC, 0xDD, 0xDF, 0xFE} | set(range(0xE0, 0xF0))
_JPEG_BARE = set(range(0xD0, 0xDA)) | set(range(0xF0, 0xFE)) | {0xC8}


def _jpeg_walk(blob: bytes, name: str) -> None:
    """JpegImageFile._open and Image.open's checks, which PIL runs in Python
    before libjpeg sees the file: FF D8 FF, then marker by marker up to SOS
    (junk between markers skipped, an unknown marker refused, each segment
    read by its length and refused when the file ends inside it; a SOF of 8
    bits and 1, 3 or 4 components; whole DQT tables; JFIF, Adobe and ICC
    fields where PIL reads them), a nonzero size and no more pixels than PIL
    opens. Raises `ValueError` where PIL raises."""
    def refuse(why: str):
        raise ValueError(f"{name}: {why} (PIL's JPEG reader refuses it)")

    if blob[:3] != b"\xff\xd8\xff":
        refuse("not a JPEG file: it starts FF D8 but not FF D8 FF")
    pos, byte, size, mode, icc = 3, 0xFF, None, None, []

    def segment() -> bytes:  # n = i16(read(2)) - 2; _safe_read(n)
        nonlocal pos
        if pos + 2 > len(blob):
            refuse("truncated JPEG (a segment without its length)")
        n = (blob[pos] << 8 | blob[pos + 1]) - 2
        pos += 2
        if n <= 0:
            return b""
        if pos + n > len(blob):
            refuse("truncated JPEG (a segment past the end of the file)")
        pos += n
        return blob[pos - n:pos]

    while True:
        if byte != 0xFF:  # junk between markers
            if pos >= len(blob):
                refuse("truncated JPEG (no SOS)")
            byte, pos = blob[pos], pos + 1
            continue
        if pos >= len(blob):
            refuse("truncated JPEG (no SOS)")
        marker, pos = blob[pos], pos + 1
        if marker in (0x00, 0xFF):  # an escaped FF, or fill: move on
            byte = 0xFF if marker == 0xFF else -1
            continue
        if marker in _JPEG_SOF:
            s = segment()
            if len(s) < 5:
                refuse(f"short SOF segment (marker 0xFF{marker:02X})")
            size = (s[3] << 8 | s[4], s[1] << 8 | s[2])
            if s[0] != 8:
                refuse(f"{s[0]}-bit samples")
            if len(s) < 6 or s[5] not in (1, 3, 4):
                refuse(f"{s[5] if len(s) > 5 else 0}-component image")
            mode = s[5]
            if icc and len(min(icc)) < 14:  # icclist.sort(); icclist[0][13]
                refuse("a short ICC_PROFILE APP2 segment")
            icc = []
            if (len(s) - 6) % 3:  # the last component's 3 bytes cut short
                refuse(f"short SOF segment (marker 0xFF{marker:02X})")
        elif marker == 0xDB:
            s = segment()
            while s:
                length = 1 + (64 if s[0] < 16 else 128)
                if len(s) < length:
                    refuse("bad quantization table marker")
                s = s[length:]
        elif 0xE0 <= marker <= 0xEF:
            s = segment()
            if marker in (0xE0, 0xEE) and s.startswith(b"JFIF" if marker == 0xE0 else b"Adobe") \
                    and len(s) < 7:
                refuse(f"a short {'JFIF APP0' if marker == 0xE0 else 'Adobe APP14'} segment")
            if marker == 0xE2 and s.startswith(b"ICC_PROFILE\0"):
                icc.append(s)
            if marker == 0xED and s.startswith(b"Photoshop 3.0\0"):
                _photoshop_walk(s, refuse)
        elif marker in _JPEG_SEGMENT:
            segment()
            if marker == 0xDA:
                break
        elif marker not in _JPEG_BARE:
            refuse(f"no marker found (0xFF{marker:02X})")
        if pos >= len(blob):
            refuse("truncated JPEG (no SOS)")
        byte, pos = blob[pos], pos + 1
    if mode is None or size[0] <= 0 or size[1] <= 0:
        refuse("no frame of a nonzero size before SOS")
    _check_pixels(size[0], size[1], name)


def _photoshop_walk(s: bytes, refuse) -> None:
    """The APP13 handler's walk over "8BIM" resources: a struct.error stops
    it, but a record cut short before its name length is an IndexError PIL
    does not catch."""
    offset = 14
    while s[offset:offset + 4] == b"8BIM":
        offset += 4
        if offset + 2 > len(s):
            return
        code = struct.unpack_from(">H", s, offset)[0]
        offset += 2
        if offset >= len(s):
            refuse("a Photoshop APP13 resource cut short")
        offset += 1 + s[offset]
        offset += offset & 1
        if offset + 4 > len(s):
            return
        size = struct.unpack_from(">I", s, offset)[0]
        offset += 4
        if code == 0x03ED and len(s[offset:offset + size]) < 14:  # ResolutionInfo
            return
        offset += size
        offset += offset & 1


# ---- BMP: Pillow's BmpImagePlugin ----------------------------------------------------

_BIT2MODE = {1: ("P", "P;1"), 4: ("P", "P;4"), 8: ("P", "P"), 16: ("RGB", "BGR;15"),
             24: ("RGB", "BGR"), 32: ("RGB", "BGRX")}
_MASK_MODES = {
    (32, (0xFF0000, 0xFF00, 0xFF, 0x0)): "BGRX",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0x0)): "XBGR",
    (32, (0xFF000000, 0xFF00, 0xFF, 0x0)): "BGXR",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)): "ABGR",
    (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)): "RGBA",
    (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)): "BGRA",
    (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)): "BGAR",
    (32, (0x0, 0x0, 0x0, 0x0)): "BGRA",
    (24, (0xFF0000, 0xFF00, 0xFF)): "BGR",
    (16, (0xF800, 0x7E0, 0x1F)): "BGR;16",
    (16, (0x7C00, 0x3E0, 0x1F)): "BGR;15",
}
_RAW_BITS = {"1": 1, "P;1": 1, "P;4": 4, "P": 8, "L": 8, "BGR;15": 16, "BGR;16": 16, "BGR": 24}
# 32-bit raw modes: the byte of each of R, G, B (and A) in a pixel.
_BYTE_ORDER = {"BGRX": (2, 1, 0), "XBGR": (3, 2, 1), "BGXR": (3, 1, 0), "ABGR": (3, 2, 1, 0),
               "RGBA": (0, 1, 2, 3), "BGRA": (2, 1, 0, 3), "BGAR": (3, 1, 0, 2)}


def _u16(b: bytes, o: int) -> int:
    return struct.unpack_from("<H", b, o)[0]


def _u32(b: bytes, o: int) -> int:
    return struct.unpack_from("<I", b, o)[0]


def _bmp_layout(blob: bytes, name: str) -> Dict:
    """The header as BmpImageFile._bitmap reads it: size, mode, raw mode,
    decoder and where the pixels start."""
    if len(blob) < 18:
        raise ValueError(f"{name}: truncated BMP header")
    offset, header_size = _u32(blob, 10), _u32(blob, 14)
    hd = blob[18:14 + header_size]
    if len(hd) < header_size - 4:
        raise ValueError(f"{name}: truncated BMP header")
    info = {"direction": -1}
    if header_size == 12:
        info.update(width=_u16(hd, 0), height=_u16(hd, 2), bits=_u16(hd, 6), compression=0,
                    padding=3, colors=0)
    elif header_size in (40, 52, 56, 64, 108, 124):
        flip = hd[7] == 0xFF
        info.update(direction=1 if flip else -1, width=_u32(hd, 0),
                    height=2 ** 32 - _u32(hd, 4) if flip else _u32(hd, 4), bits=_u16(hd, 10),
                    compression=_u32(hd, 12), colors=_u32(hd, 28), padding=4)
        if info["compression"] == 3:
            if len(hd) >= 48:
                masks = [_u32(hd, 36 + 4 * i) for i in range(4 if len(hd) >= 52 else 3)]
            else:
                masks = [_u32(blob, 14 + header_size + 4 * i) for i in range(3)]
            masks += [0] * (4 - len(masks))
            info["rgba_mask"] = tuple(masks)
    else:
        raise ValueError(f"{name}: unsupported BMP header type ({header_size})")
    bits = info["bits"]
    colors = info["colors"] or (1 << bits)
    if offset == 14 + header_size and bits <= 8:
        offset += 4 * colors
    if bits not in _BIT2MODE:
        raise ValueError(f"{name}: unsupported BMP pixel depth ({bits})")
    mode, raw_mode = _BIT2MODE[bits]
    decoder = "raw"
    compression = info["compression"]
    if compression == 3:
        key = info["rgba_mask"] if bits == 32 else info["rgba_mask"][:3]
        if (bits, key) not in _MASK_MODES:
            raise ValueError(f"{name}: unsupported BMP bitfields layout")
        raw_mode = _MASK_MODES[(bits, key)]
        if bits == 32 and "A" in raw_mode:
            mode = "RGBA"
    elif compression in (1, 2):
        decoder = "rle"
    elif compression != 0:
        raise ValueError(f"{name}: unsupported BMP compression ({compression})")
    if mode == "P":
        if not 0 < colors <= 65536:
            raise ValueError(f"{name}: unsupported BMP palette size ({colors})")
        pad = info["padding"]
        palette = blob[14 + header_size:14 + header_size + pad * colors]
        greys = (0, 255) if colors == 2 else range(colors)
        if all(palette[i * pad:i * pad + 3] == bytes([v]) * 3 for i, v in enumerate(greys)):
            mode = "1" if colors == 2 else "L"
            raw_mode = mode
    info.update(mode=mode, raw_mode=raw_mode, decoder=decoder, offset=offset)
    return info


def _bmp_pixels(rows: np.ndarray, raw_mode: str, w: int) -> np.ndarray:
    """Rows of raw bytes [h, >= row bytes] -> PIL's array for the raw mode."""
    from wast3d_tpu_torch import native

    bits = _RAW_BITS.get(raw_mode, 32)
    if bits < 8:
        v = native.unpack_bits(rows, w, bits)
        return (v * np.uint8(255)).view(bool) if raw_mode == "1" else v  # bytes 0 / 255
    if bits == 8:
        return np.ascontiguousarray(rows[:, :w])
    if bits == 16:
        v = rows[:, :2 * w].reshape(rows.shape[0], w, 2).astype(np.uint16)
        v = v[..., 0] | (v[..., 1] << 8)
        if raw_mode == "BGR;16":
            parts = ((v >> 11) & 31, 31), ((v >> 5) & 63, 63), (v & 31, 31)
        else:
            parts = ((v >> 10) & 31, 31), ((v >> 5) & 31, 31), (v & 31, 31)
        return np.stack([(p.astype(np.int32) * 255 // m) for p, m in parts], -1).astype(np.uint8)
    if bits == 24:
        return np.ascontiguousarray(rows[:, :3 * w].reshape(-1, w, 3)[..., ::-1])
    return np.ascontiguousarray(rows[:, :4 * w].reshape(-1, w, 4)[..., list(_BYTE_ORDER[raw_mode])])


def decode_bmp(blob: bytes, name: str = "<bytes>") -> np.ndarray:
    """BMP bytes -> `np.asarray(PIL.Image.open(...))` (module docstring)."""
    from wast3d_tpu_torch import native

    info = _bmp_layout(blob, name)
    w, h, mode, raw_mode = info["width"], info["height"], info["mode"], info["raw_mode"]
    if w < 1 or h < 1:
        raise ValueError(f"{name}: BMP of size {w}x{h}")
    if info["decoder"] == "rle":
        if mode not in ("P", "L"):  # Pillow's raw modes for runs are "P" and "L" only
            raise ValueError(f"{name}: run-length BMP of mode {mode}")
        rows = native.bmp_rle(blob, info["offset"], w, h, info["compression"] == 2, name)
    else:
        stride = ((w * info["bits"] + 31) >> 3) & ~3
        need = (w * _RAW_BITS.get(raw_mode, 32) + 7) // 8
        if need > stride:
            raise ValueError(f"{name}: BMP rows of {stride} bytes hold no {raw_mode} row of "
                             f"{w} pixels")
        data = blob[info["offset"]:info["offset"] + h * stride]
        if len(data) < (h - 1) * stride + need:
            raise ValueError(f"{name}: image file is truncated")
        data = np.frombuffer(data.ljust(h * stride, b"\x00"), np.uint8).reshape(h, stride)
        rows = _bmp_pixels(data, raw_mode, w)
    return np.ascontiguousarray(rows[::-1]) if info["direction"] == -1 else rows


def bmp_rle_reference(blob: bytes, start: int, width: int, height: int,
                      rle4: bool) -> np.ndarray:
    """Plain version of `native.bmp_rle` (Pillow's BmpRleDecoder, in
    Python)."""
    data, x, pos, total = bytearray(), 0, start, width * height
    while len(data) < total:
        if pos + 2 > len(blob):
            break
        count, byte = blob[pos], blob[pos + 1]
        pos += 2
        if count:
            count = min(count, max(0, width - x))
            if rle4:
                data += bytes((byte >> 4) if i % 2 == 0 else (byte & 15) for i in range(count))
            else:
                data += bytes([byte]) * count
            x += count
        elif byte == 0:
            data += b"\x00" * (-len(data) % width)
            x = 0
        elif byte == 1:
            break
        elif byte == 2:
            if pos + 4 > len(blob):
                break
            right, up = blob[pos + 2], blob[pos + 3]
            pos += 4
            data += b"\x00" * (right + up * width)
            x = len(data) % width
        else:
            want = byte // 2 if rle4 else byte
            got = blob[pos:pos + want]
            pos += len(got)
            data += bytes(v for b in got for v in (b >> 4, b & 15)) if rle4 else got
            if len(got) < want:
                break
            x += byte
            pos += pos % 2
    if len(data) < total:
        raise ValueError(f"not enough image data (RLE gives {len(data)} of {total} pixels)")
    return np.frombuffer(bytes(data[:total]), np.uint8).reshape(height, width)


# ---- TIFF: Pillow's TiffImagePlugin, over libtiff for compressed files --------------

# Pillow's OPEN_INFO for the kinds read here: (byte order or None for both,
# photometric, sample format, fill order, bits per sample, extra samples) ->
# (mode, raw mode). A fill order 2 raw mode ends in "R" (bits reversed).
_TIFF_INFO = {}
for (_p, _b), (_m, _r) in {
        (0, 1): ("1", "1;I"), (1, 1): ("1", "1"), (0, 2): ("L", "L;2I"), (1, 2): ("L", "L;2"),
        (0, 4): ("L", "L;4I"), (1, 4): ("L", "L;4"), (0, 8): ("L", "L;I"), (1, 8): ("L", "L"),
        (3, 1): ("P", "P;1"), (3, 2): ("P", "P;2"), (3, 4): ("P", "P;4"),
        (3, 8): ("P", "P")}.items():
    _TIFF_INFO[(None, _p, (1,), 1, (_b,), ())] = (_m, _r)
    _TIFF_INFO[(None, _p, (1,), 2, (_b,), ())] = (_m, _r + ("R" if ";" in _r else ";R"))
_TIFF_INFO[("<", 1, (1,), 2, (16,), ())] = ("I;16", "I;16R")
_TIFF_INFO[(None, 2, (1,), 2, (8, 8, 8), ())] = ("RGB", "RGB;R")
for _k, _v in {
        (None, 1, (2,), (8,), ()): ("L", "L"),
        ("<", 0, (1,), (16,), ()): ("I;16", "I;16"), ("<", 1, (1,), (16,), ()): ("I;16", "I;16"),
        (">", 1, (1,), (16,), ()): ("I;16B", "I;16B"),
        ("<", 1, (2,), (16,), ()): ("I", "I;16S"), (">", 1, (2,), (16,), ()): ("I", "I;16BS"),
        ("<", 0, (3,), (32,), ()): ("F", "F;32F"), (">", 0, (3,), (32,), ()): ("F", "F;32BF"),
        ("<", 1, (1,), (32,), ()): ("I", "I;32N"),
        ("<", 1, (2,), (32,), ()): ("I", "I;32S"), (">", 1, (2,), (32,), ()): ("I", "I;32BS"),
        ("<", 1, (3,), (32,), ()): ("F", "F;32F"), (">", 1, (3,), (32,), ()): ("F", "F;32BF"),
        (None, 1, (1,), (8, 8), (2,)): ("LA", "LA"),
        (None, 2, (1,), (8, 8, 8), ()): ("RGB", "RGB"),
        (None, 2, (1,), (8, 8, 8, 8), ()): ("RGBA", "RGBA"),
        (None, 2, (1,), (8, 8, 8, 8), (0,)): ("RGB", "RGBX"),
        (None, 2, (1,), (8,) * 5, (0, 0)): ("RGB", "RGBXX"),
        (None, 2, (1,), (8,) * 6, (0, 0, 0)): ("RGB", "RGBXXX"),
        (None, 2, (1,), (8, 8, 8, 8), (1,)): ("RGBA", "RGBa"),
        (None, 2, (1,), (8,) * 5, (1, 0)): ("RGBA", "RGBaX"),
        (None, 2, (1,), (8,) * 6, (1, 0, 0)): ("RGBA", "RGBaXX"),
        (None, 2, (1,), (8, 8, 8, 8), (2,)): ("RGBA", "RGBA"),
        (None, 2, (1,), (8,) * 5, (2, 0)): ("RGBA", "RGBAX"),
        (None, 2, (1,), (8,) * 6, (2, 0, 0)): ("RGBA", "RGBAXX"),
        (None, 2, (1,), (8, 8, 8, 8), (999,)): ("RGBA", "RGBA"),
        (None, 2, (1,), (16, 16, 16), ()): ("RGB", "RGB;16"),
        (None, 2, (1,), (16,) * 4, ()): ("RGBA", "RGBA;16"),
        (None, 2, (1,), (16,) * 4, (0,)): ("RGB", "RGBX;16"),
        (None, 2, (1,), (16,) * 4, (1,)): ("RGBA", "RGBa;16"),
        (None, 2, (1,), (16,) * 4, (2,)): ("RGBA", "RGBA;16"),
        (None, 3, (1,), (8, 8), (0,)): ("P", "PX"),
        (None, 3, (1,), (8, 8), (2,)): ("PA", "PA"),
        (None, 5, (1,), (8, 8, 8, 8), ()): ("CMYK", "CMYK"),
        (None, 5, (1,), (8,) * 5, (0,)): ("CMYK", "CMYKX"),
        (None, 5, (1,), (8,) * 6, (0, 0)): ("CMYK", "CMYKXX"),
        (None, 5, (1,), (16,) * 4, ()): ("CMYK", "CMYK;16"),
        (None, 6, (1,), (8, 8, 8), ()): ("RGB", "RGBX"), (None, 6, (1,), (8,), ()): ("L", "L"),
        (None, 8, (1,), (8, 8, 8), ()): ("LAB", "LAB"),
        ("<", 1, (1,), (12,), ()): ("I;16", "I;12")}.items():
    _TIFF_INFO[_k[:3] + (1,) + _k[3:]] = _v
_TAG_NAMES = {256: "ImageWidth", 257: "ImageLength", 258: "BitsPerSample", 259: "Compression",
              262: "PhotometricInterpretation", 266: "FillOrder", 273: "StripOffsets",
              277: "SamplesPerPixel", 278: "RowsPerStrip", 279: "StripByteCounts",
              284: "PlanarConfiguration", 317: "Predictor", 322: "TileWidth",
              323: "TileLength", 324: "TileOffsets", 325: "TileByteCounts",
              338: "ExtraSamples", 339: "SampleFormat", 347: "JPEGTables",
              530: "YCbCrSubsampling", 274: "Orientation", 320: "ColorMap", 292: "T4Options",
              293: "T6Options", 529: "YCbCrCoefficients", 532: "ReferenceBlackWhite",
              512: "JPEGProc", 513: "JPEGInterchangeFormat",
              514: "JPEGInterchangeFormatLength", 515: "JPEGRestartInterval",
              519: "JPEGQTables", 520: "JPEGDCTables", 521: "JPEGACTables"}
_RATIONAL_TAGS = (529, 532)
# The tags whose unreadable entry fails libtiff's directory: ImageWidth,
# ImageLength, BitsPerSample, Compression, SamplesPerPixel,
# PlanarConfiguration, TileWidth, TileLength.
_CORE_TAGS = (256, 257, 258, 259, 277, 284, 322, 323)
# Bits per pixel of each raw mode (Pillow's unpackers); a one-letter raw mode
# is one band of a separate-planes file read without libtiff.
_RAW_MODE_BITS = {"1": 1, "1;I": 1, "L;2": 2, "L;2I": 2, "L;4": 4, "L;4I": 4, "L": 8, "L;I": 8,
                  "P;1": 1, "P;2": 2, "P;4": 4, "P": 8, "PX": 16, "PA": 16, "LA": 16,
                  "I;16": 16, "I;16N": 16, "I;16B": 16, "I;16S": 16, "I;16BS": 16,
                  "I;32N": 32, "I;32S": 32, "I;32BS": 32, "I": 32, "F;32F": 32, "F;32BF": 32,
                  "F": 32, "RGB": 24, "RGBX": 32, "RGBXX": 40, "RGBXXX": 48, "RGBA": 32,
                  "RGBa": 32, "RGBAX": 40, "RGBaX": 40, "RGBAXX": 48, "RGBaXX": 48,
                  "CMYK": 32, "CMYKX": 40, "CMYKXX": 48, "LAB": 24, "I;12": 12}
_RAW_MODE_BITS.update(dict.fromkeys("RGBACMYK", 8))
for _m, _n in (("RGB", 48), ("RGBX", 64), ("RGBA", 64), ("RGBa", 64), ("CMYK", 64)):
    for _e in "LBN":
        _RAW_MODE_BITS[f"{_m};16{_e}"] = _n
_BIT_REVERSED = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)
_BANDS = {"1": "1", "L": "L", "P": "P", "I": "I", "F": "F", "RGB": "RGB", "RGBA": "RGBA",
          "CMYK": "CMYK", "LAB": "LAB"}  # the one-letter raw modes each mode takes
_ORIENT = {2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1], 4: lambda a: a[::-1],
           5: lambda a: a.swapaxes(0, 1), 6: lambda a: a[::-1].swapaxes(0, 1),
           7: lambda a: a[::-1, ::-1].swapaxes(0, 1), 8: lambda a: a[:, ::-1].swapaxes(0, 1)}


class _Skipped(NamedTuple):
    """A directory entry `_tiff_tags` leaves out, and why."""
    tag: int
    past_end: bool  # its values run past the end of the file (else: a type not read here)
    why: str
    values: tuple = ()  # what libtiff reads of it: an integer entry of another width or
    # sign, or of StripOffsets and StripByteCounts the values inside the file
    typ: int = 0


# The integer types libtiff reads a number from, whatever the tag's own type.
_INTEGER_TYPES = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 16: "Q", 17: "q"}


def _tiff_tags(blob: bytes, name: str) -> Tuple[str, Dict[int, tuple], list]:
    """The first directory's entries for the tags read here: SHORT or LONG
    values (BigTIFF: LONG8 too; JPEGTables: UNDEFINED bytes;
    YCbCrCoefficients and ReferenceBlackWhite: RATIONAL, as (numerator,
    denominator) pairs; JPEGInterchangeFormat / Length, which only libtiff
    reads: any 8-32-bit integer). Such a tag twice is refused (PIL keeps
    the last of two entries where libtiff keeps the first), and so is an
    XMP (700) that is not bytes (Pillow fails on it). A BigTIFF (version
    43) has 8-byte offsets and counts and 20-byte entries; PIL reads it
    only little-endian (a big-endian one it takes for a classic TIFF and
    fails on). An entry of another type (PIL reads bytes, text and
    fractions where it wants integers; libtiff refuses the types it does
    not expect), or whose values lie past the end of the file, is left out
    and listed (`_Skipped`) in the third value returned, for the caller to
    raise or not (for an old-style JPEG file libtiff reads integers of any
    width and sign, and passes over the rest; it reads no more of
    StripOffsets and StripByteCounts than one value a strip)."""
    bo = "<" if blob[:2] == b"II" else ">"
    if len(blob) < 8:
        raise ValueError(f"{name}: TIFF header truncated")
    big = blob[2:4] in (b"+\x00", b"\x00+")
    if big and bo == ">":
        raise ValueError(f"{name}: big-endian BigTIFF, which PIL does not read (it takes it for a "
                         "classic TIFF)")
    if big and (len(blob) < 16 or struct.unpack_from("<HH", blob, 4) != (8, 0)):
        raise ValueError(f"{name}: BigTIFF header without 8-byte offsets")
    ofs, cnt, entry, word = ("Q", "Q", 20, 8) if big else ("I", "H", 12, 4)
    (ifd,) = struct.unpack_from(bo + ofs, blob, 8 if big else 4)
    head = struct.calcsize(cnt)
    if ifd + head > len(blob):
        raise ValueError(f"{name}: TIFF directory past the end of the file")
    (n,) = struct.unpack_from(bo + cnt, blob, ifd)
    if ifd + head + entry * n > len(blob):
        raise ValueError(f"{name}: TIFF directory past the end of the file")
    tags, skipped = {}, []
    for i in range(n):
        at = ifd + head + entry * i
        tag, typ, count = struct.unpack_from(bo + "HH" + ofs, blob, at)
        if tag == 700 and 1 < typ <= 18 and typ != 7:  # Pillow reads XMP as bytes only
            raise ValueError(f"{name}: TIFF XMP (tag 700) of type {typ}, which Pillow fails on")
        if tag not in _TAG_NAMES:
            continue
        what = f"{name}: TIFF {_TAG_NAMES[tag]} (tag {tag})"
        allowed = ((7,) if tag == 347 else (5,) if tag in _RATIONAL_TAGS else
                   (1, 3, 4, 6, 8, 9) if tag in (513, 514) else (3, 4))
        # UNDEFINED; RATIONAL; SHORT, LONG (or LONG8); only libtiff reads 513
        # and 514, and it takes any 8-32-bit integer
        fmt = (None if typ not in allowed + ((16,) if big and tag not in _RATIONAL_TAGS + (347,)
                                             else ())
               else {5: "II", 7: "B"}.get(typ) or _INTEGER_TYPES[typ])
        odd = fmt is None and _INTEGER_TYPES.get(typ)
        if fmt is None and not odd:
            skipped.append(_Skipped(tag, False, f"{what} of type {typ} is not supported"))
            continue
        if tag in tags:
            raise ValueError(f"{what} twice")
        size = struct.calcsize(fmt or odd) * count
        at += 4 + word
        if size > word:
            (at,) = struct.unpack_from(bo + ofs, blob, at)
        if odd:
            values = (struct.unpack_from(bo + odd * count, blob, at)
                      if at + size <= len(blob) else ())
            skipped.append(_Skipped(tag, False, f"{what} of type {typ} is not supported",
                                    values, typ))
            continue
        if at + size > len(blob):
            fit = max(len(blob) - at, 0) // struct.calcsize(fmt) if tag in (273, 279) else 0
            skipped.append(_Skipped(tag, True, f"{what} past the end of the file",
                                    struct.unpack_from(bo + fmt * fit, blob, at) if fit else ()))
            continue
        tags[tag] = (blob[at:at + size] if typ == 7
                     else struct.unpack_from(bo + fmt * count, blob, at))
    return bo, tags, skipped


def _refuse(name: str, tag: int, value, why: str = "is not supported") -> None:
    raise ValueError(f"{name}: TIFF {_TAG_NAMES.get(tag, tag)} (tag {tag}) = {value} {why}")


def _one(tags: Dict, tag: int, default=None):
    v = tags.get(tag)
    return default if v is None else v[0] if len(v) == 1 else v


def _tiff_strip(data: bytes, compression: int, size: int, name: str,
                ccitt: Tuple[int, int, int] = (0, 0, 0)) -> np.ndarray:
    """One strip or tile decompressed to at least `size` bytes; CCITT takes
    (width, rows, T4Options)."""
    from wast3d_tpu_torch import native

    if compression == 1:
        out = np.frombuffer(data[:size], np.uint8)
    elif compression in (2, 3, 4):
        out = native.ccitt_decode(data, compression, ccitt[2], ccitt[0], ccitt[1], name).reshape(-1)
    elif compression == 34925:  # libtiff's LZMA codec: an .xz stream
        try:
            out = np.frombuffer(lzma.LZMADecompressor(lzma.FORMAT_XZ).decompress(data, size),
                                np.uint8)
        except lzma.LZMAError as e:
            raise ValueError(f"{name}: bad LZMA data in a TIFF strip ({e})") from None
    elif compression == 32773:
        out = native.packbits_decode(data, size, name)
    elif compression == 5:
        out = native.lzw_decode(data, size, name)
    elif compression == 50000:  # libtiff's ZSTD codec: Zstandard frames
        out = native.zstd_decode(data, size, name)
    else:  # 8, 32946: Deflate
        try:
            out = np.frombuffer(zlib.decompressobj().decompress(data, size), np.uint8)
        except zlib.error as e:
            raise ValueError(f"{name}: bad Deflate data in a TIFF strip ({e})") from None
    if out.size < size:
        raise ValueError(f"{name}: TIFF strip decodes to {out.size} of {size} bytes")
    return out


def _tiff_setup(blob: bytes, name: str) -> Dict:
    """TiffImageFile._setup: the tags PIL reads, its mode and raw mode."""
    bo, tags, skipped = _tiff_tags(blob, name)
    t = dict(bo=bo, tags=tags, skipped=skipped)
    compression = _one(tags, 259)
    if compression is None:  # none, or of another integer type (libtiff reads it)
        compression = next((s.values[0] for s in skipped if s.tag == 259 and s.values), 1)
    if compression == 6:  # libtiff reads integers of any width and sign: not past 32 bits
        # (but strip arrays), nor bytes in a tag Pillow reads itself
        tags.update((s.tag, s.values) for s in skipped if not s.past_end and s.values
                    and min(s.values) >= 0 and (s.tag in (273, 279) or max(s.values) < 2 ** 32)
                    and not (s.typ == 1 and s.tag in _CORE_TAGS))
    # libtiff's directory fails on a core tag left out, and on strip offsets
    # or counts of an unknown type; only its old-style JPEG codec reads on
    # past the other entries skipped (but RowsPerStrip's: Pillow fails).
    core = [s.why for s in skipped if s.tag not in tags and (
        s.tag in _CORE_TAGS + (278,) or s.tag in (273, 279) and not s.past_end)]
    if core or skipped and compression != 6:
        raise ValueError((core or [s.why for s in skipped])[0])
    if compression not in (1, 2, 3, 4, 5, 6, 7, 8, 32773, 32946, 34925, 50000):
        _refuse(name, 259, compression)
    planar = _one(tags, 284, 1)
    if planar not in (1, 2):
        _refuse(name, 284, planar)
    # Pillow takes an old-style JPEG file (6) for YCbCr whatever its tag says
    # (libtiff goes by the tag), and three samples a pixel by default.
    photo = 6 if compression == 6 else _one(tags, 262, 0)
    fill = _one(tags, 266, 1)
    w, h = _one(tags, 256), _one(tags, 257)
    if not isinstance(w, int) or not isinstance(h, int):
        raise ValueError(f"{name}: TIFF without one ImageWidth (tag 256) and ImageLength "
                         "(tag 257)")
    sf = tags.get(339, (1,))
    if len(sf) > 1 and max(sf) == min(sf) == 1:
        sf = (1,)
    bps, extra = tags.get(258, (1,)), tags.get(338, ())
    bps_count = (3 if photo in (2, 6, 8) else 4 if photo == 5 else 1) + len(extra)
    spp = _one(tags, 277, 3 if compression == 6 else 1)
    if not isinstance(spp, int) or spp > 6:
        _refuse(name, 277, spp)
    if spp < len(bps):
        bps = bps[:spp]
    elif spp > len(bps) == 1:
        bps = bps * spp
    if len(bps) != spp:
        _refuse(name, 258, bps, f"for {spp} samples per pixel is not supported")
    key = (photo, sf, fill, tuple(bps), tuple(extra))
    info = _TIFF_INFO.get((bo,) + key) or _TIFF_INFO.get((None,) + key)
    if info is None:  # name the tag that takes the file out of PIL's table
        def known(**kw):
            k = dict(photo=photo, sf=sf, fill=fill)
            k.update(kw)
            k = (k["photo"], k["sf"], k["fill"], tuple(bps), tuple(extra))
            return (bo,) + k in _TIFF_INFO or (None,) + k in _TIFF_INFO
        if sf != (1,) and known(sf=(1,)):
            _refuse(name, 339, sf[0] if len(sf) == 1 else sf)
        if fill != 1 and known(fill=1):
            _refuse(name, 266, fill)
        if not any(k[1] == photo for k in _TIFF_INFO):
            _refuse(name, 262, photo)
        _refuse(name, 258, f"{tuple(bps)} (SampleFormat {sf}, ExtraSamples {tuple(extra)})")
    mode, raw_mode = info
    if mode in ("P", "PA") and (not tags.get(320) or compression != 1 and bps[0] < 8 and len(
            tags[320]) != 3 << bps[0]):  # libtiff ignores a ColorMap of the wrong length
        raise ValueError(f"{name}: palette TIFF without a ColorMap (tag 320) of "
                         f"{3 << bps[0]} entries")
    if compression in (2, 3, 4) and bps != (1,):  # libtiff's Fax3SetupState
        _refuse(name, 259, compression, f"with {spp} samples of {bps[0]} bits is not something "
                "PIL reads (libtiff: CCITT takes one bit a pixel)")
    ycbcr = None
    if photo == 6 and compression == 7 and planar != 1:
        _refuse(name, 262, f"6 (YCbCr) with Compression 7, PlanarConfiguration {planar}",
                "is not supported; JPEG YCbCr is read in one plane")
    if photo == 6 and compression not in (1, 6, 7):  # Pillow reads it through TIFFRGBAImage
        sub = tuple(tags.get(530, (2, 2))[:2])
        if bps != (8, 8, 8):
            _refuse(name, 258, bps, "of YCbCr is not something PIL reads (libtiff's RGBA "
                    "reader takes three 8-bit samples)")
        if sub not in _YCBCR_UNITS if planar == 1 else sub != (1, 1):
            _refuse(name, 530, sub, "is not something PIL reads (libtiff's RGBA reader takes "
                    + ("1x1, 1x2, 2x1, 2x2, 4x1, 4x2 and 4x4" if planar == 1
                       else "1x1 in separate planes") + ")")
        ycbcr = sub, ycbcr_tables(_rationals(tags.get(529), (0.299, 0.587, 0.114)),
                                  _rationals(tags.get(532), (0, 255, 128, 255, 128, 255)), name)
    if compression != 1:  # Pillow hands the file to libtiff
        if fill == 2:
            mode, raw_mode = (_TIFF_INFO.get((bo,) + key[:2] + (1,) + key[3:])
                              or _TIFF_INFO[(None,) + key[:2] + (1,) + key[3:]])
        if photo == 6 and compression == 7:
            raw_mode = "RGB"
        elif raw_mode in ("I;16", "I;16B"):
            raw_mode = "I;16N"
        elif raw_mode.endswith(";16"):
            raw_mode += "N"
    elif raw_mode.endswith(";16") and raw_mode != "I;16":
        raw_mode += "L" if bo == "<" else "B"
    t.update(compression=compression, planar=planar, photo=photo, fill=fill, w=w, h=h,
             bps=tuple(bps), spp=spp, bps_count=bps_count, mode=mode, raw_mode=raw_mode,
             orientation=_one(tags, 274, 1), ycbcr=ycbcr)
    return t


# The subsamplings tif_getimage.c has a chunky YCbCr routine for.
_YCBCR_UNITS = ((1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4))


def _rationals(v, default) -> np.ndarray:
    """A RATIONAL tag's values as libtiff's float array (float32 of each
    quotient), or libtiff's default."""
    if v is None:
        return np.array(default, np.float32)
    num, den = np.array(v[0::2], np.float64), np.array(v[1::2], np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(num == 0, 0.0, num / den).astype(np.float32)


def ycbcr_tables(luma: np.ndarray, refbw: np.ndarray, name: str = "<bytes>") -> np.ndarray:
    """libtiff's TIFFYCbCrToRGBInit in its float32 arithmetic: int32 [5, 256]
    Y_tab, Cr_r_tab, Cb_b_tab, Cr_g_tab, Cb_g_tab for YCbCrCoefficients
    `luma` and ReferenceBlackWhite `refbw` (float32)."""
    f = np.float32
    luma, refbw = np.asarray(luma, f), np.asarray(refbw, f)
    if len(luma) < 3 or len(refbw) < 6 or np.isnan(luma).any() or luma[1] == 0 or np.isnan(
            refbw).any():
        raise ValueError(f"{name}: TIFF YCbCrCoefficients (tag 529) or ReferenceBlackWhite "
                         "(tag 532) that libtiff refuses")

    def fix(x):  # (int32)(x * (1L << 16) + 0.5): the product in float, the sum in double
        return int(float(f(x) * f(65536)) + 0.5)

    def clamp(x, lo, hi):
        return lo if x < lo else hi if x > hi else x

    lr, lg, lb = luma[0], luma[1], luma[2]
    f1 = f(2) - f(2) * lr
    f2 = f(lr * f1) / lg
    f3 = f(2) - f(2) * lb
    f4 = f(lb * f3) / lg
    d1, d2 = fix(clamp(f1, f(0), f(2))), -fix(clamp(f2, f(0), f(2)))
    d3, d4 = fix(clamp(f3, f(0), f(2))), -fix(clamp(f4, f(0), f(2)))

    def code2v(c, rb, rw, cr):  # ((c - (int32)rb) * (float)cr) / (float)(rw - rb or 1)
        den = f(rw - rb)
        return f(f(c - int(rb)) * f(cr)) / (den if den != 0 else f(1))

    def clampw(v):
        return int(clamp(v, f(-4096), f(4096)))

    out = np.zeros((5, 256), np.int64)
    for i in range(256):
        x = i - 128
        cr = clampw(code2v(x, refbw[4] - f(128), refbw[5] - f(128), 127))
        cb = clampw(code2v(x, refbw[2] - f(128), refbw[3] - f(128), 127))
        out[:, i] = ((clampw(code2v(x + 128, refbw[0], refbw[1], 255))), (d1 * cr + 32768) >> 16,
                     (d3 * cb + 32768) >> 16, d2 * cr, d4 * cb + 32768)
    return out.astype(np.int32)


def ycbcr_to_rgb_reference(units: np.ndarray, sh: int, sv: int, width: int, rows: int,
                           tables: np.ndarray) -> np.ndarray:
    """The plain version of `native.ycbcr_to_rgb`: each pixel of a width x
    rows segment takes its luma sample and its data unit's Cb and Cr through
    TIFFYCbCrtoRGB."""
    across, unit = -(-width // sh), sh * sv + 2
    u = np.asarray(units, np.uint8)[:-(-rows // sv) * across * unit].reshape(-1, across, unit)
    y, x = np.mgrid[0:rows, 0:width]
    cell = u[y // sv, x // sh]
    lum = np.take_along_axis(cell, ((y % sv) * sh + x % sh)[..., None], -1)[..., 0]
    cb, cr = cell[..., sh * sv], cell[..., sh * sv + 1]
    t = np.asarray(tables, np.int64)
    yv = t[0][lum]
    rgb = np.stack([yv + t[1][cr], yv + ((t[4][cb] + t[3][cr]) >> 16), yv + t[2][cb]], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def _bit_order(raw_mode: str) -> Tuple[str, bool]:
    """A raw mode without its fill-order suffix, and whether it had one."""
    if len(raw_mode) > 1 and raw_mode.endswith("R"):
        return raw_mode[:-1].rstrip(";"), True
    return raw_mode, False


def _unpremultiply(v: np.ndarray) -> np.ndarray:
    """Unpack.c's unpackRGBa: RGB divided by alpha."""
    a = v[..., 3:].astype(np.int32)
    rgb = np.minimum(v[..., :3].astype(np.int32) * 255 // np.maximum(a, 1), 255)
    rgb = np.where(a == 255, v[..., :3], rgb)
    return np.where(a == 0, 0, np.concatenate([rgb, a], -1)).astype(np.uint8)


def _unpack(mode: str, raw_mode: str, rows: np.ndarray, width: int) -> np.ndarray:
    """Pillow's unpacker (mode, raw_mode) on uint8 [n, row bytes] -> [n,
    width(, bands)] in `np.asarray`'s dtype; one-letter raw modes give the
    band they name."""
    from wast3d_tpu_torch import native

    n = rows.shape[0]
    raw_mode, reverse = _bit_order(raw_mode)
    if reverse:
        rows = _BIT_REVERSED[rows]
    bits = _RAW_MODE_BITS[raw_mode]
    if bits < 8:
        v = native.unpack_bits(rows, width, bits)
        if mode == "1":  # PIL's bool array holds the bytes 0 and 255
            return ((v == 0) if raw_mode == "1;I" else (v != 0)).view(np.uint8) * np.uint8(
                255)
        if mode == "L":
            v = v * np.uint8(255 // ((1 << bits) - 1))
            return 255 - v if raw_mode.endswith("I") else v
        return v
    need = (width * bits + 7) // 8 if bits == 12 else width * bits // 8
    if rows.shape[1] < need:
        raise ValueError(f"rows of {rows.shape[1]} bytes for {width} pixels of {raw_mode}")
    r = np.ascontiguousarray(rows[:, :need])
    if len(raw_mode) == 1:  # one band of a separate-planes file
        if mode == "LAB" and raw_mode in "AB":  # Pillow's LAB band unpackers: a, b signed
            return r ^ np.uint8(128)
        if raw_mode in "LP":
            return r
        if raw_mode in "IF":
            return r.view("<i4" if raw_mode == "I" else "<f4")
        return r
    if mode in ("L", "P") and raw_mode in ("L", "L;I", "P"):
        return 255 - r if raw_mode == "L;I" else r
    if raw_mode in ("PX", "PA", "LA"):
        v = r.reshape(n, width, 2)
        return np.ascontiguousarray(v[..., 0]) if raw_mode == "PX" else v
    if raw_mode == "I;12":  # unpackI12_I16: two samples in three bytes, from the high bit
        v = r.astype(np.uint16)
        out = np.zeros((n, width + 1), np.uint16)
        a, b, c = v[:, 0::3], v[:, 1::3], v[:, 2::3]
        k = min(a.shape[1], b.shape[1])
        out[:, 0:2 * k:2] = (a[:, :k] << 4) | (b[:, :k] >> 4)
        k2 = min(b.shape[1], c.shape[1])
        out[:, 1:2 * k2:2] = ((b[:, :k2] & 15) << 8) | c[:, :k2]
        return out[:, :width].astype("<u2")
    if mode.startswith("I;16"):
        v = r.view(">u2" if raw_mode == "I;16B" else "<u2")
        return v.astype(">u2" if mode == "I;16B" else "<u2")
    if mode in ("I", "F"):
        dt = {"I;16S": "<i2", "I;16BS": ">i2", "I;32N": "<i4", "I;32S": "<i4", "I;32BS": ">i4",
              "F;32F": "<f4", "F;32BF": ">f4"}[raw_mode]
        return r.view(dt).astype(np.int32 if mode == "I" else np.float32)
    if raw_mode.endswith(("16L", "16B", "16N")):
        c = bits // 16
        v = r.view(">u2" if raw_mode.endswith("B") else "<u2").reshape(n, width, c)
        v = (v >> 8).astype(np.uint8)
        raw_mode = raw_mode[:-4]
    else:
        v = r.reshape(n, width, bits // 8)
    if raw_mode.startswith("RGBa"):
        return _unpremultiply(v[..., :4])
    return np.ascontiguousarray(v[..., :len(mode)])


def _empty(mode: str, h: int, w: int) -> np.ndarray:
    """Pillow's new image of `mode` (zeros) in `np.asarray`'s layout; mode
    "1" as uint8 0 / 255 until `decode_tiff` views it as bool."""
    shape = (h, w) if mode in ("1", "L", "P", "I", "F", "I;16", "I;16B") else (h, w, len(mode))
    return np.zeros(shape, {"I": np.int32, "F": np.float32, "I;16": "<u2",
                            "I;16B": ">u2"}.get(mode, np.uint8))


def _tiff_raw(blob: bytes, t: Dict, name: str) -> np.ndarray:
    """An uncompressed file as Pillow's own raw decoder reads it: one tile
    descriptor per strip or tile (and per plane), loaded in offset order."""
    tags, w, h = t["tags"], t["w"], t["h"]
    if 273 in tags:
        offsets, tw, th = tags[273], w, _one(tags, 278, h)
    elif 324 in tags:
        offsets, tw, th = tags[324], _one(tags, 322), _one(tags, 323)
    else:
        raise ValueError(f"{name}: TIFF without StripOffsets (tag 273) or TileOffsets (tag 324)")
    if not isinstance(tw, int) or not isinstance(th, int) or tw < 1 or th < 1:
        _refuse(name, 322 if 324 in tags else 278, (tw, th), "is not a tile size PIL reads")
    if not offsets:
        raise ValueError(f"{name}: TIFF without the offset of any strip or tile")
    planar = t["planar"]
    if tw == w and th == h and planar != 2:
        offsets = offsets[-1:]
    out = _empty(t["mode"], h, w)
    tiles, x = [], 0
    y = layer = 0
    for off in offsets:
        stride = tw * sum(t["bps"]) / 8 if x + tw > w else 0
        raw_mode = t["raw_mode"]
        if planar == 2:
            if layer >= len(raw_mode):
                raise ValueError(f"{name}: more TIFF planes than {raw_mode!r} has bands")
            raw_mode = raw_mode[layer]
            stride /= t["bps_count"]
        tiles.append((off, x, y, min(x + tw, w), min(y + th, h), raw_mode, int(stride)))
        x += tw
        if x >= w:
            x, y = 0, y + th
            if y >= h:
                y, layer = 0, layer + 1
    for off, x0, y0, x1, y1, raw_mode, stride in sorted(tiles, key=lambda d: d[0]):
        if len(raw_mode) == 1 and raw_mode not in _BANDS.get(t["mode"], ""):
            raise ValueError(f"{name}: a separate {raw_mode!r} plane of a {t['mode']} TIFF is "
                             "not something PIL reads")
        if raw_mode in ("L;IR", "P;1R", "P;2R", "P;4R"):  # no such unpacker in Pillow
            _refuse(name, 266, 2, f"uncompressed in mode {t['mode']} is not something PIL reads")
        row = (_RAW_MODE_BITS[_bit_order(raw_mode)[0]] * (x1 - x0) + 7) // 8
        stride = stride or row
        need = (y1 - y0 - 1) * stride + row
        if off + need > len(blob):
            why = (" (PhotometricInterpretation (tag 262) = 6: PIL reads uncompressed chunky "
                   "YCbCr as 4 bytes a pixel)" if t["photo"] == 6 and planar == 1 else "")
            raise ValueError(f"{name}: TIFF image data truncated (a tile at {off} needs {need} "
                             f"bytes, the file has {max(len(blob) - off, 0)}){why}")
        rows = np.lib.stride_tricks.as_strided(
            np.frombuffer(blob, np.uint8, need, off), (y1 - y0, row), (stride, 1))
        v = _unpack(t["mode"], raw_mode, rows, x1 - x0)
        if len(raw_mode) == 1 and out.ndim == 3:
            out[y0:y1, x0:x1, _BANDS[t["mode"]].index(raw_mode)] = v
        else:
            out[y0:y1, x0:x1] = v
    return out


def _tiff_jpeg(data: bytes, t: Dict, expect: list, width: int, rows: int, last: bool,
               name: str) -> np.ndarray:
    """One strip or tile of a JPEG TIFF as libtiff's JPEGPreDecode checks it
    and libjpeg decodes it: the shared JPEGTables first, the TIFF's colour
    space (YCbCr -> RGB for photometric 6, else the components as coded)."""
    from wast3d_tpu_torch import native

    tables = t["tags"].get(347)
    if tables is not None and data[:2] == b"\xff\xd8":
        if tables[:2] != b"\xff\xd8":
            _refuse(name, 347, repr(tables[:4]), "is not a JPEG stream")
        data = (tables[:-2] if tables[-2:] == b"\xff\xd9" else tables) + data[2:]
    w, h, factors = native.jpeg_frame(data, name)
    comps = t["spp"] if t["planar"] == 1 else 1
    if len(factors) != comps:
        raise ValueError(f"{name}: a JPEG strip or tile of {len(factors)} components in a TIFF "
                         f"of {comps} (libtiff: improper JPEG component count)")
    if not expect:  # YCbCrSubsampling, else (libtiff's fix-up) the first stream's own
        sub = t["tags"].get(530)
        expect.append(((tuple(sub[:2]) if sub and len(sub) >= 2 else factors[0])
                       if t["photo"] == 6 and comps == 3 else (1, 1)))
    if factors[0] != expect[0] or any(f != (1, 1) for f in factors[1:]):
        raise ValueError(f"{name}: JPEG sampling factors {factors} in a TIFF that needs "
                         f"{expect[0]} then 1x1 (libtiff: improper JPEG sampling factors)")
    if w != width or not (h == rows or (last and h > rows)):
        raise ValueError(f"{name}: a {w}x{h} JPEG stream for a {width}x{rows} TIFF strip or tile")
    out = native.decode_jpeg(data, name, colour=1 if t["photo"] == 6 else 2)
    return out[:rows].reshape(rows, -1)


def _tiff_ojpeg(blob: bytes, t: Dict, name: str) -> np.ndarray:
    """An old-style JPEG file (Compression 6) as Pillow reads it through
    libtiff 4.7.1's OJPEG codec and RGBA reader (`_ojpeg_stream`: the one
    baseline stream libtiff hands libjpeg). libjpeg gives libtiff the
    components raw (no upsampling, no colour conversion); three components
    become data units of the stream's luma sampling and go through
    TIFFYCbCrToRGB (`native.ycbcr_to_rgb`) whatever PhotometricInterpretation
    (2, 6 or none) says; one component of a one-sample file is the grey
    plane. A strip whose read fails leaves its rows as zeroed data units when
    it is the last (the RGBA reader goes on past errors); a failure before
    the last, or any in a grey file (read strip by strip), is Pillow's error.
    What libtiff or Pillow refuses raises, naming the tag."""
    from wast3d_tpu_torch import native

    tags, w, h, spp = t["tags"], t["w"], t["h"], t["spp"]
    photo = _one(tags, 262) if len(tags.get(262, (0,))) == 1 else None  # more: passed over
    if t["bps"] != (8,) * spp:
        _refuse(name, 258, t["bps"], "with old-style JPEG is not something PIL reads (libtiff "
                "takes 8-bit samples)")
    # Three samples are YCbCr to libtiff's OJPEG codec whether the tag says
    # 2, 6 or nothing; one is a grey plane under any other tag.
    if (spp not in (1, 3) or (photo in (None, 2, 6)) != (spp == 3)) or t["planar"] != 1:
        _refuse(name, 262, f"{photo} with {spp} samples in PlanarConfiguration {t['planar']}",
                "is not something PIL reads with old-style JPEG (Compression 6)")
    if 322 in tags:
        _refuse(name, 322, _one(tags, 322), "with old-style JPEG is not supported (tiled "
                "old-style JPEG)")
    for tag in (277, 278, 284):  # libtiff's directory takes one value of each
        if len(tags.get(tag, (0,))) != 1:
            _refuse(name, tag, tags[tag], "is not one value (libtiff refuses the directory)")
    # Pillow's strip buffer holds RowsPerStrip rows of RGBA (grey: under 2**31
    # rows), 2**32 - 1 standing for the whole image; libtiff refuses 0.
    rows = _one(tags, 278, h)
    if rows == 0 or ((2 ** 31 - 1) // 4 // w if spp == 3 else 2 ** 31 - 1) < rows < 2 ** 32 - 1:
        _refuse(name, 278, rows, "is not something Pillow reads with old-style JPEG (decoder "
                "error -9 or -2)")
    rows = min(rows, h)
    stream = _ojpeg_stream(blob, t, rows, name)
    _, frame_h, factors = native.jpeg_frame(stream, name)
    if len(factors) != spp:
        raise ValueError(f"{name}: old-style JPEG stream of {len(factors)} components in a TIFF "
                         f"of {spp} samples (libtiff refuses it)")
    (fh, fv), rest = factors[0], factors[1:]
    if rows < h and rows % (8 * fv if spp == 3 else 8):
        _refuse(name, 278, rows, f"is not a multiple of the {8 * fv}-row MCUs of its old-style "
                "JPEG (libtiff: incompatible vertical subsampling and image strip length)")
    if (fh, fv) not in _YCBCR_UNITS or any(f != (1, 1) for f in rest):
        raise ValueError(f"{name}: old-style JPEG sampling {factors}, which libtiff would "
                         "upsample itself or has no RGBA routine for (Pillow: decoder error -2)")
    planes, failed_row = native.jpeg_raw_planes(stream, name)
    failed = None if failed_row < 0 else min(failed_row * 8 * fv // rows, -(-h // rows) - 1)
    if failed is not None and (spp == 1 or failed + 1 < -(-h // rows)):
        raise ValueError(f"{name}: old-style JPEG data fails in strip {failed} (libtiff: "
                         "premature end of JPEG data, or a restart marker out of turn)")
    if spp == 1:
        return _ojpeg_past_frame(planes[0], frame_h, rows, h, w)
    # libjpeg gives no rows past its frame's (whose height wraps past 65535),
    # and libtiff's buffer of one iMCU row keeps the last for every later
    # one, with the row before's data where the last's blocks pass the
    # frame's height (libjpeg writes none there)
    more = -(-h // (8 * fv)) - planes[0].shape[0] // (8 * fv)
    if more > 0:
        for p, (_, v) in zip(planes, factors):
            real = -(-frame_h * v // fv // 8) * 8
            if p.shape[0] >= 16 * v:
                p[real:] = p[real - 8 * v:p.shape[0] - 8 * v]
        planes = [np.concatenate([p, np.tile(p[-8 * v:], (more, 1))])
                  for p, (_, v) in zip(planes, factors)]
    uy, ux = -(-h // fv), -(-w // fh)
    luma = planes[0][:uy * fv, :ux * fh].reshape(uy, fv, ux, fh).transpose(0, 2, 1, 3)
    units = np.concatenate([luma.reshape(uy, ux, fv * fh), planes[1][:uy, :ux, None],
                            planes[2][:uy, :ux, None]], -1)
    if failed is not None:  # the last strip's read failed: its buffer, zeroed
        units[failed * rows // fv:] = 0
    tables = ycbcr_tables(_rationals(tags.get(529), (0.299, 0.587, 0.114)),
                          _rationals(tags.get(532), (0, 255, 128, 255, 128, 255)), name)
    return native.ycbcr_to_rgb(units, fh, fv, w, h, tables, name)


def _ojpeg_past_frame(plane: np.ndarray, frame_h: int, rows: int, h: int, w: int) -> np.ndarray:
    """A grey old-style JPEG as Pillow reads it strip by strip into one
    buffer: libjpeg gives no scanlines past its frame's height (which wraps
    past 65535), so there each strip keeps the rows of the strip before."""
    if frame_h >= h:
        return np.ascontiguousarray(plane[:h, :w])
    buf, out = np.zeros((rows, w), np.uint8), np.empty((h, w), np.uint8)
    for y in range(0, h, rows):
        n = min(max(frame_h - y, 0), rows)
        buf[:n] = plane[y:y + n, :w]
        out[y:y + rows] = buf[:min(rows, h - y)]
    return out


# The markers libtiff's OJPEG codec reads before SOS.
_OJPEG_MARKERS = {0xD8, 0xDB, 0xC4, 0xDD, 0xC0, 0xC1, 0xDA, 0xFE} | set(range(0xE0, 0xF0))


def _ojpeg_walk(stream: bytes, spp: int, name: str) -> Tuple[int, Optional[bytes], bool]:
    """OJPEGReadHeaderInfoSec's walk over the source up to SOS: any marker
    but SOI, APPn, COM, DQT, DHT, DRI, SOF0 / SOF1 and SOS is refused. A
    byte other than 0xFF where a marker should start ends the walk: after an
    SOF libtiff's stream then fails (Pillow: decoder error -2), before one
    libtiff builds the header from the table tags and the data starts at
    that byte. SOS must be of one component a sample, and the source hold
    it up to its last table selector: libtiff skips the three bytes after
    (Ss, Se, Ah / Al) and writes 0, 63, 0 there itself. Returns where the
    entropy-coded data starts, the stream's own header as libtiff hands it
    on (None: the header comes from the tables), and whether it has a
    DRI."""
    pos, marks = 0, set()
    while True:
        if pos < len(stream) and stream[pos] != 0xFF:
            if marks & {0xC0, 0xC1}:
                raise ValueError(f"{name}: old-style JPEG header broken off at byte {pos} of its "
                                 "stream, before its SOS (Pillow: decoder error -2)")
            return pos, None, False
        while pos < len(stream) and stream[pos] == 0xFF:
            pos += 1
        if pos >= len(stream):
            raise ValueError(f"{name}: old-style JPEG data without SOS (libtiff refuses it)")
        m = stream[pos]
        marks.add(m)
        pos += 1
        if m not in _OJPEG_MARKERS:
            raise ValueError(f"{name}: old-style JPEG data with marker 0xFF{m:02X}, which "
                             "libtiff's OJPEG codec refuses (Unknown marker type)")
        if m != 0xD8 and pos + 2 > len(stream):
            raise ValueError(f"{name}: old-style JPEG data cut short in its markers")
        if m == 0xDA:
            if stream[pos:pos + 3] != struct.pack(">HB", 6 + 2 * spp, spp):
                raise ValueError(f"{name}: old-style JPEG SOS not of {spp} components (libtiff: "
                                 "corrupt SOS marker)")
            if pos + 3 + 2 * spp > len(stream):
                raise ValueError(f"{name}: old-style JPEG data cut short in its SOS segment")
            sos = stream[pos - 2:pos + 3 + 2 * spp] + b"\x00\x3f\x00"
            return min(pos + 6 + 2 * spp, len(stream)), stream[:pos - 2] + sos, 0xDD in marks
        if m != 0xD8:
            pos += stream[pos] << 8 | stream[pos + 1]


def _ojpeg_stream(blob: bytes, t: Dict, rows: int, name: str) -> bytes:
    """The stream libtiff's OJPEG codec hands libjpeg. Its source is the
    JPEGInterchangeFormat (513) bytes (when 513 is inside the file;
    JPEGInterchangeFormatLength 0 or too long runs to the end), then each
    strip's (cut at the end of the file; a byte count of 0 runs to it; a
    strip at offset 0 or past the end gives nothing; without
    StripByteCounts only the interchange form reads). If the source starts
    with a marker, its markers up to SOS are the header (with libtiff's own
    DRI, `_ojpeg_restart`, where it has none); else libtiff builds one: a
    DQT and two DHTs a component from JPEGQTables / DCTables / ACTables
    (519-521), the DRI, SOF0 at the YCbCrSubsampling (530, default 2x2) for
    component 0 and 1x1 for the others, SOS (JPEGProc changes nothing).
    Then the rest of the source, an RST marker after each strip's data
    while any strip follows and EOI after the last's (so a strip without
    data shifts the later ones' data a restart interval early). Where the
    stream runs out before its EOI, libjpeg asks for more ("Premature end
    of JPEG data"), and libtiff's source makes a restart marker out of turn
    an error too: the strip being read then fails (`native.jpeg_raw_planes`
    reports where)."""
    from wast3d_tpu_torch import native

    tags, w, h, spp = t["tags"], t["w"], t["h"], t["spp"]
    segments = []  # (strip index or None, bytes)
    start = _one(tags, 513, 0)
    if isinstance(start, int) and 0 < start < len(blob):
        length = _one(tags, 514, 0)
        length = length if isinstance(length, int) and 0 < length <= len(blob) - start else \
            len(blob) - start
        segments.append((None, blob[start:start + length]))
    strips = -(-h // rows)
    # libtiff reads one value a strip of StripOffsets and StripByteCounts, so
    # arrays that run past the end of the file hold if those values fit
    # (Pillow reads neither for YCbCr; a grey file's offsets it needs whole)
    inside = {s.tag: s.values for s in t["skipped"] if s.past_end and len(s.values) >= strips}
    offsets = tags.get(273) or (inside.get(273, ()) if spp == 3 else ())
    if offsets:  # libtiff's strips are the rows': more offsets are cut off, fewer padded with 0
        offsets = (tuple(offsets) + (0,) * strips)[:strips]
    counts = tags.get(279) or inside.get(279)
    if offsets and counts is None and spp == 1:  # read strip by strip, past its estimate
        raise ValueError(f"{name}: grey old-style JPEG without StripByteCounts (tag 279): "
                         "libtiff's estimate of its strips runs past the file")
    for i, off in enumerate(offsets):
        cnt = counts[i] if counts and i < len(counts) else 0
        data = blob[off:off + cnt] if cnt else blob[off:]
        segments.append((i, data if 0 < off < len(blob) else b""))
    source = b"".join(d for _, d in segments)
    at, head, dri = _ojpeg_walk(source, spp, name) if source[:1] == b"\xff" else (0, None, False)
    if head is None and offsets and counts is None:
        raise ValueError(f"{name}: old-style JPEG in the table form without StripByteCounts "
                         "(tag 279), which Pillow fails to read (decoder error -2)")
    if head is None:  # its SOF: the TIFF's size, 16 bits each
        return b"".join([_ojpeg_tables(blob, t, rows, name)] + _ojpeg_data(segments, at, strips))
    sw, sh, factors = native.jpeg_frame(head, name)
    if sw != w or sh < h:
        raise ValueError(f"{name}: a {sw}x{sh} old-style JPEG stream in a {w}x{h} TIFF (libtiff "
                         "refuses it)")
    if not dri:  # libtiff's own restart interval, where the stream gives none
        sos = len(head) - 8 - 2 * spp
        head = head[:sos] + _ojpeg_restart(t, rows, factors[0] if spp == 3 else (1, 1)) + head[sos:]
    return b"".join([head] + _ojpeg_data(segments, at, strips))


def _ojpeg_data(segments: list, at: int, strips: int) -> list:
    """The source's data from `at` on, an RST marker after each strip's while
    any strip follows, and EOI after the last's."""
    out, restarts, pos = [], 0, 0
    for i, data in segments:
        lo = max(at - pos, 0)
        pos += len(data)
        if lo >= len(data):
            continue
        out.append(data[lo:])
        if i is None:
            continue
        if i + 1 < strips:
            out.append(bytes([0xFF, 0xD0 + restarts % 8]))
            restarts += 1
        else:
            out.append(b"\xff\xd9")
            break
    return out


def _ojpeg_restart(t: Dict, rows: int, sub: Tuple[int, int]) -> bytes:
    """The DRI segment libtiff's OJPEG codec writes unless the stream has its
    own: one strip's MCUs at the luma sampling `sub` in a file of more than
    one strip, else JPEGRestartInterval (515) where it is one value (kept
    as 16 bits; 0, or no tag: no DRI)."""
    w, h = t["w"], t["h"]
    if rows < h:
        interval = -(-w // (8 * sub[0])) * (rows // (8 * sub[1]))
    else:
        interval = _one(t["tags"], 515, 0)
        interval = interval & 65535 if isinstance(interval, int) else 0
    return b"\xff\xdd\x00\x04" + struct.pack(">H", interval & 65535) if interval else b""


def _ojpeg_sampling(t: Dict) -> Tuple[int, int]:
    """YCbCrSubsampling as libtiff's OJPEG codec keeps it (a byte each)."""
    sub = t["tags"].get(530, (2, 2)) if t["spp"] == 3 else (1, 1)
    return (sub[0] & 255, sub[1] & 255) if len(sub) >= 2 else (2, 2)


def _ojpeg_tables(blob: bytes, t: Dict, rows: int, name: str) -> bytes:
    """The header libtiff's OJPEG codec builds from the table tags."""
    tags, w, h, spp = t["tags"], t["w"], t["h"], t["spp"]
    missing = [f"{_TAG_NAMES[k]} (tag {k})" for k in (519, 520, 521) if k not in tags]
    if missing:
        _refuse(name, 259, 6, f"without JPEGInterchangeFormat (tag 513) or {', '.join(missing)} "
                "is not something PIL reads (libtiff: missing JPEG tables)")
    for tag in (519, 520, 521):  # libtiff takes up to 3 (0 past the count)
        if len(tags[tag]) > 3:
            _refuse(name, tag, tags.get(tag), "is more than 3 table offsets (libtiff: incorrect "
                    "count)")
    if w > 65535:
        _refuse(name, 256, w, "does not fit the 16 bits of the SOF libtiff writes (Pillow: "
                "decoder error -2)")
    sub = _ojpeg_sampling(t)
    if sub not in _YCBCR_UNITS:
        _refuse(name, 530, sub, "with old-style JPEG is not something PIL reads (libtiff has no "
                "routine for it)")
    q, dc, ac = (_ojpeg_table_ids((tags[tag] + (0,) * spp)[:spp], tag, name)
                 for tag in (519, 520, 521))
    out = b"\xff\xd8"
    for c in set(q):
        at = tags[519][c]
        if at + 64 > len(blob):
            _refuse(name, 519, tags[519], "points past the end of the file")
        out += b"\xff\xdb\x00\x43" + bytes([c]) + blob[at:at + 64]
    for cls, tag, ids in ((0, 520, dc), (1, 521, ac)):
        for c in set(ids):
            at = tags[tag][c]
            if at + 16 > len(blob) or at + 16 + sum(blob[at:at + 16]) > len(blob):
                _refuse(name, tag, tags[tag], "points past the end of the file")
            table = blob[at:at + 16 + sum(blob[at:at + 16])]
            out += b"\xff\xc4" + struct.pack(">H", 3 + len(table)) + bytes([cls << 4 | c]) + table
    # libtiff writes the DRI and SOF fields a byte at a time from wider counts
    out += _ojpeg_restart(t, rows, sub)
    out += b"\xff\xc0" + struct.pack(">HBHHB", 8 + 3 * spp, 8, h & 65535, w & 65535, spp) + b"".join(
        bytes([c + 1, (sub[0] << 4 | sub[1]) if c == 0 else 0x11, q[c]]) for c in range(spp))
    return out + b"\xff\xda" + struct.pack(">HB", 6 + 2 * spp, spp) + b"".join(
        bytes([c + 1, dc[c] << 4 | ac[c]]) for c in range(spp)) + b"\x00\x3f\x00"


def _ojpeg_table_ids(offsets: tuple, tag: int, name: str) -> list:
    """Each component's table, as libtiff's OJPEG codec reads the offsets of
    one table tag: an offset of 0, or the component before's, takes the
    component before's table; one of an earlier component is refused."""
    ids = []
    for c, at in enumerate(offsets):
        if c and (not at or at == offsets[c - 1]):
            ids.append(ids[-1])
        elif not at or at in offsets[:max(c - 1, 0)]:
            _refuse(name, tag, offsets, "is not a table offset a component (libtiff: missing "
                    "JPEG tables, or a corrupt table tag)")
        else:
            ids.append(c)
    return ids


def _tiff_predicted(seg: np.ndarray, t: Dict, predictor: int, spp: int, name: str) -> np.ndarray:
    """libtiff's predictors and byte swapping on one decoded strip or tile,
    uint8 [rows, row bytes] -> the samples in native (little-endian) order."""
    bits, bo = t["bps"][0], t["bo"]
    if predictor == 3:
        if t["tags"].get(339, (1,))[0] != 3 or bits != 32:
            _refuse(name, 317, 3, f"with {bits}-bit samples of SampleFormat "
                    f"{t['tags'].get(339, (1,))[0]} is not supported (libtiff: floating point "
                    "only)")
        n, row = seg.shape
        b = np.cumsum(seg.reshape(n, -1, spp), axis=1, dtype=np.uint8).reshape(n, 4, row // 4)
        return np.ascontiguousarray(b[:, ::-1].transpose(0, 2, 1)).reshape(n, row)
    if predictor == 2 and bits not in (8, 16, 32):
        _refuse(name, 317, 2, f"with {bits}-bit samples is not supported")
    if bits in (16, 32) and (predictor == 2 or bo == ">"):
        v = seg.view(f"{bo}u{bits // 8}")
        if predictor == 2:
            n = v.shape[0]
            v = np.cumsum(v.reshape(n, -1, spp), axis=1, dtype=v.dtype).reshape(n, -1)
        return np.ascontiguousarray(v, f"<u{bits // 8}").view(np.uint8)
    if predictor == 2:
        n = seg.shape[0]
        return np.cumsum(seg.reshape(n, -1, spp), axis=1, dtype=np.uint8).reshape(n, -1)
    return seg


def _tiff_libtiff(blob: bytes, t: Dict, name: str) -> np.ndarray:
    """A compressed file as Pillow's libtiff decoder reads it: each strip or
    tile (and plane) decompressed, predicted and swapped to native order as
    libtiff does, then unpacked with Pillow's raw mode; edge tiles cropped.
    YCbCr goes through libtiff's RGBA reader, as Pillow sends it."""
    from wast3d_tpu_torch import native

    tags, w, h, spp, planar = t["tags"], t["w"], t["h"], t["spp"], t["planar"]
    compression, mode, raw_mode = t["compression"], t["mode"], t["raw_mode"]
    bits = t["bps"][0]
    if any(b != bits for b in t["bps"]):
        _refuse(name, 258, t["bps"], "(samples of different sizes) is not supported")
    tiled = 322 in tags
    if tiled:
        if not all(k in tags for k in (323, 324, 325)):
            _refuse(name, 322, _one(tags, 322), "without TileLength (tag 323), TileOffsets (324) "
                    "and TileByteCounts (325) is not supported")
        tw, th, offsets, counts = _one(tags, 322), _one(tags, 323), tags[324], tags[325]
    else:
        if 273 not in tags or 279 not in tags:
            raise ValueError(f"{name}: TIFF without StripOffsets (tag 273) and StripByteCounts "
                             "(tag 279)")
        tw, th, offsets, counts = w, _one(tags, 278, h), tags[273], tags[279]
        th = min(th, h) if isinstance(th, int) and th < 2 ** 32 - 1 else h
    if not isinstance(tw, int) or not isinstance(th, int) or tw < 1 or th < 1:
        _refuse(name, 322 if tiled else 278, (tw, th), "is not a strip or tile size")
    across, down = (-(-w // tw) if tiled else 1), -(-h // th)
    planes = spp if planar == 2 else 1
    if len(offsets) != across * down * planes or len(counts) != len(offsets):
        raise ValueError(f"{name}: TIFF strips or tiles ({len(offsets)} offsets, {len(counts)} "
                         f"byte counts) do not cover the image ({across * down * planes})")
    seg_spp = 1 if planar == 2 else spp
    row_bytes = (tw * bits * seg_spp + 7) // 8
    bands = 1 if mode in ("1", "L", "P", "I", "F", "I;16", "I;16B") else len(mode)
    if planar == 2 and bands > 1:
        if bits not in (8, 16):
            _refuse(name, 258, t["bps"], "in separate planes is not supported (Pillow reads 8 "
                    "and 16 bits)")
        if t["ycbcr"] is None and not tiled and (
                w * _RAW_MODE_BITS[raw_mode] // bands + 7) // 8 > row_bytes:
            _refuse(name, 338, tuple(tags.get(338, ())), "in separate strips is not supported "
                    "(Pillow: fewer bands than planes)")
        planes = bands
    elif planar == 2 and spp > 1:
        _refuse(name, 284, 2, f"for {spp} samples of a {mode} image is not supported")
    predictor = _one(tags, 317, 1) if compression in (5, 8, 32946, 34925, 50000) else 1
    if predictor not in (1, 2, 3):
        _refuse(name, 317, predictor)
    out = _empty(mode, h, w)
    band_out = np.zeros((h, w, bands), np.uint8) if planar == 2 and bands > 1 else None
    expect = []
    ycbcr, units = t["ycbcr"], None
    for p in range(planes):
        for s in range(across * down):
            i = p * across * down + s
            y0, x0 = (s // across) * th, (s % across) * tw
            rows, cw, ch = (th if tiled else min(th, h - y0)), min(tw, w - x0), min(th, h - y0)
            off, cnt = offsets[i], counts[i]
            if off + cnt > len(blob):
                raise ValueError(f"{name}: TIFF strip or tile {i} past the end of the file")
            data = blob[off:off + cnt]
            if t["fill"] == 2 and compression != 7:
                data = _BIT_REVERSED[np.frombuffer(data, np.uint8)].tobytes()
            if compression == 7:
                seg = _tiff_jpeg(data, t, expect, tw, rows, not tiled and s == down - 1, name)
            elif ycbcr is not None and planar == 1 and tiled:  # gtTileContig: TIFFReadTile
                (sh, sv), unit = ycbcr[0], ycbcr[0][0] * ycbcr[0][1] + 2
                size = -(-th // sv) * -(-tw // sh) * unit
                units = _tiff_strip(data, compression, size, name)[:size]
                rgb = native.ycbcr_to_rgb(units, sh, sv, tw, th, ycbcr[1], name)
                out[y0:y0 + ch, x0:x0 + cw] = rgb[:ch, :cw]
                continue
            elif ycbcr is not None and planar == 1:
                units = _ycbcr_strip(data, t, units, rows, name)
                out[y0:y0 + ch] = native.ycbcr_to_rgb(units, *ycbcr[0], w, ch, ycbcr[1], name)
                continue
            else:
                seg = _tiff_strip(data, compression, rows * row_bytes, name,
                                  (tw, rows, _one(tags, 292, 0)))
                seg = seg[:rows * row_bytes].reshape(rows, row_bytes)
                seg = _tiff_predicted(seg, t, predictor, seg_spp, name)
            if band_out is not None:  # Pillow's band copies ("R", "R;16N", ...)
                v = seg[:ch].view("<u2") >> 8 if bits == 16 else seg[:ch]
                band_out[y0:y0 + ch, x0:x0 + cw, p] = v[:, :cw]
            else:
                out[y0:y0 + ch, x0:x0 + cw] = _unpack(mode, raw_mode, seg[:ch], cw)
    if band_out is None:
        return out
    if ycbcr is not None:  # putseparate8bitYCbCr11tile: one data unit a pixel
        return native.ycbcr_to_rgb(band_out, 1, 1, w, h, ycbcr[1], name)
    if mode == "LAB":  # Pillow's LAB band unpackers: a and b signed
        band_out[..., 1:] ^= np.uint8(128)
    if mode in ("LA", "PA"):  # band 1 is not the alpha byte of Pillow's LA / PA pixels
        band_out[..., 1] = 0
    extra = tags.get(338, ())
    if mode == "RGBA" and (not extra or extra[0] == 1):  # associated alpha, or none named
        return _unpremultiply(band_out)
    return band_out


def _ycbcr_strip(data: bytes, t: Dict, units, rows: int, name: str) -> np.ndarray:
    """A chunky YCbCr strip's data units as gtStripContig reads them into
    its one buffer: TIFFReadEncodedStrip of the rows rounded up to whole
    unit rows times TIFFScanlineSize (a unit row's bytes divided by the
    vertical subsampling, rounded down), so 4x4 units an odd number across
    leave the buffer's last bytes as the strip before left them (zeros at
    first)."""
    (sh, sv), w = t["ycbcr"][0], t["w"]
    row_size = -(-w // sh) * (sh * sv + 2)
    if units is None:
        th = _one(t["tags"], 278, t["h"])
        th = min(th, t["h"]) if isinstance(th, int) and th < 2 ** 32 - 1 else t["h"]
        units = np.zeros(-(-th // sv) * row_size, np.uint8)
    want = -(-rows // sv) * sv * (row_size // sv)
    units[:want] = _tiff_strip(data, t["compression"], want, name)[:want]
    return units


# T.4's run-length codes as (bit string, run): terminating 0-63, make-up
# 64-1728 of each colour, and the make-up codes 1792-2560 both share.
_CCITT_SHARED = dict(zip(
    "00000001000 00000001100 00000001101 000000010010 000000010011 000000010100 000000010101 "
    "000000010110 000000010111 000000011100 000000011101 000000011110 000000011111".split(),
    range(1792, 2561, 64)))
_CCITT_RUNS = [dict(zip((
    "00110101 000111 0111 1000 1011 1100 1110 1111 10011 10100 00111 01000 001000 000011 "
    "110100 110101 101010 101011 0100111 0001100 0001000 0010111 0000011 0000100 0101000 "
    "0101011 0010011 0100100 0011000 00000010 00000011 00011010 00011011 00010010 00010011 "
    "00010100 00010101 00010110 00010111 00101000 00101001 00101010 00101011 00101100 "
    "00101101 00000100 00000101 00001010 00001011 01010010 01010011 01010100 01010101 "
    "00100100 00100101 01011000 01011001 01011010 01011011 01001010 01001011 00110010 "
    "00110011 00110100 11011 10010 010111 0110111 00110110 00110111 01100100 01100101 "
    "01101000 01100111 011001100 011001101 011010010 011010011 011010100 011010101 011010110 "
    "011010111 011011000 011011001 011011010 011011011 010011000 010011001 010011010 011000 "
    "010011011").split(), list(range(64)) + list(range(64, 1729, 64)))), dict(zip((
    "0000110111 010 11 10 011 0011 0010 00011 000101 000100 0000100 0000101 0000111 00000100 "
    "00000111 000011000 0000010111 0000011000 0000001000 00001100111 00001101000 00001101100 "
    "00000110111 00000101000 00000010111 00000011000 000011001010 000011001011 000011001100 "
    "000011001101 000001101000 000001101001 000001101010 000001101011 000011010010 "
    "000011010011 000011010100 000011010101 000011010110 000011010111 000001101100 "
    "000001101101 000011011010 000011011011 000001010100 000001010101 000001010110 "
    "000001010111 000001100100 000001100101 000001010010 000001010011 000000100100 "
    "000000110111 000000111000 000000100111 000000101000 000001011000 000001011001 "
    "000000101011 000000101100 000001011010 000001100110 000001100111 0000001111 "
    "000011001000 000011001001 000001011011 000000110011 000000110100 000000110101 "
    "0000001101100 0000001101101 0000001001010 0000001001011 0000001001100 0000001001101 "
    "0000001110010 0000001110011 0000001110100 0000001110101 0000001110110 0000001110111 "
    "0000001010010 0000001010011 0000001010100 0000001010101 0000001011010 0000001011011 "
    "0000001100100 0000001100101").split(), list(range(64)) + list(range(64, 1729, 64))))]
for _runs in _CCITT_RUNS:
    _runs.update(_CCITT_SHARED)


def ccitt_reference(data: bytes, mode: int, options: int, width: int, rows: int) -> np.ndarray:
    """The plain version of `native.ccitt_decode`: TIFF Compression `mode` 2
    (Modified Huffman, rows on bytes), 3 (T.4: EOL before each row, with
    `options` bit 0 a tag bit choosing 1-D or 2-D) or 4 (T.6) -> uint8
    [rows, ceil(width / 8)] packed rows, 1 for a black run. Bits are held as
    libtiff's accumulator holds them: whole bytes loaded as a lookup needs
    them, zero bits padded up to the lookup's width at the end of the data."""
    stream = np.unpackbits(np.frombuffer(data, np.uint8))
    st = {"pos": 0, "avail": 0, "cp": 0, "eol": False}

    def need(n, two_bytes=False):  # NeedBits16 / NeedBits8
        if st["avail"] >= n:
            return
        for k in range(2 if two_bytes else 1):
            if st["cp"] >= len(data):
                if st["avail"] == 0 and k == 0:
                    raise ValueError("CCITT data ends before the last row")
                st["avail"] = n
                return
            st["cp"] += 1
            st["avail"] += 8
            if st["avail"] >= n:
                return

    def get(n):
        v = stream[st["pos"]:st["pos"] + n]
        return "".join(map(str, v)) + "0" * (n - len(v))

    def clear(n):
        st["pos"] += n
        st["avail"] -= n

    def lookup(colour):  # LOOKUP16: a run, -1 for an EOL, -2 for no code
        width_ = 13 if colour else 12
        need(width_, True)
        bits = get(width_)
        if bits[:12] == "000000000001":
            clear(12)
            return -1
        for k in range(2, width_ + 1):
            if bits[:k] in _CCITT_RUNS[colour]:
                clear(k)
                return _CCITT_RUNS[colour][bits[:k]]
        return -2

    def run(colour):
        total = 0
        while True:
            r = lookup(colour)
            if r < 0:
                raise ValueError("bad CCITT run code")
            total += r
            if r < 64:
                return total

    def row_1d():  # EXPAND1D, then CLEANUP_RUNS
        runs, a0, pending, done = [], 0, 0, False
        while not done:
            for colour in (0, 1):
                while True:
                    r = lookup(colour)
                    if r < 0:
                        st["eol"], done = r == -1, True
                        break
                    if r < 64:
                        runs.append(pending + r)
                        a0, pending = a0 + r, 0
                        break
                    a0, pending = a0 + r, pending + r
                if done or a0 >= width:
                    done = True
                    break
            if not done and len(runs) >= 2 and runs[-1] == runs[-2] == 0:
                del runs[-2:]
        if pending:
            runs.append(pending)
        if a0 != width:
            while a0 > width and runs:
                a0 -= runs.pop()
            if a0 < width:
                a0 = max(a0, 0)
                if len(runs) % 2:
                    runs.append(0)
                runs.append(width - a0)
            elif a0 > width:
                runs += [width, 0]
        return [min(int(c), width) for c in np.cumsum(runs)[:-1]]

    modes = {"1": 0, "011": 1, "010": -1, "001": "H", "0001": "P", "000011": 2, "000010": -2,
             "0000011": 3, "0000010": -3}

    def row_2d(ref):
        changes, a0, colour = [], -1, 0
        while a0 < width:
            need(7)
            bits = get(7)
            code = next((bits[:k] for k in range(1, 8) if bits[:k] in modes), None)
            if code is None:
                raise ValueError("bad CCITT mode code")
            clear(len(code))
            if code == "001":  # horizontal
                a1 = max(a0, 0) + run(colour)
                a2 = a1 + run(colour ^ 1)
                if a2 > width:
                    raise ValueError("a CCITT run past the end of its row")
                changes += [a for a in (a1, a2) if a < width]
                a0 = a2
                continue
            j = bisect.bisect_right(ref, a0)
            j += j < len(ref) and j % 2 != colour
            b1 = ref[j] if j < len(ref) else width
            b2 = ref[j + 1] if j + 1 < len(ref) else width
            if code == "0001":  # pass
                a0 = b2
                continue
            a1 = b1 + modes[code]
            if a1 > width or a1 < max(a0, 0):
                raise ValueError("a CCITT vertical code past its row")
            a0 = a1
            if a0 < width:
                changes.append(a0)
            colour ^= 1
        return changes

    out = np.zeros((rows, (width + 7) // 8), np.uint8)
    ref = []
    for y in range(rows):
        two_d = mode == 4
        if mode == 3:  # SYNC_EOL: 11 zero bits anywhere (unless an EOL ended the row),
            while not st["eol"]:  # zero bytes, then up to a 1 bit
                need(11, True)
                if get(11) == "0" * 11:
                    break
                clear(1)
            while True:
                need(8)
                if get(8) != "0" * 8:
                    break
                clear(8)
            while get(1) == "0":
                clear(1)
            clear(1)
            if options & 1:
                need(1)
                two_d = get(1) == "0"
                clear(1)
        st["eol"] = False
        cur = row_2d(ref) if two_d else row_1d()
        if mode == 2:  # FAXMODE_BYTEALIGN
            clear(st["avail"] % 8)
        line = np.zeros(width, np.uint8)
        for k in range(0, len(cur), 2):
            line[cur[k]:cur[k + 1] if k + 1 < len(cur) else width] = 1
        out[y] = np.packbits(line)
        ref = cur
    return out


def decode_tiff(blob: bytes, name: str = "<bytes>") -> np.ndarray:
    """TIFF bytes (the first image) -> `np.asarray(PIL.Image.open(...))`
    (module docstring)."""
    t = _tiff_setup(blob, name)
    _check_pixels(t["w"], t["h"], name)
    img = (_tiff_raw if t["compression"] == 1 else _tiff_ojpeg if t["compression"] == 6
           else _tiff_libtiff)(blob, t, name)
    if t["mode"] == "1":
        img = img.view(bool)
    orient = _ORIENT.get(t["orientation"])
    return img if orient is None else np.ascontiguousarray(orient(img))


# ---- Netpbm: Pillow's PpmImagePlugin -------------------------------------------------

_WHITESPACE = b" \t\n\x0b\x0c\r"
_PNM_MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L", b"P6": "RGB",
              b"P0CMYK": "CMYK", b"Pf": "F", b"PyP": "P", b"PyRGBA": "RGBA", b"PyCMYK": "CMYK"}
_SAFEBLOCK = 1024 * 1024  # what Pillow's plain decoder reads at a time


def _pnm_header(blob: bytes, name: str):
    """PpmImageFile._open: (mode, width, height, the decoder's name and
    argument, the offset of the data)."""
    pos, magic = 0, b""
    for _ in range(6):
        c = blob[pos:pos + 1]
        pos += len(c)
        if not c or c in _WHITESPACE:
            break
        magic += c
    if magic not in _PNM_MODES:
        raise ValueError(f"{name}: not a Netpbm file PIL reads (magic {magic!r})")
    mode = _PNM_MODES[magic]

    def token() -> bytes:
        nonlocal pos
        tok = b""
        while len(tok) <= 10:
            c = blob[pos:pos + 1]
            pos += len(c)
            if not c:
                break
            if c in _WHITESPACE:
                if not tok:
                    continue
                break
            if c == b"#":  # the rest of the line, up to CR, LF or the end
                while True:
                    c = blob[pos:pos + 1]
                    pos += len(c)
                    if c in b"\r\n":
                        break
                continue
            tok += c
        if not tok:
            raise ValueError(f"{name}: Netpbm header ends early")
        if len(tok) > 10:
            raise ValueError(f"{name}: Netpbm header token {tok[:11]!r} too long")
        return tok

    def number(tok: bytes, kind=int):
        try:
            return kind(tok)
        except ValueError:
            raise ValueError(f"{name}: Netpbm header token {tok!r} is not a number") from None

    w, h = number(token()), number(token())
    plain = magic in (b"P1", b"P2", b"P3")
    if mode == "1":
        decoder = ("plain", None) if plain else ("raw", "1;I")
    elif mode == "F":
        scale = number(token(), float)
        if scale == 0.0 or not np.isfinite(scale):
            raise ValueError(f"{name}: PFM scale {scale} must be finite and non-zero")
        decoder = ("raw", "F;32F" if scale < 0 else "F;32BF")
    else:
        maxval = number(token())
        if not 0 < maxval < 65536:
            raise ValueError(f"{name}: Netpbm maxval {maxval} is not in 1..65535")
        if maxval > 255 and mode == "L":
            mode = "I"
        if plain:
            decoder = ("plain", maxval)
        elif maxval == 65535 and mode == "I":
            decoder = ("raw", "I;16B")
        elif maxval != 255:
            decoder = ("scaled", maxval)
        else:
            decoder = ("raw", mode)
    if w <= 0 or h <= 0:
        raise ValueError(f"{name}: Netpbm size {w}x{h}")
    return mode, w, h, decoder, pos


def _pnm_comments_out(block: bytes, spans: bool) -> Tuple[bytes, bool]:
    """PpmPlainDecoder._ignore_comments on one block: (the block without its
    comments, whether a comment runs on into the next block)."""
    def end(b, start=0):
        a, c = b.find(b"\n", start), b.find(b"\r", start)
        return min(a, c) if a * c > 0 else max(a, c)

    if spans:
        e = end(block)
        if e == -1:
            return b"", True
        block = block[e + 1:]
    while True:
        start = block.find(b"#")
        if start == -1:
            return block, False
        e = end(block, start)
        if e == -1:
            return block[:start], True
        block = block[:start] + block[e + 1:]


def _pnm_plain(blob: bytes, pos: int, mode: str, w: int, h: int, maxval, name: str):
    """PpmPlainDecoder: ASCII samples read a block at a time, comments
    dropped, each sample scaled as round(value / maxval * out max)."""
    spans = False
    if mode == "1":
        total, data = w * h, b""
        while len(data) != total:
            block = blob[pos:pos + _SAFEBLOCK]
            pos += len(block)
            if not block:
                break
            block, spans = _pnm_comments_out(block, spans)
            tokens = b"".join(block.split())
            if np.any((np.frombuffer(tokens, np.uint8) | 1) != 49):
                raise ValueError(f"{name}: a P1 sample other than 0 or 1")
            data = (data + tokens)[:total]
        if len(data) < total:
            raise ValueError(f"{name}: not enough image data ({len(data)} of {total} samples)")
        return ((np.frombuffer(data, np.uint8) == 48) * np.uint8(255)).view(bool).reshape(h, w)
    bands = len(mode) if mode not in ("I", "L", "P") else 1
    total, values, half = w * h * bands, [], b""
    out_max = 65535 if mode == "I" else 255
    count, flushed = 0, False
    while count != total:
        block = blob[pos:pos + _SAFEBLOCK]
        pos += len(block)
        if not block:  # the end: the last token, once (PIL loops forever in a comment here)
            if not half or flushed:
                break
            block, flushed = b" ", True
        block, spans = _pnm_comments_out(block, spans)
        block, half = half + block, b""
        tokens = block.split()
        if block and not block[-1:].isspace():
            half = tokens.pop()
            if len(half) > 10:
                raise ValueError(f"{name}: Netpbm sample token {half[:11]!r} too long")
        tokens = tokens[:total - count]
        if any(len(t) > 10 for t in tokens):
            raise ValueError(f"{name}: a Netpbm sample token is too long")
        try:
            v = np.array([int(t) for t in tokens], np.int64)
        except ValueError:
            raise ValueError(f"{name}: a Netpbm sample is not a number") from None
        if v.size and (v.min() < 0 or v.max() > maxval):
            raise ValueError(f"{name}: a Netpbm sample outside 0..{maxval}")
        values.append(v)
        count += v.size
    if count < total:
        raise ValueError(f"{name}: not enough image data ({count} of {total} samples)")
    v = np.round(np.concatenate(values) / maxval * out_max)
    return v.astype(np.int32 if mode == "I" else np.uint8).reshape(
        (h, w, bands) if bands > 1 else (h, w))


def decode_pnm(blob: bytes, name: str = "<bytes>") -> np.ndarray:
    """Netpbm bytes -> `np.asarray(PIL.Image.open(...))` (module docstring)."""
    mode, w, h, (kind, arg), pos = _pnm_header(blob, name)
    _check_pixels(w, h, name)
    if kind == "plain":
        return _pnm_plain(blob, pos, mode, w, h, arg, name)
    bands = len(mode) if mode not in ("I", "L", "P", "F", "1") else 1
    if kind == "scaled":  # PpmDecoder: one or two big-endian bytes a sample
        dt = np.uint8 if arg < 256 else np.dtype(">u2")
        n = w * h * bands
        if len(blob) - pos < n * np.dtype(dt).itemsize:
            raise ValueError(f"{name}: Netpbm data truncated")
        out_max = 65535 if mode == "I" else 255
        v = np.frombuffer(blob, dt, n, pos).astype(np.float64)
        v = np.minimum(out_max, np.round(v / arg * out_max))
        return v.astype(np.int32 if mode == "I" else np.uint8).reshape(
            (h, w, bands) if bands > 1 else (h, w))
    row = (w + 7) // 8 if mode == "1" else w * {"I": 2, "F": 4}.get(mode, bands)
    if len(blob) - pos < row * h:
        raise ValueError(f"{name}: Netpbm data truncated ({len(blob) - pos} of {row * h} bytes)")
    rows = np.frombuffer(blob, np.uint8, row * h, pos).reshape(h, row)
    if mode == "F":  # rows stored bottom-up
        return np.ascontiguousarray(_unpack("F", arg, rows, w)[::-1])
    if mode == "1":
        return _unpack("1", "1;I", rows, w).view(bool)
    if mode == "I":
        return rows.view(">u2").astype(np.int32)
    return rows.reshape((h, w, bands) if bands > 1 else (h, w)).copy()


# ---- TGA: Pillow's TgaImagePlugin ----------------------------------------------------

_TGA_RAW = {(1, 8): "P", (3, 1): "1", (3, 8): "L", (3, 16): "LA", (2, 16): "BGRA;15Z",
            (2, 24): "BGR", (2, 32): "BGRA"}


def _tga_header(blob: bytes):
    """TgaImageFile._open's checks: (mode, raw mode, width, height, depth,
    image type, flags, the offset of the pixels), or None when PIL would not
    take the file for a TGA."""
    if len(blob) < 18:
        return None
    id_len, cmap_type, image_type = blob[0], blob[1], blob[2]
    w, h = struct.unpack_from("<HH", blob, 12)
    depth, flags = blob[16], blob[17]
    if cmap_type not in (0, 1) or w == 0 or h == 0 or depth not in (1, 8, 16, 24, 32):
        return None
    if image_type in (3, 11):
        mode = {1: "1", 16: "LA"}.get(depth, "L")
    elif image_type in (1, 9):
        mode = "P" if cmap_type else "L"
    elif image_type in (2, 10):
        mode = "RGB" if depth == 24 else "RGBA"
    else:
        return None
    pos = 18 + id_len
    if cmap_type:
        first, size, map_depth = struct.unpack_from("<HHB", blob, 3)
        if map_depth not in (16, 24, 32):
            return None
        pos += size * map_depth // 8
    return mode, _TGA_RAW.get((image_type & 7, depth)), w, h, depth, image_type, flags, pos


def decode_tga(blob: bytes, name: str = "<bytes>") -> np.ndarray:
    """TGA bytes -> `np.asarray(PIL.Image.open(...))` (module docstring)."""
    from wast3d_tpu_torch import native

    head = _tga_header(blob)
    if head is None:
        raise ValueError(f"{name}: not a TGA file PIL reads")
    mode, raw, w, h, depth, image_type, flags, pos = head
    first, size = struct.unpack_from("<HH", blob, 3)
    if raw is None or (mode == "L" and raw == "P") or (image_type == 11 and depth == 1) or (
            blob[1] and (blob[7] == 32 or mode in ("1", "RGB", "RGBA") or first + size > 256)):
        cmap = (f"a colour map of {first} + {size} entries at {blob[7]} bits" if blob[1]
                else "no colour map")
        raise ValueError(f"{name}: a TGA of image type {image_type} at {depth} bits with "
                         f"{cmap} is not one PIL loads")
    _check_pixels(w, h, name)
    bpp = max(depth // 8, 1)
    row = (w + 7) // 8 if depth == 1 else w * bpp
    if image_type & 8:
        rows = native.tga_rle(blob[pos:], bpp, row, h, name)
    else:
        if len(blob) - pos < row * h:
            raise ValueError(f"{name}: TGA data truncated ({len(blob) - pos} of {row * h} bytes)")
        rows = np.frombuffer(blob, np.uint8, row * h, pos).reshape(h, row)
    if raw == "1":
        v = _unpack("1", "1", rows, w).view(bool)
    elif raw == "BGRA;15Z":
        p = rows.view("<u2").astype(np.int32)
        v = np.stack([(p >> 10 & 31) * 255 // 31, (p >> 5 & 31) * 255 // 31,
                      (p & 31) * 255 // 31, np.where(p & 0x8000, 0, 255)], -1).astype(np.uint8)
    elif raw in ("BGR", "BGRA"):
        v = rows.reshape(h, w, bpp)[..., [2, 1, 0, 3][:bpp]]
    else:
        v = rows.reshape(h, w, bpp) if bpp > 1 else rows
    if not flags & 0x20:  # bottom-up
        v = v[::-1]
    if flags & 0x10:  # right to left
        v = v[:, ::-1]
    return np.ascontiguousarray(v)


def tga_rle_reference(data: bytes, depth: int, row_bytes: int, rows: int) -> np.ndarray:
    """Plain version of `native.tga_rle`."""
    out, pos, total = bytearray(), 0, row_bytes * rows
    while len(out) < total:
        if pos >= len(data):
            break
        n = depth * ((data[pos] & 0x7F) + 1)
        if data[pos] & 0x80:
            if pos + 1 + depth > len(data):
                break
            if len(out) % row_bytes + n > row_bytes:
                raise ValueError("a TGA run passes the end of its row (PIL: buffer overrun)")
            out += data[pos + 1:pos + 1 + depth] * (n // depth)
            pos += 1 + depth
        else:
            if pos + 1 + n > len(data):
                break
            out += data[pos + 1:pos + 1 + n]
            pos += 1 + n
    if len(out) < total:
        raise ValueError(f"TGA run-length data truncated ({len(out)} of {total} bytes)")
    return np.frombuffer(bytes(out[:total]), np.uint8).reshape(rows, row_bytes)


# ---- QOI: Pillow's QoiImagePlugin ----------------------------------------------------

def decode_qoi(blob: bytes, name: str = "<bytes>") -> np.ndarray:
    """QOI bytes -> `np.asarray(PIL.Image.open(...))`: RGB when the header
    says 3 channels, else RGBA."""
    from wast3d_tpu_torch import native

    if len(blob) < 14:
        raise ValueError(f"{name}: QOI header truncated")
    w, h = struct.unpack_from(">II", blob, 4)
    if w == 0 or h == 0:
        raise ValueError(f"{name}: QOI size {w}x{h}")
    _check_pixels(w, h, name)
    return native.qoi_decode(blob[14:], w, h, 3 if blob[12] == 3 else 4, name)


def qoi_reference(data: bytes, width: int, height: int, channels: int) -> np.ndarray:
    """Plain version of `native.qoi_decode` (Pillow's QoiDecoder)."""
    index = [(0, 0, 0, 0)] * 64
    prev, pos, out, total = (0, 0, 0, 255), 0, bytearray(), width * height * channels
    while len(out) < total:
        if pos >= len(data):
            raise ValueError("QOI data truncated")
        b = data[pos]
        pos += 1
        if b in (0xFE, 0xFF):
            n = 3 if b == 0xFE else 4
            if pos + n > len(data):
                raise ValueError("QOI data truncated")
            px = tuple(data[pos:pos + n]) + prev[3:] * (n == 3)
            pos += n
        elif b >> 6 == 0:
            px = index[b]
        elif b >> 6 == 1:
            px = tuple((prev[i] + (b >> (4 - 2 * i) & 3) - 2) % 256 for i in range(3)) + prev[3:]
        elif b >> 6 == 2:
            if pos >= len(data):
                raise ValueError("QOI data truncated")
            dg, b2 = (b & 0x3F) - 32, data[pos]
            pos += 1
            px = ((prev[0] + dg + (b2 >> 4) - 8) % 256, (prev[1] + dg) % 256,
                  (prev[2] + dg + (b2 & 15) - 8) % 256, prev[3])
        else:
            out += bytes(prev[:channels]) * ((b & 0x3F) + 1)
            continue
        prev = px
        index[(px[0] * 3 + px[1] * 5 + px[2] * 7 + px[3] * 11) % 64] = px
        out += bytes(px[:channels])
    return np.frombuffer(bytes(out[:total]), np.uint8).reshape(height, width, channels)


def lzw_reference(blob: bytes, out_size: int) -> np.ndarray:
    """Plain version of `native.lzw_decode` (libtiff's LZWDecode)."""
    if len(blob) >= 2 and blob[0] == 0 and blob[1] & 1:
        raise ValueError("old-style (LSB-first) TIFF LZW is not supported")
    table = [bytes([i]) for i in range(256)] + [b"", b""]
    out, width, old, pos, acc, have = bytearray(), 9, "start", 0, 0, 0
    count = 258  # entries, counted on past 4096 as libtiff does
    while len(out) < out_size:
        while have < width and pos < len(blob):
            acc = (acc << 8) | blob[pos]
            pos += 1
            have += 8
        if have < width:
            break
        code = (acc >> (have - width)) & ((1 << width) - 1)
        have -= width
        acc &= (1 << have) - 1
        if code == 257:
            break
        if code == 256:
            table, width, old, count = table[:258], 9, None, 258
            continue
        if old == "start":
            raise ValueError("corrupt LZW data (a strip must start with a Clear code)")
        if old is None:
            if code > 256:
                raise ValueError(f"corrupt LZW data (code {code} after Clear)")
            entry = table[code]
        else:
            if count >= 4096 + 1023:
                raise ValueError("corrupt LZW data (the table overflows without a Clear code)")
            if code > count or code in (256, 257):
                raise ValueError(f"corrupt LZW data (code {code} not yet in the table)")
            entry = table[code] if code < count else old + old[:1]
            if count < 4096:
                table.append(old + entry[:1])
            count += 1
            if count > (1 << width) - 2 and width < 12:
                width += 1
        out += entry
        old = entry
    return np.frombuffer(bytes(out[:out_size]), np.uint8)


def packbits_reference(blob: bytes, out_size: int) -> np.ndarray:
    """Plain version of `native.packbits_decode`."""
    out, pos = bytearray(), 0
    while pos < len(blob) and len(out) < out_size:
        c = blob[pos] - 256 if blob[pos] > 127 else blob[pos]
        pos += 1
        if c >= 0:
            out += blob[pos:pos + c + 1]
            pos += c + 1
        elif c != -128 and pos < len(blob):
            out += blob[pos:pos + 1] * (1 - c)
            pos += 1
    return np.frombuffer(bytes(out[:out_size]), np.uint8)


# ---- JPEG upsampling: jdsample.c -------------------------------------------------------

def jpeg_idct_reference(coef: np.ndarray, qt: np.ndarray) -> np.ndarray:
    """The plain version of `native.jpeg_idct`: int16 [n, 64] coefficients
    (natural order) and uint16 [64] quantisers -> uint8 [n, 8, 8], as
    libjpeg-turbo's SIMD islow IDCT computes them (16-bit dequantisation and
    sums in0 +- in4, in7 + in3, in5 + in1; 32-bit products; each pass
    saturated to 16 bits; the outputs to [-128, 127], then + 128; the DC row
    alone, shifted in 16 bits, when rows 1-7 are zero)."""
    c = np.asarray(coef, np.int64).reshape(-1, 8, 8)
    q = np.asarray(qt, np.int64).reshape(8, 8)

    def w16(v):
        return (v + 32768) % 65536 - 32768

    def sat(v):
        return np.clip(v, -32768, 32767)

    def one_d(x):  # over axis 1 of [n, 8, 8]
        i = [x[:, k] for k in range(8)]
        tmp3, tmp2 = i[2] * 10703 + i[6] * 4433, i[2] * 4433 - i[6] * 10704
        tmp0, tmp1 = w16(i[0] + i[4]) * 8192, w16(i[0] - i[4]) * 8192
        z3, z4 = w16(i[7] + i[3]), w16(i[5] + i[1])
        z3p, z4p = z3 * -6436 + z4 * 9633, z3 * 9633 + z4 * 6437
        o0 = i[7] * -4927 + i[1] * -7373 + z3p
        o3 = i[7] * -7373 + i[1] * 4926 + z4p
        o1 = i[5] * -4176 + i[3] * -20995 + z4p
        o2 = i[5] * -20995 + i[3] * 4177 + z3p
        t10, t13, t11, t12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
        return np.stack([t10 + o3, t11 + o2, t12 + o1, t13 + o0, t13 - o0, t12 - o1,
                         t11 - o2, t10 - o3], 1)

    dq = w16(c * q)
    ws = sat((one_d(dq) + 1024) >> 11)
    dc_only = ~c[:, 1:].any(axis=(1, 2))
    ws[dc_only] = w16(dq[dc_only, :1] * 4).repeat(8, 1)
    out = sat((one_d(ws.transpose(0, 2, 1)) + (1 << 17)) >> 18).transpose(0, 2, 1)
    return (np.clip(out, -128, 127) + 128).astype(np.uint8)


def jpeg_undifference_reference(diff: np.ndarray, predictor: int, point_transform: int = 0,
                                reset_every: int = 0) -> np.ndarray:
    """Plain version of `native.jpeg_undifference`: lossless JPEG's
    predictions (H.1.2.1) row by row, each sum kept to 16 bits, then the
    point transform undone into 8 bits."""
    diff = np.asarray(diff, np.int64)
    out = np.zeros(diff.shape, np.int64)
    initial = 1 << (7 - point_transform)
    for r in range(diff.shape[0]):
        if r == 0 or (reset_every and r % reset_every == 0):
            # Ra = (diff + Ra) & 0xFFFF from `initial`: a running sum
            out[r] = (np.cumsum(diff[r]) + initial) & 0xFFFF
            continue
        prev, row = out[r - 1], out[r]
        row[0] = (diff[r, 0] + prev[0]) & 0xFFFF
        for x in range(1, diff.shape[1]):
            ra, rb, rc = int(row[x - 1]), int(prev[x]), int(prev[x - 1])
            p = (ra, rb, rc, ra + rb - rc, ra + ((rb - rc) >> 1), rb + ((ra - rc) >> 1),
                 (ra + rb) >> 1)[predictor - 1]
            row[x] = (diff[r, x] + p) & 0xFFFF
    return ((out << point_transform) & 0xFF).astype(np.uint8)


def jpeg_upsample_reference(plane: np.ndarray, rh: int, rv: int, out_width: int,
                            out_height: int) -> np.ndarray:
    """Plain version of `native.jpeg_upsample`: triangle ("fancy") filters
    for h2v1, h2v2 (planes more than 2 samples wide) and h1v2, replication
    for every other integral ratio; the rows above the first and below the
    last are the edge rows again."""
    p = plane.astype(np.int32)
    h, w = p.shape
    y = np.arange(out_height)
    iy, even = y // rv, (y % 2 == 0)
    near = p[iy]
    other = p[np.clip(np.where(even, iy - 1, iy + 1), 0, h - 1)]
    if (rh, rv) == (1, 1):
        out = near
    elif (rh, rv) == (1, 2):
        out = (3 * near + other + np.where(even, 1, 2)[:, None]) >> 2
    elif rh == 2 and rv in (1, 2) and w > 2:
        s = near if rv == 1 else 3 * near + other  # column sums
        left = np.concatenate([s[:, :1], s[:, :-1]], axis=1)
        right = np.concatenate([s[:, 1:], s[:, -1:]], axis=1)
        out = np.empty((out_height, 2 * w), np.int32)
        if rv == 1:
            out[:, 0::2] = (3 * s + left + 1) >> 2
            out[:, 1::2] = (3 * s + right + 2) >> 2
        else:
            out[:, 0::2] = (3 * s + left + 8) >> 4
            out[:, 1::2] = (3 * s + right + 7) >> 4
    else:
        out = near[:, np.arange(out_width) // rh]
    return out[:, :out_width].astype(np.uint8)


# ---- WebP: libwebp's demuxer and WebPAnimDecoder, frame 0 -----------------------------

_ALPHA_FLAG, _ANIMATION_FLAG, _VALID_FLAGS = 0x10, 0x02, 0x3E
_MAX_CHUNK = 2 ** 32 - 1 - 8 - 1


def _u24(b: bytes, o: int) -> int:
    return b[o] | (b[o + 1] << 8) | (b[o + 2] << 16)


def _webp_features(fourcc: bytes, payload: bytes, size: int, name: str) -> Tuple[int, int, bool]:
    """(width, height, has alpha) of a VP8 / VP8L chunk, checked as
    WebPGetFeatures checks it."""
    if fourcc == b"VP8L":
        if len(payload) < 5 or payload[0] != 0x2F or payload[4] >> 5:
            raise ValueError(f"{name}: bad WebP lossless header")
        bits = _u32(payload, 1)
        return (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1, bool((bits >> 28) & 1)
    if len(payload) < 10:
        raise ValueError(f"{name}: truncated WebP lossy header")
    bits = _u24(payload, 0)
    if (bits & 1 or (bits >> 1) & 7 > 3 or not (bits >> 4) & 1 or bits >> 5 >= size
            or payload[3:6] != b"\x9d\x01\x2a"):
        raise ValueError(f"{name}: bad WebP lossy frame header")
    w, h = _u16(payload, 6) & 0x3FFF, _u16(payload, 8) & 0x3FFF
    if not w or not h:
        raise ValueError(f"{name}: WebP lossy frame of size {w}x{h}")
    return w, h, False


def _webp_chunk(blob: bytes, pos: int, end: int, name: str) -> Tuple[bytes, int, int]:
    """(fourcc, payload size, padded size) of the chunk at `pos`, which must
    lie inside the RIFF payload."""
    if end - pos < 8:
        raise ValueError(f"{name}: truncated WebP chunk header at byte {pos}")
    size = _u32(blob, pos + 4)
    padded = size + (size & 1)
    if size > _MAX_CHUNK or padded > end - pos - 8:
        raise ValueError(f"{name}: WebP chunk {blob[pos:pos + 4]!r} of {size} bytes runs past "
                         "the end of the RIFF data")
    return blob[pos:pos + 4], size, padded


def _webp_frame(blob: bytes, pos: int, end: int, name: str):
    """The demuxer's StoreFrame: an ALPH chunk and a VP8 / VP8L chunk from
    `pos`, stopping at any other chunk. Returns ({"alpha": (offset, payload)
    or absent, "image": (offset, fourcc, padded payload), "width", "height",
    "has_alpha"}, the offset after them)."""
    frame = {}
    while True:
        fourcc, size, padded = _webp_chunk(blob, pos, end, name)
        payload = blob[pos + 8:pos + 8 + size]
        if fourcc == b"ALPH" and "alpha" not in frame:
            frame["alpha"] = (pos, payload)
        elif fourcc in (b"VP8 ", b"VP8L") and "image" not in frame:
            if fourcc == b"VP8L" and "alpha" in frame:
                raise ValueError(f"{name}: WebP lossless frame after an ALPH chunk")
            w, h, a = _webp_features(fourcc, payload, size, name)
            frame.update(image=(pos, fourcc, blob[pos + 8:pos + 8 + padded]), width=w, height=h,
                         has_alpha=a)
        else:
            return frame, pos
        pos += 8 + padded
        if pos == end:
            return frame, pos


def _webp_layout(blob: bytes, name: str):
    """(canvas width, canvas height, RGBA?, frame 0) as WebPDemux parses the
    file, refusing what it refuses."""
    if len(blob) < 20:
        raise ValueError(f"{name}: truncated WebP header")
    riff = _u32(blob, 4)
    if riff < 8 or riff > _MAX_CHUNK:
        raise ValueError(f"{name}: bad RIFF size ({riff})")
    end = riff + 8
    if len(blob) < end:
        raise ValueError(f"{name}: RIFF size {riff} runs past the end of the file "
                         f"({len(blob)} bytes)")
    if blob[12:16] != b"VP8X":
        frame, _ = _webp_frame(blob, 12, end, name)
        if "image" not in frame:
            raise ValueError(f"{name}: WebP file without an image")
        frame.pop("alpha", None)  # no VP8X, no alpha flag: the demuxer drops it
        frame.update(x=0, y=0)
        return frame["width"], frame["height"], frame["has_alpha"], frame
    _, size, padded = _webp_chunk(blob, 12, end, name)
    if size < 10:
        raise ValueError(f"{name}: VP8X chunk of {size} bytes")
    flags = blob[20]
    cw, ch = 1 + _u24(blob, 24), 1 + _u24(blob, 27)
    animated = bool(flags & _ANIMATION_FLAG)
    pos, anim, frames = 20 + padded, False, []
    if flags & ~_VALID_FLAGS:
        raise ValueError(f"{name}: VP8X flags {flags:#x} set reserved bits")
    while True:
        fourcc, size, padded = _webp_chunk(blob, pos, end, name)
        if fourcc == b"VP8X":
            raise ValueError(f"{name}: second VP8X chunk")
        if fourcc in (b"ALPH", b"VP8 ", b"VP8L"):
            if anim or animated or frames:
                raise ValueError(f"{name}: WebP image chunk outside an animation frame")
            frame, pos = _webp_frame(blob, pos, end, name)
            # RGBA as WebPGetFeatures says: the lossless header's bit, or the
            # flag or an ALPH chunk; the demuxer drops the chunk without the flag
            lossless = "image" in frame and frame["image"][1] == b"VP8L"
            rgba = frame["has_alpha"] if lossless else bool(flags & _ALPHA_FLAG) or "alpha" in frame
            if not flags & _ALPHA_FLAG:
                frame.pop("alpha", None)
            frames.append(dict(frame, x=0, y=0))
        elif fourcc == b"ANMF":
            if not anim:
                raise ValueError(f"{name}: ANMF chunk before ANIM")
            if padded < 16:
                raise ValueError(f"{name}: ANMF chunk of {size} bytes")
            start = pos + 24
            frame, pos = _webp_frame(blob, start, end, name)
            if pos - start > padded - 16:
                raise ValueError(f"{name}: ANMF frame runs past its chunk")
            if animated and frame:
                frames.append(dict(frame, x=2 * _u24(blob, start - 16),
                                   y=2 * _u24(blob, start - 13)))
        else:
            if fourcc == b"ANIM":
                if padded < 6:
                    raise ValueError(f"{name}: ANIM chunk of {size} bytes")
                anim = True
            pos += 8 + padded
        if pos == end:
            break
        if end - pos < 8:
            raise ValueError(f"{name}: truncated WebP chunk header at byte {pos}")
    if not frames:
        raise ValueError(f"{name}: WebP file without a frame")
    for f in frames:
        if "image" not in f or ("alpha" in f and f["alpha"][0] > f["image"][0]):
            raise ValueError(f"{name}: WebP frame without its image, or with alpha after it")
        inside = (f["x"] + f["width"] <= cw and f["y"] + f["height"] <= ch if animated else
                  (f["width"], f["height"]) == (cw, ch))
        if not inside:
            raise ValueError(f"{name}: WebP frame {f['width']}x{f['height']} at "
                             f"({f['x']}, {f['y']}) does not fit its {cw}x{ch} canvas")
    return cw, ch, bool(flags & _ALPHA_FLAG) if animated else rgba, frames[0]


def decode_webp(blob: bytes, name: str = "<bytes>") -> np.ndarray:
    """WebP bytes -> `np.asarray(PIL.Image.open(...))`: frame 0 on the canvas,
    uint8 [H, W, 3] or [H, W, 4] (module docstring)."""
    from wast3d_tpu_torch import native

    cw, ch, rgba, frame = _webp_layout(blob, name)
    _check_pixels(cw, ch, name)
    _, fourcc, payload = frame["image"]
    w, h = frame["width"], frame["height"]
    if fourcc == b"VP8L":
        pixels = native.vp8l_decode(payload, w, h, name)
    else:
        pixels = native.vp8_decode(payload, w, h, name)
        if "alpha" in frame:
            pixels[..., 3] = native.webp_alpha(frame["alpha"][1], w, h, name)
    if (w, h) != (cw, ch):  # an animation's first frame on its cleared canvas
        canvas = np.zeros((ch, cw, 4), np.uint8)
        canvas[frame["y"]:frame["y"] + h, frame["x"]:frame["x"] + w] = pixels
        pixels = canvas
    return pixels if rgba else np.ascontiguousarray(pixels[..., :3])


# ---- GIF: Pillow's GifImagePlugin, the first image ------------------------------------

def _gif_palette_needed(p: bytes, name: str) -> bool:
    """GifImageFile._is_palette_needed: False for the identity grey ramp."""
    for i in range(0, len(p), 3):
        if i + 3 > len(p):
            raise ValueError(f"{name}: truncated GIF colour table")
        if not i // 3 == p[i] == p[i + 1] == p[i + 2]:
            return True
    return False


def _gif_block(blob: bytes, pos: int) -> Tuple[bytes, int]:
    """GifImageFile.data(): the sub-block at `pos` (None at a terminator or
    the end) and the offset after it."""
    if pos < len(blob) and blob[pos]:
        return blob[pos + 1:pos + 1 + blob[pos]], pos + 1 + blob[pos]
    return None, min(pos + 1, len(blob))


def decode_gif(blob: bytes, name: str = "<bytes>") -> np.ndarray:
    """GIF bytes -> `np.asarray(PIL.Image.open(...))` of the first image:
    uint8 [H, W] indices or grey levels (module docstring)."""
    from wast3d_tpu_torch import native

    if len(blob) < 13:
        raise ValueError(f"{name}: truncated GIF header")
    w, h, flags = _u16(blob, 6), _u16(blob, 8), blob[10]
    pos, palette, transparency = 13, False, None
    if flags & 128:
        n = 3 << ((flags & 7) + 1)
        palette = _gif_palette_needed(blob[pos:pos + n], name)
        pos += n
    while True:  # the blocks before the first image, as `_seek(0)` reads them
        if pos >= len(blob) or blob[pos] == 0x3B:
            raise ValueError(f"{name}: no image in the GIF file")
        s, pos = blob[pos], pos + 1
        if s == 0x21:
            if pos >= len(blob):
                raise ValueError(f"{name}: truncated GIF extension")
            label, (block, pos) = blob[pos], _gif_block(blob, pos + 1)
            if label == 249 and block is not None:
                if len(block) < 3 or (block[0] & 1 and len(block) < 4):
                    raise ValueError(f"{name}: truncated GIF graphic control extension")
                if block[0] & 1:
                    transparency = block[3]
            elif label == 254:
                while block:
                    block, pos = _gif_block(blob, pos)
                continue
            elif label == 255 and block is not None and block.startswith(b"NETSCAPE2.0"):
                _, pos = _gif_block(blob, pos)
            while block:
                block, pos = _gif_block(blob, pos)
        elif s == 0x2C:
            if pos + 9 > len(blob):
                raise ValueError(f"{name}: truncated GIF image descriptor")
            x0, y0, fw, fh = struct.unpack_from("<4H", blob, pos)
            fflags, pos = blob[pos + 8], pos + 9
            if fflags & 128:
                n = 3 << ((fflags & 7) + 1)
                palette = _gif_palette_needed(blob[pos:pos + n], name)
                pos += n
            if pos >= len(blob):
                raise ValueError(f"{name}: truncated GIF image")
            bits, pos = blob[pos], pos + 1
            break
    W, H = max(w, x0 + fw), max(h, y0 + fh)
    _check_pixels(W, H, name)
    if not fw or not fh:
        raise ValueError(f"{name}: GIF image of size {fw}x{fh}")
    data = []
    while pos < len(blob) and blob[pos] and pos + 1 + blob[pos] <= len(blob):
        data.append(blob[pos + 1:pos + 1 + blob[pos]])  # whole sub-blocks only
        pos += 1 + blob[pos]
    pixels = native.gif_lzw(b"".join(data), bits, fw * fh, name)
    if pixels.size < fw * fh:
        raise ValueError(f"{name}: image file is truncated (GIF data gives {pixels.size} of "
                         f"{fw * fh} pixels)")
    rows = pixels.reshape(fh, fw)
    if fflags & 64:  # interlaced: rows 0, 8, ..., then 4, 12, ..., 2, 6, ..., 1, 3, ...
        order = np.concatenate([np.arange(s, fh, d) for s, d in ((0, 8), (4, 8), (2, 4),
                                                                 (1, 2))])
        rows = rows[np.argsort(order, kind="stable")]
    canvas = np.full((H, W), 0 if transparency is None else transparency, np.uint8)
    canvas[y0:y0 + fh, x0:x0 + fw] = rows
    return canvas


def gif_lzw_reference(data: bytes, bits: int, out_size: int) -> np.ndarray:
    """Plain version of `native.gif_lzw` (Pillow's GifDecode.c)."""
    if not 0 <= bits <= 12:
        raise ValueError(f"bad LZW minimum code size ({bits})")
    clear, out, strings = 1 << bits, bytearray(), {}
    codesize, nxt, prev, pos, acc, have = bits + 1, clear + 2, None, 0, 0, 0

    def string(c):
        return strings[c] if c > clear + 1 else bytes([c & 255])

    while len(out) < out_size:
        while have < codesize and pos < len(data):
            acc |= data[pos] << have
            pos += 1
            have += 8
        if have < codesize:
            break
        c = acc & ((1 << codesize) - 1)
        acc >>= codesize
        have -= codesize
        if c == clear:
            codesize, nxt, prev = bits + 1, clear + 2, None
            continue
        if c == clear + 1:
            break
        if prev is None:
            if c > clear:
                raise ValueError(f"corrupt LZW data (first code {c})")
            entry = string(c)
        else:
            if c > nxt:
                raise ValueError(f"corrupt LZW data (code {c} past the table)")
            entry = string(prev) + string(prev)[:1] if c == nxt else string(c)
            if nxt < 4096:
                strings[nxt] = string(prev) + entry[:1]
                if nxt == (1 << codesize) - 1 and codesize < 12:
                    codesize += 1
                nxt += 1
        out += entry
        prev = c
    return np.frombuffer(bytes(out[:out_size]), np.uint8)


# ---- VP8's inverse transforms and libwebp's YUV -> RGB ---------------------------------

def vp8_idct_reference(coeffs, prediction=None) -> np.ndarray:
    """Plain version of `native.vp8_idct`: the inverse WHT of 16 coefficients
    (-> int16 [16]) or the inverse DCT added to a uint8 [4, 4] prediction."""
    c = np.asarray(coeffs, np.int64).reshape(4, 4)
    if prediction is None:
        a0, a1 = c[0] + c[3], c[1] + c[2]
        a2, a3 = c[1] - c[2], c[0] - c[3]
        t = np.stack([a0 + a1, a3 + a2, a0 - a1, a3 - a2])  # rows 0, 1, 2, 3
        dc = t[:, 0] + 3
        b0, b1 = dc + t[:, 3], t[:, 1] + t[:, 2]
        b2, b3 = t[:, 1] - t[:, 2], dc - t[:, 3]
        return (np.stack([b0 + b1, b3 + b2, b0 - b1, b3 - b2], 1) >> 3).astype(np.int16).reshape(16)

    def wrap(v):  # the products wrap at 32 bits, as in the native routine
        return ((v + 2 ** 31) % 2 ** 32) - 2 ** 31

    def mul1(a):
        return (wrap(a * 20091) >> 16) + a

    def mul2(a):
        return wrap(a * 35468) >> 16

    def pass_(v, rounder):  # over axis 0 of v: [in0, in4, in8, in12] -> 4 outputs
        a, b = v[0] + rounder + v[2], v[0] + rounder - v[2]
        cc, d = mul2(v[1]) - mul1(v[3]), mul1(v[1]) + mul2(v[3])
        return np.stack([a + d, b + cc, b - cc, a - d])

    tmp = pass_(c, 0)                # tmp[r, col]: column col's vertical pass
    out = pass_(tmp.T, 4) >> 3       # [x, row]
    pred = np.asarray(prediction, np.int64).reshape(4, 4)
    return np.clip(pred + out.T, 0, 255).astype(np.uint8)


def yuv_to_rgba_reference(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Plain version of `native.yuv_to_rgba`: each chroma sample from the
    nearest row and column of the half-size plane (weight 9), the next
    nearest (3, 3) and the diagonal (1), as `((a + b + c + d + 8 + 2 (b +
    c)) >> 3 + a) >> 1`, the first and (even) last columns from the rows alone
    as `(3 a + c + 2) >> 2`; then libwebp's 14-bit YUV -> RGB."""
    h, w = y.shape
    uh, uw = (h + 1) // 2, (w + 1) // 2
    row = np.arange(h)
    near = row >> 1
    far = np.where(row & 1, np.minimum(near + 1, uh - 1), np.maximum(near - 1, 0))
    x = np.arange(w)
    # columns of the nearest (cn) and the other (co) chroma sample for each x
    cn = np.where(x & 1, (x - 1) >> 1, x >> 1)
    co = np.where(x & 1, cn + 1, cn - 1)
    edge = (x == 0) | ((x == w - 1) & (w % 2 == 0))

    def up(p):
        p = np.asarray(p, np.int32)[:uh, :uw]
        a, d_row = p[near][:, cn], p[far]
        b = p[near][:, np.clip(co, 0, uw - 1)]
        c, d = d_row[:, cn], d_row[:, np.clip(co, 0, uw - 1)]
        mid = (((a + b + c + d + 8 + 2 * (b + c)) >> 3) + a) >> 1
        return np.where(edge, (3 * a + c + 2) >> 2, mid)

    U, V = up(u), up(v)
    Y = (np.asarray(y, np.int32) * 19077) >> 8

    def clip(t):
        return np.where((t & ~16383) == 0, t >> 6, np.where(t < 0, 0, 255))

    rgb = [clip(Y + ((V * 26149) >> 8) - 14234),
           clip(Y - ((U * 6419) >> 8) - ((V * 13320) >> 8) + 8708),
           clip(Y + ((U * 33050) >> 8) - 17685)]
    return np.stack(rgb + [np.full_like(Y, 255)], -1).astype(np.uint8)
