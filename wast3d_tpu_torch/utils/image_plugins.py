"""The rest of the formats PIL 12 opens, read as its plugins read them.

`utils/image_io.decode_image` tries these in PIL's order (`Image.ID`);
each `decode_*` returns `np.asarray(PIL.Image.open(...))` (dtype, shape
and bytes), or None where PIL's plugin declines the file (a SyntaxError,
or an IndexError, TypeError, KeyError, EOFError or struct.error while it
opens it: PIL then goes on to its next format), and raises `ValueError`
naming the file where PIL raises (when it opens the file or when
`np.asarray` loads it).

- DIB (`BmpImagePlugin.DibImageFile`): a BMP info header of 12, 40, 52,
  56, 64, 108 or 124 bytes at the start, no file header; the pixels right
  after the header (and its bit masks and palette), through `decode_bmp`.
- BLP: BLP1 (a JPEG of the shared header and the first mipmap, turned to
  RGB as PIL's `convert` does and read back as "BGR": red and blue change
  places; or 256-colour palette indices, the pixels straight after the
  palette) and BLP2 (palette indices; DXT1, DXT3 or DXT5 by the alpha
  encoding, decoded as BlpImagePlugin's Python does: 5-6-5 colours
  without bit replication, and laid out a block row of 4 rows at a time
  across whole blocks, so a width that is not a multiple of 4 shears the
  rows as PIL's raw reader does); RGBA when the header's alpha flag says
  so, else RGB, whatever the encoding gives.
- DCX: the first page's PCX (`image_formats.decode_pcx`).
- FITS: the first HDU with an image (or a GZIP_1 tile-compressed
  BINTABLE's), BITPIX 8 ("L"), 16 ("I;16", the big-endian samples read
  little-endian as PIL does), 32 ("I", likewise), -32 ("F") and -64 ("F"
  over the first four bytes of each 8), rows bottom-up; BZERO and BSCALE
  are not applied (PIL applies neither); NAXIS 1 is one column, NAXIS 3 and
  up the first plane, NAXIS 0 no image.
- FLI / FLC: frame 1's chunks (`native.fli_decode`), palette indices.
- FTEX: DXT1 (`native.bcn_decode`, RGBA) or raw RGB of the first mipmap.
- GBR: GIMP brushes of version 1 or 2, L or RGBA.
- IM: every "Image type" of ImImagePlugin's table, rows bottom-up: bilevel,
  L, P at 2 / 4 / 8 bits, line-interleaved RGB / RGBA / RGBX / CMYK /
  YCbCr / LA / PA, pixel-interleaved RGB, the three-plane "RGB3", 16-bit
  ("I;16", "I;16L", "I;16B"), 32-bit integer, 8-32-bit integer and 32-bit
  float samples as "F" (2-31 bits through `native.bit_decode`), and a LUT
  that turns L / LA into P / PA; the header's own checks run on any bytes,
  as PIL runs them.
- IMT (IM Tools): 8-bit grey after its form feed.
- IPTC / NAA: the 8:10 records as raw L, or one band of RGB / CMYK (the
  others zero), or the image PIL opens from them (compression 5).
- McIdas areas: L, "I;16B" or "I;32B" (as "I") with the area's stride.
- MSP: version 1 raw, version 2 run lengths (`native.msp_rows`), bilevel.
- PCD: the 768 x 512 base image at 96 x 2048 (`native.pcd_decode`: PIL's
  PhotoYCC tables, chroma replicated), turned as the header's orientation
  says.
- PIXAR: RGB at offset 1024.
- SPIDER: 2D images and the first of a stack, big- or little-endian float.
- XBM: the hex bytes after `_bits[]` (`native.xbm_decode`), bilevel, least
  significant bit first.
- XPM: palette keys of 1 or more characters (`native.xpm_lookup`), P up to
  256 colours, else RGB.
- XVThumb: 8-bit 3-3-2 palette indices.

The plain versions the tests hold the native loops to are here too:
`fli_reference`, `msp_reference`, `pcd_reference`, `xbm_reference`,
`xpm_reference` and `bit_reference`.
"""

from __future__ import annotations

import gzip
import math
import re
import struct
import threading
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from wast3d_tpu_torch.utils.image_io import _check_pixels, decode_bmp


class _Declined(Exception):
    """PIL's plugin declines the file (SyntaxError and the errors Image.open
    turns into one): the next format is tried."""


# Whether the reader running in this thread is still where PIL's `_open` is.
_opening = threading.local()


def _declines(fn):
    """Run a reader, turning its `_Declined` into None, and a short read's
    struct.error or IndexError too while it opens the file (PIL's `_open`
    turns them into a SyntaxError); once `_opened` has passed, such an
    error is the file's ValueError."""
    def reader(blob: bytes, name: str = "<bytes>"):
        outer = getattr(_opening, "now", False)
        _opening.now = True
        try:
            return fn(blob, name)
        except _Declined:
            return None
        except (struct.error, IndexError) as e:
            if _opening.now:
                return None
            raise ValueError(f"{name}: broken {fn.__name__[7:].upper()} data ({e})") from None
        finally:
            _opening.now = outer
    reader.__name__, reader.__doc__ = fn.__name__, fn.__doc__
    return reader


def _truncated(name: str, what: str):
    raise ValueError(f"{name}: image file is truncated ({what})")


def _opened(w, h, mode: str, name: str) -> None:
    """ImageFile's checks once `_open` is done: a mode and a positive size
    (else PIL declines), then the decompression bomb check."""
    if not mode or not isinstance(w, (int, float)) or not isinstance(h, (int, float)):
        raise _Declined
    if w <= 0 or h <= 0:
        raise _Declined
    _opening.now = False
    if not isinstance(w, int) or not isinstance(h, int):
        raise ValueError(f"{name}: image size {w}x{h} is not whole pixels (PIL cannot make it)")
    _check_pixels(w, h, name)


# ---- Pillow's raw decoder -------------------------------------------------------------

# Bits per pixel of the raw modes read here, and np.asarray's dtype per mode.
_RAW_BITS = {"1": 1, "P;2": 2, "P;4": 4, "L": 8, "P": 8, "RGB": 24, "BGR": 24, "RGBA": 32,
             "RGB;L": 24, "LA;L": 16, "PA;L": 16, "RGBA;L": 32, "RGBX;L": 32, "CMYK;L": 32,
             "YCbCr;L": 24, "I;16": 16, "I;16L": 16, "I;16B": 16, "I;32": 32, "I;32S": 32,
             "I;32B": 32, "I": 32, "F": 32, "F;32": 32, "F;32F": 32, "F;32BF": 32, "F;8": 8,
             "F;8S": 8, "F;16": 16, "F;16S": 16, "G": 8, "R": 8, "B": 8}
_DTYPES = {"1": bool, "L": np.uint8, "P": np.uint8, "I;16": "<u2", "I;16L": "<u2",
           "I;16B": ">u2", "I": "<i4", "F": "<f4"}
_SAMPLES = {"L;": "u1", "I;16": "<u2", "I;16L": "<u2", "I;16B": ">u2", "I;32": "<i4",
            "I;32S": "<i4", "I;32B": ">u4", "I": "<i4", "F": "<f4", "F;32": "<u4",
            "F;32F": "<f4", "F;32BF": ">f4", "F;8": "u1", "F;8S": "i1", "F;16": "<u2",
            "F;16S": "<i2"}


def _shape(mode: str, h: int, w: int) -> Tuple[int, ...]:
    return (h, w) if mode in _DTYPES else (h, w, len(mode))


def _raw(blob: bytes, offset: int, mode: str, raw_mode: str, w: int, h: int, name: str,
         stride: int = 0, ystep: int = 1, out: Optional[np.ndarray] = None) -> np.ndarray:
    """Pillow's raw decoder at `offset`: rows of the raw mode's bytes (or
    `stride` bytes apart), top-down or (ystep -1) bottom-up, unpacked into
    `mode`; data that ends before the last row is PIL's "image file is
    truncated". A one-band raw mode ("R", "G", "B") fills that band of
    `out`."""
    if offset < 0:
        raise ValueError(f"{name}: tile offset {offset} cannot be negative")
    row = (w * _RAW_BITS[raw_mode] + 7) // 8
    if stride and stride < row:
        raise ValueError(f"{name}: rows {stride} bytes apart hold no row of {row} bytes "
                         "(Pillow: decoder configuration error)")
    step = stride or row
    need = (h - 1) * step + row
    if len(blob) - offset < need:
        _truncated(name, f"{max(len(blob) - offset, 0)} of {need} bytes")
    rows = np.lib.stride_tricks.as_strided(np.frombuffer(blob, np.uint8, need, offset), (h, row),
                                           (step, 1))
    if ystep < 0:
        rows = rows[::-1]
    if out is None:
        out = np.zeros(_shape(mode, h, w), _DTYPES.get(mode, np.uint8))
    if raw_mode in ("R", "G", "B"):
        out[..., "RGB".index(raw_mode)] = rows[:, :w]
    elif raw_mode in ("1", "P;2", "P;4"):
        from wast3d_tpu_torch import native

        v = native.unpack_bits(np.ascontiguousarray(rows), w, _RAW_BITS[raw_mode], name)
        out[...] = (v * np.uint8(255)).view(bool) if raw_mode == "1" else v
    elif raw_mode.endswith(";L"):  # a row of each band in turn
        bands = _RAW_BITS[raw_mode] // 8
        v = rows[:, :bands * w].reshape(h, bands, w).transpose(0, 2, 1)
        out[...] = v[..., :out.shape[2]] if out.ndim == 3 else v[..., 0]
    elif raw_mode in ("L", "P", "RGB", "RGBA"):
        out[...] = rows[:, :row].reshape(out.shape)
    elif raw_mode == "BGR":
        v = rows[:, :row].reshape(h, w, 3)[..., ::-1]
        out[..., :3] = v
        if out.shape[2] == 4:
            out[..., 3] = 255
    else:
        v = np.ascontiguousarray(rows[:, :row]).view(_SAMPLES[raw_mode]).reshape(h, w)
        out[...] = v.astype(out.dtype)
    return out


# ---- DIB -----------------------------------------------------------------------------

_DIB_HEADERS = (12, 40, 52, 56, 64, 108, 124)


def accepts_dib(blob: bytes) -> bool:
    return len(blob) >= 4 and struct.unpack_from("<I", blob)[0] in _DIB_HEADERS


@_declines
def decode_dib(blob: bytes, name: str = "<bytes>") -> Optional[np.ndarray]:
    """A DIB (a BMP without its file header) -> PIL's array: BmpImageFile's
    `_bitmap` at offset 0, the pixels where its reads of the header, the
    bit masks of a 40-byte BITFIELDS header and the palette leave off."""
    header = struct.unpack_from("<I", blob)[0]
    if len(blob) < header:
        raise ValueError(f"{name}: truncated DIB header")
    at = header
    if header == 12:
        bits, compression, colors, pad = struct.unpack_from("<H", blob, 10)[0], 0, 0, 3
    else:
        bits = struct.unpack_from("<H", blob, 14)[0]
        compression, colors = struct.unpack_from("<I", blob, 16)[0], struct.unpack_from(
            "<I", blob, 32)[0]
        pad = 4
        if compression == 3 and header < 52:
            struct.unpack_from("<III", blob, at)  # the masks; a short read declines
            at += 12
    if bits <= 8:
        at += pad * (colors or 1 << bits)
    fake = b"BM" + struct.pack("<IHHI", 14 + len(blob), 0, 0, 14 + at) + blob
    return decode_bmp(fake, name)


# ---- BLP -----------------------------------------------------------------------------

def _safe_read(blob: bytes, pos: int, n: int, name: str) -> bytes:
    """ImageFile._safe_read: nothing for n <= 0, else n bytes or an error."""
    if n <= 0:
        return b""
    if pos + n > len(blob):
        raise ValueError(f"{name}: Truncated File Read (BLP)")
    return blob[pos:pos + n]


def _unpack_565(c: np.ndarray):
    c = c.astype(np.int32)
    return ((c >> 11) & 0x1F) << 3, ((c >> 5) & 0x3F) << 2, (c & 0x1F) << 3


def _blp_dxt(data: bytes, n: int, alpha: bool, bx: int, by: int) -> np.ndarray:
    """BlpImagePlugin's decode_dxt1 / 3 / 5 on `by` rows of `bx` blocks ->
    uint8 [by, 4, bx * 4, 3 or 4] (its rows of whole blocks)."""
    size = 8 if n == 1 else 16
    b = np.frombuffer(data, np.uint8, by * bx * size).reshape(by, bx, size).astype(np.int32)
    col = b[..., 0:8] if n == 1 else b[..., 8:16]
    c0, c1 = col[..., 0] | col[..., 1] << 8, col[..., 2] | col[..., 3] << 8
    code = col[..., 4] | col[..., 5] << 8 | col[..., 6] << 16 | col[..., 7] << 24
    r0, g0, b0 = _unpack_565(c0)
    r1, g1, b1 = _unpack_565(c1)
    ctl = (code[..., None] >> (2 * np.arange(16))) & 3  # [by, bx, 16] pixel 4 j + i
    four = (c0 > c1)[..., None] if n == 1 else np.ones(c0.shape + (1,), bool)
    rgb = []
    for v0, v1 in ((r0, r1), (g0, g1), (b0, b1)):
        v0, v1 = v0[..., None], v1[..., None]
        mix2 = np.where(four, (2 * v0 + v1) // 3, (v0 + v1) // 2)
        mix3 = np.where(four, (2 * v1 + v0) // 3, 0)
        rgb.append(np.choose(ctl, [np.broadcast_to(v0, ctl.shape), np.broadcast_to(v1, ctl.shape),
                                   mix2, mix3]))
    chans = rgb
    if n == 1:
        if alpha:
            chans = rgb + [np.where(~four & (ctl == 3), 0, 255)]
    elif n == 2:
        nib = b[..., 0:8]
        a = np.stack([nib & 0xF, nib >> 4], -1).reshape(by, bx, 16)
        chans = rgb + [a * 17]
    else:
        a0, a1 = b[..., 0:1], b[..., 1:2]
        bits = sum(b[..., 2 + k].astype(np.int64) << (8 * k) for k in range(6))
        code_a = (bits[..., None] >> (3 * np.arange(16))) & 7
        interp = np.where(a0 > a1, ((8 - code_a) * a0 + (code_a - 1) * a1) // 7,
                          np.where(code_a == 6, 0, np.where(code_a == 7, 255,
                                                            ((6 - code_a) * a0 + (code_a - 1)
                                                             * a1) // 5)))
        chans = rgb + [np.where(code_a == 0, a0, np.where(code_a == 1, a1, interp))]
    px = np.stack(chans, -1).astype(np.uint8).reshape(by, bx, 4, 4, len(chans))
    return px.transpose(0, 2, 1, 3, 4).reshape(by, 4, bx * 4, len(chans))


def _jpeg_rgb(data: bytes, name: str) -> np.ndarray:
    """A JPEG opened by JpegImageFile and turned to RGB by `convert`, as BLP1
    reads its JPEG (its "CMYK" edit of the tile changes the JPEG mode, not
    the "CMYK;I" raw mode: four components come out as usual)."""
    from wast3d_tpu_torch import native
    from wast3d_tpu_torch.utils.image_io import _jpeg_walk

    _jpeg_walk(data, name)
    img = native.decode_jpeg(data, name)
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=2)
    if img.shape[2] == 3:
        return img
    cmyk = img.astype(np.int32)  # Convert.c's cmyk2rgb
    nk = 255 - cmyk[..., 3:]
    t = cmyk[..., :3] * nk + 128
    return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)


def accepts_blp(blob: bytes) -> bool:
    return blob[:4] in (b"BLP1", b"BLP2")


@_declines
def decode_blp(blob: bytes, name: str = "<bytes>") -> Optional[np.ndarray]:
    """BLP1 / BLP2 -> PIL's array (module docstring)."""
    compression = struct.unpack_from("<i", blob, 4)[0]
    if blob[:4] == b"BLP1":
        alpha = struct.unpack_from("<I", blob, 8)[0] != 0
        w, h = struct.unpack_from("<II", blob, 12)
        encoding = struct.unpack_from("<i", blob, 20)[0]
        struct.unpack_from("<I", blob, 24)
        pos = 28
    else:
        encoding, a, alpha_encoding = struct.unpack_from("<bbb", blob, 8)
        alpha = a != 0
        w, h = struct.unpack_from("<II", blob, 12)
        pos = 20
    mode = "RGBA" if alpha else "RGB"
    _opened(w, h, mode, name)
    head = _safe_read(blob, pos, 128, name)
    offsets, lengths = struct.unpack("<16I", head[:64]), struct.unpack("<16I", head[64:])
    pos += 128
    bands = len(mode)

    def palette_indices(at: int) -> np.ndarray:
        data = np.frombuffer(_safe_read(blob, at, lengths[0], name), np.uint8)
        pal = np.frombuffer(_safe_read(blob, pos, 1024, name), np.uint8).reshape(256, 4)
        return pal[data][:, [2, 1, 0, 3][:bands]].reshape(-1)

    if blob[:4] == b"BLP1":
        if compression == 0:
            n = struct.unpack("<I", _safe_read(blob, pos, 4, name))[0]
            jpeg_header = _safe_read(blob, pos + 4, n, name)
            at = max(pos + 4 + n, offsets[0]) if n > 0 else max(pos + 4, offsets[0])
            data = jpeg_header + _safe_read(blob, at, lengths[0], name)
            rgb = _jpeg_rgb(data, name)
            flat = rgb[..., ::-1]  # the RGB bytes read back as "BGR"
            if flat.shape[:2] != (h, w):
                flat = flat.reshape(-1, 3)
                if flat.shape[0] < w * h:
                    raise ValueError(f"{name}: not enough image data (BLP1 JPEG)")
                flat = flat[:w * h].reshape(h, w, 3)
            out = np.full((h, w, bands), 255, np.uint8)
            out[..., :3] = flat
            return out
        if compression != 1 or encoding not in (4, 5):
            raise ValueError(f"{name}: unsupported BLP1 compression {compression} / encoding "
                             f"{encoding}")
        flat = palette_indices(pos + 1024)
    else:
        if compression != 1 or encoding not in (1, 2):
            raise ValueError(f"{name}: unknown BLP2 compression {compression} / encoding "
                             f"{encoding}")
        _safe_read(blob, pos, 1024, name)  # the palette is read whatever the encoding
        if encoding == 1:
            flat = palette_indices(offsets[0])
        else:
            n = {0: 1, 1: 2, 7: 3}.get(alpha_encoding)
            if n is None:
                raise ValueError(f"{name}: unsupported BLP alpha encoding {alpha_encoding}")
            bx, by = (w + 3) // 4, (h + 3) // 4
            data = _safe_read(blob, offsets[0], bx * by * (8 if n == 1 else 16), name)
            flat = _blp_dxt(data, n, alpha, bx, by).reshape(-1)
    if flat.size < w * h * bands:
        raise ValueError(f"{name}: not enough image data (BLP)")
    return np.ascontiguousarray(flat[:w * h * bands].reshape(h, w, bands))


# ---- DCX -----------------------------------------------------------------------------

def accepts_dcx(blob: bytes) -> bool:
    return blob[:4] == b"\xb1\x68\xde\x3a"


@_declines
def decode_dcx(blob: bytes, name: str = "<bytes>") -> Optional[np.ndarray]:
    """The first page of a DCX: its PCX (`image_formats.decode_pcx`)."""
    from wast3d_tpu_torch.utils import image_formats

    offsets = []
    for i in range(1024):
        (off,) = struct.unpack_from("<I", blob, 4 + 4 * i)
        if not off:
            break
        offsets.append(off)
    if not offsets:
        raise _Declined
    page = blob[offsets[0]:]
    if not (page[:1] == b"\x0a" and page[1:2] in (b"\x00", b"\x02", b"\x03", b"\x05")):
        raise _Declined
    return image_formats.decode_pcx(page, name)


# ---- FITS ----------------------------------------------------------------------------

_FITS_MODES = {8: "L", 16: "I;16", 32: "I", -32: "F", -64: "F"}


def accepts_fits(blob: bytes) -> bool:
    return blob[:6] == b"SIMPLE"


@_declines
def decode_fits(blob: bytes, name: str = "<bytes>") -> Optional[np.ndarray]:
    """FITS -> PIL's array: FitsImageFile's walk over the 80-byte cards
    (the first HDU with an image, or a GZIP_1 tile-compressed table's), its
    modes, and the raw rows bottom-up."""
    headers: Dict[bytes, bytes] = {}
    pos, in_progress, found = 0, False, None
    while True:
        card = blob[pos:pos + 80]
        pos += len(card)
        if not card:
            raise ValueError(f"{name}: Truncated FITS file")
        keyword = card[:8].strip()
        if keyword in (b"SIMPLE", b"XTENSION"):
            in_progress = True
        elif headers and not in_progress:
            break
        elif keyword == b"END":
            pos = math.ceil(pos / 2880) * 2880
            if not found:
                found = _fits_parse(headers, name)
            in_progress = False
            continue
        if found:
            continue
        value = card[8:].split(b"/")[0].strip()
        if value.startswith(b"="):
            value = value[1:].strip()
        if not headers and (not keyword.startswith(b"SIMPLE") or value != b"T"):
            raise _Declined
        headers[keyword] = value
    if not found:
        raise ValueError(f"{name}: No image data (FITS)")
    decoder, offset, (w, h), mode, bits = found
    _opened(w, h, mode, name)
    offset += pos - 80
    if decoder == "raw":
        return _raw(blob, offset, mode, mode, w, h, name, ystep=-1)
    try:
        value = gzip.decompress(blob[offset:])
    except (OSError, EOFError, zlib.error) as e:
        raise ValueError(f"{name}: bad GZIP_1 FITS data ({e})") from None
    nb = min(bits // 8, 4)
    k = np.arange(w * h)[:, None] * 4 + np.arange(4 - nb, 4)[None, :] if nb > 0 else None
    v = np.frombuffer(value, np.uint8)
    rows = [] if k is None else [v[r[r < len(v)]] for r in k.reshape(h, w * nb)]
    data = np.concatenate(rows[::-1]).tobytes() if rows else b""
    need = w * h * (_RAW_BITS[mode] // 8)
    if len(data) < need:
        raise ValueError(f"{name}: not enough image data (FITS GZIP_1)")
    return _raw(data, 0, mode, mode, w, h, name)


def _fits_parse(headers: Dict[bytes, bytes], name: str):
    """FitsImageFile._parse_headers -> (decoder, offset, size, mode, BITPIX)
    or None for no image (NAXIS 0)."""
    def number(key: bytes) -> int:
        try:
            return int(headers[key])
        except ValueError:
            raise ValueError(f"{name}: FITS {key.decode(errors='replace')} = "
                             f"{headers[key]!r} is not a number") from None
        except KeyError:
            raise _Declined from None

    def size(prefix: bytes):
        naxis = number(prefix + b"NAXIS")
        if naxis == 0:
            return None
        if naxis == 1:
            return 1, number(prefix + b"NAXIS1")
        return number(prefix + b"NAXIS1"), number(prefix + b"NAXIS2")

    prefix, decoder, offset = b"", "raw", 0
    if headers.get(b"XTENSION") == b"'BINTABLE'" and headers.get(b"ZIMAGE") == b"T":
        if b"ZCMPTYPE" not in headers:
            raise ValueError(f"{name}: FITS tile-compressed table without ZCMPTYPE")
        if headers[b"ZCMPTYPE"] == b"'GZIP_1  '":
            table = size(prefix) or (0, 0)
            offset = table[0] * table[1] * (number(b"BITPIX") // 8)
            prefix, decoder = b"Z", "fits_gzip"
    wh = size(prefix)
    if not wh:
        return None
    bits = number(prefix + b"BITPIX")
    return decoder, offset, wh, _FITS_MODES.get(bits, ""), bits


# ---- FLI / FLC -----------------------------------------------------------------------

def accepts_fli(blob: bytes) -> bool:
    return (len(blob) >= 16 and blob[4:6] in (b"\x11\xaf", b"\x12\xaf")
            and struct.unpack_from("<H", blob, 14)[0] in (0, 3))


@_declines
def decode_fli(blob: bytes, name: str = "<bytes>") -> Optional[np.ndarray]:
    """FLI / FLC -> PIL's array: FliImageFile's header checks and colour
    chunks, then frame 1 at offset 128 (`native.fli_decode`)."""
    from wast3d_tpu_torch import native

    s = blob[:128]
    if not (accepts_fli(s) and s[20:22] == b"\x00" * 2 and s[42:80] == b"\x00" * 38
            and s[88:] == b"\x00" * 40):
        raise _Declined
    w, h = struct.unpack_from("<HH", s, 8)
    pos = 128
    s = blob[pos:pos + 16]
    pos += len(s)
    if struct.unpack_from("<H", s, 4)[0] == 0xF100:
        pos = 128 + struct.unpack_from("<I", s)[0]
        s = blob[pos:pos + 16]
        pos += len(s)
    if struct.unpack_from("<H", s, 4)[0] == 0xF1FA:
        chunk_size = None
        for _ in range(struct.unpack_from("<H", s, 6)[0]):
            if chunk_size is not None:
                pos += chunk_size - 6
                if pos < 0:
                    raise ValueError(f"{name}: FLI chunk sizes seek before the file's start")
            s = blob[pos:pos + 6]
            pos += len(s)
            chunk_type = struct.unpack_from("<H", s, 4)[0]
            if chunk_type in (4, 11):
                _fli_palette(blob, pos)
                break
            chunk_size = struct.unpack_from("<I", s)[0]
            if not chunk_size:
                break
    head = blob[128:132]  # seek(0), still in `_open`
    if not head:
        raise _Declined  # EOFError: missing frame size
    (size,) = struct.unpack_from("<I", head)
    _opened(w, h, "P", name)
    frame = blob[128:128 + size]
    if not frame or len(frame) < 4 or len(frame) + len(frame) % 2 < size:
        _truncated(name, "FLI frame")
    return native.fli_decode(frame, w, h, np.zeros((h, w), np.uint8), name)


def _fli_palette(blob: bytes, pos: int) -> None:
    """FliImageFile._palette's reads, for the errors they raise."""
    (count,) = struct.unpack_from("<H", blob, pos)
    pos, i = pos + 2, 0
    for _ in range(count):
        s = blob[pos:pos + 2]
        pos += len(s)
        i += s[0]
        n = s[1] or 256
        s = blob[pos:pos + 3 * n]
        pos += len(s)
        for k in range(0, len(s), 3):
            s[k + 2]
            if i >= 256:
                raise IndexError
            i += 1


def fli_reference(frame: bytes, width: int, height: int, image: np.ndarray) -> np.ndarray:
    """The plain version of `native.fli_decode` (FliDecode.c): one frame
    chunk applied to a copy of `image`."""
    im = image.copy()
    buf = np.frombuffer(frame, np.uint8)
    total = len(buf)

    def i16(at):
        return int(buf[at]) | int(buf[at + 1]) << 8

    def overrun():
        raise ValueError("FLI frame overrun")

    if total < 8:
        overrun()
    if i16(4) != 0xF1FA:
        raise ValueError("not an FLI frame chunk")
    ptr, left = 16, total - 16
    for _ in range(i16(6)):
        if left < 10:
            overrun()
        data = ptr + 6
        end = ptr + left

        def oob(n):
            if data + n > end:
                overrun()

        kind = i16(ptr + 4)
        if kind in (4, 11, 18):
            pass
        elif kind == 7:
            lines, data = i16(data), data + 2
            line = y = 0
            while line < lines and y < height:
                oob(2)
                packets, data = i16(data), data + 2
                while packets & 0x8000:
                    if packets & 0x4000:
                        y += 65536 - packets
                        if y >= height:
                            overrun()
                    else:
                        im[y, width - 1] = packets & 0xFF
                    oob(2)
                    packets, data = i16(data), data + 2
                x = p = 0
                while p < packets:
                    oob(2)
                    x += int(buf[data])
                    if buf[data + 1] >= 128:
                        oob(4)
                        n = 256 - int(buf[data + 1])
                        if x + 2 * n > width:
                            break
                        im[y, x:x + 2 * n] = np.tile(buf[data + 2:data + 4], n)
                        x, data = x + 2 * n, data + 4
                    else:
                        n = 2 * int(buf[data + 1])
                        if x + n > width:
                            break
                        oob(2 + n)
                        im[y, x:x + n] = buf[data + 2:data + 2 + n]
                        data, x = data + 2 + n, x + n
                    p += 1
                if p < packets:
                    break
                line, y = line + 1, y + 1
            if line < lines:
                overrun()
        elif kind == 12:
            y = i16(data)
            ymax = y + i16(data + 2)
            data += 4
            while y < ymax and y < height:
                oob(1)
                packets, data = int(buf[data]), data + 1
                x = p = 0
                while p < packets:
                    oob(2)
                    x += int(buf[data])
                    if buf[data + 1] & 0x80:
                        n = 256 - int(buf[data + 1])
                        if x + n > width:
                            break
                        oob(3)
                        im[y, x:x + n] = buf[data + 2]
                        data += 3
                    else:
                        n = int(buf[data + 1])
                        if x + n > width:
                            break
                        oob(2 + n)
                        im[y, x:x + n] = buf[data + 2:data + 2 + n]
                        data += n + 2
                    p, x = p + 1, x + n
                if p < packets:
                    break
                y += 1
            if y < ymax:
                overrun()
        elif kind == 13:
            im[:] = 0
        elif kind == 15:
            for y in range(height):
                data += 1
                x = 0
                while x < width:
                    oob(2)
                    if buf[data] & 0x80:
                        n = 256 - int(buf[data])
                        if x + n > width:
                            break
                        oob(n + 1)
                        im[y, x:x + n] = buf[data + 1:data + 1 + n]
                        data += n + 1
                    else:
                        n = int(buf[data])
                        if x + n > width:
                            break
                        im[y, x:x + n] = buf[data + 1]
                        data += 2
                    x += n
                if x != width:
                    overrun()
        elif kind == 16:
            if data + width * height > end:
                raise ValueError("image file is truncated (an FLI COPY chunk)")
            im[:] = buf[data:data + width * height].reshape(height, width)
        else:
            raise ValueError(f"unknown FLI chunk type {kind}")
        advance = struct.unpack_from("<i", frame, ptr)[0]
        if advance == 0:
            raise ValueError("FLI chunk of size 0")
        if advance < 0 or advance > left:
            overrun()
        ptr, left = ptr + advance, left - advance
    return im


# ---- FTEX ----------------------------------------------------------------------------

def accepts_ftex(blob: bytes) -> bool:
    return blob[:4] == b"FTEX"


@_declines
def decode_ftex(blob: bytes, name: str = "<bytes>") -> Optional[np.ndarray]:
    """FTEX -> PIL's array: the first mipmap, DXT1 as RGBA through
    `native.bcn_decode` or raw RGB."""
    from wast3d_tpu_torch import native

    w, h, _, count, fmt, where = struct.unpack_from("<6i", blob, 8)
    if count != 1:
        raise ValueError(f"{name}: FTEX of {count} formats (PIL asserts one)")
    if where < 0:
        raise ValueError(f"{name}: FTEX data offset {where} is negative")
    (size,) = struct.unpack_from("<i", blob, where)
    data = blob[where + 4:] if size < 0 else blob[where + 4:where + 4 + size]
    if fmt not in (0, 1):
        raise ValueError(f"{name}: Invalid texture compression format: {fmt}")
    _opened(w, h, "RGBA" if fmt == 0 else "RGB", name)
    if fmt == 1:
        return _raw(data, 0, "RGB", "RGB", w, h, name)
    need = ((w + 3) // 4) * ((h + 3) // 4) * 8
    if len(data) < need:
        _truncated(name, f"{len(data)} of {need} bytes of DXT1 blocks")
    return native.bcn_decode(data[:need], 1, False, w, h, name)


# ---- GBR -----------------------------------------------------------------------------

def accepts_gbr(blob: bytes) -> bool:
    return (len(blob) >= 8 and struct.unpack_from(">I", blob)[0] >= 20
            and struct.unpack_from(">I", blob, 4)[0] in (1, 2))


@_declines
def decode_gbr(blob: bytes, name: str = "<bytes>") -> Optional[np.ndarray]:
    """A GIMP brush -> PIL's array (L for depth 1, RGBA for 4)."""
    header, version, w, h, depth = struct.unpack_from(">5I", blob)
    if w == 0 or h == 0 or depth not in (1, 4):
        raise _Declined
    pos = 20
    if version == 2:
        if blob[20:24] != b"GIMP":
            raise _Declined
        struct.unpack_from(">I", blob, 24)
        pos = 28
    pos += max(header - pos, 0)
    mode = "L" if depth == 1 else "RGBA"
    _opened(w, h, mode, name)
    data = blob[pos:pos + w * h * depth]
    if len(data) < w * h * depth:
        raise ValueError(f"{name}: not enough image data (GIMP brush)")
    return _raw(data, 0, mode, mode, w, h, name)


# ---- IM ------------------------------------------------------------------------------

_IM_OPEN = {"0 1 image": ("1", "1"), "L 1 image": ("1", "1"), "Greyscale image": ("L", "L"),
            "Grayscale image": ("L", "L"), "RGB image": ("RGB", "RGB;L"),
            "RLB image": ("RGB", "RLB"), "RYB image": ("RGB", "RLB"), "B1 image": ("1", "1"),
            "B2 image": ("P", "P;2"), "B4 image": ("P", "P;4"), "X 24 image": ("RGB", "RGB"),
            "L 32 S image": ("I", "I;32"), "L 32 F image": ("F", "F;32"),
            "RGB3 image": ("RGB", "RGB;T"), "RYB3 image": ("RGB", "RYB;T"),
            "LA image": ("LA", "LA;L"), "PA image": ("LA", "PA;L"),
            "RGBA image": ("RGBA", "RGBA;L"), "RGBX image": ("RGB", "RGBX;L"),
            "CMYK image": ("CMYK", "CMYK;L"), "YCC image": ("YCbCr", "YCbCr;L")}
for _i in ("8", "8S", "16", "16S", "32", "32F"):
    _IM_OPEN[f"L {_i} image"] = _IM_OPEN[f"L*{_i} image"] = ("F", f"F;{_i}")
for _i in ("16", "16L", "16B"):
    _IM_OPEN[f"L {_i} image"] = _IM_OPEN[f"L*{_i} image"] = (f"I;{_i}", f"I;{_i}")
_IM_OPEN["L 32S image"] = _IM_OPEN["L*32S image"] = ("I", "I;32S")
for _j in range(2, 33):
    _IM_OPEN[f"L*{_j} image"] = ("F", f"F;{_j}")
_IM_SPLIT = re.compile(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$")
_IM_TAGS = ("Comment", "Date", "Digitalization equipment", "File size (no of images)", "Lut",
            "Name", "Scale (x,y)", "Image size (x*y)", "Image type")
# The (mode, raw mode) pairs Pillow has an unpacker for, of those IM can ask.
_IM_UNPACKERS = {("1", "1"), ("L", "L"), ("P", "P"), ("RGB", "RGB;L"), ("P", "P;2"),
                 ("P", "P;4"), ("RGB", "RGB"), ("I", "I;32"), ("F", "F;32"), ("LA", "LA;L"),
                 ("PA", "PA;L"), ("RGBA", "RGBA;L"), ("RGB", "RGBX;L"), ("CMYK", "CMYK;L"),
                 ("YCbCr", "YCbCr;L"), ("F", "F;8"), ("F", "F;8S"), ("F", "F;16"),
                 ("F", "F;16S"), ("F", "F;32F"), ("I;16", "I;16"), ("I;16L", "I;16L"),
                 ("I;16B", "I;16B"), ("I", "I;32S"), ("P", "P")}


def _im_number(s: str):
    try:
        return int(s)
    except ValueError:
        return float(s)


@_declines
def decode_im(blob: bytes, name: str = "<bytes>") -> Optional[np.ndarray]:
    """IM -> PIL's array: ImImageFile's header lines (tried on any bytes),
    its modes and raw modes, a LUT's palette, rows bottom-up."""
    from wast3d_tpu_torch import native

    if b"\n" not in blob[:100]:
        raise _Declined
    info = {"Image type": "L", "Image size (x*y)": (512, 512)}
    raw_mode, n, pos = "L", 0, 0
    while True:
        s = blob[pos:pos + 1]
        pos += len(s)
        if s == b"\r":
            continue
        if not s or s in (b"\0", b"\x1a"):
            break
        end = blob.find(b"\n", pos)
        end = len(blob) if end < 0 else end + 1
        s, pos = s + blob[pos:end], end
        if len(s) > 100:
            raise _Declined
        s = s[:-2] if s.endswith(b"\r\n") else s[:-1] if s.endswith(b"\n") else s
        m = _IM_SPLIT.match(s)
        if not m:
            raise _Declined
        k, v = (g.decode("latin-1", "replace") for g in m.group(1, 2))
        if k in ("File size (no of images)", "Scale (x,y)", "Image size (x*y)"):
            try:
                v = tuple(map(_im_number, v.replace("*", ",").split(",")))
            except ValueError:
                raise ValueError(f"{name}: IM header {k}: {v} is not a number") from None
            if len(v) == 1:
                v = v[0]
        elif k == "Image type" and v in _IM_OPEN:
            v, raw_mode = _IM_OPEN[v]
        info[k] = v
        if k in _IM_TAGS:
            n += 1
    if not n:
        raise _Declined
    size, mode = info["Image size (x*y)"], info["Image type"]
    while s and not s.startswith(b"\x1a"):
        s = blob[pos:pos + 1]
        pos += len(s)
    if not s:
        raise _Declined  # "File truncated"
    if "Lut" in info:
        palette = blob[pos:pos + 768]
        pos += len(palette)
        grey = all(palette[i] == palette[i + 256] == palette[i + 512] for i in range(256))
        if mode in ("L", "LA", "P", "PA") and not grey:
            mode, raw_mode = ("P", "P") if mode in ("L", "P") else ("PA", "PA;L")
    if not isinstance(size, tuple):
        raise _Declined  # size[0] of a number: TypeError
    if len(size) != 2:
        raise ValueError(f"{name}: IM image size {size} is not two numbers")
    w, h = size
    _opened(w, h, mode, name)
    if raw_mode.startswith("F;") and raw_mode[2:].isdigit() and int(raw_mode[2:]) not in (8, 16,
                                                                                          32):
        if mode != "F":
            raise ValueError(f"{name}: IM samples of {raw_mode[2:]} bits in mode {mode}")
        return native.bit_decode(blob[pos:], int(raw_mode[2:]), w, h, name=name)
    if raw_mode in ("RGB;T", "RYB;T"):
        if mode != "RGB":
            raise ValueError(f"{name}: IM mode {mode} with three planes")
        out = np.zeros((h, w, 3), np.uint8)
        for k, band in enumerate("GRB"):  # three planes, read in offset order
            _raw(blob, pos + k * w * h, mode, band, w, h, name, ystep=-1, out=out)
        return out
    if (mode, raw_mode) not in _IM_UNPACKERS:
        raise ValueError(f"{name}: IM image type {info['Image type']!r} (mode {mode}, raw mode "
                         f"{raw_mode}) is not something PIL decodes")
    if mode == "YCbCr":
        out = np.zeros((h, w, 3), np.uint8)
        return _raw(blob, pos, mode, raw_mode, w, h, name, ystep=-1, out=out)
    if mode == "PA":
        out = np.zeros((h, w, 2), np.uint8)
        return _raw(blob, pos, mode, raw_mode, w, h, name, ystep=-1, out=out)
    return _raw(blob, pos, mode, raw_mode, w, h, name, ystep=-1)


def bit_reference(data: bytes, bits: int, width: int, height: int, pad: int = 8, fill: int = 3,
                  sign: int = 0, ystep: int = -1) -> np.ndarray:
    """The plain version of `native.bit_decode` (BitDecode.c)."""
    out = np.zeros((height, width), np.float32)
    mask = (1 << bits) - 1
    buffer = count = x = 0
    y = height - 1 if ystep < 0 else 0
    for byte in data:
        if fill & 1:
            buffer |= byte << count
        else:
            buffer = (buffer << 8 | byte) & (2 ** 64 - 1)
        count += 8
        while count >= bits:
            if fill & 2:
                v = buffer & mask
                buffer = byte >> (8 - (count - bits)) if count > 32 else buffer >> bits
            else:
                v = (buffer >> (count - bits)) & mask
            count -= bits
            if sign and v & (1 << (bits - 1)):
                v -= 1 << bits
            out[y, x] = v
            x += 1
            if x >= width:
                y += -1 if ystep < 0 else 1
                if y < 0 or y >= height:
                    return out
                x = 0
                if pad > 0:
                    count = 0
    raise ValueError("image file is truncated (IM samples end early)")


# ---- IMT -----------------------------------------------------------------------------

_IMT_FIELD = re.compile(rb"([a-z]*) ([^ \r\n]*)")


@_declines
def decode_imt(blob: bytes, name: str = "<bytes>") -> Optional[np.ndarray]:
    """IM Tools -> PIL's array: ImtImageFile's header (tried on any bytes),
    8-bit grey after the form feed."""
    buffer, pos = blob[:100], min(100, len(blob))
    if b"\n" not in buffer:
        raise _Declined
    w = h = 0
    size, mode, offset = (0, 0), "", None
    while True:
        if buffer:
            s, buffer = buffer[:1], buffer[1:]
        else:
            s = blob[pos:pos + 1]
            pos += len(s)
        if not s:
            break
        if s == b"\x0c":
            offset = pos - len(buffer)
            break
        if b"\n" not in buffer:
            more = blob[pos:pos + 100]
            buffer, pos = buffer + more, pos + len(more)
        lines = buffer.split(b"\n")
        s += lines.pop(0)
        buffer = b"\n".join(lines)
        if len(s) == 1 or len(s) > 100:
            break
        if s[0] == ord("*"):
            continue
        m = _IMT_FIELD.match(s)
        if not m:
            break
        k, v = m.group(1, 2)
        if k in (b"width", b"height"):
            try:
                v = int(v)
            except ValueError:
                raise ValueError(f"{name}: IM Tools {k.decode()} {v!r} is not a number") from None
            w, h = (v, h) if k == b"width" else (w, v)
            size = w, h
        elif k == b"pixel" and v == b"n8":
            mode = "L"
    _opened(size[0], size[1], mode, name)
    if offset is None:
        raise ValueError(f"{name}: cannot load this image (IM Tools without data)")
    return _raw(blob, offset, "L", "L", size[0], size[1], name)


# ---- IPTC ----------------------------------------------------------------------------

def _iptc_field(blob: bytes, pos: int, name: str):
    """IptcImageFile.field: (tag or None, data size, position after)."""
    s = blob[pos:pos + 5]
    pos += len(s)
    if not s.strip(b"\x00"):
        return None, 0, pos
    tag = s[1], s[2]
    if s[0] != 0x1C or tag[0] not in (1, 2, 3, 4, 5, 6, 7, 8, 9, 240):
        raise _Declined
    size = s[3]
    if size > 132:
        raise ValueError(f"{name}: illegal field length in IPTC/NAA file")
    if size == 128:
        size = 0
    elif size > 128:
        ext = blob[pos:pos + size - 128]
        pos += len(ext)
        size = _iptc_int(ext)
    else:
        size = struct.unpack_from(">H", s, 3)[0]
    return tag, size, pos


def _iptc_int(c) -> int:
    if not isinstance(c, bytes):
        raise TypeError
    return struct.unpack(">I", (b"\0\0\0\0" + c)[-4:])[0]


@_declines
def decode_iptc(blob: bytes, name: str = "<bytes>") -> Optional[np.ndarray]:
    """IPTC / NAA -> PIL's array: IptcImageFile's records (tried on any
    bytes), then its load: the 8:10 records' data as an 8-bit PGM (raw) or
    as the file PIL opens from them, one band of RGB / CMYK."""
    from wast3d_tpu_torch.utils import image_io

    info: Dict = {}
    pos = 0
    try:
        while True:
            offset = pos
            tag, size, pos = _iptc_field(blob, pos, name)
            if not tag or tag == (8, 10):
                break
            data = blob[pos:pos + size] if size else None
            pos += len(data) if data else 0
            if tag in info:
                info[tag] = (info[tag] if isinstance(info[tag], list) else [info[tag]]) + [data]
            else:
                info[tag] = data
        layers, component = info[(3, 60)][0], info[(3, 60)][1]
        mode, band = "", None
        if layers == 1 and not component:
            mode = "L"
        else:
            if layers == 3 and component:
                mode = "RGB"
            elif layers == 4 and component:
                mode = "CMYK"
            band = info[(3, 65)][0] - 1 if (3, 65) in info else 0
        w, h = _iptc_int(info[(3, 20)]), _iptc_int(info[(3, 30)])
        try:
            compression = {1: "raw", 5: "jpeg"}[_iptc_int(info[(3, 120)])]
        except (KeyError, TypeError):
            raise ValueError(f"{name}: Unknown IPTC image compression") from None
    except (KeyError, TypeError):
        raise _Declined from None
    _opened(w, h, mode, name)
    if tag != (8, 10):
        raise ValueError(f"{name}: cannot load this image (IPTC without 8:10 records)")
    data, pos = b"", offset
    while True:
        try:
            kind, size, pos = _iptc_field(blob, pos, name)
        except _Declined:  # once opened, PIL's SyntaxError is an error
            raise ValueError(f"{name}: invalid IPTC/NAA record after the image data") from None
        if kind != (8, 10):
            break
        chunk = blob[pos:pos + size]
        data, pos = data + chunk, pos + len(chunk)
    if compression == "raw":
        img = image_io.decode_pnm(b"P5\n%d %d\n255\n" % (w, h) + data, name)
    else:
        img = image_io.decode_image(data, name)
    if band is None:
        if img.shape != (h, w) or img.dtype != np.uint8:
            raise ValueError(f"{name}: IPTC image of shape {img.shape} in an L file of {w}x{h}")
        return img
    bands = len(mode)
    if not -bands <= band < bands:
        raise ValueError(f"{name}: IPTC band {band + 1} of a {mode} image")
    if img.ndim != 2 or img.dtype != np.uint8:
        raise ValueError(f"{name}: IPTC band of shape {img.shape} (PIL: mode mismatch)")
    if img.shape != (h, w):
        raise ValueError(f"{name}: IPTC band of {img.shape[1]}x{img.shape[0]} in a {w}x{h} "
                         "file")
    out = np.zeros((h, w, bands), np.uint8)
    out[..., band] = img
    return out


# ---- McIdas --------------------------------------------------------------------------

def accepts_mcidas(blob: bytes) -> bool:
    return blob[:8] == b"\x00\x00\x00\x00\x00\x00\x00\x04"


@_declines
def decode_mcidas(blob: bytes, name: str = "<bytes>") -> Optional[np.ndarray]:
    """A McIdas area -> PIL's array: L, I;16B or I (from I;32B), rows
    `w[15] + w[10] w[11] w[14]` bytes apart from `w[34] + w[15]`."""
    if len(blob) < 256:
        raise _Declined
    w = (0,) + struct.unpack_from(">64i", blob)
    if w[11] not in (1, 2, 4):
        raise _Declined
    mode, raw_mode = {1: ("L", "L"), 2: ("I;16B", "I;16B"), 4: ("I", "I;32B")}[w[11]]
    width, height = w[10], w[9]
    _opened(width, height, mode, name)
    stride = w[15] + w[10] * w[11] * w[14]
    if stride < 0:
        raise ValueError(f"{name}: McIdas rows {stride} bytes apart")
    return _raw(blob, w[34] + w[15], mode, raw_mode, width, height, name, stride=stride)


# ---- MSP -----------------------------------------------------------------------------

def accepts_msp(blob: bytes) -> bool:
    return blob[:4] in (b"DanM", b"LinS")


@_declines
def decode_msp(blob: bytes, name: str = "<bytes>") -> Optional[np.ndarray]:
    """Windows Paint -> PIL's array (bilevel): version 1 raw, version 2's
    row map and runs (`native.msp_rows`)."""
    from wast3d_tpu_torch import native

    s = blob[:32]
    if len(s) < 32:
        raise _Declined
    words = np.frombuffer(s, "<u2")
    if np.bitwise_xor.reduce(words) != 0:
        raise _Declined  # bad checksum
    w, h = int(words[2]), int(words[3])
    _opened(w, h, "1", name)
    if s[:4] == b"DanM":
        return _raw(blob, 32, "1", "1", w, h, name)
    rowmap = blob[32:32 + 2 * h]
    if len(rowmap) < 2 * h:
        raise ValueError(f"{name}: Truncated MSP file in row map")
    need = (w + 7) // 8 * h
    data, made = native.msp_rows(blob[32 + 2 * h:], np.frombuffer(rowmap, "<u2"), w, need, name)
    if made < need:
        raise ValueError(f"{name}: not enough image data (MSP)")
    return _raw(data.tobytes(), 0, "1", "1", w, h, name)


def msp_reference(data: bytes, rowmap: np.ndarray, width: int, cap: int) -> Tuple[np.ndarray, int]:
    """The plain version of `native.msp_rows` (MspDecoder's loop)."""
    out, pos = bytearray(), 0
    for x, length in enumerate(int(v) for v in rowmap):
        if length == 0:
            out += b"\xff" * ((width + 7) // 8)
            continue
        row = data[pos:pos + length]
        pos += length
        if len(row) != length:
            raise ValueError(f"Truncated MSP file, expected {length} bytes on row {x}")
        i = 0
        while i < length:
            kind, i = row[i], i + 1
            if kind == 0:
                if i + 2 > length:
                    raise ValueError(f"Corrupted MSP file in row {x}")
                out += bytes(row[i + 1:i + 2]) * row[i]
                i += 2
            else:
                out += row[i:i + kind]
                i += kind
    return np.frombuffer(bytes(out[:cap]), np.uint8), len(out)


# ---- PCD -----------------------------------------------------------------------------

# Pillow's PhotoYCC unpacker ("YCC;P", UnpackYCC.c) as int16 [5, 256]: L[y],
# CR[c2], CB[c1], GR[c2], GB[c1]; R = L + CR, G = L + GR + GB, B = L + CB,
# each clamped. Read out of PIL 12.1.0's unpacker, which takes every
# (y, c1, c2).
PCD_TABLES = np.frombuffer(bytes.fromhex("".join((
    "00000100030004000500070008000a000b000c000e000f0010001200130014001600170018001a001b001d001e001f00",
    "21002200230025002600270029002a002b002d002e00300031003200340035003600380039003a003c003d003e004000",
    "41004300440045004700480049004b004c004d004f0050005200530054005600570058005a005b005c005e005f006000",
    "6200630065006600670069006a006b006d006e006f0071007200730075007600780079007a007c007d007e0080008100",
    "8200840085008600880089008b008c008d008f00900091009300940095009700980099009b009c009e009f00a000a200",
    "a300a400a600a700a800aa00ab00ad00ae00af00b100b200b300b500b600b700b900ba00bb00bd00be00c000c100c200",
    "c400c500c600c800c900ca00cc00cd00ce00d000d100d300d400d500d700d800d900db00dc00dd00df00e000e100e300",
    "e400e600e700e800ea00eb00ec00ee00ef00f000f200f300f500f600f700f900fa00fb00fd00fe00ff00010102010301",
    "05010601080109010a010c010d010e01100111011201140115011601180119011b011c011d011f012001210123012401",
    "25012701280129012b012c012e012f0130013201330134013601370138013a013b013d013e013f014101420143014501",
    "4601470149014a014b014d014e01500151015201540155015601580159015a0107ff09ff0bff0dff0fff11ff12ff14ff",
    "16ff18ff1aff1bff1dff1fff21ff23ff25ff26ff28ff2aff2cff2eff30ff31ff33ff35ff37ff39ff3aff3cff3eff40ff",
    "42ff44ff45ff47ff49ff4bff4dff4eff50ff52ff54ff56ff58ff59ff5bff5dff5fff61ff63ff64ff66ff68ff6aff6cff",
    "6dff6fff71ff73ff75ff77ff78ff7aff7cff7eff80ff81ff83ff85ff87ff89ff8bff8cff8eff90ff92ff94ff96ff97ff",
    "99ff9bff9dff9fffa0ffa2ffa4ffa6ffa8ffaaffabffadffafffb1ffb3ffb4ffb6ffb8ffbaffbcffbeffbfffc1ffc3ff",
    "c5ffc7ffc9ffcaffccffceffd0ffd2ffd3ffd5ffd7ffd9ffdbffddffdeffe0ffe2ffe4ffe6ffe7ffe9ffebffedffefff",
    "f1fff2fff4fff6fff8fffafffcfffdffffff0000020004000500070009000b000d000f00100012001400160018001a00",
    "1b001d001f00210023002400260028002a002c002e002f00310033003500370038003a003c003e004000420043004500",
    "470049004b004d004e005000520054005600570059005b005d005f00610062006400660068006a006b006d006f007100",
    "73007500760078007a007c007e008000810083008500870089008a008c008e009000920094009500970099009b009d00",
    "9e00a000a200a400a600a800a900ab00ad00af00b100b300b400b600b800ba00bc00bd00bf00c100c300c500c700c800",
    "ca00cc00ce00d000d100d300d500d700a7fea9feabfeaefeb0feb2feb4feb7feb9febbfebdfebffec2fec4fec6fec8fe",
    "cafecdfecffed1fed3fed6fed8fedafedcfedefee1fee3fee5fee7feeafeecfeeefef0fef2fef5fef7fef9fefbfefefe",
    "00ff02ff04ff06ff09ff0bff0dff0fff11ff14ff16ff18ff1aff1dff1fff21ff23ff25ff28ff2aff2cff2eff31ff33ff",
    "35ff37ff39ff3cff3eff40ff42ff44ff47ff49ff4bff4dff50ff52ff54ff56ff58ff5bff5dff5fff61ff64ff66ff68ff",
    "6aff6cff6fff71ff73ff75ff77ff7aff7cff7eff80ff83ff85ff87ff89ff8bff8eff90ff92ff94ff97ff99ff9bff9dff",
    "9fffa2ffa4ffa6ffa8ffabffadffafffb1ffb3ffb6ffb8ffbaffbcffbeffc1ffc3ffc5ffc7ffcaffccffceffd0ffd2ff",
    "d5ffd7ffd9ffdbffdeffe0ffe2ffe4ffe6ffe9ffebffedffeffff1fff4fff6fff8fffafffdffffff0000020004000700",
    "09000b000d00100012001400160018001b001d001f0021002300260028002a002c002f0031003300350037003a003c00",
    "3e00400043004500470049004b004e00500052005400560059005b005d005f0062006400660068006a006d006f007100",
    "7300760078007a007c007e0081008300850087008a008c008e00900092009500970099009b009d00a000a200a400a600",
    "a900ab00ad00af00b100b400b600b800ba00bd00bf00c100c300c500c800ca00cc00ce00d000d300d500d700d900dc00",
    "7f007e007d007c007b007a00790079007800770076007500740073007200710070006f006e006d006c006c006b006a00",
    "69006800670066006500640063006200610060005f005f005e005d005c005b005a005900580057005600550054005300",
    "53005200510050004f004e004d004c004b004a00490048004700460046004500440043004200410040003f003e003d00",
    "3c003b003a00390039003800370036003500340033003200310030002f002e002d002d002c002b002a00290028002700",
    "260025002400230022002100200020001f001e001d001c001b001a001900180017001600150014001300130012001100",
    "10000f000e000d000c000b000a00090008000700060006000500040003000200010000000000fffffefffdfffcfffbff",
    "fbfffafff9fff8fff7fff6fff5fff4fff3fff2fff1fff0ffefffeeffeeffedffecffebffeaffe9ffe8ffe7ffe6ffe5ff",
    "e4ffe3ffe2ffe1ffe1ffe0ffdfffdeffddffdcffdbffdaffd9ffd8ffd7ffd6ffd5ffd4ffd4ffd3ffd2ffd1ffd0ffcfff",
    "ceffcdffccffcbffcaffc9ffc8ffc8ffc7ffc6ffc5ffc4ffc3ffc2ffc1ffc0ffbfffbeffbdffbcffbbffbbffbaffb9ff",
    "b8ffb7ffb6ffb5ffb4ffb3ffb2ffb1ffb0ffafffaeffaeffadffacffabffaaffa9ffa8ffa7ffa6ffa5ffa4ffa3ffa2ff",
    "a2ffa1ffa0ff9fff9eff9dff9cff9bff9aff99ff98ff97ff96ff95ff95ff94ff43004300420042004100410041004000",
    "40003f003f003e003e003e003d003d003c003c003b003b003b003a003a00390039003800380038003700370036003600",
    "350035003400340034003300330032003200310031003100300030002f002f002e002e002e002d002d002c002c002b00",
    "2b002b002a002a0029002900280028002800270027002600260025002500250024002400230023002200220022002100",
    "2100200020001f001f001f001e001e001d001d001c001c001c001b001b001a001a001900190019001800180017001700",
    "16001600160015001500140014001300130013001200120011001100100010000f000f000f000e000e000d000d000c00",
    "0c000c000b000b000a000a00090009000900080008000700070006000600060005000500040004000300030003000200",
    "02000100010000000000000000000000fffffffffefffefffefffdfffdfffcfffcfffbfffbfffbfffafffafff9fff9ff",
    "f8fff8fff8fff7fff7fff6fff6fff5fff5fff5fff4fff4fff3fff3fff2fff2fff2fff1fff1fff0fff0ffefffefffeeff",
    "eeffeeffedffedffecffecffebffebffebffeaffeaffe9ffe9ffe8ffe8ffe8ffe7ffe7ffe6ffe6ffe5ffe5ffe5ffe4ff",
    "e4ffe3ffe3ffe2ffe2ffe2ffe1ffe1ffe0ffe0ffdfffdfffdfffdeffdeffddffddffdcffdcffdcffdbffdbffdaffdaff",
    "d9ffd9ffd9ffd8ffd8ffd7ffd7ffd6ff",
))), "<i2").reshape(5, 256)


def accepts_pcd(blob: bytes) -> bool:
    return blob[2048:2052] == b"PCD_"


@_declines
def decode_pcd(blob: bytes, name: str = "<bytes>") -> Optional[np.ndarray]:
    """A PhotoCD file's 768 x 512 base image -> PIL's array (RGB), turned by
    90 or 270 degrees as the header's orientation bits say."""
    from wast3d_tpu_torch import native

    if not accepts_pcd(blob):
        raise _Declined
    orientation = blob[2048 + 1538] & 3
    _opened(768, 512, "RGB", name)
    out = native.pcd_decode(blob[96 * 2048:], PCD_TABLES, name)
    if orientation in (1, 3):
        return np.ascontiguousarray(np.rot90(out, 1 if orientation == 1 else 3))
    return out


def pcd_reference(data: bytes, tables: np.ndarray = PCD_TABLES) -> np.ndarray:
    """The plain version of `native.pcd_decode` (PcdDecode.c and the
    "YCC;P" unpacker)."""
    w, h = 768, 512
    if len(data) < 3 * w * h // 2:
        raise ValueError("image file is truncated (PhotoCD base image)")
    pairs = np.frombuffer(data, np.uint8, 3 * w * h // 2).reshape(h // 2, 3 * w)
    y = pairs[:, :2 * w].reshape(h, w).astype(np.int32)
    c1 = np.repeat(np.repeat(pairs[:, 2 * w:2 * w + w // 2], 2, 0), 2, 1).astype(np.int32)
    c2 = np.repeat(np.repeat(pairs[:, 2 * w + w // 2:], 2, 0), 2, 1).astype(np.int32)
    t = tables.astype(np.int32)
    lum = t[0][y]
    rgb = np.stack([lum + t[1][c2], lum + t[3][c2] + t[4][c1], lum + t[2][c1]], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


# ---- PIXAR ---------------------------------------------------------------------------

def accepts_pixar(blob: bytes) -> bool:
    return blob[:4] == b"\x80\xe8\x00\x00"


@_declines
def decode_pixar(blob: bytes, name: str = "<bytes>") -> Optional[np.ndarray]:
    """A PIXAR raster -> PIL's array: RGB at offset 1024 (mode 14, 2)."""
    s = blob[:512]
    h, w = struct.unpack_from("<HH", s, 416)
    mode = "RGB" if struct.unpack_from("<HH", s, 424) == (14, 2) else ""
    _opened(w, h, mode, name)
    return _raw(blob, 1024, "RGB", "RGB", w, h, name)


# ---- SPIDER --------------------------------------------------------------------------

def _spider_header(t) -> int:
    """isSpiderHeader: the header's byte length, or 0."""
    h = (99,) + t
    for i in (1, 2, 5, 12, 13, 22, 23):
        if not math.isfinite(h[i]) or h[i] != int(h[i]):
            return 0
    if int(h[5]) not in (1, 3, -11, -12, -21, -22):
        return 0
    labrec, labbyt, lenbyt = int(h[13]), int(h[22]), int(h[23])
    return labbyt if labbyt == labrec * lenbyt else 0


@_declines
def decode_spider(blob: bytes, name: str = "<bytes>") -> Optional[np.ndarray]:
    """A SPIDER image -> PIL's array (F): SpiderImageFile's header test
    (big-endian first, tried on any bytes), a 2D image or the first of a
    stack."""
    f = blob[:108]
    if len(f) < 108:
        raise _Declined
    for bo in (">", "<"):
        t = struct.unpack(bo + "27f", f)
        hdrlen = _spider_header(t)
        if hdrlen:
            break
    else:
        raise _Declined
    h = (99,) + t
    if int(h[5]) != 1:
        raise _Declined
    size = int(h[12]), int(h[2])
    istack, number = int(h[24]), int(h[27])
    if istack == 0 and number == 0:
        offset = hdrlen
    elif istack > 0 and number == 0:
        offset = hdrlen * 2
    elif istack == 0 and number > 0:
        raise ValueError(f"{name}: SPIDER image number {number} outside a stack (PIL: "
                         "AttributeError)")
    else:
        raise _Declined  # inconsistent stack header values
    _opened(size[0], size[1], "F", name)
    return _raw(blob, offset, "F", "F;32BF" if bo == ">" else "F;32F", size[0], size[1], name)


# ---- XBM -----------------------------------------------------------------------------

_XBM_HEAD = re.compile(
    rb"\s*#define[ \t]+.*_width[ \t]+(?P<width>[0-9]+)[\r\n]+"
    b"#define[ \t]+.*_height[ \t]+(?P<height>[0-9]+)[\r\n]+"
    b"(?P<hotspot>"
    b"#define[ \t]+[^_]*_x_hot[ \t]+(?P<xhot>[0-9]+)[\r\n]+"
    b"#define[ \t]+[^_]*_y_hot[ \t]+(?P<yhot>[0-9]+)[\r\n]+"
    b")?"
    rb"[\000-\377]*_bits\[]")


def accepts_xbm(blob: bytes) -> bool:
    return blob.lstrip().startswith(b"#define")


@_declines
def decode_xbm(blob: bytes, name: str = "<bytes>") -> Optional[np.ndarray]:
    """X11 bitmap -> PIL's array (bilevel, least significant bit first):
    the header within the first 512 bytes, then `native.xbm_decode`."""
    from wast3d_tpu_torch import native

    m = _XBM_HEAD.match(blob[:512])
    if not m:
        raise _Declined
    w, h = int(m.group("width")), int(m.group("height"))
    _opened(w, h, "1", name)
    rows = native.xbm_decode(blob[m.end():], w, h, name)
    return (np.unpackbits(rows, axis=1, bitorder="little")[:, :w] * np.uint8(255)).view(bool)


def xbm_reference(data: bytes, width: int, height: int) -> np.ndarray:
    """The plain version of `native.xbm_decode` (XbmDecode.c)."""
    digits = {c: int(chr(c), 16) for c in b"0123456789abcdefABCDEF"}
    n = (width + 7) // 8 * height
    out, p = [], 0
    while len(out) < n:
        p = data.find(b"x", p)
        if p < 0 or len(data) - p < 3:
            raise ValueError("image file is truncated (XBM data ends early)")
        out.append(digits.get(data[p + 1], 0) << 4 | digits.get(data[p + 2], 0))
        p += 3
    return np.array(out, np.uint8).reshape(height, (width + 7) // 8)


# ---- XPM -----------------------------------------------------------------------------

_XPM_HEAD = re.compile(b'"([0-9]*) ([0-9]*) ([0-9]*) ([0-9]*)')


def accepts_xpm(blob: bytes) -> bool:
    return blob[:9] == b"/* XPM */"


def _readline(blob: bytes, pos: int) -> Tuple[bytes, int]:
    end = blob.find(b"\n", pos)
    end = len(blob) if end < 0 else end + 1
    return blob[pos:end], end


@_declines
def decode_xpm(blob: bytes, name: str = "<bytes>") -> Optional[np.ndarray]:
    """X11 pixmap -> PIL's array: XpmImageFile's header and palette lines,
    then XpmDecoder's pixel lines (`native.xpm_lookup`); P for up to 256
    colours, else RGB."""
    from wast3d_tpu_torch import native

    pos = 9
    while True:
        line, pos = _readline(blob, pos)
        if not line:
            raise _Declined
        m = _XPM_HEAD.match(line)
        if m:
            break
    try:
        w, h, colours, bpp = (int(g) for g in m.groups())
    except ValueError:
        raise ValueError(f"{name}: XPM header {line!r} is not four numbers") from None
    palette: Dict[bytes, bytes] = {}
    for _ in range(colours):
        line, pos = _readline(blob, pos)
        line = line.rstrip()
        c, s = line[1:bpp + 1], line[bpp + 1:-2].split()
        for i in range(0, len(s), 2):
            if s[i] == b"c":
                rgb = s[i + 1]
                if rgb == b"None":
                    pass
                elif rgb.startswith(b"#"):
                    try:
                        v = int(rgb[1:], 16)
                    except ValueError:
                        raise ValueError(f"{name}: XPM colour {rgb!r}") from None
                    palette[c] = bytes([(v >> 16) & 255, (v >> 8) & 255, v & 255])
                else:
                    raise ValueError(f"{name}: cannot read this XPM file (colour {rgb!r})")
                break
        else:
            raise ValueError(f"{name}: cannot read this XPM file (a palette line without c)")
    mode = "RGB" if colours > 256 else "P"
    _opened(w, h, mode, name)
    data, ends, header = [], [], False
    for line in _lines(blob[pos:]):
        if line.rstrip() == b"/* pixels */" and not header:
            header = True
            continue
        data.append(b'"'.join(line.split(b'"')[1:-1]))
    text = b"".join(data)
    ends = np.cumsum([len(d) for d in data], dtype=np.int64)
    keys = list(palette)
    index, made = native.xpm_lookup(text, ends, bpp, keys, w * h, name) if bpp > 0 else (
        np.zeros(0, np.int32), 0)
    if made < w * h:
        raise ValueError(f"{name}: not enough image data (XPM)")
    if mode == "P":
        return index.astype(np.uint8).reshape(h, w)
    colours_rgb = np.frombuffer(b"".join(palette.values()), np.uint8).reshape(-1, 3)
    return colours_rgb[index].reshape(h, w, 3)


def _lines(data: bytes) -> List[bytes]:
    """`readline` over `data`: lines with their newline, the last one
    without."""
    out = data.split(b"\n")
    return [x + b"\n" for x in out[:-1]] + ([out[-1]] if out[-1] else [])


def xpm_reference(data: bytes, ends: np.ndarray, bpp: int, keys, pixels: int
                  ) -> Tuple[np.ndarray, int]:
    """The plain version of `native.xpm_lookup` (XpmDecoder's loop)."""
    index = {k: i for i, k in reversed(list(enumerate(keys)))}
    out, start = [], 0
    for end in (int(e) for e in ends):
        if len(out) >= pixels:
            break
        line = data[start:end]
        for i in range(0, len(line), bpp):
            key = line[i:i + bpp]
            if key not in index:
                raise ValueError(f"XPM pixel key {key!r} is not in the palette")
            out.append(index[key])
        start = end
    return np.array(out[:pixels], np.int32), len(out)


# ---- XVThumb -------------------------------------------------------------------------

def accepts_xvthumb(blob: bytes) -> bool:
    return blob[:6] == b"P7 332"


@_declines
def decode_xvthumb(blob: bytes, name: str = "<bytes>") -> Optional[np.ndarray]:
    """An XV thumbnail -> PIL's array: 8-bit palette indices after the
    comment lines and the size line."""
    _, pos = _readline(blob, 6)
    while True:
        s, pos = _readline(blob, pos)
        if not s:
            raise _Declined
        if s[0] != 35:
            break
    parts = s.strip().split(maxsplit=2)[:2]
    if len(parts) < 2:
        raise ValueError(f"{name}: XV thumbnail size line {s!r}")
    try:
        w, h = int(parts[0]), int(parts[1])
    except ValueError:
        raise ValueError(f"{name}: XV thumbnail size line {s!r}") from None
    _opened(w, h, "P", name)
    return _raw(blob, pos, "P", "P", w, h, name)
