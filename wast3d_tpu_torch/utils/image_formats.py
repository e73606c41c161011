"""ICO / CUR, DDS, ICNS, PSD, SGI, PCX and Sun raster, read as PIL 12 reads them.

`utils/image_io.decode_image` dispatches these by signature, in PIL's
order; each `decode_*` here returns `np.asarray(PIL.Image.open(...))` or
None where PIL's plugin declines the file (a SyntaxError, or an IndexError,
KeyError or struct.error while it opens it, which PIL turns into one: PIL
then goes on to its next format), and raises `ValueError` naming the file
where PIL raises.

- ICO: the entry IcoFile puts first (largest width x height, then lowest
  colour depth, then file order; a size byte of 0 is 256): a PNG through
  `png.decode_png`, or a DIB of twice the height whose top half is the
  image, turned to RGBA with the alpha of its 32-bit pixels (a 32-bit
  entry) or its 1-bit AND mask, as IcoFile.frame does.
- CUR: CurImageFile's entry (the first, or a later one larger in both
  width and height bytes), its DIB's top half in the DIB's own mode (a
  32-bit DIB at offset 22 as RGBA, BGRA in the file).
- DDS: DdsImagePlugin's modes: uncompressed bit masks (RGB / RGBA, each
  channel scaled as its decoder does), L, LA, 8-bit palette indices, and
  BC1-BC7 (DXT1 / DXT3 / DXT5, BC4, BC5 unsigned and signed, BC6H unsigned
  and signed, BC7; fourCC or DX10 DXGI formats) through `native.bcn_decode`
  (Pillow's BcnDecode.c, quirks included: BC6H's unrounded interpolation
  and its signed deltas wrapped without sign extension).
- ICNS: the size IcnsFile.bestsize picks (the largest (width, height,
  scale) with an entry of its types) read as dataforsize reads it: a PNG
  entry in its own mode, a JPEG 2000 entry (`utils/jpeg2000.py`) turned
  to RGBA as PIL's convert does, or 24-bit RGB (raw, or packbits-like runs
  band by band) with its 8-bit mask as alpha; an RGB result comes out as
  np.asarray gives it for a file PIL opened as RGBA (the first 3 h w bytes
  of its 4-byte pixels).
- PSD: the merged image in PsdImagePlugin's modes (1, L, P, RGB, RGBA from
  four channels, CMYK stored inverted, LAB), raw or PackBits rows
  (`native.packbits_rows`, Pillow's row decoder: a run never spills into
  the next row).
- SGI: 8 and 16 bits (16-bit as its high byte, in mode L / RGB / RGBA),
  verbatim or run-length (`native.sgi_rle`, Pillow's SgiRleDecode with its
  bounds checks and early end), rows bottom-up.
- PCX: 1-bit, 1-bit in 2 or 4 planes, 8-bit L (no palette, or the identity
  greys) or P, 24-bit in 3 planes, runs through `native.pcx_rle` (Pillow's
  PcxDecode, its plane compaction included).
- Sun raster: depths 1, 4, 8 (L, or P with a colour map), 24 and 32 (RGB
  or BGR by type), raw rows padded to 16 bits or byte-encoded runs
  (`native.sun_rle`, over unpadded rows as Pillow's SunRleDecode reads
  them).

The plain versions the tests hold the native loops to are here:
`bcn_reference`, `packbits_rows_reference`, `sgi_rle_reference`,
`pcx_rle_reference` and `sun_rle_reference`.
"""

from __future__ import annotations

import math
import struct
from typing import Dict, Optional, Tuple

import numpy as np

from wast3d_tpu_torch.utils import png
from wast3d_tpu_torch.utils.image_io import _check_pixels, _unpack, decode_bmp


def _bits(v: np.ndarray) -> np.ndarray:
    """0 / 1 values -> PIL's "1" array (bools holding the bytes 0 and 255)."""
    return (np.asarray(v, np.uint8) * np.uint8(255)).view(bool)


def _truncated(name: str, what: str):
    raise ValueError(f"{name}: image file is truncated ({what})")


def _be(fmt: str, blob: bytes, at: int):
    """struct.unpack_from, None where PIL's read would come up short (its
    struct.error, which makes the plugin decline)."""
    if at < 0 or at + struct.calcsize(fmt) > len(blob):
        return None
    v = struct.unpack_from(fmt, blob, at)
    return v[0] if len(v) == 1 else v


# ---- DIBs inside ICO and CUR ------------------------------------------------------------

def _dib(blob: bytes, at: int, name: str):
    """BmpImageFile._bitmap on the DIB header at `at`, its height halved (the
    XOR image) -> (pixels in the DIB's mode, info), or None where PIL
    declines (a header cut short before its size)."""
    header_size = _be("<I", blob, at)
    if header_size is None:
        return None
    hd = blob[at + 4:at + header_size]
    if header_size in (40, 52, 56, 64, 108, 124) and len(hd) >= 36:
        bits, compression, colors = (struct.unpack_from("<H", hd, 10)[0],
                                     struct.unpack_from("<I", hd, 12)[0],
                                     struct.unpack_from("<I", hd, 28)[0])
        flip = hd[7] == 0xFF
        height = 2 ** 32 - struct.unpack_from("<I", hd, 4)[0] if flip else struct.unpack_from(
            "<I", hd, 4)[0]
        width, pad = struct.unpack_from("<I", hd, 0)[0], 4
    elif header_size == 12 and len(hd) >= 8:
        width, height = struct.unpack_from("<HH", hd, 0)
        bits, compression, colors, flip, pad = struct.unpack_from("<H", hd, 6)[0], 0, 0, False, 3
    else:  # a header the BMP reader refuses: it names what is wrong
        decode_bmp(b"BM" + struct.pack("<IHHI", 0, 0, 0, 0) + blob[at:], name)
        raise ValueError(f"{name}: unsupported BMP header type ({header_size})")
    _check_pixels(width, height, name)
    half = height // 2
    pixels = header_size + (12 if compression == 3 and header_size < 52 else 0)
    palette = b""
    if bits in (1, 4, 8):  # mode "P": the palette follows the header
        n = colors or (1 << bits)
        palette = blob[at + pixels:at + pixels + pad * n] if 0 < n <= 65536 else b""
        pixels += pad * n
    dib = bytearray(blob[at:])
    if header_size == 12:
        struct.pack_into("<H", dib, 6, half)
    else:
        struct.pack_into("<I", dib, 8, (2 ** 32 - half) % 2 ** 32 if flip else half)
    out = decode_bmp(b"BM" + struct.pack("<IHHI", 0, 0, 0, 14 + pixels) + bytes(dib), name)
    return out, dict(width=width, height=half, bits=bits, compression=compression,
                     offset=at + pixels, palette=palette, pad=pad, flip=flip)


def _rgba(img: np.ndarray, info: Dict) -> np.ndarray:
    """Image.convert("RGBA") of a DIB's pixels: palette indices through the
    BMP palette (BGR(X); past its end, the greys of Pillow's default
    palette; a grey palette gives the same greys), bits and greys spread
    over RGB, alpha 255 unless the DIB has it."""
    if img.dtype == bool:
        img = img.view(np.uint8) * np.uint8(255)
    if img.ndim == 3:
        if img.shape[2] == 4:
            return img.copy()
        return np.concatenate([img, np.full(img.shape[:2] + (1,), 255, np.uint8)], axis=2)
    lut = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
    if info["bits"] <= 8 and info["palette"]:
        pad = info["pad"]
        n = min(len(info["palette"]) // pad, 256)
        lut[:n] = np.frombuffer(info["palette"], np.uint8)[:n * pad].reshape(n, pad)[:, 2::-1]
    return np.concatenate([lut[img], np.full(img.shape + (1,), 255, np.uint8)], axis=2)


def decode_ico(blob: bytes, name: str = "<bytes>") -> Optional[np.ndarray]:
    """ICO bytes -> PIL's array of the entry it loads (module docstring)."""
    count = _be("<H", blob, 4)
    if count is None:
        return None
    entries = []
    for i in range(count):
        s = blob[6 + 16 * i:22 + 16 * i]
        if len(s) < 16:
            return None
        w, h, colors = s[0] or 256, s[1] or 256, s[2]
        bpp, size, offset = struct.unpack_from("<HII", s, 6)
        depth = bpp or (colors != 0 and math.ceil(math.log(colors, 2))) or 256
        entries.append((w * h, depth, w, h, bpp, size, offset))
    if not entries:
        return None
    entries.sort(key=lambda e: e[1])
    entries.sort(key=lambda e: e[0], reverse=True)
    _, _, w, h, bpp, size, offset = entries[0]
    if blob[offset:offset + 8] == png._SIGNATURE:
        return png.decode_png(blob[offset:], name)
    got = _dib(blob, offset, name)
    if got is None:
        return None
    img, info = got
    w, h = info["width"], info["height"]
    if bpp == 32:  # the 32-bit pixels' fourth bytes, rows bottom-up
        alpha = blob[info["offset"]:info["offset"] + w * h * 4][3::4]
        if len(alpha) < w * h:
            raise ValueError(f"{name}: not enough image data (the icon's alpha)")
        mask = np.frombuffer(alpha, np.uint8)[:w * h].reshape(h, w)[::-1]
    else:  # the AND mask, where the directory's size says it ends
        stride = -(-w // 32) * 4
        total = stride * h
        at = offset + size - total
        if at < 0:
            raise ValueError(f"{name}: an icon's AND mask before the start of the file")
        data = blob[at:at + total]
        if len(data) < total:
            raise ValueError(f"{name}: not enough image data (the icon's AND mask)")
        bits = np.unpackbits(np.frombuffer(data, np.uint8).reshape(h, stride), axis=1)[:, :w]
        mask = np.where(bits[::-1] == 0, 255, 0).astype(np.uint8)
    out = _rgba(img, info)
    out[..., 3] = mask
    return out


def decode_cur(blob: bytes, name: str = "<bytes>") -> Optional[np.ndarray]:
    """CUR bytes -> PIL's array of the cursor it loads (module docstring)."""
    count = _be("<H", blob, 4)
    if count is None:
        return None
    m, pos = b"", 6
    try:
        for _ in range(count):
            s = blob[pos:pos + 16]
            pos += len(s)
            if not m:
                m = s
            elif s[0] > m[0] and s[1] > m[1]:
                m = s
    except IndexError:
        return None
    at = _be("<I", m, 12) if m else None
    if at is None:
        return None
    got = _dib(blob, at if at else pos, name)
    if got is None:
        return None
    img, info = got
    if info["bits"] == 32 and info["compression"] == 0 and at == 22:  # BGRA, as Pillow reads it
        w, h = info["width"], info["height"]
        stride = 4 * w
        rows = np.frombuffer(blob[info["offset"]:info["offset"] + h * stride].ljust(h * stride, b"\0"),
                             np.uint8).reshape(h, w, 4)
        img = np.concatenate([img, (rows if info["flip"] else rows[::-1])[..., 3:]], axis=2)
    return img


# ---- DDS ---------------------------------------------------------------------------------

_DDS_FOURCC = {b"DXT1": (1, "DXT1"), b"DXT3": (2, "DXT3"), b"DXT5": (3, "DXT5"),
               b"BC4U": (4, "BC4"), b"ATI1": (4, "BC4"), b"BC5S": (5, "BC5S"),
               b"BC5U": (5, "BC5"), b"ATI2": (5, "BC5")}
_DXGI = {70: (1, "BC1"), 71: (1, "BC1"), 73: (2, "BC2"), 74: (2, "BC2"), 76: (3, "BC3"),
         77: (3, "BC3"), 79: (4, "BC4"), 80: (4, "BC4"), 82: (5, "BC5"), 83: (5, "BC5"),
         84: (5, "BC5S"), 95: (6, "BC6H"), 96: (6, "BC6HS"), 97: (7, "BC7"), 98: (7, "BC7"),
         99: (7, "BC7")}
BCN_BANDS = {1: 4, 2: 4, 3: 4, 4: 1, 5: 3, 6: 3, 7: 4}  # channels of each BCn decoder's mode


def decode_dds(blob: bytes, name: str = "<bytes>") -> Optional[np.ndarray]:
    """DDS bytes -> PIL's array (module docstring)."""
    from wast3d_tpu_torch import native

    header_size = _be("<I", blob, 4)
    if header_size is None:
        return None
    if header_size != 124:
        raise ValueError(f"{name}: unsupported DDS header size {header_size}")
    header = blob[8:128]
    if len(header) != 120:
        raise ValueError(f"{name}: incomplete DDS header: {len(header)} bytes")
    height, width = struct.unpack_from("<II", header, 4)
    pfflags, fourcc, bitcount = struct.unpack_from("<I4sI", header, 72)
    pos, n, signed, mode = 128, 0, False, None
    if pfflags & 0x40:  # DDPF_RGB: its bit masks, Pillow's DdsRgbDecoder
        count = 4 if pfflags & 1 else 3
        masks = struct.unpack_from(f"<{count}I", header, 84)
        if width <= 0 or height <= 0:
            return None
        _check_pixels(width, height, name)
        return _dds_masks(blob, pos, width, height, bitcount // 8, masks)
    if pfflags & 0x20000:  # DDPF_LUMINANCE
        if bitcount == 8:
            mode = "L"
        elif bitcount == 16 and pfflags & 1:
            mode = "LA"
        else:
            raise ValueError(f"{name}: unsupported DDS bit count {bitcount} for flags {pfflags}")
    elif pfflags & 0x20:  # DDPF_PALETTEINDEXED8: a 1024-byte palette first
        mode, pos = "P", min(pos + 1024, len(blob))
    elif pfflags & 0x4:  # DDPF_FOURCC
        if fourcc == b"DX10":
            dxgi = _be("<I", blob, 128)
            if dxgi is None:
                return None
            pos = min(148, len(blob))
            if dxgi in _DXGI:
                n, fmt = _DXGI[dxgi]
            elif dxgi in (27, 28, 29):
                mode = "RGBA"
            else:
                raise ValueError(f"{name}: unimplemented DXGI format {dxgi}")
        elif fourcc in _DDS_FOURCC:
            n, fmt = _DDS_FOURCC[fourcc]
        else:
            raise ValueError(f"{name}: unimplemented DDS pixel format {fourcc!r}")
        signed = n and fmt in ("BC5S", "BC6HS")
    else:
        raise ValueError(f"{name}: unknown DDS pixel format flags {pfflags}")
    if width <= 0 or height <= 0:
        return None
    _check_pixels(width, height, name)
    if n:
        out = native.bcn_decode(blob[pos:], n, bool(signed), width, height, name)
        return out[..., 0] if n == 4 else out
    bands = len(mode)
    need = width * height * bands
    data = blob[pos:pos + need]
    if len(data) < need:
        _truncated(name, f"{len(data)} of {need} bytes of pixels")
    out = np.frombuffer(data, np.uint8).reshape(height, width, bands)
    return out[..., 0].copy() if bands == 1 else out.copy()


def _dds_masks(blob: bytes, pos: int, width: int, height: int, bytecount: int,
               masks) -> np.ndarray:
    """DdsRgbDecoder: each pixel a little-endian value of `bytecount` bytes
    (past the end of the file, what is there and then zeros), each channel
    int((value & mask) >> its trailing zeros) / (mask >> them) * 255)."""
    n = width * height
    if bytecount:
        raw = np.frombuffer(blob[pos:pos + n * bytecount].ljust(n * bytecount, b"\0"),
                            np.uint8).reshape(n, bytecount)[:, :4].astype(np.uint64)
        value = sum(raw[:, k] << np.uint64(8 * k) for k in range(raw.shape[1]))
    else:
        value = np.zeros(n, np.uint64)
    out = []
    for mask in masks:
        shift = (mask & -mask).bit_length() - 1 if mask else 0
        total = mask >> shift
        if total:
            v = ((value & np.uint64(mask)) >> np.uint64(shift)).astype(np.float64)
            out.append((v / total * 255).astype(np.uint8))
        else:
            out.append(np.zeros(n, np.uint8))
    return np.stack(out, 1).reshape(height, width, len(masks))


# ---- BCn: Pillow's BcnDecode.c -----------------------------------------------------------

def _565(c: int):
    r, g, b = (c & 0xF800) >> 8, (c & 0x7E0) >> 3, (c & 0x1F) << 3
    return [r | r >> 5, g | g >> 6, b | b >> 5, 255]


def _bc1(blk: bytes, separate_alpha: bool):
    c0, c1, lut = struct.unpack_from("<HHI", blk)
    p0, p1 = _565(c0), _565(c1)
    if c0 > c1 or separate_alpha:
        p2 = [(2 * a + b) // 3 for a, b in zip(p0[:3], p1[:3])] + [255]
        p3 = [(a + 2 * b) // 3 for a, b in zip(p0[:3], p1[:3])] + [255]
    else:
        p2, p3 = [(a + b) // 2 for a, b in zip(p0[:3], p1[:3])] + [255], [0, 0, 0, 0]
    p = (p0, p1, p2, p3)
    return [list(p[(lut >> (2 * i)) & 3]) for i in range(16)]


def _bc3_alpha(blk: bytes, signed: bool):
    a0, a1 = (((blk[0] ^ 128) - 128) + 128, ((blk[1] ^ 128) - 128) + 128) if signed else blk[:2]
    lut = int.from_bytes(blk[2:8], "little")
    a = [a0, a1]
    if a0 > a1:
        a += [((7 - i) * a0 + i * a1) // 7 for i in range(1, 7)]
    else:
        a += [((5 - i) * a0 + i * a1) // 5 for i in range(1, 5)] + [0, 255]
    return [a[(lut >> (3 * i)) & 7] & 255 for i in range(16)]


# BC7: per mode (subsets, partition bits, rotation bits, index-selection
# bits, colour bits, alpha bits, endpoint p-bits, shared p-bits, index bits,
# second index bits).
_BC7_MODES = ((3, 4, 0, 0, 4, 0, 1, 0, 3, 0), (2, 6, 0, 0, 6, 0, 0, 1, 3, 0),
              (3, 6, 0, 0, 5, 0, 0, 0, 2, 0), (2, 6, 0, 0, 7, 0, 1, 0, 2, 0),
              (1, 0, 2, 1, 5, 6, 0, 0, 2, 3), (1, 0, 2, 0, 7, 8, 0, 0, 2, 2),
              (1, 0, 0, 0, 7, 7, 1, 0, 4, 0), (2, 6, 0, 0, 5, 5, 1, 0, 2, 0))
# Two- and three-subset partitions (a bit, or two, a pixel) and their anchors.
_P2 = (0xcccc, 0x8888, 0xeeee, 0xecc8, 0xc880, 0xfeec, 0xfec8, 0xec80, 0xc800, 0xffec, 0xfe80,
       0xe800, 0xffe8, 0xff00, 0xfff0, 0xf000, 0xf710, 0x008e, 0x7100, 0x08ce, 0x008c, 0x7310,
       0x3100, 0x8cce, 0x088c, 0x3110, 0x6666, 0x366c, 0x17e8, 0x0ff0, 0x718e, 0x399c, 0xaaaa,
       0xf0f0, 0x5a5a, 0x33cc, 0x3c3c, 0x55aa, 0x9696, 0xa55a, 0x73ce, 0x13c8, 0x324c, 0x3bdc,
       0x6996, 0xc33c, 0x9966, 0x0660, 0x0272, 0x04e4, 0x4e40, 0x2720, 0xc936, 0x936c, 0x39c6,
       0x639c, 0x9336, 0x9cc6, 0x817e, 0xe718, 0xccf0, 0x0fcc, 0x7744, 0xee22)
_P3 = (0xaa685050, 0x6a5a5040, 0x5a5a4200, 0x5450a0a8, 0xa5a50000, 0xa0a05050, 0x5555a0a0,
       0x5a5a5050, 0xaa550000, 0xaa555500, 0xaaaa5500, 0x90909090, 0x94949494, 0xa4a4a4a4,
       0xa9a59450, 0x2a0a4250, 0xa5945040, 0x0a425054, 0xa5a5a500, 0x55a0a0a0, 0xa8a85454,
       0x6a6a4040, 0xa4a45000, 0x1a1a0500, 0x0050a4a4, 0xaaa59090, 0x14696914, 0x69691400,
       0xa08585a0, 0xaa821414, 0x50a4a450, 0x6a5a0200, 0xa9a58000, 0x5090a0a8, 0xa8a09050,
       0x24242424, 0x00aa5500, 0x24924924, 0x24499224, 0x50a50a50, 0x500aa550, 0xaaaa4444,
       0x66660000, 0xa5a0a5a0, 0x50a050a0, 0x69286928, 0x44aaaa44, 0x66666600, 0xaa444444,
       0x54a854a8, 0x95809580, 0x96969600, 0xa85454a8, 0x80959580, 0xaa141414, 0x96960000,
       0xaaaa1414, 0xa05050a0, 0xa0a5a5a0, 0x96000000, 0x40804080, 0xa9a8a9a8, 0xaaaaaa44,
       0x2a4a5254)
_A2 = (15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 2, 8, 2, 2, 8, 8,
       15, 2, 8, 2, 2, 8, 8, 2, 2, 15, 15, 6, 8, 2, 8, 15, 15, 2, 8, 2, 2, 2, 15, 15, 6, 6, 2,
       6, 8, 15, 15, 2, 2, 15, 15, 15, 15, 15, 2, 2, 15)
_A3A = (3, 3, 15, 15, 8, 3, 15, 15, 8, 8, 6, 6, 6, 5, 3, 3, 3, 3, 8, 15, 3, 3, 6, 10, 5, 8, 8,
        6, 8, 5, 15, 15, 8, 15, 3, 5, 6, 10, 8, 15, 15, 3, 15, 5, 15, 15, 15, 15, 3, 15, 5, 5,
        5, 8, 5, 10, 5, 10, 8, 13, 15, 12, 3, 3)
_A3B = (15, 8, 8, 3, 15, 15, 3, 8, 15, 15, 15, 15, 15, 15, 15, 8, 15, 8, 15, 3, 15, 8, 15, 8,
        3, 15, 6, 10, 15, 15, 10, 8, 15, 3, 15, 10, 10, 8, 9, 10, 6, 15, 8, 15, 3, 6, 6, 8, 15,
        3, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 3, 15, 15, 8)
_WEIGHTS = {2: (0, 21, 43, 64), 3: (0, 9, 18, 27, 37, 46, 55, 64),
            4: (0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64)}


def _bc7(blk: bytes):
    v = int.from_bytes(blk, "little")
    if blk[0] == 0:
        return [[0, 0, 0, 255]] * 16
    mode = (blk[0] & -blk[0]).bit_length() - 1
    ns, pb, rb, isb, cb, ab, epb, spb, ib, ib2 = _BC7_MODES[mode]
    bit = mode + 1

    def take(n):
        nonlocal bit
        bit += n
        return (v >> (bit - n)) & ((1 << n) - 1)

    partition, rotation, index_sel = take(pb), take(rb), take(isb)
    ep = [[0, 0, 0, 255] for _ in range(2 * ns)]
    for c in range(3):
        for e in ep:
            e[c] = take(cb)
    for e in ep:
        e[3] = take(ab) if ab else 255
    bands = 4 if ab else 3
    if epb or spb:
        cb, ab = cb + 1, ab + 1 if ab else 0
    if epb:
        for e in ep:
            p = take(1)
            for c in range(bands):
                e[c] = e[c] << 1 | p
    if spb:
        for i in range(0, len(ep), 2):
            p = take(1)
            for e in ep[i:i + 2]:
                for c in range(bands):
                    e[c] = e[c] << 1 | p
    for e in ep:
        for c in range(bands):
            b = cb if c < 3 else ab
            x = (e[c] << (8 - b)) & 255
            e[c] = x | x >> b
    cw, aw = _WEIGHTS[ib], _WEIGHTS[ib2 if ab and ib2 else ib]
    cbit, abit = bit, bit + 16 * ib - ns
    out = []
    for i in range(16):
        s = (_P2[partition] >> i & 1 if ns == 2 else _P3[partition] >> 2 * i & 3 if ns == 3
             else 0)
        n0 = ib - (i == 0 or ns == 2 and i == _A2[partition]
                   or ns == 3 and i in (_A3A[partition], _A3B[partition]))
        i0 = (v >> cbit) & ((1 << n0) - 1)
        cbit += n0
        e0, e1 = ep[2 * s], ep[2 * s + 1]
        s0 = s1 = cw[i0]
        if ib2:
            n1 = ib2 - (i == 0)
            i1 = (v >> abit) & ((1 << n1) - 1)
            abit += n1
            s0, s1 = (aw[i1], cw[i0]) if index_sel else (cw[i0], aw[i1])
        px = [(((64 - s0) * e0[c] + s0 * e1[c] + 32) >> 6) & 255 for c in range(3)]
        px.append((((64 - s1) * e0[3] + s1 * e1[3] + 32) >> 6) & 255)
        if rotation:
            px[rotation - 1], px[3] = px[3], px[rotation - 1]
        out.append(px)
    return out


# BC6H: mode -> (mode bits, transformed, endpoint bits, delta bits of r, g,
# b, the header's fields in stream order: endpoint (0 the first of subset 0,
# 1 its second, 2 and 3 subset 1's), channel, bits high to low (a field
# written low to high, r0[10:11], gives its bits in that order)).
_BC6_LAYOUTS = {
    0x00: (2, True, 10, (5, 5, 5), "g2[4] b2[4] b3[4] r0[9:0] g0[9:0] b0[9:0] r1[4:0] g3[4] "
           "g2[3:0] g1[4:0] b3[0] g3[3:0] b1[4:0] b3[1] b2[3:0] r2[4:0] b3[2] r3[4:0] b3[3]"),
    0x01: (2, True, 7, (6, 6, 6), "g2[5] g3[4] g3[5] r0[6:0] b3[0] b3[1] b2[4] g0[6:0] b2[5] "
           "b3[2] g2[4] b0[6:0] b3[3] b3[5] b3[4] r1[5:0] g2[3:0] g1[5:0] g3[3:0] b1[5:0] "
           "b2[3:0] r2[5:0] r3[5:0]"),
    0x02: (5, True, 11, (5, 4, 4), "r0[9:0] g0[9:0] b0[9:0] r1[4:0] r0[10] g2[3:0] g1[3:0] "
           "g0[10] b3[0] g3[3:0] b1[3:0] b0[10] b3[1] b2[3:0] r2[4:0] b3[2] r3[4:0] b3[3]"),
    0x06: (5, True, 11, (4, 5, 4), "r0[9:0] g0[9:0] b0[9:0] r1[3:0] r0[10] g3[4] g2[3:0] "
           "g1[4:0] g0[10] g3[3:0] b1[3:0] b0[10] b3[1] b2[3:0] r2[3:0] b3[0] b3[2] r3[3:0] "
           "g2[4] b3[3]"),
    0x0a: (5, True, 11, (4, 4, 5), "r0[9:0] g0[9:0] b0[9:0] r1[3:0] r0[10] b2[4] g2[3:0] "
           "g1[3:0] g0[10] b3[0] g3[3:0] b1[4:0] b0[10] b2[3:0] r2[3:0] b3[1] b3[2] r3[3:0] "
           "b3[4] b3[3]"),
    0x0e: (5, True, 9, (5, 5, 5), "r0[8:0] b2[4] g0[8:0] g2[4] b0[8:0] b3[4] r1[4:0] g3[4] "
           "g2[3:0] g1[4:0] b3[0] g3[3:0] b1[4:0] b3[1] b2[3:0] r2[4:0] b3[2] r3[4:0] b3[3]"),
    0x12: (5, True, 8, (6, 5, 5), "r0[7:0] g3[4] b2[4] g0[7:0] b3[2] g2[4] b0[7:0] b3[3] b3[4] "
           "r1[5:0] g2[3:0] g1[4:0] b3[0] g3[3:0] b1[4:0] b3[1] b2[3:0] r2[5:0] r3[5:0]"),
    0x16: (5, True, 8, (5, 6, 5), "r0[7:0] b3[0] b2[4] g0[7:0] g2[5] g2[4] b0[7:0] g3[5] b3[4] "
           "r1[4:0] g3[4] g2[3:0] g1[5:0] g3[3:0] b1[4:0] b3[1] b2[3:0] r2[4:0] b3[2] r3[4:0] "
           "b3[3]"),
    0x1a: (5, True, 8, (5, 5, 6), "r0[7:0] b3[1] b2[4] g0[7:0] b2[5] g2[4] b0[7:0] b3[5] b3[4] "
           "r1[4:0] g3[4] g2[3:0] g1[4:0] b3[0] g3[3:0] b1[5:0] b2[3:0] r2[4:0] b3[2] r3[4:0] "
           "b3[3]"),
    0x1e: (5, False, 6, (6, 6, 6), "r0[5:0] g3[4] b3[0] b3[1] b2[4] g0[5:0] g2[5] b2[5] b3[2] "
           "g2[4] b0[5:0] g3[5] b3[3] b3[5] b3[4] r1[5:0] g2[3:0] g1[5:0] g3[3:0] b1[5:0] "
           "b2[3:0] r2[5:0] r3[5:0]"),
    0x03: (5, False, 10, (10, 10, 10), "r0[9:0] g0[9:0] b0[9:0] r1[9:0] g1[9:0] b1[9:0]"),
    0x07: (5, True, 11, (9, 9, 9), "r0[9:0] g0[9:0] b0[9:0] r1[8:0] r0[10] g1[8:0] g0[10] "
           "b1[8:0] b0[10]"),
    0x0b: (5, True, 12, (8, 8, 8), "r0[9:0] g0[9:0] b0[9:0] r1[7:0] r0[10:11] g1[7:0] "
           "g0[10:11] b1[7:0] b0[10:11]"),
    0x0f: (5, True, 16, (4, 4, 4), "r0[9:0] g0[9:0] b0[9:0] r1[3:0] r0[10:15] g1[3:0] "
           "g0[10:15] b1[3:0] b0[10:15]"),
}


def _bc6_fields(layout: str):
    """A layout string -> [(endpoint, channel, bit)] in stream order."""
    out = []
    for f in layout.split():
        e, c = int(f[1]), "rgb".index(f[0])
        hi, _, lo = f[3:-1].partition(":")
        hi, lo = int(hi), int(lo or hi)
        out += [(e, c, b) for b in (range(lo, hi + 1) if hi >= lo else range(lo, hi - 1, -1))]
    return out


BC6_MODES = {k: v[:4] + (_bc6_fields(v[4]),) for k, v in _BC6_LAYOUTS.items()}


def _sext(x: int, bits: int) -> int:
    x &= (1 << bits) - 1
    return x - (1 << bits) if x >> (bits - 1) else x


def _bc6_unquantize(x: int, bits: int, signed: bool) -> int:
    if not signed:
        if bits >= 15 or x == 0:
            return x
        return 0xFFFF if x == (1 << bits) - 1 else ((x << 15) + 0x4000) >> (bits - 1)
    x = _sext(x, 16)  # Pillow keeps endpoints as UINT16 and reads them back as INT16
    if bits >= 16:
        return x
    a = -x if x < 0 else x
    if a:
        a = 0x7FFF if a >= (1 << (bits - 1)) - 1 else ((a << 15) + 0x4000) >> (bits - 1)
    return -a if x < 0 else a


def _bc6_byte(v: int, signed: bool) -> int:
    """An interpolated value -> a half float -> its clamped byte
    (int(f * 255) in float32; NaN gives 0)."""
    if signed:
        h = 0x8000 | (-v * 31) >> 5 if v < 0 else (v * 31) >> 5
    else:
        h = (v * 31) >> 6
    f = np.array([h & 0xFFFF], np.uint16).view(np.float16).astype(np.float32)[0]
    if np.isnan(f) or f < 0:
        return 0
    return 255 if f > 1 else int(f * np.float32(255))


def _bc6(blk: bytes, signed: bool):
    v = int.from_bytes(blk, "little")
    mode = v & 3 if v & 3 < 2 else v & 31
    if mode not in BC6_MODES:
        return [[0, 0, 0]] * 16
    bit, transformed, bits, delta, fields = BC6_MODES[mode]
    ns = 1 if mode in (0x03, 0x07, 0x0b, 0x0f) else 2
    ep = [[0, 0, 0] for _ in range(4)]
    for e, c, b in fields:
        ep[e][c] |= (v >> bit & 1) << b
        bit += 1
    partition = 0
    if ns == 2:
        partition, bit = v >> bit & 31, bit + 5
    if signed:
        ep[0] = [_sext(x, bits) for x in ep[0]]
    for e in ep[1:2 * ns]:
        for c in range(3):
            if transformed:  # a delta from the first endpoint, wrapped (no sign extension)
                e[c] = (ep[0][c] + _sext(e[c], delta[c])) & ((1 << bits) - 1)
            elif signed:
                e[c] = _sext(e[c], bits)
    ue = [[_bc6_unquantize(x, bits, signed) for x in e] for e in ep[:2 * ns]]
    w = _WEIGHTS[3 if ns == 2 else 4]
    out = []
    for i in range(16):
        s = _P2[partition] >> i & 1 if ns == 2 else 0
        n = (3 if ns == 2 else 4) - (i == 0 or ns == 2 and i == _A2[partition])
        wt = w[v >> bit & ((1 << n) - 1)]
        bit += n
        e0, e1 = ue[2 * s], ue[2 * s + 1]
        out.append([_bc6_byte((e0[c] * (64 - wt) + e1[c] * wt) >> 6, signed) for c in range(3)])
    return out


def bcn_reference(data: bytes, n: int, signed: bool, width: int, height: int) -> np.ndarray:
    """The plain version of `native.bcn_decode`: BCn decoder `n` (1 BC1, 2
    BC2, 3 BC3, 4 BC4, 5 BC5, 6 BC6H, 7 BC7; `signed` for BC5S and BC6HS)
    over 4 x 4 blocks, row by row -> uint8 [height, width, channels]
    (BCN_BANDS: RGBA, L, RGB; the edge blocks cropped)."""
    size = 8 if n in (1, 4) else 16
    bw, bh = -(-width // 4), -(-height // 4)
    if len(data) < bw * bh * size:
        raise ValueError(f"image file is truncated ({len(data)} of {bw * bh * size} bytes of "
                         "blocks)")
    out = np.zeros((bh * 4, bw * 4, 4), np.uint8)
    for k in range(bw * bh):
        blk = bytes(data[k * size:(k + 1) * size])
        if n == 1:
            px = _bc1(blk, False)
        elif n == 2:
            px = _bc1(blk[8:], True)
            for i in range(16):
                a = blk[i >> 1] >> (4 * (i & 1)) & 15
                px[i][3] = a << 4 | a
        elif n == 3:
            px = _bc1(blk[8:], True)
            for i, a in enumerate(_bc3_alpha(blk, False)):
                px[i][3] = a
        elif n == 4:
            px = [[a, 0, 0, 0] for a in _bc3_alpha(blk, False)]
        elif n == 5:
            r, g = _bc3_alpha(blk, signed), _bc3_alpha(blk[8:], signed)
            px = [[r[i], g[i], 128 if signed else 0, 0] for i in range(16)]
        elif n == 6:
            px = [p + [0] for p in _bc6(blk, signed)]
        else:
            px = _bc7(blk)
        y, x = divmod(k, bw)
        out[4 * y:4 * y + 4, 4 * x:4 * x + 4] = np.array(px, np.uint8).reshape(4, 4, 4)
    return np.ascontiguousarray(out[:height, :width, :BCN_BANDS[n]])


# ---- PSD -----------------------------------------------------------------------------------

_PSD_MODES = {(0, 1): ("1", 1), (0, 8): ("L", 1), (1, 8): ("L", 1), (2, 8): ("P", 1),
              (3, 8): ("RGB", 3), (4, 8): ("CMYK", 4), (7, 8): ("L", 1), (8, 8): ("L", 1),
              (9, 8): ("LAB", 3)}


def decode_psd(blob: bytes, name: str = "<bytes>") -> Optional[np.ndarray]:
    """PSD bytes -> PIL's array of the merged image (module docstring)."""
    from wast3d_tpu_torch import native

    if len(blob) < 26 or struct.unpack_from(">H", blob, 4)[0] != 1:
        return None
    channels, h, w, bits, pmode = struct.unpack_from(">HIIHH", blob, 12)
    if (pmode, bits) not in _PSD_MODES:
        return None  # a KeyError in PsdImageFile._open: PIL declines
    mode, need = _PSD_MODES[(pmode, bits)]
    if need > channels:
        raise ValueError(f"{name}: not enough channels ({channels}) for a {mode} PSD")
    if mode == "RGB" and channels == 4:
        mode, need = "RGBA", 4
    # PsdImageFile._open's reads: each stops at the end of the file, a seek
    # does not; a short integer is a struct.error, and PIL declines.
    end_of_file, pos = len(blob), 26
    size = _be(">I", blob, pos)  # colour mode data
    if size is None:
        return None
    pos = min(pos + 4 + size, end_of_file)
    size = _be(">I", blob, pos)  # image resources
    if size is None:
        return None
    pos += 4
    end = pos + size
    while size and pos < end:
        pos = min(pos + 4, end_of_file)  # signature
        if pos + 3 > end_of_file:  # the id, then the name's length
            return None
        n = blob[pos + 2]
        pos += 3
        got = len(blob[pos:pos + n])
        pos = min(pos + got + (0 if got & 1 else 1), end_of_file)
        n = _be(">I", blob, pos)
        if n is None:
            return None
        got = len(blob[pos + 4:pos + 4 + n])
        pos = min(pos + 4 + got + (got & 1), end_of_file)
    size = _be(">I", blob, pos)  # layer and mask information
    if size is None:
        return None
    pos += 4
    if size:
        if _be(">I", blob, pos) is None:
            return None
        pos += size
    compression = _be(">H", blob, pos)
    if compression is None:
        return None
    pos += 2
    if w <= 0 or h <= 0:
        return None
    _check_pixels(w, h, name)
    row = (w + 7) // 8 if bits == 1 else w
    planes = []
    if compression == 1:
        counts = blob[pos:pos + 2 * need * h]
        if len(counts) < 2 * need * h:
            return None  # PsdImagePlugin's i16 on the short byte counts: a struct.error
        pos += 2 * need * h
        offsets = np.concatenate([[0], np.cumsum(np.frombuffer(counts, ">u2").astype(np.int64))])
        for c in range(need):
            planes.append(native.packbits_rows(blob[pos + offsets[c * h]:], row, h, name))
    elif compression == 0:
        for c in range(need):
            at = pos + c * w * h
            data = blob[at:at + row * h]
            if len(data) < row * h:
                _truncated(name, f"a PSD channel of {len(data)} of {row * h} bytes")
            planes.append(np.frombuffer(data, np.uint8).reshape(h, row))
    else:
        raise ValueError(f"{name}: cannot load this image (PSD compression {compression})")
    if mode == "1":
        return _bits(np.unpackbits(planes[0], axis=1)[:, :w])
    if len(mode) == 1 or mode == "P":
        return planes[0].copy()
    bands = []
    for c, p in enumerate(planes):
        if mode == "CMYK":
            p = 255 - p
        elif mode == "LAB":
            p = _unpack("LAB", "LAB"[c], p, w)
        bands.append(p)
    return np.stack(bands, axis=2)


def packbits_rows_reference(data: bytes, row_bytes: int, rows: int) -> np.ndarray:
    """The plain version of `native.packbits_rows`: Pillow's PackBitsDecode,
    which fills one row at a time (a run or literal past the row's end is
    cut there) -> uint8 [rows, row_bytes]."""
    out = np.zeros((rows, row_bytes), np.uint8)
    p, y, x, buf = 0, 0, 0, bytearray(row_bytes)
    while y < rows:
        if p >= len(data):
            raise ValueError("image file is truncated (PackBits rows)")
        c = data[p]
        if c & 0x80:
            if c == 0x80:
                p += 1
                continue
            if p + 2 > len(data):
                raise ValueError("image file is truncated (PackBits rows)")
            n = min(257 - c, row_bytes - x)
            buf[x:x + n] = bytes([data[p + 1]]) * n
            x, p = x + n, p + 2
        else:
            if p + c + 2 > len(data):
                raise ValueError("image file is truncated (PackBits rows)")
            n = min(c + 1, row_bytes - x)
            buf[x:x + n] = data[p + 1:p + 1 + n]
            x, p = x + n, p + c + 2
        if x >= row_bytes:
            out[y] = np.frombuffer(bytes(buf), np.uint8)
            y, x = y + 1, 0
    return out


# ---- SGI -----------------------------------------------------------------------------------

_SGI_MODES = {(1, 1, 1): "L", (1, 2, 1): "L", (2, 1, 1): "L", (2, 2, 1): "L", (1, 3, 3): "RGB",
              (2, 3, 3): "RGB", (1, 3, 4): "RGBA", (2, 3, 4): "RGBA"}


def decode_sgi(blob: bytes, name: str = "<bytes>") -> Optional[np.ndarray]:
    """SGI bytes -> PIL's array (module docstring)."""
    from wast3d_tpu_torch import native

    if len(blob) < 12:
        return None
    compression, bpc = blob[2], blob[3]
    dimension, w, h, z = struct.unpack_from(">HHHH", blob, 4)
    mode = _SGI_MODES.get((bpc, dimension, z))
    if mode is None:
        raise ValueError(f"{name}: unsupported SGI image mode (bpc {bpc}, dimension "
                         f"{dimension}, zsize {z})")
    if w <= 0 or h <= 0:
        return None
    _check_pixels(w, h, name)
    bands = len(mode)
    if compression == 1:
        rows = native.sgi_rle(blob, w, h, bands, bpc, name)  # top-down
        v = rows.reshape(h, w, bands, bpc)[..., 0]
    elif compression == 0:
        page = w * h * bpc
        planes = []
        for b in range(bands):
            data = blob[512 + b * page:512 + (b + 1) * page]
            if len(data) < page:
                if bpc == 2:
                    raise ValueError(f"{name}: not enough image data (SGI plane {b})")
                _truncated(name, f"SGI plane {b} of {len(data)} of {page} bytes")
            planes.append(np.frombuffer(data, np.uint8).reshape(h, w, bpc)[::-1, :, 0])
        v = np.stack(planes, axis=2)
    else:
        raise ValueError(f"{name}: cannot load this image (SGI compression {compression})")
    return np.ascontiguousarray(v[..., 0] if bands == 1 else v)


def sgi_rle_reference(blob: bytes, width: int, height: int, bands: int, bpc: int) -> np.ndarray:
    """The plain version of `native.sgi_rle`: Pillow's SgiRleDecode on a whole
    file -> uint8 [height, width * bands * bpc] rows top-down (16-bit
    samples big-endian), rows after an early end left zero. A row's length
    in the table only bounds its steps (read as a signed int); its packets
    end at a zero count, and the file's end is the bound Pillow checks."""
    size = len(blob) - 512
    tab = bands * height
    if size < 8 * tab:
        raise ValueError("buffer overrun when reading image file (SGI tables)")
    buf = blob[512:]
    starts = struct.unpack_from(f">{tab}I", buf, 0)
    lengths = struct.unpack_from(f">{tab}I", buf, 4 * tab)
    row_bytes = width * bands * bpc
    out = np.zeros((height, row_bytes), np.uint8)
    row = bytearray(row_bytes)
    last = size - 1  # the last byte the decoder may read
    for r in range(height):
        for c in range(bands):
            start, n = starts[r + c * height], lengths[r + c * height]
            n -= (n >> 31) << 32  # a step count Pillow holds in an int: past 2^31, negative
            if start < 512:
                raise ValueError("buffer overrun when reading image file (SGI row)")
            src, x, dst = start - 512, 0, c * bpc
            for k in range(n, 0, -1):  # one packet a step, as Pillow counts
                if src + bpc - 1 > last:
                    raise ValueError("buffer overrun when reading image file (SGI row)")
                pixel = buf[src + bpc - 1]
                src += bpc
                if k == 1 and pixel != 0:
                    return out
                count = pixel & 0x7F
                if not count:
                    break
                if x + count > width:
                    raise ValueError("buffer overrun when reading image file (SGI row)")
                x += count
                if pixel & 0x80:
                    if src + bpc * count > last:
                        raise ValueError("buffer overrun when reading image file (SGI row)")
                    for _ in range(count):
                        row[dst:dst + bpc] = buf[src:src + bpc]
                        src, dst = src + bpc, dst + bands * bpc
                else:
                    if src + 2 * (bpc - 1) > last:
                        raise ValueError("buffer overrun when reading image file (SGI row)")
                    for _ in range(count):
                        row[dst:dst + bpc] = buf[src:src + bpc]
                        dst += bands * bpc
                    src += bpc
        out[height - 1 - r] = np.frombuffer(bytes(row), np.uint8)
    return out


# ---- PCX -----------------------------------------------------------------------------------

_PCX_BITS = {"1": 1, "P;2L": 2, "P;4L": 4, "L": 8, "P": 8, "RGB;L": 24}


def decode_pcx(blob: bytes, name: str = "<bytes>") -> Optional[np.ndarray]:
    """PCX bytes -> PIL's array (module docstring)."""
    from wast3d_tpu_torch import native

    if len(blob) < 68:
        return None
    x0, y0, x1, y1 = struct.unpack_from("<HHHH", blob, 4)
    if x1 + 1 <= x0 or y1 + 1 <= y0:
        return None
    version, bits, planes = blob[1], blob[3], blob[65]
    provided = struct.unpack_from("<H", blob, 66)[0]
    if bits == 1 and planes == 1:
        mode = raw = "1"
    elif bits == 1 and planes in (2, 4):
        mode, raw = "P", f"P;{planes}L"
    elif version == 5 and bits == 8 and planes == 1:
        mode = raw = "L"
        pal = blob[-769:]  # (in a shorter file, a short read from its start)
        if len(pal) == 769 and pal[0] == 12 and pal[1:] != bytes(
                np.repeat(np.arange(256, dtype=np.uint8), 3)):
            mode = raw = "P"
    elif version == 5 and bits == 8 and planes == 3:
        mode, raw = "RGB", "RGB;L"
    else:
        raise ValueError(f"{name}: unknown PCX mode (version {version}, {bits} bits, {planes} "
                         "planes)")
    w, h = x1 + 1 - x0, y1 + 1 - y0
    _check_pixels(w, h, name)
    stride = (w * bits + 7) // 8
    if provided != stride:
        stride += stride % 2
    row_bytes = planes * stride
    if (w * _PCX_BITS[raw] + 7) // 8 > row_bytes:
        raise ValueError(f"{name}: buffer overrun when reading image file (PCX rows of "
                         f"{row_bytes} bytes)")
    rows = native.pcx_rle(blob[128:], row_bytes, w, _PCX_BITS[raw], h, name)
    if raw == "1":
        return _bits(np.unpackbits(rows, axis=1)[:, :w])
    if raw in ("P;2L", "P;4L"):
        s = (w + 7) // 8
        v = np.zeros((h, w), np.uint8)
        for p in range(planes):
            v |= np.unpackbits(rows[:, p * s:(p + 1) * s], axis=1)[:, :w] << p
        return v
    if raw == "RGB;L":
        return np.ascontiguousarray(rows[:, :3 * w].reshape(h, 3, w).transpose(0, 2, 1))
    return np.ascontiguousarray(rows[:, :w])


def pcx_rle_reference(data: bytes, row_bytes: int, width: int, bits: int,
                      rows: int) -> np.ndarray:
    """The plain version of `native.pcx_rle`: Pillow's PcxDecode -> uint8
    [rows, row_bytes], each row's planes moved together as it moves them
    (at 2 or 4 `bits` a pixel, bit planes of (width + 7) // 8 bytes; else
    planes of `width` bytes, when row_bytes is not a multiple of it); a run
    past its row is an error."""
    out = np.zeros((rows, row_bytes), np.uint8)
    p, y, x, buf = 0, 0, 0, bytearray(row_bytes)
    while y < rows:
        if p >= len(data):
            raise ValueError("image file is truncated (PCX rows)")
        c = data[p]
        if c & 0xC0 == 0xC0:
            if p + 2 > len(data):
                raise ValueError("image file is truncated (PCX rows)")
            n = c & 0x3F
            if x + n > row_bytes:
                raise ValueError("buffer overrun when reading image file (a PCX run past its row)")
            buf[x:x + n] = bytes([data[p + 1]]) * n
            x, p = x + n, p + 2
        else:
            buf[x] = c
            x, p = x + 1, p + 1
        if x >= row_bytes:
            if bits in (2, 4):
                size, bands = (width + 7) // 8, bits
                stride = row_bytes // bands
            else:
                size, bands = width, row_bytes // width
                stride = row_bytes // bands if bands else 0
            if stride > size:
                for i in range(1, bands):
                    buf[i * size:(i + 1) * size] = buf[i * stride:i * stride + size]
            out[y] = np.frombuffer(bytes(buf), np.uint8)
            y, x = y + 1, 0
    return out


# ---- Sun raster ----------------------------------------------------------------------------

def decode_sun(blob: bytes, name: str = "<bytes>") -> Optional[np.ndarray]:
    """Sun raster bytes -> PIL's array (module docstring)."""
    from wast3d_tpu_torch import native

    if len(blob) < 32:
        return None
    w, h, depth, _, ftype, ptype, plen = struct.unpack_from(">7I", blob, 4)
    raw = {1: "1;I", 4: "L;4", 8: "L", 24: "RGB" if ftype == 3 else "BGR",
           32: "RGBX" if ftype == 3 else "BGRX"}.get(depth)
    if raw is None or plen and (plen > 1024 or ptype != 1):
        return None  # SunImageFile raises SyntaxError: PIL declines
    pos = 32
    if plen:
        pos += plen
        if depth in (4, 8):
            raw = raw.replace("L", "P")
    if ftype not in (0, 1, 2, 3, 4, 5) or w <= 0 or h <= 0:
        return None
    _check_pixels(w, h, name)
    row = (w * depth + 7) // 8
    if ftype == 2:
        rows = native.sun_rle(blob[pos:], row, h, name)
    else:
        stride = ((w * depth + 15) // 16) * 2
        need = (h - 1) * stride + row
        if pos + need > len(blob):
            _truncated(name, f"Sun raster rows need {need} bytes")
        rows = np.lib.stride_tricks.as_strided(np.frombuffer(blob, np.uint8, need, pos),
                                               (h, row), (stride, 1))
    if raw == "1;I":
        return _bits(np.unpackbits(rows, axis=1)[:, :w] == 0)
    if raw in ("L;4", "P;4"):
        v = np.stack([rows >> 4, rows & 15], 2).reshape(h, -1)[:, :w]
        return v * np.uint8(17) if raw == "L;4" else np.ascontiguousarray(v)
    if raw in ("L", "P"):
        return np.ascontiguousarray(rows[:, :w])
    c = 3 if raw in ("RGB", "BGR") else 4
    v = np.asarray(rows[:, :c * w]).reshape(h, w, c)[..., :3]
    return np.ascontiguousarray(v if raw.startswith("RGB") else v[..., ::-1])


def sun_rle_reference(data: bytes, row_bytes: int, rows: int) -> np.ndarray:
    """The plain version of `native.sun_rle`: Pillow's SunRleDecode (80 n v:
    n + 1 copies of v, 80 00: one 80, any other byte itself; a run goes on
    into the next rows) -> uint8 [rows, row_bytes]."""
    flat = bytearray()
    total, p = rows * row_bytes, 0
    while len(flat) < total:
        if p >= len(data):
            raise ValueError("image file is truncated (Sun raster runs)")
        if data[p] == 0x80:
            if p + 2 > len(data):
                raise ValueError("image file is truncated (Sun raster runs)")
            if data[p + 1] == 0:
                flat.append(0x80)
                p += 2
                continue
            if p + 3 > len(data):
                raise ValueError("image file is truncated (Sun raster runs)")
            flat += bytes([data[p + 2]]) * (data[p + 1] + 1)
            p += 3
        else:
            flat.append(data[p])
            p += 1
    return np.frombuffer(bytes(flat[:total]), np.uint8).reshape(rows, row_bytes)


# ---- ICNS -----------------------------------------------------------------------------

# IcnsFile.SIZES: (width, height, scale) -> its entry types, in the order
# IcnsFile.dataforsize reads them ("png" a PNG or JPEG 2000 entry, "rle"
# 24-bit RGB, "rle_t" it32's, "mask" an 8-bit alpha mask).
_ICNS_SIZES = {(512, 512, 2): [(b"ic10", "png")], (512, 512, 1): [(b"ic09", "png")],
               (256, 256, 2): [(b"ic14", "png")], (256, 256, 1): [(b"ic08", "png")],
               (128, 128, 2): [(b"ic13", "png")],
               (128, 128, 1): [(b"ic07", "png"), (b"it32", "rle_t"), (b"t8mk", "mask")],
               (64, 64, 1): [(b"icp6", "png")], (32, 32, 2): [(b"ic12", "png")],
               (48, 48, 1): [(b"ih32", "rle"), (b"h8mk", "mask")],
               (32, 32, 1): [(b"icp5", "png"), (b"il32", "rle"), (b"l8mk", "mask")],
               (16, 16, 2): [(b"ic11", "png")],
               (16, 16, 1): [(b"icp4", "png"), (b"is32", "rle"), (b"s8mk", "mask")]}


def _icns_rgba(img: np.ndarray, mode: str, name: str) -> np.ndarray:
    """A JPEG 2000 entry's array -> RGBA as PIL's convert("RGBA") makes it."""
    h, w = img.shape[:2]
    out = np.full((h, w, 4), 255, np.uint8)
    if mode == "RGBA":
        return img
    if mode == "RGB":
        out[..., :3] = img
    elif mode in ("L", "I;16"):
        out[..., :3] = np.minimum(img, 255)[..., None]
    elif mode == "LA":
        out[..., :3], out[..., 3] = img[..., :1], img[..., 1]
    elif mode == "CMYK":
        nk = 255 - img[..., 3:].astype(np.int32)
        t = img[..., :3].astype(np.int32) * nk + 128
        out[..., :3] = np.clip(nk - (((t >> 8) + t) >> 8), 0, 255)
    else:
        raise ValueError(f"{name}: an ICNS JPEG 2000 entry in mode {mode} (only RGB(A), L(A), "
                         f"I;16 and CMYK entries are read)")
    return out


def _icns_rle(blob: bytes, at: int, side: Tuple[int, int], name: str) -> np.ndarray:
    """IcnsImagePlugin.read_32's packbits-like runs from `at`, band by band
    (reading on past the entry as PIL's file reads do)."""
    n = side[0] * side[1]
    bands = []
    for _ in range(3):
        data, left = bytearray(), n
        while left > 0:
            if at >= len(blob):
                break
            b = blob[at]
            at += 1
            if b & 0x80:
                size = b - 125
                data += blob[at:at + 1] * size
                at += 1
            else:
                size = b + 1
                data += blob[at:at + size]
                at += size
            left -= size
        if left != 0:
            raise ValueError(f"{name}: ICNS RGB runs end {left} samples off their band")
        if len(data) < n:
            raise ValueError(f"{name}: not enough image data in an ICNS RGB entry")
        bands.append(np.frombuffer(bytes(data[:n]), np.uint8).reshape(side[1], side[0]))
    return np.stack(bands, -1)


def decode_icns(blob: bytes, name: str = "<bytes>") -> Optional[np.ndarray]:
    """IcnsImagePlugin: the entry of the largest (width, height, scale) that
    has one: a PNG entry in the PNG's own mode, a JPEG 2000 entry converted
    to RGBA, or 24-bit RGB (raw, or runs per band) with its 8-bit mask as
    alpha (RGB without one). None where PIL's plugin declines the file."""
    from wast3d_tpu_torch.utils import jpeg2000

    if len(blob) < 8:
        return None
    filesize = struct.unpack_from(">I", blob, 4)[0]
    entries, i = {}, 8
    while i < filesize:
        if i + 8 > len(blob):
            return None
        sig, size = struct.unpack_from(">4sI", blob, i)
        if size <= 0:
            return None
        entries[sig] = (i + 8, size - 8)
        i += size
    sizes = [s for s, kinds in _ICNS_SIZES.items() if any(k in entries for k, _ in kinds)]
    if not sizes:
        return None
    best = max(sizes)
    side = (best[0] * best[2], best[1] * best[2])
    _check_pixels(*side, name)
    channels: Dict[str, np.ndarray] = {}
    pad = 255  # the fourth byte of PIL's RGB pixels: 0 where Image.new made them
    for code, kind in _ICNS_SIZES[best]:
        if code not in entries:
            continue
        start, length = entries[code]
        if kind == "png":
            head = blob[start:start + 12]
            if head.startswith(png._SIGNATURE):
                channels["RGBA"] = png.decode_png(blob[start:], name)
            elif head.startswith((jpeg2000.J2K_SIGNATURE, b"\r\n\x87\n")) \
                    or head == jpeg2000.JP2_SIGNATURE:
                entry = blob[start:start + length]
                mode = jpeg2000.pil_mode(entry, name)
                channels["RGBA"] = _icns_rgba(jpeg2000.decode_jpeg2000(entry, name), mode, name)
            else:
                raise ValueError(f"{name}: unsupported ICNS subimage format")
        elif kind == "mask":
            a = np.frombuffer(blob[start:start + side[0] * side[1]], np.uint8)
            if a.size < side[0] * side[1]:
                raise ValueError(f"{name}: not enough image data in an ICNS mask")
            channels["A"] = a.reshape(side[1], side[0])
        else:
            if kind == "rle_t":
                if blob[start:start + 4] != b"\x00\x00\x00\x00":
                    raise ValueError(f"{name}: it32 entry without its zero signature")
                start, length = start + 4, length - 4
            if length == side[0] * side[1] * 3:
                channels["RGB"] = np.frombuffer(blob[start:start + length],
                                                np.uint8).reshape(side[1], side[0], 3)
            else:
                channels["RGB"], pad = _icns_rle(blob, start, side, name), 0
    if "RGBA" in channels:
        img, pad = channels["RGBA"], 255
    elif "RGB" not in channels:
        raise ValueError(f"{name}: an ICNS size with a mask and no RGB entry (PIL's KeyError)")
    elif "A" in channels:
        return np.concatenate([channels["RGB"], channels["A"][..., None]], -1)
    else:
        img = channels["RGB"]
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError(f"{name}: an ICNS PNG entry that is not RGB or RGBA (PIL: no packer "
                         f"to RGBA)")
    if img.shape[2] == 4:
        return img
    # PIL opened the file as RGBA: np.asarray packs the RGB image's 4-byte
    # pixels (R, G, B, pad) and reads the first 3 * h * w bytes as RGB.
    h, w = img.shape[:2]
    packed = np.concatenate([img, np.full((h, w, 1), pad, np.uint8)], -1)
    return packed.reshape(-1)[:3 * h * w].reshape(h, w, 3).copy()
