"""Every image the JAX package reads through PIL, read without PIL.

`read_image(path)` / `decode_image(blob, name)` return exactly what
`np.asarray(PIL.Image.open(path))` returns (dtype, shape and values),
dispatching on the file's signature, never on its extension:

- `\\x89PNG\\r\\n\\x1a\\n`: PNG, every colour type at every bit depth
  (`utils/png.decode_png`);
- `FF D8`: JPEG, baseline or progressive, 1, 3 or 4 components, any
  integral sampling (`native.decode_jpeg`);
- `BM`: BMP (`decode_bmp`): BmpImagePlugin's modes (1/4/8-bit palettes as
  "P" indices, or "1" / "L" when the palette is black and white or the
  identity greys; 16-, 24- and 32-bit BI_RGB as RGB; BI_BITFIELDS layouts
  as RGB or RGBA), RLE8 / RLE4, bottom-up or top-down;
- `II*\\0` / `MM\\0*`: TIFF (`decode_tiff`): strips of chunky samples,
  8-bit L, LA, RGB, RGBA (and their ExtraSamples variants), WhiteIsZero L,
  16-bit grey ("I;16", or "I;16B" for big-endian files) and 16-bit RGB(A)
  as the high byte of each sample; compression none, PackBits, LZW or
  Deflate (8, 32946), predictor 1 or 2.

Anything else raises `ValueError` naming the file and, for an unknown
signature, its first bytes; a TIFF outside these names the tag and its
value. The byte loops are native (`native/image.cpp`, `native/jpeg.cpp`,
with no fallback); numpy here turns samples into PIL's arrays. The plain
versions the tests hold the native routines to are here too
(`bmp_rle_reference`, `lzw_reference`, `packbits_reference`,
`jpeg_upsample_reference`) and in `utils/png.py`.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, Tuple

import numpy as np

from wast3d_tpu_torch.utils import png

_PNG = b"\x89PNG\r\n\x1a\n"


def read_image(path: str) -> np.ndarray:
    """`np.asarray(PIL.Image.open(path))`, without PIL."""
    with open(path, "rb") as f:
        return decode_image(f.read(), path)


def decode_image(blob: bytes, name: str = "<bytes>") -> np.ndarray:
    """`np.asarray(PIL.Image.open(io.BytesIO(blob)))`, without PIL; `name`
    names the file in errors."""
    from wast3d_tpu_torch import native

    if blob[:8] == _PNG:
        return png.decode_png(blob, name)
    if blob[:2] == b"\xff\xd8":
        return native.decode_jpeg(blob, name)
    if blob[:2] == b"BM":
        return decode_bmp(blob, name)
    if blob[:4] in (b"II*\x00", b"MM\x00*"):
        return decode_tiff(blob, name)
    raise ValueError(f"{name}: not an image this reader knows (PNG, JPEG, BMP or TIFF); "
                     f"it starts with {blob[:8]!r}")


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


# ---- TIFF: Pillow's TiffImagePlugin on strips -----------------------------------------

_TIFF_TYPES = {1: "B", 2: "c", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 16: "Q"}
# (photometric, bits per sample, extra samples) -> (mode, raw mode)
_TIFF_MODES = {
    (0, (8,), ()): ("L", "L;I"),
    (1, (8,), ()): ("L", "L"),
    (1, (16,), ()): ("I;16", "I;16"),
    (1, (8, 8), (2,)): ("LA", "LA"),
    (2, (8, 8, 8), ()): ("RGB", "RGB"),
    (2, (8, 8, 8, 8), ()): ("RGBA", "RGBA"),
    (2, (8, 8, 8, 8), (0,)): ("RGB", "RGBX"),
    (2, (8, 8, 8, 8), (1,)): ("RGBA", "RGBa"),
    (2, (8, 8, 8, 8), (2,)): ("RGBA", "RGBA"),
    (2, (8, 8, 8, 8), (999,)): ("RGBA", "RGBA"),
    (2, (16, 16, 16), ()): ("RGB", "RGB;16"),
    (2, (16, 16, 16, 16), ()): ("RGBA", "RGBA;16"),
    (2, (16, 16, 16, 16), (0,)): ("RGB", "RGBX;16"),
    (2, (16, 16, 16, 16), (1,)): ("RGBA", "RGBa;16"),
    (2, (16, 16, 16, 16), (2,)): ("RGBA", "RGBA;16"),
}
_TAG_NAMES = {259: "Compression", 262: "PhotometricInterpretation", 258: "BitsPerSample",
              266: "FillOrder", 284: "PlanarConfiguration", 317: "Predictor",
              322: "TileWidth", 338: "ExtraSamples", 339: "SampleFormat",
              277: "SamplesPerPixel"}


def _tiff_tags(blob: bytes, name: str) -> Tuple[str, Dict[int, tuple]]:
    bo = "<" if blob[:2] == b"II" else ">"
    (ifd,) = struct.unpack_from(bo + "I", blob, 4)
    if ifd + 2 > len(blob):
        raise ValueError(f"{name}: TIFF directory past the end of the file")
    (n,) = struct.unpack_from(bo + "H", blob, ifd)
    tags = {}
    for i in range(n):
        tag, typ, count = struct.unpack_from(bo + "HHI", blob, ifd + 2 + 12 * i)
        if typ not in _TIFF_TYPES or typ == 2:
            continue  # text, rationals and the rest: no tag read here uses them
        size = struct.calcsize(_TIFF_TYPES[typ]) * count
        at = ifd + 10 + 12 * i
        if size > 4:
            (at,) = struct.unpack_from(bo + "I", blob, at)
        if at + size > len(blob):
            raise ValueError(f"{name}: TIFF tag {tag} past the end of the file")
        tags[tag] = struct.unpack_from(bo + _TIFF_TYPES[typ] * count, blob, at)
    return bo, tags


def _refuse(name: str, tag: int, value) -> None:
    raise ValueError(f"{name}: TIFF {_TAG_NAMES.get(tag, tag)} (tag {tag}) = {value} is not "
                     "supported")


def _tiff_strip(data: bytes, compression: int, size: int, name: str) -> np.ndarray:
    from wast3d_tpu_torch import native

    if compression == 1:
        out = np.frombuffer(data[:size], np.uint8)
    elif compression == 32773:
        out = native.packbits_decode(data, size, name)
    elif compression == 5:
        out = native.lzw_decode(data, size, name)
    else:  # 8, 32946: Deflate
        try:
            out = np.frombuffer(zlib.decompressobj().decompress(data, size), np.uint8)
        except zlib.error as e:
            raise ValueError(f"{name}: bad Deflate data in a TIFF strip ({e})") from None
    if out.size < size:
        raise ValueError(f"{name}: TIFF strip decodes to {out.size} of {size} bytes")
    return out


def decode_tiff(blob: bytes, name: str = "<bytes>") -> np.ndarray:
    """TIFF bytes (the first image) -> `np.asarray(PIL.Image.open(...))`
    (module docstring)."""
    bo, tags = _tiff_tags(blob, name)
    if 322 in tags:
        _refuse(name, 322, tags[322][0])
    w, h = tags[256][0], tags[257][0]
    spp = tags.get(277, (1,))[0]
    bits = tags.get(258, (1,))
    bits = bits * spp if len(bits) == 1 and spp > 1 else bits
    extra = tags.get(338, ())
    for tag, default in ((266, 1), (284, 1), (339, 1)):
        value = tags.get(tag, (default,))
        if any(v != default for v in value):
            _refuse(name, tag, value[0] if len(value) == 1 else value)
    compression = tags.get(259, (1,))[0]
    if compression not in (1, 5, 8, 32773, 32946):
        _refuse(name, 259, compression)
    predictor = tags.get(317, (1,))[0]
    if predictor not in (1, 2):
        _refuse(name, 317, predictor)
    photometric = tags.get(262, (None,))[0]
    key = (photometric, tuple(bits), tuple(extra))
    if key not in _TIFF_MODES:
        if photometric not in (0, 1, 2):
            _refuse(name, 262, photometric)
        _refuse(name, 258, f"{tuple(bits)} (ExtraSamples {tuple(extra)})")
    mode, raw_mode = _TIFF_MODES[key]
    nbytes = bits[0] // 8
    rps = min(tags.get(278, (2 ** 32 - 1,))[0], h)
    offsets, counts = tags[273], tags.get(279)
    if counts is None or len(counts) != len(offsets) or len(offsets) != -(-h // rps):
        raise ValueError(f"{name}: TIFF strips do not cover the image")
    row = w * spp * nbytes
    dtype = np.dtype(bo + ("u2" if nbytes == 2 else "u1"))
    strips = []
    for i, (off, cnt) in enumerate(zip(offsets, counts)):
        rows = min(rps, h - i * rps)
        raw = _tiff_strip(blob[off:off + cnt], compression, rows * row, name)
        s = raw[:rows * row].view(dtype).astype(dtype.newbyteorder("=")).reshape(rows, w, spp)
        if predictor == 2 and compression in (5, 8, 32946):  # libtiff's horizontal sums
            s = np.cumsum(s, axis=1, dtype=s.dtype)
        strips.append(s)
    v = np.concatenate(strips)
    if mode == "I;16":
        return v[..., 0].astype(">u2") if bo == ">" else v[..., 0]
    if nbytes == 2:
        v = (v >> 8).astype(np.uint8)
    if raw_mode == "L;I":
        return 255 - v[..., 0]
    if mode == "L":
        return v[..., 0]
    if raw_mode.startswith("RGBX"):
        return np.ascontiguousarray(v[..., :3])
    if raw_mode.startswith("RGBa"):  # associated alpha: Unpack.c's unpackRGBa
        a = v[..., 3:].astype(np.int32)
        rgb = np.minimum(v[..., :3].astype(np.int32) * 255 // np.maximum(a, 1), 255)
        rgb = np.where(a == 255, v[..., :3], rgb)
        return np.where(a == 0, 0, np.concatenate([rgb, a], -1)).astype(np.uint8)
    return np.ascontiguousarray(v)


def lzw_reference(blob: bytes, out_size: int) -> np.ndarray:
    """Plain version of `native.lzw_decode` (libtiff's LZWDecode)."""
    table = [bytes([i]) for i in range(256)] + [b"", b""]
    out, width, old, pos, acc, have = bytearray(), 9, None, 0, 0, 0
    while True:
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
            table, width, old = table[:258], 9, None
            continue
        if old is None:
            if code > 255:
                raise ValueError(f"corrupt LZW data (first code {code})")
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            if len(table) < 4096:
                table.append(old + entry[:1])
        elif code == len(table) and len(table) < 4096:
            entry = old + old[:1]
            table.append(entry)
        else:
            raise ValueError(f"corrupt LZW data (code {code} past the table)")
        out += entry
        old = entry
        if len(table) + 1 >= (1 << width) and width < 12:
            width += 1
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
