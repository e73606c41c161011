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
  Deflate (8, 32946), predictor 1 or 2;
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
  hold the frame) filled with the transparent index, or 0, outside the frame.

Anything else raises `ValueError` naming the file and, for an unknown
signature, its first bytes; a TIFF outside these names the tag and its
value. A WebP or GIF of more pixels than PIL opens (twice
`PIL.Image.MAX_IMAGE_PIXELS`) raises before anything is allocated. The byte
loops are native (`native/image.cpp`, `native/jpeg.cpp`, `native/webp.cpp`,
with no fallback); numpy here turns samples into PIL's arrays. The plain
versions the tests hold the native routines to are here too
(`bmp_rle_reference`, `lzw_reference`, `packbits_reference`,
`jpeg_upsample_reference`, `gif_lzw_reference`, `vp8_idct_reference`,
`yuv_to_rgba_reference`) and in `utils/png.py`.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, Tuple

import numpy as np

from wast3d_tpu_torch.utils import png

_PNG = b"\x89PNG\r\n\x1a\n"
_WEBP_FIRST = (b"VP8 ", b"VP8L", b"VP8X")


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
    if blob[:4] == b"RIFF" and blob[8:12] == b"WEBP" and blob[12:16] in _WEBP_FIRST:
        return decode_webp(blob, name)
    if blob[:6] in (b"GIF87a", b"GIF89a"):
        return decode_gif(blob, name)
    raise ValueError(f"{name}: not an image this reader knows (PNG, JPEG, BMP, TIFF, WebP or "
                     f"GIF); it starts with {blob[:8]!r}")


# PIL refuses (DecompressionBombError) more pixels than twice MAX_IMAGE_PIXELS.
MAX_PIXELS = 2 * (1024 * 1024 * 1024 // 4 // 3)


def _check_pixels(width: int, height: int, name: str) -> None:
    if width * height > MAX_PIXELS:
        raise ValueError(f"{name}: {width}x{height} is more pixels than PIL opens "
                         f"({MAX_PIXELS})")


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
