"""PNG read/write and image resize without PIL (stdlib `zlib` + numpy).

The JAX package reads, writes and resizes images with PIL, which the card's
machine does not have. This module covers what the serving path needs:

- `write_png`: 8-bit grey, RGB or RGBA, non-interlaced, filter type 0.
- `read_png`: 8-bit non-interlaced grey, grey+alpha, RGB and RGBA, with all
  five row filters. Palette, 16-bit and interlaced files raise ValueError.
- `resize`: replaces `PIL.Image.resize` in `build_cameras`. PIL's default
  filter for RGB images is bicubic; this one takes the box average when
  both sides shrink by a whole factor and the nearest pixel otherwise, so a
  resized ground-truth image differs from the JAX package's by the filter.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}  # colour type -> samples per pixel
_COLOR_TYPE = {v: k for k, v in _CHANNELS.items()}


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """uint8 [H,W], [H,W,1|2|3|4] -> PNG bytes."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    if c not in _COLOR_TYPE:
        raise ValueError(f"unsupported channel count {c}")
    raw = np.zeros((h, 1 + w * c), np.uint8)  # filter byte 0 on every row
    raw[:, 1:] = img.reshape(h, w * c)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_png(img))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(data: np.ndarray, h: int, w: int, bpp: int) -> np.ndarray:
    stride = w * bpp
    rows = data.reshape(h, 1 + stride)
    out = np.zeros((h, stride), np.int32)
    prior = np.zeros(stride, np.int32)
    for y in range(h):
        ftype = int(rows[y, 0])
        filt = rows[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = filt
        elif ftype == 1:  # Sub: running sum along the row, per channel
            cur = np.cumsum(filt.reshape(w, bpp), axis=0).reshape(stride) & 0xFF
        elif ftype == 2:  # Up
            cur = (filt + prior) & 0xFF
        elif ftype in (3, 4):  # Average / Paeth: sequential along the row
            cur = np.zeros(stride, np.int32)
            left = np.zeros(bpp, np.int32)
            upleft = np.zeros(bpp, np.int32)
            for x in range(0, stride, bpp):
                up = prior[x:x + bpp]
                pred = (left + up) // 2 if ftype == 3 else _paeth(left, up, upleft)
                left = (filt[x:x + bpp] + pred) & 0xFF
                cur[x:x + bpp] = left
                upleft = up
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = cur
        prior = cur
    return out.astype(np.uint8)


def decode_png(blob: bytes) -> np.ndarray:
    """PNG bytes -> uint8 [H,W] (grey) or [H,W,C]."""
    if blob[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(blob):
        (length,) = struct.unpack(">I", blob[pos:pos + 4])
        tag = blob[pos + 4:pos + 8]
        data = blob[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", data)
        elif tag == b"IDAT":
            idat.append(data)
        elif tag == b"IEND":
            break
    if hdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _comp, _filt, interlace = hdr
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise ValueError(
            f"unsupported PNG (bit depth {depth}, colour type {ctype}, "
            f"interlace {interlace}): 8-bit non-interlaced grey/RGB/RGBA only")
    c = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    img = _unfilter(raw, h, w, c).reshape(h, w, c)
    return img[:, :, 0] if c == 1 else img


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def resize(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """[H,W,C] float -> [height,width,C]: box average for whole-factor
    shrinks, nearest pixel otherwise (see the module docstring)."""
    h, w = img.shape[:2]
    if h % height == 0 and w % width == 0:
        fy, fx = h // height, w // width
        return img.reshape(height, fy, width, fx, -1).mean(axis=(1, 3)).reshape(
            (height, width) + img.shape[2:]).astype(img.dtype)
    ys = np.minimum(((np.arange(height) + 0.5) * h / height).astype(np.int64), h - 1)
    xs = np.minimum(((np.arange(width) + 0.5) * w / width).astype(np.int64), w - 1)
    return img[ys][:, xs]
