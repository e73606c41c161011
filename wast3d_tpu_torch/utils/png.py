"""PNG read/write and PIL's image resize without PIL (stdlib `zlib`, numpy
and the native host library).

The JAX package reads, writes and resizes images with PIL, which the card's
machine does not have. This module gives PIL's results:

- `encode_png` / `write_png`: 8-bit grey, grey+alpha, RGB or RGBA, every
  row with one filter type (0, the default, to 4), optionally Adam7
  interlaced.
- `decode_png` / `read_png`: 8-bit grey, grey+alpha, RGB and RGBA, with all
  five row filters, non-interlaced or Adam7. `zlib` inflates the data; the
  native library (`native/image.cpp`, `native.png_unfilter`) undoes the
  filters and the interlacing, with no fallback. `_unfilter` and
  `_deinterlace` are the plain numpy versions the tests hold it to.
  Palette and 16-bit files raise ValueError.
- `resize`: PIL's default `Image.resize` (bicubic, Pillow's
  `src/libImaging/Resample.c`) on uint8 [H,W] or [H,W,C], bit for bit, in
  plain numpy; `resize_native` is the same through `native.resize_u8`.
  Each axis: scale = in / out, filter scale fs = max(scale, 1), support
  2 fs; output x reads inputs [xmin, xmax) around center = (x + 0.5) scale
  with weights cubic((j + xmin - center + 0.5) / fs) (a = -0.5), normalised
  in double and rounded to 22 fractional bits; the sum, plus a half, is
  shifted down and clipped to uint8. The horizontal pass runs first and
  rounds to uint8, then the vertical one; an axis whose size does not
  change is skipped. As PIL does, images with alpha (grey+alpha, RGBA) are
  resampled premultiplied and divided back.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}  # colour type -> samples per pixel
_COLOR_TYPE = {v: k for k, v in _CHANNELS.items()}
# Adam7 passes: (x0, y0, dx, dy) of each pass's pixels in the image.
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))
PRECISION_BITS = 22  # Resample.c's fixed point for 8-bit images


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filter_rows(img: np.ndarray, ftype: int) -> np.ndarray:
    """uint8 [h, w, c] -> the filtered scanlines [h, 1 + w c], each row with
    filter `ftype`."""
    h, w, c = img.shape
    x = img.reshape(h, w * c).astype(np.int32)
    up = np.concatenate([np.zeros((1, w * c), np.int32), x[:-1]])
    left = np.concatenate([np.zeros((h, c), np.int32), x[:, :-c]], axis=1)
    upleft = np.concatenate([np.zeros((h, c), np.int32), up[:, :-c]], axis=1)
    pred = {0: 0, 1: left, 2: up, 3: (left + up) // 2, 4: _paeth(left, up, upleft)}[ftype]
    out = np.empty((h, 1 + w * c), np.uint8)
    out[:, 0] = ftype
    out[:, 1:] = (x - pred) & 0xFF
    return out


def encode_png(img: np.ndarray, filter_type: int = 0, interlace: bool = False) -> bytes:
    """uint8 [H,W], [H,W,1|2|3|4] -> PNG bytes, every row filtered with
    `filter_type` (0-4), Adam7 passes when `interlace`."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    if c not in _COLOR_TYPE:
        raise ValueError(f"unsupported channel count {c}")
    if filter_type not in range(5):
        raise ValueError(f"bad PNG filter type {filter_type}")
    if interlace:
        passes = [img[y0::dy, x0::dx] for x0, y0, dx, dy in ADAM7]
        raw = b"".join(_filter_rows(p, filter_type).tobytes() for p in passes if p.size)
    else:
        raw = _filter_rows(img, filter_type).tobytes()
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, int(interlace))
    return (_SIGNATURE + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", zlib.compress(raw, 6))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray, filter_type: int = 0, interlace: bool = False) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_png(img, filter_type, interlace))


def _unfilter(data: np.ndarray, h: int, w: int, bpp: int) -> np.ndarray:
    """Plain version: filtered scanlines [h (1 + w bpp)] -> uint8 [h, w bpp]."""
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


def _pass_size(h: int, w: int, x0: int, y0: int, dx: int, dy: int):
    return (h - y0 + dy - 1) // dy if h > y0 else 0, (w - x0 + dx - 1) // dx if w > x0 else 0


def _deinterlace(data: np.ndarray, h: int, w: int, bpp: int) -> np.ndarray:
    """Plain version of Adam7: each pass is its own filtered sub-image (an
    empty pass has no bytes) -> uint8 [h, w bpp]."""
    out = np.zeros((h, w, bpp), np.uint8)
    pos = 0
    for x0, y0, dx, dy in ADAM7:
        ph, pw = _pass_size(h, w, x0, y0, dx, dy)
        if ph == 0 or pw == 0:
            continue
        n = ph * (1 + pw * bpp)
        if pos + n > data.size:
            raise ValueError("PNG image data too short")
        out[y0::dy, x0::dx] = _unfilter(data[pos:pos + n], ph, pw, bpp).reshape(ph, pw, bpp)
        pos += n
    if pos != data.size:
        raise ValueError("PNG image data has trailing bytes")
    return out.reshape(h, w * bpp)


def parse_png(blob: bytes):
    """PNG bytes -> (width, height, channels, interlaced, the inflated
    filtered scanlines as uint8)."""
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
    if depth != 8 or ctype not in _CHANNELS or interlace not in (0, 1):
        raise ValueError(
            f"unsupported PNG (bit depth {depth}, colour type {ctype}, "
            f"interlace {interlace}): 8-bit grey/grey+alpha/RGB/RGBA only")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    return w, h, _CHANNELS[ctype], bool(interlace), raw


def decode_png_reference(blob: bytes) -> np.ndarray:
    """Plain version of `decode_png` (numpy unfiltering, row by row)."""
    w, h, c, interlaced, raw = parse_png(blob)
    if interlaced:
        img = _deinterlace(raw, h, w, c)
    else:
        if raw.size != h * (1 + w * c):
            raise ValueError("PNG image data does not match its size")
        img = _unfilter(raw, h, w, c)
    img = img.reshape(h, w, c)
    return img[:, :, 0] if c == 1 else img


def decode_png(blob: bytes, name: str = "<bytes>") -> np.ndarray:
    """PNG bytes -> uint8 [H,W] (grey) or [H,W,C]; the native library
    undoes the filters and the interlacing."""
    from wast3d_tpu_torch import native

    w, h, c, interlaced, raw = parse_png(blob)
    img = native.png_unfilter(raw, h, w, c, interlaced, name)
    return img[:, :, 0] if c == 1 else img


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def _cubic(x: np.ndarray) -> np.ndarray:
    """Resample.c's bicubic_filter, a = -0.5, in its order of operations."""
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def resample_coeffs(n_in: int, n_out: int):
    """Resample.c's precompute_coeffs + normalize_coeffs_8bpc: per output
    index, the first input it reads, how many it reads, and the int64
    weights [n_out, ksize] (zero past that count)."""
    scale = n_in / n_out
    fs = max(scale, 1.0)
    support = 2.0 * fs
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(n_out) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    count = np.minimum(np.trunc(center + support + 0.5), n_in).astype(np.int64) - xmin
    j = np.arange(ksize)
    w = _cubic((j[None, :] + xmin[:, None] - center[:, None] + 0.5) * (1.0 / fs))
    w = np.where(j[None, :] < count[:, None], w, 0.0)
    total = np.zeros(n_out)
    for i in range(ksize):  # summed in order, as the C loop sums
        total = total + w[:, i]
    w = np.where(total[:, None] != 0.0, w / np.where(total == 0.0, 1.0, total)[:, None], w)
    scaled = w * (1 << PRECISION_BITS)
    kk = np.where(w < 0, np.trunc(-0.5 + scaled), np.trunc(0.5 + scaled)).astype(np.int64)
    return xmin, count, kk


def _resample_axis(img: np.ndarray, axis: int, n_out: int) -> np.ndarray:
    n_in = img.shape[axis]
    xmin, count, kk = resample_coeffs(n_in, n_out)
    a = np.moveaxis(img, axis, 0)
    acc = np.full((n_out,) + a.shape[1:], 1 << (PRECISION_BITS - 1), np.int64)
    extra = (1,) * (a.ndim - 1)
    for j in range(kk.shape[1]):
        src = a[np.minimum(xmin + j, n_in - 1)].astype(np.int64)
        acc += src * kk[:, j].reshape((n_out,) + extra)
    out = np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def _resample(img: np.ndarray, width: int, height: int) -> np.ndarray:
    if img.shape[1] != width:
        img = _resample_axis(img, 1, width)
    if img.shape[0] != height:
        img = _resample_axis(img, 0, height)
    return np.ascontiguousarray(img)


def _muldiv255(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    t = a.astype(np.int32) * b + 128
    return ((t >> 8) + t) >> 8


def _premultiplied(img: np.ndarray, width: int, height: int, resample) -> np.ndarray:
    """PIL's `Image.resize` route: grey+alpha and RGBA go through La / RGBa
    (colour times alpha / 255, rounded), are resampled, and are divided
    back (255 colour // alpha, clipped; alpha 0 and 255 kept as is)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (
            img.ndim == 3 and img.shape[2] not in (1, 2, 3, 4)):
        raise ValueError(f"resize takes uint8 [H,W] or [H,W,1-4], got {img.dtype} "
                         f"{img.shape}")
    if width < 1 or height < 1:
        raise ValueError(f"resize to {width}x{height}")
    if img.shape[0] == height and img.shape[1] == width:
        return img.copy()
    if img.ndim == 2 or img.shape[2] in (1, 3):
        return resample(img, width, height)
    alpha = img[..., -1:].astype(np.int32)
    pre = img.copy()
    pre[..., :-1] = _muldiv255(img[..., :-1], alpha)
    out = resample(pre, width, height)
    alpha = out[..., -1:].astype(np.int32)
    colour = out[..., :-1].astype(np.int32)
    keep = (alpha == 0) | (alpha == 255)
    divided = np.minimum(255 * colour // np.maximum(alpha, 1), 255)
    out[..., :-1] = np.where(keep, colour, divided)
    return out


def resize(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """PIL's `Image.fromarray(img).resize((width, height))` for uint8 [H,W]
    or [H,W,C], in plain numpy (module docstring)."""
    return _premultiplied(img, width, height, _resample)


def resize_native(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """`resize` through the native library (`native.resize_u8`)."""
    from wast3d_tpu_torch import native

    return _premultiplied(img, width, height, native.resize_u8)
