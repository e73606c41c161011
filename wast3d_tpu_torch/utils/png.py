"""PNG read/write and PIL's image resize without PIL (stdlib `zlib`, numpy
and the native host library).

The JAX package reads, writes and resizes images with PIL, which the card's
machine does not have. This module gives PIL's results:

- `encode_png` / `write_png`: 8-bit (uint8) or 16-bit (uint16) grey,
  grey+alpha, RGB or RGBA, every row with one filter type (0, the default,
  to 4), optionally Adam7 interlaced.
- `decode_png` / `read_png`: every colour type at every bit depth the PNG
  specification allows, with all five row filters, non-interlaced or Adam7,
  giving what `np.asarray(PIL.Image.open(f))` gives (PngImagePlugin's
  modes): 8-bit files their samples; 16-bit RGB, RGBA and grey+alpha the
  high byte of each sample (grey+alpha as RGBA: grey, grey, grey, alpha);
  16-bit grey uint16 values ("I;16"); 2- and 4-bit grey scaled to 8 bits
  (x 85, x 17); 1-bit grey bool (holding the bytes 0 and 255, as PIL's
  does); palette files their indices. PLTE, tRNS and the other ancillary
  chunks leave the array alone; the CRC of every chunk before the image
  data is checked and IDAT's is not, as PIL does. `zlib` inflates the data;
  the native library (`native/image.cpp`, `native.png_unfilter`) undoes the
  filters, unpacks sub-byte samples and the interlacing, with no fallback.
  `decode_png_reference` (`_unfilter`, `_unpack`, `_deinterlace`) is the
  plain numpy version the tests hold it to.
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
from typing import NamedTuple, Tuple

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples per pixel
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}  # channels -> colour type, for the writer
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
    """uint8 [h, w, c] or uint16 [h, w, c] -> the filtered scanlines [h, 1 +
    row bytes], each row with filter `ftype`."""
    h, w, c = img.shape
    if img.dtype == np.uint16:
        img = np.ascontiguousarray(img, ">u2").view(np.uint8).reshape(h, w, 2 * c)
        c *= 2
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
    """uint8 or uint16 [H,W], [H,W,1|2|3|4] -> 8- or 16-bit PNG bytes, every
    row filtered with `filter_type` (0-4), Adam7 passes when `interlace`."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"write_png takes uint8 or uint16, got {img.dtype}")
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
    ihdr = struct.pack(">IIBBBBB", w, h, 8 * img.itemsize, _COLOR_TYPE[c], 0, 0, int(interlace))
    return (_SIGNATURE + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", zlib.compress(raw, 6))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray, filter_type: int = 0, interlace: bool = False) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_png(img, filter_type, interlace))


def _unfilter(data: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Plain version: filtered scanlines [h (1 + stride)] -> uint8 [h,
    stride], `bpp` bytes a pixel for the filters."""
    rows = data.reshape(h, 1 + stride)
    out = np.zeros((h, stride), np.int32)
    prior = np.zeros(stride, np.int32)
    for y in range(h):
        ftype = int(rows[y, 0])
        filt = rows[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = filt
        elif ftype == 1:  # Sub: running sum along the row, per byte of a pixel
            cur = np.cumsum(filt.reshape(-1, bpp), axis=0).reshape(stride) & 0xFF
        elif ftype == 2:  # Up
            cur = (filt + prior) & 0xFF
        elif ftype in (3, 4):  # Average / Paeth: sequential along the row
            cur = np.zeros(stride, np.int32)
            for x in range(stride):
                left = cur[x - bpp] if x >= bpp else 0
                upleft = prior[x - bpp] if x >= bpp else 0
                pred = (left + prior[x]) // 2 if ftype == 3 else _paeth(left, prior[x], upleft)
                cur[x] = (filt[x] + pred) & 0xFF
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = cur
        prior = cur
    return out.astype(np.uint8)


def _unpack(rows: np.ndarray, w: int, bits: int) -> np.ndarray:
    """Plain version of `native.unpack_bits`: uint8 rows of `bits`-bit
    samples packed from the high bit -> uint8 [h, w] sample values."""
    shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
    vals = (rows[:, :, None] >> shifts) & ((1 << bits) - 1)
    return vals.reshape(rows.shape[0], -1)[:, :w].astype(np.uint8)


def _samples(data: np.ndarray, h: int, w: int, c: int, bits: int) -> np.ndarray:
    """One (sub-)image's filtered scanlines -> its samples as
    `native.png_unfilter` gives them, in plain numpy."""
    stride = (w * c * bits + 7) // 8
    rows = _unfilter(data, h, stride, max(1, c * bits // 8))
    if bits < 8:
        return _unpack(rows, w, bits)[:, :, None]
    return rows.reshape(h, w, -1)


def _pass_size(h: int, w: int, x0: int, y0: int, dx: int, dy: int):
    return (h - y0 + dy - 1) // dy if h > y0 else 0, (w - x0 + dx - 1) // dx if w > x0 else 0


def _deinterlace(data: np.ndarray, h: int, w: int, c: int, bits: int) -> np.ndarray:
    """Plain version of Adam7: each pass is its own filtered sub-image (an
    empty pass has no bytes)."""
    out = np.zeros((h, w, c * 2 if bits == 16 else (c if bits == 8 else 1)), np.uint8)
    pos = 0
    for x0, y0, dx, dy in ADAM7:
        ph, pw = _pass_size(h, w, x0, y0, dx, dy)
        if ph == 0 or pw == 0:
            continue
        n = ph * (1 + (pw * c * bits + 7) // 8)
        if pos + n > data.size:
            raise ValueError("PNG image data too short")
        out[y0::dy, x0::dx] = _samples(data[pos:pos + n], ph, pw, c, bits)
        pos += n
    if pos != data.size:
        raise ValueError("PNG image data has trailing bytes")
    return out


class PngHeader(NamedTuple):
    width: int
    height: int
    depth: int
    color_type: int
    interlaced: bool

    @property
    def channels(self) -> int:
        return _CHANNELS[self.color_type]


def read_chunks(blob: bytes, name: str = "<bytes>") -> Tuple[PngHeader, np.ndarray]:
    """PNG bytes -> (its header, the inflated filtered scanlines as uint8).
    Colour types and bit depths outside the specification raise, as PIL
    raises on them; so does a bad CRC in a chunk before the image data."""
    if blob[:8] != _SIGNATURE:
        raise ValueError(f"{name}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos + 8 <= len(blob):
        (length,) = struct.unpack(">I", blob[pos:pos + 4])
        tag = blob[pos + 4:pos + 8]
        data = blob[pos + 8:pos + 8 + length]
        if not idat and tag != b"IDAT":
            crc = blob[pos + 8 + length:pos + 12 + length]
            if len(crc) < 4 or struct.unpack(">I", crc)[0] != zlib.crc32(tag + data):
                raise ValueError(f"{name}: broken PNG file (bad checksum in {tag!r})")
        pos += 12 + length
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", data)
        elif tag == b"IDAT":
            idat.append(data)
        elif tag == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{name}: PNG without IHDR")
    w, h, depth, ctype, _comp, _filt, interlace = hdr
    if depth not in _DEPTHS.get(ctype, ()) or interlace not in (0, 1):
        raise ValueError(f"{name}: unknown PNG mode (bit depth {depth}, colour type {ctype}, "
                         f"interlace {interlace})")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    return PngHeader(w, h, depth, ctype, bool(interlace)), raw


def parse_png(blob: bytes):
    """PNG bytes -> (width, height, channels, interlaced, the inflated
    filtered scanlines as uint8)."""
    hdr, raw = read_chunks(blob)
    return hdr.width, hdr.height, hdr.channels, hdr.interlaced, raw


def pil_array(samples: np.ndarray, hdr: PngHeader) -> np.ndarray:
    """`png_unfilter`'s samples -> `np.asarray(PIL.Image.open(f))`
    (PngImagePlugin's mode for the bit depth and colour type)."""
    depth, ctype = hdr.depth, hdr.color_type
    if depth < 8:
        v = samples[:, :, 0]
        if ctype == 3:  # "P": the indices
            return v
        # mode "1": PIL's bool array holds the bytes 0 and 255
        return (v * np.uint8(255 // ((1 << depth) - 1))).view(bool if depth == 1 else np.uint8)
    if depth == 8:
        return samples[:, :, 0] if samples.shape[2] == 1 else samples
    if ctype == 0:  # "I;16"
        return samples.view(">u2")[:, :, 0].astype(np.uint16)
    hi = samples[:, :, 0::2]  # "RGB;16B", "RGBA;16B", "LA;16B": the high bytes
    if ctype == 4:
        hi = hi[:, :, [0, 0, 0, 1]]
    return np.ascontiguousarray(hi)


def decode_png_reference(blob: bytes) -> np.ndarray:
    """Plain version of `decode_png` (numpy unfiltering, row by row)."""
    hdr, raw = read_chunks(blob)
    h, w, c, bits = hdr.height, hdr.width, hdr.channels, hdr.depth
    if hdr.interlaced:
        samples = _deinterlace(raw, h, w, c, bits)
    else:
        if raw.size != h * (1 + (w * c * bits + 7) // 8):
            raise ValueError("PNG image data does not match its size")
        samples = _samples(raw, h, w, c, bits)
    return pil_array(samples, hdr)


def decode_png(blob: bytes, name: str = "<bytes>") -> np.ndarray:
    """PNG bytes -> PIL's array of them (module docstring); the native
    library undoes the filters, the packing and the interlacing."""
    from wast3d_tpu_torch import native

    hdr, raw = read_chunks(blob, name)
    samples = native.png_unfilter(raw, hdr.height, hdr.width, hdr.channels, hdr.interlaced,
                                  name, bits=hdr.depth)
    return pil_array(samples, hdr)


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
