"""WebP files that PIL's `save` cannot ask for, written through libwebp by ctypes.

A tool for writing test fixtures where PIL is installed; the port never
imports it, and `chip_smoke.py` does not either (the card's machine has no
Pillow). It needs the libwebp that Pillow's wheel bundles in
`site-packages/pillow.libs/` (`libwebp-*.so.7.2.0`, libwebp 1.6, encoder ABI
0x0210), with its `libsharpyuv-*.so` loaded first with `RTLD_GLOBAL`; it calls
the exported `WebPConfigInitInternal`, `WebPPictureInitInternal`,
`WebPPictureImportRGB(A)`, `WebPEncode` and the memory writer.

`encode(img, **fields)` starts from `WebPConfigInit` (quality 75, method 4)
and sets any of these `WebPConfig` fields: `lossless`, `quality`, `method`,
`segments` (1-4), `sns_strength`, `filter_strength` (0-100),
`filter_sharpness` (0-7), `filter_type` (0 simple, 1 normal), `autofilter`,
`alpha_compression` (0 raw, 1 lossless), `alpha_filtering` (0-2),
`alpha_quality`, `partitions` (log2 of the token partitions, 0-3; libwebp
writes one partition whatever this says at `method` 3 and above),
`near_lossless`, `exact`, `use_sharp_yuv`. PIL's own writer leaves most of
them at their defaults (the normal loop filter, 4 segments, one token
partition), so the simple filter, one segment, 2-8 partitions, raw or
unfiltered alpha and near-lossless files come from here.

`animation(canvas, frames)` wraps single-image files into an animated WebP
(VP8X + ANIM + one ANMF per frame at its offset), which gives a first frame
smaller than the canvas; PIL's animation writer always starts with a whole
canvas. `with_alpha(lossy, alpha_chunk(alpha, compression, filtering))` adds
an ALPH chunk built here with any compression (raw, lossless) and filter
(none, horizontal, vertical, gradient): libwebp's encoder picks the filter
itself, and never filters raw alpha.
"""

from __future__ import annotations

import ctypes
import glob
import os
import struct
from typing import Dict, List, Tuple

import numpy as np

_FIELDS = {  # WebPConfig (libwebp 1.6): offset of each field, in 4-byte ints
    "lossless": 0, "quality": 1, "method": 2, "segments": 6, "sns_strength": 7,
    "filter_strength": 8, "filter_sharpness": 9, "filter_type": 10, "autofilter": 11,
    "alpha_compression": 12, "alpha_filtering": 13, "alpha_quality": 14, "partitions": 18,
    "near_lossless": 23, "exact": 24, "use_sharp_yuv": 26}
_ABI = 0x0210
# WebPPicture (x86-64): byte offsets of the fields set here
_PIC_USE_ARGB, _PIC_WIDTH, _PIC_WRITER = 0, 8, 96  # writer, then custom_ptr
_LIB = None


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from PIL import __file__ as pil_init

        libs = os.path.join(os.path.dirname(os.path.dirname(pil_init)), "pillow.libs")
        sharp = glob.glob(os.path.join(libs, "libsharpyuv-*.so*"))
        webp = glob.glob(os.path.join(libs, "libwebp-*.so.7*"))
        if not sharp or not webp:
            raise RuntimeError(f"no libwebp / libsharpyuv under {libs}")
        ctypes.CDLL(sharp[0], mode=ctypes.RTLD_GLOBAL)
        _LIB = ctypes.CDLL(webp[0])
    return _LIB


class _MemoryWriter(ctypes.Structure):
    _fields_ = [("mem", ctypes.POINTER(ctypes.c_uint8)), ("size", ctypes.c_size_t),
                ("max_size", ctypes.c_size_t), ("pad", ctypes.c_uint32 * 1)]


def encode(img: np.ndarray, **fields) -> bytes:
    """uint8 [H, W, 3] or [H, W, 4] -> a WebP file written with the given
    `WebPConfig` fields (module docstring)."""
    lib = _library()
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    config = (ctypes.c_int32 * 64)()
    if not lib.WebPConfigInitInternal(config, 0, ctypes.c_float(75.0), _ABI):
        raise RuntimeError("WebPConfigInit failed (libwebp ABI)")
    floats = ctypes.cast(config, ctypes.POINTER(ctypes.c_float))
    for key, value in fields.items():
        if key == "quality":
            floats[_FIELDS[key]] = float(value)
        else:
            config[_FIELDS[key]] = int(value)
    if not lib.WebPValidateConfig(config):
        raise ValueError(f"libwebp refuses the configuration {fields}")
    picture = (ctypes.c_uint8 * 256)()
    if not lib.WebPPictureInitInternal(picture, _ABI):
        raise RuntimeError("WebPPictureInit failed (libwebp ABI)")
    struct.pack_into("<iii", picture, _PIC_USE_ARGB, 1, 0, 0)
    struct.pack_into("<ii", picture, _PIC_WIDTH, w, h)
    writer = _MemoryWriter()
    lib.WebPMemoryWriterInit(ctypes.byref(writer))
    write_fn = ctypes.cast(lib.WebPMemoryWrite, ctypes.c_void_p).value
    struct.pack_into("<QQ", picture, _PIC_WRITER, write_fn, ctypes.addressof(writer))
    importer = lib.WebPPictureImportRGBA if c == 4 else lib.WebPPictureImportRGB
    try:
        if not importer(picture, img.ctypes.data_as(ctypes.c_void_p), w * c):
            raise RuntimeError("WebPPictureImport failed")
        if not lib.WebPEncode(config, picture):
            raise RuntimeError(f"WebPEncode failed with {fields}")
        return ctypes.string_at(writer.mem, writer.size)
    finally:
        lib.WebPPictureFree(picture)
        lib.WebPMemoryWriterClear(ctypes.byref(writer))


def chunks(blob: bytes) -> List[Tuple[bytes, bytes]]:
    """The (fourcc, payload) chunks of a WebP file, in order."""
    out, pos, end = [], 12, 8 + struct.unpack_from("<I", blob, 4)[0]
    while pos + 8 <= end:
        fourcc, size = blob[pos:pos + 4], struct.unpack_from("<I", blob, pos + 4)[0]
        out.append((fourcc, blob[pos + 8:pos + 8 + size]))
        pos += 8 + size + (size & 1)
    return out


def _chunk(fourcc: bytes, payload: bytes) -> bytes:
    return fourcc + struct.pack("<I", len(payload)) + payload + b"\x00" * (len(payload) & 1)


def riff(chunk_list: List[Tuple[bytes, bytes]]) -> bytes:
    body = b"WEBP" + b"".join(_chunk(f, p) for f, p in chunk_list)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def vp8x(width: int, height: int, flags: int) -> Tuple[bytes, bytes]:
    return b"VP8X", bytes([flags, 0, 0, 0]) + (width - 1).to_bytes(3, "little") + (
        height - 1).to_bytes(3, "little")


def animation(canvas: Tuple[int, int], frames: List[Dict], alpha: bool = False) -> bytes:
    """An animated WebP on a `canvas` (width, height): each frame a dict with
    `file` (a single-image WebP file), `x` and `y` (even), shown 100 ms,
    blended, not disposed; the VP8X alpha flag when `alpha`."""
    out = [vp8x(*canvas, 0x02 | (0x10 if alpha else 0)),
           (b"ANIM", struct.pack("<IH", 0xFFFFFFFF, 0))]
    for f in frames:
        image = [c for c in chunks(f["file"]) if c[0] in (b"ALPH", b"VP8 ", b"VP8L")]
        info = _info(f["file"])
        head = ((f["x"] // 2).to_bytes(3, "little") + (f["y"] // 2).to_bytes(3, "little")
                + (info[0] - 1).to_bytes(3, "little") + (info[1] - 1).to_bytes(3, "little")
                + (100).to_bytes(3, "little") + b"\x00")
        out.append((b"ANMF", head + b"".join(_chunk(c, p) for c, p in image)))
    return riff(out)


def _info(blob: bytes) -> Tuple[int, int]:
    """(width, height) of a single-image WebP file."""
    for fourcc, p in chunks(blob):
        if fourcc == b"VP8X":
            return 1 + int.from_bytes(p[4:7], "little"), 1 + int.from_bytes(p[7:10], "little")
        if fourcc == b"VP8 ":
            return (struct.unpack_from("<H", p, 6)[0] & 0x3FFF,
                    struct.unpack_from("<H", p, 8)[0] & 0x3FFF)
        if fourcc == b"VP8L":
            bits = struct.unpack_from("<I", p, 1)[0]
            return (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1
    raise ValueError("not a single-image WebP file")


def filter_alpha(alpha: np.ndarray, method: int) -> np.ndarray:
    """libwebp's alpha filters (1 horizontal, 2 vertical, 3 gradient; 0 none):
    the residuals its decoder unfilters back to `alpha` (uint8 [h, w])."""
    a = alpha.astype(np.int32)
    pred = np.zeros_like(a)
    pred[0, 1:] = a[0, :-1]  # the first row is horizontal whatever the filter
    if method:
        pred[1:, 0] = a[:-1, 0]
    if method == 1:
        pred[1:, 1:] = a[1:, :-1]
    elif method == 2:
        pred[1:, 1:] = a[:-1, 1:]
    elif method == 3:
        pred[1:, 1:] = np.clip(a[1:, :-1] + a[:-1, 1:] - a[:-1, :-1], 0, 255)
    return ((a - pred) % 256).astype(np.uint8) if method else alpha.astype(np.uint8)


def alpha_chunk(alpha: np.ndarray, compression: int, filtering: int,
                preprocessing: int = 0) -> Tuple[bytes, bytes]:
    """An ALPH chunk for `alpha` (uint8 [h, w]) with the given header fields:
    compression 0 stores the filtered bytes; 1 stores them as the green of a
    lossless stream (a lossless file's VP8L payload without its 5-byte
    header)."""
    residuals = filter_alpha(alpha, filtering)
    header = bytes([compression | (filtering << 2) | (preprocessing << 4)])
    if compression == 0:
        return b"ALPH", header + residuals.tobytes()
    green = np.zeros(alpha.shape + (3,), np.uint8)
    green[..., 1] = residuals
    vp8l = dict(chunks(encode(green, lossless=1, exact=1)))[b"VP8L"]
    return b"ALPH", header + vp8l[5:]


def with_alpha(lossy: bytes, alph: Tuple[bytes, bytes]) -> bytes:
    """A lossy single-image file with `alph` added: VP8X (alpha flag), ALPH,
    VP8."""
    w, h = _info(lossy)
    return riff([vp8x(w, h, 0x10), alph, (b"VP8 ", dict(chunks(lossy))[b"VP8 "])])


def decode_yuv(blob: bytes) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """libwebp's own decode of a lossy file to its Y, U and V planes
    (`WebPDecodeYUV`): the planes before the conversion to RGB."""
    lib = _library()
    w, h, stride, uv_stride = (ctypes.c_int() for _ in range(4))
    u, v = ctypes.POINTER(ctypes.c_uint8)(), ctypes.POINTER(ctypes.c_uint8)()
    lib.WebPDecodeYUV.restype = ctypes.POINTER(ctypes.c_uint8)
    y = lib.WebPDecodeYUV(blob, len(blob), ctypes.byref(w), ctypes.byref(h), ctypes.byref(u),
                          ctypes.byref(v), ctypes.byref(stride), ctypes.byref(uv_stride))
    if not y:
        raise ValueError("WebPDecodeYUV failed")
    try:
        uh, uw = (h.value + 1) // 2, (w.value + 1) // 2

        def plane(p, rows, cols, step):
            flat = np.ctypeslib.as_array(p, shape=(rows * step,)).reshape(rows, step)
            return flat[:, :cols].copy()

        return (plane(y, h.value, w.value, stride.value), plane(u, uh, uw, uv_stride.value),
                plane(v, uh, uw, uv_stride.value))
    finally:
        lib.WebPFree(y)
