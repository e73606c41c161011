"""Native (C++) host-side IO, loaded through ctypes.

The port's counterpart of `wast3d_tpu/native`: the same C ABI and Python
API (`available`, `read_ply_f32`, `write_ply_f32`, `read_colmap_points3d`,
the `WAST3D_NO_NATIVE` opt-out), plus what datasets need without PIL, since
the card's machine has none: a JPEG decoder (`read_jpeg`, `decode_jpeg`;
Huffman-coded baseline and progressive, arithmetic-coded sequential and
progressive, lossless, 1, 3 or 4 components, any integral sampling,
damaged and partly refined files as libjpeg-turbo 3.1.3 reads them;
`jpeg.cpp`, with its upsampler alone as `jpeg_upsample`, its IDCT as
`jpeg_idct` and its lossless undifferencing as `jpeg_undifference`),
and the byte loops
of the other readers (`image.cpp`): PNG unfiltering and Adam7 at every bit
depth (`png_unfilter`), sub-byte unpacking (`unpack_bits`), BMP run lengths
(`bmp_rle`), TIFF LZW, PackBits and CCITT (`lzw_decode`, `packbits_decode`,
`ccitt_decode`), TIFF YCbCr -> RGB (`ycbcr_to_rgb`), TGA run lengths (`tga_rle`), QOI (`qoi_decode`) and PIL's bicubic resize
(`resize_u8`); and the WebP and GIF bitstreams
(`webp.cpp`): lossless (`vp8l_decode`), lossy (`vp8_decode`, with its inverse
transforms alone as `vp8_idct` and its YUV -> RGB as `yuv_to_rgba`), ALPH
chunks (`webp_alpha`) and GIF's LZW (`gif_lzw`); TIFF's ZSTD strips
(`zstd.cpp`: `zstd_decode`); the loops of the ICO / DDS / PSD / SGI /
PCX / Sun readers (`raster.cpp`: `bcn_decode`, `packbits_rows`, `sgi_rle`,
`pcx_rle`, `sun_rle`); and JPEG 2000's tier-1, wavelets, colour transforms
and DC shift as OpenJPEG 2.5.4 computes them (`j2k.cpp`: `j2k_t1`,
`j2k_idwt`, `j2k_mct`, `j2k_level`); and the loops of the readers of
`utils/image_plugins.py` (`plugins.cpp`: FLI / FLC chunks `fli_decode`, MSP
runs `msp_rows`, the PhotoCD base image `pcd_decode`, XBM hex
`xbm_decode`, XPM palette keys `xpm_lookup`, IM's n-bit samples
`bit_decode`). A JPEG inside a TIFF goes through the same decoder with the
TIFF's colour space (`decode_jpeg(..., colour=...)`, `jpeg_frame`), or, for
old-style JPEG, as libjpeg's raw data (`jpeg_raw_planes`). `utils/image_io.py`,
`utils/png.py`, `utils/zstd.py`, `utils/image_formats.py`,
`utils/image_plugins.py` and `utils/jpeg2000.py` hold the plain version of
each stage that stands alone.

The library is built lazily by `_build.build_native` (one `g++ -c` a
source, all at once, then a link, in a private temporary directory under
`_build/`, then `os.replace` to a name hashed over the sources and
flags), never next to the sources, so
processes that build at once each load a whole file. The PLY and COLMAP
fast paths keep the JAX package's numpy fallbacks in `scene/ply.py` and
`scene/colmap.py`: they return None when the library is opted out or
cannot be built. The image code has no fallback: it builds the library
whatever `WAST3D_NO_NATIVE` says and raises if it cannot.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_lock = threading.Lock()
_lib = None  # the fast paths' library, or None (opted out / not built)
_tried = False
_library = None  # the loaded library, whatever the opt-out says

_c = ctypes
_SIGNATURES = {
    "w3d_read_ply_f32": ([_c.c_char_p, _c.POINTER(_c.c_float), _c.c_int64,
                          _c.POINTER(_c.c_int64), _c.POINTER(_c.c_int64)], _c.c_int),
    "w3d_write_ply_f32": ([_c.c_char_p, _c.c_char_p, _c.POINTER(_c.c_float), _c.c_int64,
                           _c.c_int64], _c.c_int),
    "w3d_read_colmap_points3d": ([_c.c_char_p, _c.POINTER(_c.c_double),
                                  _c.POINTER(_c.c_uint8), _c.c_int64,
                                  _c.POINTER(_c.c_int64)], _c.c_int),
    "w3d_jpeg_info": ([_c.c_char_p, _c.c_int64, _c.POINTER(_c.c_int32),
                       _c.POINTER(_c.c_int32), _c.POINTER(_c.c_int32), _c.c_char_p,
                       _c.c_int32], _c.c_int),
    "w3d_jpeg_decode": ([_c.c_char_p, _c.c_int64, _c.c_void_p, _c.c_int64, _c.c_char_p,
                         _c.c_int32], _c.c_int),
    "w3d_jpeg_upsample": ([_c.c_void_p, _c.c_int64, _c.c_int32, _c.c_int32, _c.c_int32,
                           _c.c_int32, _c.c_void_p, _c.c_int32, _c.c_int32, _c.c_char_p,
                           _c.c_int32], _c.c_int),
    "w3d_png_unfilter": ([_c.c_void_p, _c.c_int64, _c.c_int64, _c.c_int64, _c.c_int32,
                          _c.c_int32, _c.c_int32, _c.c_void_p, _c.c_char_p, _c.c_int32],
                         _c.c_int),
    "w3d_unpack_bits": ([_c.c_void_p, _c.c_int64, _c.c_int64, _c.c_int64, _c.c_int32,
                         _c.c_void_p, _c.c_char_p, _c.c_int32], _c.c_int),
    "w3d_bmp_rle": ([_c.c_void_p, _c.c_int64, _c.c_int64, _c.c_int64, _c.c_int64, _c.c_int32,
                     _c.c_void_p, _c.c_char_p, _c.c_int32], _c.c_int64),
    "w3d_lzw_decode": ([_c.c_void_p, _c.c_int64, _c.c_void_p, _c.c_int64, _c.c_char_p,
                        _c.c_int32], _c.c_int64),
    "w3d_packbits_decode": ([_c.c_void_p, _c.c_int64, _c.c_void_p, _c.c_int64, _c.c_char_p,
                             _c.c_int32], _c.c_int64),
    "w3d_zstd_decode": ([_c.c_char_p, _c.c_int64, _c.c_void_p, _c.c_int64, _c.c_char_p,
                         _c.c_int32], _c.c_int64),
    "w3d_resize_u8": ([_c.c_void_p, _c.c_int32, _c.c_int32, _c.c_int32, _c.c_void_p,
                       _c.c_int32, _c.c_int32, _c.c_char_p, _c.c_int32], _c.c_int),
    "w3d_vp8l_decode": ([_c.c_char_p, _c.c_int64, _c.c_int32, _c.c_int32, _c.c_void_p,
                         _c.c_char_p, _c.c_int32], _c.c_int),
    "w3d_vp8_decode": ([_c.c_char_p, _c.c_int64, _c.c_int32, _c.c_int32, _c.c_void_p,
                        _c.c_char_p, _c.c_int32], _c.c_int),
    "w3d_yuv_to_rgba": ([_c.c_void_p, _c.c_int64, _c.c_void_p, _c.c_void_p, _c.c_int64,
                         _c.c_int32, _c.c_int32, _c.c_void_p, _c.c_char_p, _c.c_int32], _c.c_int),
    "w3d_vp8_idct": ([_c.c_void_p, _c.c_int32, _c.c_void_p, _c.c_char_p, _c.c_int32], _c.c_int),
    "w3d_alpha_decode": ([_c.c_char_p, _c.c_int64, _c.c_int32, _c.c_int32, _c.c_void_p,
                          _c.c_char_p, _c.c_int32], _c.c_int),
    "w3d_gif_lzw": ([_c.c_char_p, _c.c_int64, _c.c_int32, _c.c_void_p, _c.c_int64, _c.c_char_p,
                     _c.c_int32], _c.c_int64),
    "w3d_jpeg_frame": ([_c.c_char_p, _c.c_int64, _c.POINTER(_c.c_int32), _c.c_char_p, _c.c_int32],
                       _c.c_int),
    "w3d_ccitt_decode": ([_c.c_char_p, _c.c_int64, _c.c_int32, _c.c_int32, _c.c_int32,
                          _c.c_int32, _c.c_void_p, _c.c_char_p, _c.c_int32], _c.c_int),
    "w3d_ycbcr_to_rgb": ([_c.c_void_p, _c.c_int64, _c.c_int32, _c.c_int32, _c.c_int32,
                          _c.c_int32, _c.c_void_p, _c.c_void_p, _c.c_char_p, _c.c_int32],
                         _c.c_int),
    "w3d_jpeg_idct": ([_c.c_void_p, _c.c_void_p, _c.c_int64, _c.c_void_p], _c.c_int),
    "w3d_jpeg_undifference": ([_c.c_void_p, _c.c_int64, _c.c_int32, _c.c_int32, _c.c_int32,
                               _c.c_int32, _c.c_int32, _c.c_void_p, _c.c_char_p, _c.c_int32],
                              _c.c_int),
    "w3d_jpeg_decode_raw": ([_c.c_char_p, _c.c_int64, _c.c_void_p, _c.c_int64,
                             _c.POINTER(_c.c_int32), _c.c_char_p, _c.c_int32], _c.c_int),
    "w3d_jpeg_decode_as": ([_c.c_char_p, _c.c_int64, _c.c_int32, _c.c_void_p, _c.c_int64,
                            _c.c_char_p, _c.c_int32], _c.c_int),
    "w3d_tga_rle": ([_c.c_char_p, _c.c_int64, _c.c_int32, _c.c_int64, _c.c_int64, _c.c_void_p,
                     _c.c_char_p, _c.c_int32], _c.c_int64),
    "w3d_qoi_decode": ([_c.c_char_p, _c.c_int64, _c.c_int64, _c.c_int32, _c.c_void_p,
                        _c.c_char_p, _c.c_int32], _c.c_int),
    "w3d_bcn_decode": ([_c.c_char_p, _c.c_int64, _c.c_int32, _c.c_int32, _c.c_int32, _c.c_int32,
                        _c.c_void_p, _c.c_char_p, _c.c_int32], _c.c_int),
    "w3d_packbits_rows": ([_c.c_char_p, _c.c_int64, _c.c_int64, _c.c_int64, _c.c_void_p,
                           _c.c_char_p, _c.c_int32], _c.c_int64),
    "w3d_sgi_rle": ([_c.c_char_p, _c.c_int64, _c.c_int64, _c.c_int64, _c.c_int32, _c.c_int32,
                     _c.c_void_p, _c.c_char_p, _c.c_int32], _c.c_int),
    "w3d_pcx_rle": ([_c.c_char_p, _c.c_int64, _c.c_int64, _c.c_int64, _c.c_int32, _c.c_int64,
                     _c.c_void_p, _c.c_char_p, _c.c_int32], _c.c_int64),
    "w3d_sun_rle": ([_c.c_char_p, _c.c_int64, _c.c_int64, _c.c_int64, _c.c_void_p, _c.c_char_p,
                     _c.c_int32], _c.c_int64),
    "w3d_j2k_t1": ([_c.c_char_p, _c.c_int64, _c.c_void_p, _c.c_int32, _c.c_void_p, _c.c_void_p,
                    _c.c_void_p, _c.c_int64, _c.c_int32, _c.c_char_p, _c.c_int32], _c.c_int),
    "w3d_j2k_idwt": ([_c.c_void_p, _c.c_int64, _c.c_void_p, _c.c_int32, _c.c_int32], _c.c_int),
    "w3d_j2k_mct": ([_c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_int64, _c.c_int32], _c.c_int),
    "w3d_j2k_level": ([_c.c_void_p, _c.c_int64, _c.c_int32, _c.c_int32, _c.c_int32, _c.c_int32,
                       _c.c_void_p], _c.c_int),
    "w3d_fli_decode": ([_c.c_char_p, _c.c_int64, _c.c_int32, _c.c_int32, _c.c_void_p,
                        _c.c_char_p, _c.c_int32], _c.c_int),
    "w3d_msp_rows": ([_c.c_char_p, _c.c_int64, _c.c_void_p, _c.c_int64, _c.c_int64, _c.c_void_p,
                      _c.c_int64, _c.c_char_p, _c.c_int32], _c.c_int64),
    "w3d_pcd_decode": ([_c.c_char_p, _c.c_int64, _c.c_void_p, _c.c_void_p, _c.c_char_p,
                        _c.c_int32], _c.c_int),
    "w3d_xbm_decode": ([_c.c_char_p, _c.c_int64, _c.c_int64, _c.c_int64, _c.c_void_p,
                        _c.c_char_p, _c.c_int32], _c.c_int),
    "w3d_xpm_lookup": ([_c.c_char_p, _c.c_void_p, _c.c_int64, _c.c_int64, _c.c_char_p,
                        _c.c_void_p, _c.c_int64, _c.c_int64, _c.c_void_p, _c.c_int64,
                        _c.c_char_p, _c.c_int32], _c.c_int64),
    "w3d_bit_decode": ([_c.c_char_p, _c.c_int64, _c.c_int32, _c.c_int32, _c.c_int32, _c.c_int32,
                        _c.c_int64, _c.c_int64, _c.c_int32, _c.c_void_p, _c.c_char_p,
                        _c.c_int32], _c.c_int),
}


def library() -> ctypes.CDLL:
    """Build if needed and load the library once per process; raises
    `RuntimeError` with the compiler's output if `g++` fails."""
    global _library
    with _lock:
        if _library is None:
            from wast3d_tpu_torch import _build

            lib = ctypes.CDLL(str(_build.build_native().path))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _library = lib
        return _library


def _load() -> Optional[ctypes.CDLL]:
    """The library for the fast paths, or None when `WAST3D_NO_NATIVE` is
    set or the build failed (the callers then take numpy)."""
    global _lib, _tried
    if not _tried:
        _tried = True
        if not os.environ.get("WAST3D_NO_NATIVE"):
            try:
                _lib = library()
            except (RuntimeError, OSError, subprocess.TimeoutExpired):
                _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def read_ply_f32(path: str) -> Optional[Tuple[np.ndarray, int, int]]:
    """Fast path for all-float32 binary PLYs. Returns (data [rows, cols],
    rows, cols) or None if the fast path can't handle the file."""
    lib = _load()
    if lib is None:
        return None
    max_floats = os.path.getsize(path) // 4 + 16
    buf = np.empty(max_floats, np.float32)
    rows, cols = ctypes.c_int64(), ctypes.c_int64()
    rc = lib.w3d_read_ply_f32(
        path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        max_floats, ctypes.byref(rows), ctypes.byref(cols))
    if rc != 0:
        return None
    r, c = rows.value, cols.value
    return buf[: r * c].reshape(r, c).copy(), r, c


def write_ply_f32(path: str, header: str, data: np.ndarray) -> bool:
    lib = _load()
    if lib is None:
        return False
    data = np.ascontiguousarray(data, np.float32)
    rc = lib.w3d_write_ply_f32(
        path.encode(), header.encode(),
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), data.shape[0], data.shape[1])
    return rc == 0


def read_colmap_points3d(path: str) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    lib = _load()
    if lib is None:
        return None
    # Upper bound: file size / per-point minimum (59 bytes).
    max_pts = os.path.getsize(path) // 59 + 16
    xyz = np.empty((max_pts, 3), np.float64)
    rgb = np.empty((max_pts, 3), np.uint8)
    n = ctypes.c_int64()
    rc = lib.w3d_read_colmap_points3d(
        path.encode(), xyz.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), max_pts, ctypes.byref(n))
    if rc != 0:
        return None
    return xyz[: n.value].copy(), rgb[: n.value].copy()


def _message(msg) -> str:
    return msg.value.decode(errors="replace")


def decode_jpeg(data: bytes, name: str = "<bytes>", colour: int = 0) -> np.ndarray:
    """JPEG bytes (Huffman or arithmetic-coded, sequential or progressive, or
    lossless) -> uint8 [H, W, 3], [H, W, 4] for
    CMYK / YCCK (PIL's inverted "CMYK;I"), or [H, W] for grayscale (what
    `np.asarray(PIL.Image.open(...))` gives). Other kinds of JPEG, and files
    PIL would not decode to these pixels, raise `ValueError` naming `name`
    and the reason. `colour` overrides the stream's colour space as libtiff
    does for a TIFF's strips and tiles: 1 converts YCbCr to RGB, 2 gives the
    components as coded."""
    lib = library()
    msg = ctypes.create_string_buffer(256)
    w, h, c = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int32()
    if lib.w3d_jpeg_info(data, len(data), ctypes.byref(w), ctypes.byref(h), ctypes.byref(c),
                         msg, len(msg)) != 0:
        raise ValueError(f"{name}: {_message(msg)}")
    shape = (h.value, w.value) if c.value == 1 else (h.value, w.value, c.value)
    out = np.empty(shape, np.uint8)
    if lib.w3d_jpeg_decode_as(data, len(data), colour, out.ctypes.data, out.nbytes, msg,
                              len(msg)) != 0:
        raise ValueError(f"{name}: {_message(msg)}")
    return out


def jpeg_raw_planes(data: bytes, name: str = "<bytes>") -> Tuple[list, int]:
    """A JPEG stream's components as libjpeg's raw data output leaves them
    (libtiff's old-style JPEG codec reads them so): each uint8 [rows,
    columns] in whole MCUs, before upsampling and colour conversion; and the
    iMCU row where libtiff's source fails (-1: none), as libtiff runs it:
    reading past the data, or a restart marker out of turn, is an error
    there, and the rows from it are left as they were (zeros)."""
    w, h, factors = jpeg_frame(data, name)
    hmax, vmax = max(f[0] for f in factors), max(f[1] for f in factors)
    mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    shapes = [(mcuy * v * 8, mcux * fh * 8) for fh, v in factors]
    out = np.empty(sum(a * b for a, b in shapes), np.uint8)
    msg = ctypes.create_string_buffer(256)
    failed = ctypes.c_int32(-1)
    if library().w3d_jpeg_decode_raw(data, len(data), out.ctypes.data, out.nbytes,
                                     ctypes.byref(failed), msg, len(msg)) != 0:
        raise ValueError(f"{name}: {_message(msg)}")
    planes, at = [], 0
    for a, b in shapes:
        planes.append(out[at:at + a * b].reshape(a, b))
        at += a * b
    return planes, failed.value


def jpeg_frame(data: bytes, name: str = "<bytes>") -> Tuple[int, int, Tuple[Tuple[int, int], ...]]:
    """A JPEG stream's (width, height, each component's (h, v) sampling
    factors), from its frame header."""
    info = (ctypes.c_int32 * 7)()
    msg = ctypes.create_string_buffer(256)
    if library().w3d_jpeg_frame(data, len(data), info, msg, len(msg)) != 0:
        raise ValueError(f"{name}: {_message(msg)}")
    return info[0], info[1], tuple((f >> 4, f & 15) for f in info[3:3 + info[2]])


def read_jpeg(path: str) -> np.ndarray:
    """`decode_jpeg` of the file at `path`."""
    with open(path, "rb") as f:
        return decode_jpeg(f.read(), path)


def jpeg_upsample(plane: np.ndarray, rh: int, rv: int, out_width: int,
                  out_height: int) -> np.ndarray:
    """A JPEG component's uint8 [h, w] plane, sampled rh x rv times less
    than the image, -> uint8 [out_height, out_width] as libjpeg upsamples it
    (`jpeg.cpp`; `utils/image_io.jpeg_upsample_reference` is its plain
    version)."""
    plane = np.ascontiguousarray(plane, np.uint8)
    out = np.empty((out_height, out_width), np.uint8)
    msg = ctypes.create_string_buffer(256)
    if library().w3d_jpeg_upsample(plane.ctypes.data, plane.shape[1], plane.shape[1],
                                   plane.shape[0], rh, rv, out.ctypes.data, out_width,
                                   out_height, msg, len(msg)) != 0:
        raise ValueError(f"jpeg_upsample: {_message(msg)}")
    return out


def jpeg_idct(coef: np.ndarray, qt: np.ndarray) -> np.ndarray:
    """int16 [n, 64] coefficients (natural order) and uint16 [64] quantisers
    -> uint8 [n, 8, 8] samples, as PIL's libjpeg-turbo's SIMD islow IDCT
    computes them (`jpeg.cpp`; `utils/image_io.jpeg_idct_reference` is its
    plain version)."""
    coef = np.ascontiguousarray(coef, np.int16).reshape(-1, 64)
    qt = np.ascontiguousarray(qt, np.uint16).reshape(64)
    out = np.empty((coef.shape[0], 8, 8), np.uint8)
    library().w3d_jpeg_idct(coef.ctypes.data, qt.ctypes.data, coef.shape[0], out.ctypes.data)
    return out


def jpeg_undifference(diff: np.ndarray, predictor: int, point_transform: int = 0,
                      reset_every: int = 0) -> np.ndarray:
    """An 8-bit lossless JPEG component's int32 [rows, width] differences ->
    uint8 samples, as libjpeg-turbo 3's jdlossls.c undifferences and scales
    them: `predictor` 1-7, the first row (and every `reset_every`-th, a
    restart interval's) from 2^(7 - point_transform) and Ra, sums kept to 16
    bits, each value shifted left by `point_transform` into 8 bits
    (`jpeg.cpp`; `utils/image_io.jpeg_undifference_reference` is its plain
    version)."""
    diff = np.ascontiguousarray(diff, np.int32)
    out = np.empty(diff.shape, np.uint8)
    msg = ctypes.create_string_buffer(256)
    initial = 1 << (7 - point_transform)
    if library().w3d_jpeg_undifference(diff.ctypes.data, diff.shape[0], diff.shape[1], predictor,
                                       point_transform, initial, reset_every, out.ctypes.data,
                                       msg, len(msg)) != 0:
        raise ValueError(f"jpeg_undifference: {_message(msg)}")
    return out


def ccitt_decode(data: bytes, mode: int, options: int, width: int, rows: int,
                 name: str = "<bytes>") -> np.ndarray:
    """One strip or tile of CCITT data (TIFF Compression `mode` 2, 3 or 4;
    `options` T4Options) -> uint8 [rows, ceil(width / 8)] packed rows, 1 for
    a black run (`image.cpp`; `utils/image_io.ccitt_reference` is its plain
    version)."""
    out = np.empty((rows, (width + 7) // 8), np.uint8)
    msg = ctypes.create_string_buffer(256)
    if library().w3d_ccitt_decode(data, len(data), mode, options, width, rows, out.ctypes.data,
                                  msg, len(msg)) != 0:
        raise ValueError(f"{name}: {_message(msg)}")
    return out


def ycbcr_to_rgb(units: np.ndarray, sh: int, sv: int, width: int, rows: int,
                 tables: np.ndarray, name: str = "<bytes>") -> np.ndarray:
    """Chunky 8-bit YCbCr data units of sh x sv luma samples, Cb and Cr ->
    uint8 [rows, width, 3] RGB through libtiff's TIFFYCbCrtoRGB with int32
    [5, 256] `tables` (`image.cpp`; `utils/image_io.ycbcr_to_rgb_reference` is
    its plain version)."""
    units = np.ascontiguousarray(units, np.uint8)
    tables = np.ascontiguousarray(tables, np.int32)
    out = np.empty((rows, width, 3), np.uint8)
    msg = ctypes.create_string_buffer(256)
    if library().w3d_ycbcr_to_rgb(units.ctypes.data, units.size, sh, sv, width, rows,
                                  tables.ctypes.data, out.ctypes.data, msg, len(msg)) != 0:
        raise ValueError(f"{name}: {_message(msg)}")
    return out


def png_unfilter(raw: np.ndarray, height: int, width: int, channels: int, interlaced: bool,
                 name: str = "<bytes>", bits: int = 8) -> np.ndarray:
    """A PNG's inflated, filtered scanlines (uint8) -> its samples: the five
    row filters over bytes per pixel = max(1, bits x channels / 8), and the
    seven Adam7 passes when `interlaced` (`image.cpp`). uint8 [height, width,
    channels] at 8 bits, [height, width, 2 channels] (big-endian pairs) at 16,
    [height, width, 1] sample values at 1, 2 and 4. Bad data raises
    `ValueError` naming `name`."""
    raw = np.ascontiguousarray(raw, np.uint8)
    out = np.empty((height, width, channels * 2 if bits == 16 else channels), np.uint8)
    msg = ctypes.create_string_buffer(256)
    if library().w3d_png_unfilter(raw.ctypes.data, raw.size, height, width, channels, bits,
                                  int(interlaced), out.ctypes.data, msg, len(msg)) != 0:
        raise ValueError(f"{name}: {_message(msg)}")
    return out


def unpack_bits(rows: np.ndarray, width: int, bits: int, name: str = "<bytes>") -> np.ndarray:
    """uint8 [h, row_bytes] rows of `bits`-bit samples (1, 2 or 4), packed
    from the most significant bit -> uint8 [h, width] sample values."""
    rows = np.ascontiguousarray(rows, np.uint8)
    out = np.empty((rows.shape[0], width), np.uint8)
    msg = ctypes.create_string_buffer(256)
    if library().w3d_unpack_bits(rows.ctypes.data, rows.shape[0], rows.shape[1], width, bits,
                                 out.ctypes.data, msg, len(msg)) != 0:
        raise ValueError(f"{name}: {_message(msg)}")
    return out


def bmp_rle(blob: bytes, start: int, width: int, height: int, rle4: bool,
            name: str = "<bytes>") -> np.ndarray:
    """A BMP file's RLE8 / RLE4 pixels from offset `start` -> uint8 [height,
    width], rows in file order, as Pillow's BmpRleDecoder reads them. Too
    little data raises `ValueError`, as Pillow does."""
    out = np.empty((height, width), np.uint8)
    msg = ctypes.create_string_buffer(256)
    n = library().w3d_bmp_rle(blob, len(blob), start, width, height, int(rle4),
                              out.ctypes.data, msg, len(msg))
    if n < 0:
        raise ValueError(f"{name}: {_message(msg)}")
    if n < out.size:
        raise ValueError(f"{name}: not enough image data (RLE gives {n} of {out.size} pixels)")
    return out


def _stream(fn: str, blob: bytes, out_size: int, name: str) -> np.ndarray:
    out = np.empty(out_size, np.uint8)
    msg = ctypes.create_string_buffer(256)
    n = getattr(library(), fn)(blob, len(blob), out.ctypes.data, out_size, msg, len(msg))
    if n < 0:
        raise ValueError(f"{name}: {_message(msg)}")
    return out[:n]


def lzw_decode(blob: bytes, out_size: int, name: str = "<bytes>") -> np.ndarray:
    """A TIFF LZW strip -> at most `out_size` bytes (uint8)."""
    return _stream("w3d_lzw_decode", blob, out_size, name)


def packbits_decode(blob: bytes, out_size: int, name: str = "<bytes>") -> np.ndarray:
    """A TIFF PackBits strip -> at most `out_size` bytes (uint8)."""
    return _stream("w3d_packbits_decode", blob, out_size, name)


def zstd_decode(blob: bytes, out_size: int, name: str = "<bytes>") -> np.ndarray:
    """A TIFF ZSTD strip (Zstandard frames, `zstd.cpp`) -> at most `out_size`
    bytes (uint8), as libtiff's ZSTD codec fills its buffer
    (`utils/zstd.zstd_reference` is its plain version)."""
    return _stream("w3d_zstd_decode", bytes(blob), out_size, name)


def resize_u8(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """PIL's bicubic resample of uint8 [H, W] or [H, W, C] to [height, width]
    (`image.cpp`; `utils/png.resize` is its plain version)."""
    img = np.ascontiguousarray(img, np.uint8)
    c = 1 if img.ndim == 2 else img.shape[2]
    out = np.empty((height, width) + img.shape[2:], np.uint8)
    msg = ctypes.create_string_buffer(256)
    if library().w3d_resize_u8(img.ctypes.data, img.shape[0], img.shape[1], c, out.ctypes.data,
                               height, width, msg, len(msg)) != 0:
        raise ValueError(f"resize: {_message(msg)}")
    return out


def vp8l_decode(data: bytes, width: int, height: int, name: str = "<bytes>") -> np.ndarray:
    """A VP8L chunk's payload (WebP lossless, with its 5-byte header) ->
    uint8 [height, width, 4] RGBA as libwebp decodes it (`webp.cpp`)."""
    out = np.empty((height, width, 4), np.uint8)
    msg = ctypes.create_string_buffer(256)
    if library().w3d_vp8l_decode(data, len(data), width, height, out.ctypes.data, msg,
                                 len(msg)) != 0:
        raise ValueError(f"{name}: {_message(msg)}")
    return out


def vp8_decode(data: bytes, width: int, height: int, name: str = "<bytes>") -> np.ndarray:
    """A "VP8 " chunk's payload (a WebP lossy key frame) -> uint8 [height,
    width, 4] RGBA (alpha 255) as libwebp's default output gives it: fancy
    upsampling, then its integer YUV -> RGB (`webp.cpp`)."""
    out = np.empty((height, width, 4), np.uint8)
    msg = ctypes.create_string_buffer(256)
    if library().w3d_vp8_decode(data, len(data), width, height, out.ctypes.data, msg,
                                len(msg)) != 0:
        raise ValueError(f"{name}: {_message(msg)}")
    return out


def webp_alpha(data: bytes, width: int, height: int, name: str = "<bytes>") -> np.ndarray:
    """An ALPH chunk's payload -> uint8 [height, width] alpha: raw or lossless,
    then unfiltered (none, horizontal, vertical, gradient) as libwebp does."""
    out = np.empty((height, width), np.uint8)
    msg = ctypes.create_string_buffer(256)
    if library().w3d_alpha_decode(data, len(data), width, height, out.ctypes.data, msg,
                                  len(msg)) != 0:
        raise ValueError(f"{name}: {_message(msg)}")
    return out


def yuv_to_rgba(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """uint8 planes Y [h, w], U and V [(h + 1) // 2, (w + 1) // 2] -> uint8
    [h, w, 4] RGBA (alpha 255) with libwebp's fancy upsampling
    (`utils/image_io.yuv_to_rgba_reference` is its plain version)."""
    y, u, v = (np.ascontiguousarray(p, np.uint8) for p in (y, u, v))
    h, w = y.shape
    if u.shape != v.shape or u.shape[0] < (h + 1) // 2 or u.shape[1] < (w + 1) // 2:
        raise ValueError(f"yuv_to_rgba: chroma planes {u.shape} / {v.shape} for luma {y.shape}")
    out = np.empty((h, w, 4), np.uint8)
    msg = ctypes.create_string_buffer(256)
    if library().w3d_yuv_to_rgba(y.ctypes.data, w, u.ctypes.data, v.ctypes.data, u.shape[1], w,
                                 h, out.ctypes.data, msg, len(msg)) != 0:
        raise ValueError(f"yuv_to_rgba: {_message(msg)}")
    return out


def vp8_idct(coeffs: np.ndarray, prediction: Optional[np.ndarray] = None) -> np.ndarray:
    """VP8's inverse transforms on one block of 16 int16 coefficients (raster
    order): with `prediction` (uint8 [4, 4]) the inverse DCT added to it ->
    uint8 [4, 4]; without, the inverse WHT -> int16 [16] (the DC of each of
    the 16 luma blocks)."""
    c = np.ascontiguousarray(coeffs, np.int16).reshape(16)
    if prediction is None:
        out = np.empty(16, np.int16)
    else:
        out = np.array(prediction, np.uint8).reshape(4, 4)
    msg = ctypes.create_string_buffer(256)
    if library().w3d_vp8_idct(c.ctypes.data, int(prediction is None), out.ctypes.data, msg,
                              len(msg)) != 0:
        raise ValueError(f"vp8_idct: {_message(msg)}")
    return out


def gif_lzw(data: bytes, min_code_size: int, out_size: int, name: str = "<bytes>") -> np.ndarray:
    """A GIF image's LZW data (its sub-blocks joined) -> at most `out_size`
    pixel bytes (uint8), as Pillow's GifDecode.c decodes them; fewer when the
    data or the end code comes first."""
    out = np.empty(out_size, np.uint8)
    msg = ctypes.create_string_buffer(256)
    n = library().w3d_gif_lzw(data, len(data), min_code_size, out.ctypes.data, out_size, msg,
                              len(msg))
    if n < 0:
        raise ValueError(f"{name}: {_message(msg)}")
    return out[:n]


def tga_rle(data: bytes, depth: int, row_bytes: int, rows: int,
            name: str = "<bytes>") -> np.ndarray:
    """TGA run-length packets of `depth`-byte pixels -> uint8 [rows,
    row_bytes], rows in file order, as Pillow's TgaRleDecode reads them
    (`image.cpp`); a repeat past the end of its row or too little data
    raises `ValueError`."""
    out = np.empty((rows, row_bytes), np.uint8)
    msg = ctypes.create_string_buffer(256)
    if library().w3d_tga_rle(data, len(data), depth, row_bytes, rows, out.ctypes.data, msg,
                             len(msg)) < 0:
        raise ValueError(f"{name}: {_message(msg)}")
    return out


def qoi_decode(data: bytes, width: int, height: int, channels: int,
               name: str = "<bytes>") -> np.ndarray:
    """A QOI file's ops (after its 14-byte header) -> uint8 [height, width,
    channels] as Pillow's QoiDecoder reads them (`image.cpp`)."""
    out = np.empty((height, width, channels), np.uint8)
    msg = ctypes.create_string_buffer(256)
    if library().w3d_qoi_decode(data, len(data), width * height, channels, out.ctypes.data, msg,
                                len(msg)) != 0:
        raise ValueError(f"{name}: {_message(msg)}")
    return out


def _call(fn: str, name: str, *args) -> None:
    msg = ctypes.create_string_buffer(256)
    if getattr(library(), fn)(*args, msg, len(msg)) < 0:
        raise ValueError(f"{name}: {_message(msg)}")


def bcn_decode(data: bytes, n: int, signed: bool, width: int, height: int,
               name: str = "<bytes>") -> np.ndarray:
    """BCn blocks (Pillow's decoder `n`: 1 BC1, 2 BC2, 3 BC3, 4 BC4, 5 BC5,
    6 BC6H, 7 BC7; `signed` for BC5S and BC6HS), 4 x 4 blocks row by row ->
    uint8 [height, width, 4 (RGBA), 1 (L) or 3 (RGB)] as Pillow's
    BcnDecode.c decodes them (`raster.cpp`;
    `utils/image_formats.bcn_reference` is its plain version)."""
    bands = {1: 4, 2: 4, 3: 4, 4: 1, 5: 3, 6: 3, 7: 4}[n]
    out = np.empty((height, width, bands), np.uint8)
    _call("w3d_bcn_decode", name, bytes(data), len(data), n, int(signed), width, height,
          out.ctypes.data)
    return out


def packbits_rows(data: bytes, row_bytes: int, rows: int, name: str = "<bytes>") -> np.ndarray:
    """PackBits rows as Pillow's PackBitsDecode fills them, a row at a time
    -> uint8 [rows, row_bytes] (`raster.cpp`;
    `utils/image_formats.packbits_rows_reference`)."""
    out = np.empty((rows, row_bytes), np.uint8)
    _call("w3d_packbits_rows", name, bytes(data), len(data), row_bytes, rows, out.ctypes.data)
    return out


def sgi_rle(blob: bytes, width: int, height: int, bands: int, bpc: int,
            name: str = "<bytes>") -> np.ndarray:
    """A run-length SGI file (header, tables and rows) as Pillow's
    SgiRleDecode reads it -> uint8 [height, width * bands * bpc], rows
    top-down, 16-bit samples big-endian (`raster.cpp`;
    `utils/image_formats.sgi_rle_reference`)."""
    out = np.empty((height, width * bands * bpc), np.uint8)
    _call("w3d_sgi_rle", name, bytes(blob), len(blob), width, height, bands, bpc,
          out.ctypes.data)
    return out


def pcx_rle(data: bytes, row_bytes: int, width: int, bits: int, rows: int,
            name: str = "<bytes>") -> np.ndarray:
    """PCX run-length rows of a `bits`-a-pixel raw mode as Pillow's
    PcxDecode reads them -> uint8 [rows, row_bytes] (`raster.cpp`;
    `utils/image_formats.pcx_rle_reference`)."""
    out = np.empty((rows, row_bytes), np.uint8)
    _call("w3d_pcx_rle", name, bytes(data), len(data), row_bytes, width, bits, rows,
          out.ctypes.data)
    return out


def sun_rle(data: bytes, row_bytes: int, rows: int, name: str = "<bytes>") -> np.ndarray:
    """Sun raster byte-encoded runs as Pillow's SunRleDecode reads them ->
    uint8 [rows, row_bytes] (`raster.cpp`;
    `utils/image_formats.sun_rle_reference`)."""
    out = np.empty((rows, row_bytes), np.uint8)
    _call("w3d_sun_rle", name, bytes(data), len(data), row_bytes, rows, out.ctypes.data)
    return out


def _j2k_buffer(buf: np.ndarray, reversible: bool) -> None:
    """A tile-component buffer the native loops write in place: C-contiguous
    int32 (5/3) or float32 (9/7)."""
    if buf.dtype != (np.int32 if reversible else np.float32) or not buf.flags.c_contiguous:
        raise ValueError(f"a JPEG 2000 tile-component must be contiguous "
                         f"{'int32' if reversible else 'float32'}, not {buf.dtype}")


def j2k_t1(data: bytes, cblks: np.ndarray, segs: np.ndarray, steps: np.ndarray, out: np.ndarray,
           reversible: bool, name: str = "<bytes>") -> None:
    """JPEG 2000 tier-1 (`j2k.cpp`) on the code-blocks of one tile-component
    into `out` (int32 [h, w] when `reversible`, else float32): `cblks` int32
    [n, 10] (x, y, width, height, band, style, top bit-plane + 1, ROI shift,
    first segment, segments), `segs` int32 [m, 3] (offset into `data`,
    length, passes), `steps` float32 [n] (half the band's step;
    `utils/jpeg2000.t1_reference` is the plain version of one code-block)."""
    cblks = np.ascontiguousarray(cblks, np.int32)
    segs = np.ascontiguousarray(segs, np.int32)
    steps = np.ascontiguousarray(steps, np.float32)
    _j2k_buffer(out, reversible)
    if steps.size != cblks.size // 10:
        raise ValueError(f"j2k_t1: {steps.size} steps for {cblks.size // 10} code-blocks")
    _call("w3d_j2k_t1", name, bytes(data), len(data), cblks.ctypes.data, cblks.size // 10,
          segs.ctypes.data, steps.ctypes.data, out.ctypes.data, out.shape[1], int(reversible))


def j2k_idwt(buf: np.ndarray, rects: np.ndarray, reversible: bool) -> None:
    """The inverse 5/3 (int32 `buf`) or 9/7 (float32) wavelet in place over
    the resolutions' int32 [n, 4] rectangles (x0, y0, x1, y1), as OpenJPEG
    computes it (`j2k.cpp`; `utils/jpeg2000.idwt53_reference` /
    `idwt97_reference`)."""
    rects = np.ascontiguousarray(rects, np.int32)
    _j2k_buffer(buf, reversible)
    library().w3d_j2k_idwt(buf.ctypes.data, buf.shape[1] if buf.ndim == 2 else 1, rects.ctypes.data,
                           len(rects), int(reversible))


def j2k_mct(c0: np.ndarray, c1: np.ndarray, c2: np.ndarray, reversible: bool) -> None:
    """The inverse RCT (int32) or ICT (float32) of JPEG 2000 in place
    (`utils/jpeg2000.mct_reference`)."""
    for c in (c0, c1, c2):
        _j2k_buffer(c, reversible)
        if c.size != c0.size:
            raise ValueError("j2k_mct: components of different sizes")
    library().w3d_j2k_mct(c0.ctypes.data, c1.ctypes.data, c2.ctypes.data, c0.size, int(reversible))


def j2k_level(buf: np.ndarray, reversible: bool, shift: int, lo: int, hi: int) -> np.ndarray:
    """The DC level shift and clamp to [lo, hi] of a tile-component (float32
    samples rounded by lrintf first) -> int32 of its shape."""
    buf = np.ascontiguousarray(buf, np.int32 if reversible else np.float32)
    out = np.empty(buf.shape, np.int32)
    library().w3d_j2k_level(buf.ctypes.data, buf.size, int(reversible), shift, lo, hi,
                            out.ctypes.data)
    return out


def _counted(fn: str, name: str, *args) -> int:
    msg = ctypes.create_string_buffer(256)
    n = getattr(library(), fn)(*args, msg, len(msg))
    if n < 0:
        raise ValueError(f"{name}: {_message(msg)}")
    return n


def fli_decode(frame: bytes, width: int, height: int, image: np.ndarray,
               name: str = "<bytes>") -> np.ndarray:
    """One FLI / FLC frame chunk applied to `image` (uint8 [height, width],
    the picture before it) as Pillow's FliDecode.c applies it, in place
    (`plugins.cpp`; `utils/image_plugins.fli_reference` is its plain
    version)."""
    assert image.shape == (height, width) and image.dtype == np.uint8
    assert image.flags.c_contiguous
    _call("w3d_fli_decode", name, bytes(frame), len(frame), width, height, image.ctypes.data)
    return image


def msp_rows(data: bytes, rowmap: np.ndarray, width: int, cap: int,
             name: str = "<bytes>") -> Tuple[np.ndarray, int]:
    """MSP version 2 rows (after the row map) as Pillow's MspDecoder
    expands them -> (the first `cap` bytes made, the count made)
    (`plugins.cpp`; `utils/image_plugins.msp_reference`)."""
    rowmap = np.ascontiguousarray(rowmap, np.uint16)
    out = np.zeros(cap, np.uint8)
    n = _counted("w3d_msp_rows", name, bytes(data), len(data), rowmap.ctypes.data, rowmap.size,
                 width, out.ctypes.data, cap)
    return out[:min(n, cap)], n


def pcd_decode(data: bytes, tables: np.ndarray, name: str = "<bytes>") -> np.ndarray:
    """A PhotoCD base image (from 96 * 2048 on) -> uint8 [512, 768, 3] as
    Pillow's PcdDecode.c and "YCC;P" unpacker give it, with `tables` int16
    [5, 256] (`plugins.cpp`; `utils/image_plugins.pcd_reference`)."""
    tables = np.ascontiguousarray(tables, np.int16)
    out = np.empty((512, 768, 3), np.uint8)
    _call("w3d_pcd_decode", name, bytes(data), len(data), tables.ctypes.data, out.ctypes.data)
    return out


def xbm_decode(data: bytes, width: int, height: int, name: str = "<bytes>") -> np.ndarray:
    """XBM hex bytes as Pillow's XbmDecode.c reads them -> uint8 [height,
    (width + 7) // 8] rows (`plugins.cpp`; `utils/image_plugins.xbm_reference`)."""
    out = np.empty((height, (width + 7) // 8), np.uint8)
    _call("w3d_xbm_decode", name, bytes(data), len(data), width, height, out.ctypes.data)
    return out


def xpm_lookup(data: bytes, ends: np.ndarray, bpp: int, keys, pixels: int,
               name: str = "<bytes>") -> Tuple[np.ndarray, int]:
    """XPM pixel lines (`data`, each line's end in `ends`) cut into keys of
    `bpp` characters and looked up among `keys` as XpmDecoder does, until
    `pixels` keys -> (int32 indices, at most `pixels`; the count made)
    (`plugins.cpp`; `utils/image_plugins.xpm_reference`)."""
    ends = np.ascontiguousarray(ends, np.int64)
    key_ends = np.cumsum([len(k) for k in keys], dtype=np.int64)
    out = np.zeros(pixels, np.int32)
    n = _counted("w3d_xpm_lookup", name, bytes(data), ends.ctypes.data, ends.size, bpp,
                 b"".join(keys), key_ends.ctypes.data, len(keys), pixels, out.ctypes.data, pixels)
    return out[:min(n, pixels)], n


def bit_decode(data: bytes, bits: int, width: int, height: int, pad: int = 8, fill: int = 3,
               sign: int = 0, ystep: int = -1, name: str = "<bytes>") -> np.ndarray:
    """Samples of `bits` bits as Pillow's BitDecode.c reads them (IM's
    "L*n" modes) -> float32 [height, width] (`plugins.cpp`;
    `utils/image_plugins.bit_reference`)."""
    out = np.zeros((height, width), np.float32)
    _call("w3d_bit_decode", name, bytes(data), len(data), bits, pad, fill, sign, width, height,
          ystep, out.ctypes.data)
    return out

