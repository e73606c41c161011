"""Native (C++) host-side IO, loaded through ctypes.

The port's counterpart of `wast3d_tpu/native`: the same C ABI and Python
API (`available`, `read_ply_f32`, `write_ply_f32`, `read_colmap_points3d`,
the `WAST3D_NO_NATIVE` opt-out), plus a baseline JPEG decoder
(`read_jpeg`, `decode_jpeg`; `jpeg.cpp`) for COLMAP datasets, since the
card's machine has no PIL.

The library is built lazily by `_build.build_native` (one `g++` call into a
private temporary directory under `_build/`, then `os.replace` to a name
hashed over the sources and flags), never next to the sources, so
processes that build at once each load a whole file. The PLY and COLMAP
fast paths keep the JAX package's numpy fallbacks in `scene/ply.py` and
`scene/colmap.py`: they return None when the library is opted out or
cannot be built. The JPEG decoder has no fallback: it builds the library
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


def decode_jpeg(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """Baseline JPEG bytes -> uint8 [H, W, 3], or [H, W] for grayscale (what
    `np.asarray(PIL.Image.open(...))` gives). Other kinds of JPEG raise
    `ValueError` naming `name` and the file's marker."""
    lib = library()
    msg = ctypes.create_string_buffer(256)
    w, h, c = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int32()
    if lib.w3d_jpeg_info(data, len(data), ctypes.byref(w), ctypes.byref(h), ctypes.byref(c),
                         msg, len(msg)) != 0:
        raise ValueError(f"{name}: {msg.value.decode(errors='replace')}")
    shape = (h.value, w.value) if c.value == 1 else (h.value, w.value, c.value)
    out = np.empty(shape, np.uint8)
    if lib.w3d_jpeg_decode(data, len(data), out.ctypes.data, out.nbytes, msg, len(msg)) != 0:
        raise ValueError(f"{name}: {msg.value.decode(errors='replace')}")
    return out


def read_jpeg(path: str) -> np.ndarray:
    """`decode_jpeg` of the file at `path`."""
    with open(path, "rb") as f:
        return decode_jpeg(f.read(), path)
