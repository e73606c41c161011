"""Build and load the port's CUDA kernels: plain `nvcc` + `ctypes`.

Every source under `csrc/` has a plain C interface (no PyTorch headers, no
pybind, no `torch.utils.cpp_extension`, no ninja). One `nvcc` call compiles
them all into `_build/libw3d_kernels-<hash>.so`, where the hash covers the
sources, the headers beside them and the flags, so a changed source
rebuilds and an unchanged one is reused. A file that includes PyTorch's
headers takes minutes to compile; these take seconds, and the build runs
at the first kernel call on a CUDA tensor, never at import. If `nvcc` fails, the error carries its output;
nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import List, NamedTuple

PACKAGE_DIR = Path(__file__).resolve().parent
SOURCE_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
# -Xptxas -v reports each kernel's registers, shared memory and spills.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
NVCC_TIMEOUT_S = 600

_p = ctypes.c_void_p
_i = ctypes.c_int
_f = ctypes.c_float
# name -> (argtypes, restype). Every pointer and the stream are c_void_p:
# without explicit argtypes ctypes passes Python ints as 32-bit C ints and
# cuts 64-bit pointers.
SIGNATURES = {
    "w3d_blend_fwd": ([_p, _p, _p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _p], _i),
    # K1 with its cull off; only chip_smoke.py calls it, to compare bits.
    "w3d_blend_fwd_walk_all": ([_p, _p, _p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _p], _i),
    "w3d_blend_bwd": ([_p] * 12 + [_i, _i, _i, _i, _i, _p], _i),
    "w3d_segsum": ([_p, _i, _i, _p, _p, _p, _i, _p, _p, _p, _i, _i, _p, _i, _p], _i),
    "w3d_desc_loss": ([_p] * 6 + [_i, _i, _f, _f, _p, _i, _p], _i),
    "w3d_desc_grad": ([_p] * 6 + [_i, _i, _f, _f, _p, _i, _p], _i),
    "w3d_error_string": ([_i], ctypes.c_char_p),
}


class Built(NamedTuple):
    path: Path
    seconds: float  # compile time; 0.0 when the cached library was reused
    log: str  # nvcc's output (ptxas resource usage)


def sources() -> List[Path]:
    return sorted(SOURCE_DIR.glob("*.cu"))


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(cuda_home, "bin", "nvcc")


def nvcc_command(out: Path) -> List[str]:
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(out), *map(str, sources())]


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + sorted(SOURCE_DIR.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libw3d_kernels-{h.hexdigest()[:16]}.so"


def build() -> Built:
    """Compile the kernels unless the library for these sources exists."""
    out = library_path()
    if out.exists():
        return Built(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(nvcc_command(tmp), capture_output=True, text=True,
                          timeout=NVCC_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return Built(out, seconds, proc.stdout + proc.stderr)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare every entry
    point's argtypes and restype."""
    lib = ctypes.CDLL(str(build().path))
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib
