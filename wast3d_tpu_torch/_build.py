"""Build and load the port's CUDA kernels: plain `nvcc` + `ctypes`.

Every source under `csrc/` has a plain C interface (no PyTorch headers, no
pybind, no `torch.utils.cpp_extension`, no ninja). One `nvcc -c` per
source, all started together, compiles them to objects, and one more `nvcc`
links those into `_build/libw3d_kernels-<hash>.so`, where the hash covers
the sources, the headers beside them and the flags, so a changed source
rebuilds and an unchanged one is reused. A file that includes PyTorch's
headers takes minutes to compile; these take seconds, and the build runs
at the first kernel call on a CUDA tensor, never at import. If `nvcc`
fails, the error carries its output; nothing falls back.

The host library of `native/` (PLY and COLMAP readers, the JPEG decoder)
is built the same way with one `g++` call into
`_build/libw3d_io-<hash>.so`, so it loads on a machine without a card too.
Both builds compile into a private temporary directory under `BUILD_DIR`
and `os.replace` the library into place, so processes that build at once
each load a whole file. `utils/cache.py::enable` moves `BUILD_DIR`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List, NamedTuple, Tuple

PACKAGE_DIR = Path(__file__).resolve().parent
SOURCE_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
# Each source's flags; -Xptxas -v reports each kernel's registers, shared
# memory and spills.
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
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
    # K1f, the bf16 tier (K1's arguments with the tables after `bg`), and its
    # walk of every entry (only chip_smoke.py calls the latter, as for K1).
    "w3d_blend_fwd_fast": ([_p] * 9 + [_i, _i, _i, _i, _i, _p], _i),
    "w3d_blend_fwd_fast_walk_all": ([_p] * 9 + [_i, _i, _i, _i, _i, _p], _i),
    "w3d_blend_bwd": ([_p] * 12 + [_i, _i, _i, _i, _i, _p], _i),
    # K2f: K2's arguments with the tables after `bg`, as K1f takes them.
    "w3d_blend_bwd_fast": ([_p] * 13 + [_i, _i, _i, _i, _i, _p], _i),
    "w3d_segsum": ([_p, _i, _i, _p, _p, _p, _i, _p, _p, _p, _i, _i, _p, _i, _p], _i),
    "w3d_desc_loss": ([_p] * 6 + [_i, _i, _f, _f, _p, _i, _p], _i),
    "w3d_desc_grad": ([_p] * 6 + [_i, _i, _f, _f, _p, _i, _p], _i),
    # Kg, the serving gather (csrc/pack_gather.cu): its two launches.
    "w3d_pack_rows": ([_p] * 7 + [_i, _i, _p], _i),
    "w3d_gather_rows": ([_p] * 4 + [_i, _i, _i, _p], _i),
    "w3d_error_string": ([_i], ctypes.c_char_p),
}
NATIVE_DIR = PACKAGE_DIR / "native"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
GXX_TIMEOUT_S = 300


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


def nvcc_commands(out: Path) -> Tuple[List[List[str]], List[str]]:
    """One compile command per source, into an object beside `out`, and the
    command that links those objects into the shared library `out`."""
    objects = [out.with_name(f"{out.name}.{src.stem}.o") for src in sources()]
    compiles = [[nvcc_path(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                for src, obj in zip(sources(), objects)]
    return compiles, [nvcc_path(), *ARCH, "-shared", "-o", str(out), *map(str, objects)]


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + sorted(SOURCE_DIR.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libw3d_kernels-{h.hexdigest()[:16]}.so"


def _compile(cmd: List[str], tool: str = "nvcc", timeout: int = NVCC_TIMEOUT_S) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"{tool} failed (exit {proc.returncode}):\n{log}")
    return log


def build() -> Built:
    """Compile the kernels unless the library for these sources exists."""
    out = library_path()
    if out.exists():
        return Built(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        lib = Path(tmp) / out.name
        compiles, link = nvcc_commands(lib)
        # Every compile runs to its end before the first failure is raised
        # (`pool.map` would cancel those not yet started).
        with ThreadPoolExecutor(len(compiles)) as pool:
            futures = [pool.submit(_compile, cmd) for cmd in compiles]
        logs = [f.result() for f in futures]
        logs.append(_compile(link))
        os.replace(lib, out)
    return Built(out, time.perf_counter() - t0, "".join(logs))


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


def native_sources() -> List[Path]:
    return sorted(NATIVE_DIR.glob("*.cpp"))


def gxx_path() -> str:
    return shutil.which("g++") or "g++"


def native_command(out: Path) -> List[str]:
    """The one `g++` call that builds the host library `out`."""
    return [gxx_path(), *GXX_FLAGS, "-o", str(out), *map(str, native_sources())]


def native_library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    for src in native_sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libw3d_io-{h.hexdigest()[:16]}.so"


def build_native() -> Built:
    """Compile `native/*.cpp` unless the library for these sources exists;
    a failed `g++` raises with its output."""
    out = native_library_path()
    if out.exists():
        return Built(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        lib = Path(tmp) / out.name
        log = _compile(native_command(lib), "g++", GXX_TIMEOUT_S)
        os.replace(lib, out)
    return Built(out, time.perf_counter() - t0, log)
