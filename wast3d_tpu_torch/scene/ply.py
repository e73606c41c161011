"""Bit-compatible PLY interchange for Gaussian scenes.

Port of `wast3d_tpu/scene/ply.py`: all-float32 files are read by the
port's native C++ reader (`wast3d_tpu_torch/native`) when it is available,
others (and every file when it is not) by numpy. Binary little-endian, one `vertex`
element with float32 properties x, y, z, nx, ny, nz, f_dc_0..2,
f_rest_0..(3K-4), opacity, scale_0..2, rot_0..3, K = (max_sh_degree+1)^2.
f_dc / f_rest are channel-major flattenings of the [N, K, 3] coefficients.
`save_ply` writes the same bytes as the JAX package's `save_ply`.
"""

from __future__ import annotations

import os
import re
from typing import Tuple

import numpy as np

from wast3d_tpu_torch.device import DeviceLike
from wast3d_tpu_torch.scene.gaussians import GaussianScene, from_arrays

_HEADER_RE = re.compile(rb"end_header\r?\n")

_PLY_DTYPES = {
    "float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
    "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
    "short": "<i2", "ushort": "<u2", "int": "<i4", "int32": "<i4",
    "uint": "<u4", "uint32": "<u4",
}


def _attribute_names(num_f_rest: int) -> list:
    names = ["x", "y", "z", "nx", "ny", "nz"]
    names += [f"f_dc_{i}" for i in range(3)]
    names += [f"f_rest_{i}" for i in range(num_f_rest)]
    names.append("opacity")
    names += [f"scale_{i}" for i in range(3)]
    names += [f"rot_{i}" for i in range(4)]
    return names


def save_ply(scene: GaussianScene, path: str) -> None:
    """Write the scene's valid (mask) Gaussians in the reference schema."""
    keep = scene.mask.cpu().numpy()

    def host(t):
        return t.detach().cpu().numpy()[keep]

    xyz = host(scene.xyz)
    n = xyz.shape[0]
    # channel-major flatten: [n, K, 3] -> [n, 3, K] -> [n, 3K]
    f_dc_flat = np.transpose(host(scene.features_dc), (0, 2, 1)).reshape(n, -1)
    f_rest_flat = np.transpose(host(scene.features_rest), (0, 2, 1)).reshape(n, -1)
    names = _attribute_names(f_rest_flat.shape[1])
    data = np.concatenate(
        [xyz, np.zeros_like(xyz), f_dc_flat, f_rest_flat, host(scene.opacity),
         host(scene.scaling), host(scene.rotation)], axis=1,
    ).astype("<f4")
    if data.shape[1] != len(names):
        raise ValueError(f"{data.shape[1]} columns for {len(names)} properties")

    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property float {name}" for name in names]
    header.append("end_header")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(np.ascontiguousarray(data).tobytes())


def parse_header(blob: bytes) -> Tuple[int, list, int]:
    """(vertex count, [(name, numpy dtype)], byte offset of the data)."""
    m = _HEADER_RE.search(blob)
    if m is None:
        raise ValueError("not a PLY file (no end_header)")
    header = blob[: m.start()].decode("ascii", errors="replace")
    lines = [ln.strip() for ln in header.splitlines() if ln.strip()]
    if not lines or lines[0] != "ply":
        raise ValueError("not a PLY file")
    fmt = next((ln for ln in lines if ln.startswith("format ")), "")
    if "binary_little_endian" not in fmt:
        raise ValueError(f"unsupported PLY format: {fmt!r}")
    n = None
    props = []
    in_vertex = False
    for ln in lines:
        if ln.startswith("element "):
            parts = ln.split()
            in_vertex = parts[1] == "vertex"
            if in_vertex:
                n = int(parts[2])
        elif ln.startswith("property ") and in_vertex:
            _, dtype, name = ln.split()
            if dtype not in _PLY_DTYPES:
                raise ValueError(f"unsupported property dtype {dtype}")
            props.append((name, _PLY_DTYPES[dtype]))
    if n is None:
        raise ValueError("no vertex element")
    return n, props, m.end()


def load_ply_arrays(path: str) -> dict:
    """Read a reference-schema PLY into raw numpy arrays (f_rest, scale and
    rot columns taken in numeric name order), through the native reader
    for all-float32 files when it is available, as the JAX package does."""
    with open(path, "rb") as f:
        head = f.read(1 << 16)
    if b"end_header" not in head:
        with open(path, "rb") as f:
            head = f.read()
    n, props, offset = parse_header(head)
    rec = None
    if all(dt == "<f4" for _, dt in props):
        from wast3d_tpu_torch import native

        fast = native.read_ply_f32(path)
        if fast is not None and fast[1] == n and fast[2] == len(props):
            rec = {name: fast[0][:, i] for i, (name, _) in enumerate(props)}
    if rec is None:
        with open(path, "rb") as f:
            blob = f.read()
        rec = np.frombuffer(blob, dtype=np.dtype(props), count=n, offset=offset)

    def col(name):
        return np.asarray(rec[name])

    def numbered(prefix):
        names = [p[0] for p in props if p[0].startswith(prefix)]
        return sorted(names, key=lambda s: int(s.split("_")[-1]))

    xyz = np.stack([col("x"), col("y"), col("z")], axis=1)
    f_dc = np.stack([col("f_dc_0"), col("f_dc_1"), col("f_dc_2")], axis=1)[:, :, None]
    f_rest_names = numbered("f_rest_")
    f_rest = (np.stack([col(p) for p in f_rest_names], axis=1) if f_rest_names
              else np.zeros((n, 0), np.float32))
    f_rest = f_rest.reshape(n, 3, len(f_rest_names) // 3)
    return {
        "xyz": xyz,
        "features_dc": np.transpose(f_dc, (0, 2, 1)),  # [n,1,3]
        "features_rest": np.transpose(f_rest, (0, 2, 1)),  # [n,num_rest,3]
        "opacity": col("opacity")[:, None],
        "scaling": np.stack([col(p) for p in numbered("scale_")], axis=1),
        "rotation": np.stack([col(p) for p in numbered("rot")], axis=1),
    }


def load_ply(path: str, max_sh_degree: int = 3,
             device: DeviceLike = None) -> GaussianScene:
    """Load into a GaussianScene with the active SH degree set to max, as
    the reference loader does."""
    arrs = load_ply_arrays(path)
    expected_rest = (max_sh_degree + 1) ** 2 - 1
    if arrs["features_rest"].shape[1] != expected_rest:
        raise ValueError(
            f"PLY has {arrs['features_rest'].shape[1]} f_rest coeffs per channel, "
            f"expected {expected_rest} for sh_degree {max_sh_degree}")
    return from_arrays(**arrs, max_sh_degree=max_sh_degree,
                       active_sh_degree=max_sh_degree, device=device)
