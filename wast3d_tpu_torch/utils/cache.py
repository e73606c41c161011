"""The persistent build cache of the port's compiled libraries.

Port of `wast3d_tpu/utils/cache.py`, whose `enable` points JAX's persistent
compilation cache at a directory. The port's compiled artefacts are the
CUDA kernel library and the native host library (`_build.py`), both kept in
`_build.BUILD_DIR` under names hashed over their sources and flags, so a
second run reuses them. `enable(path)` moves that directory to `path`;
without a path it keeps the directory set so far (`_build/` beside the
package by default). `WAST3D_NO_CACHE` is the authoritative opt-out, as in
JAX: each process then builds into a private temporary directory of its
own (removed when the process exits), whatever `path` says. The CLIs call
`enable()` where the JAX package's do (`cli.save_clusters`, `cli.stylize`,
`cli.sweep`, `cli.pipeline`, `train/driver.py`).
"""

from __future__ import annotations

import atexit
import os
import shutil
import tempfile
from pathlib import Path
from typing import Optional

_private: Optional[Path] = None


def enable(path: Optional[str] = None) -> Path:
    """Point the build cache at `path` (module docstring); returns the
    directory in use."""
    global _private
    from wast3d_tpu_torch import _build

    if os.environ.get("WAST3D_NO_CACHE"):
        if _private is None:
            _private = Path(tempfile.mkdtemp(prefix="w3d_build_"))
            atexit.register(shutil.rmtree, _private, True)
        _build.BUILD_DIR = _private
    elif path is not None:
        _build.BUILD_DIR = Path(path).resolve()
    return _build.BUILD_DIR
