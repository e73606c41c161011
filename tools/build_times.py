"""Time the port's kernel build two ways on one machine, in the order
single, split, split, single, each into an empty directory:

- single: one `nvcc -shared` over every source under `csrc/`, with the
  same flags (how the kernels were built before they were compiled apart);
- split: `_build.build()`, one `nvcc -c` per source, all started together,
  then one `nvcc` that links the objects.

Run it from the root of a checkout on a machine with `nvcc` (no card is
needed):

    python3 tools/build_times.py

It prints one JSON line with each way's seconds, in run order.
"""

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, os.getcwd())
from wast3d_tpu_torch import _build  # noqa: E402  (the checkout's own)


def single(out_dir: Path) -> float:
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared", "-o", str(out_dir / "lib.so"),
           *map(str, _build.sources())]
    t0 = time.perf_counter()
    subprocess.run(cmd, capture_output=True, check=True, timeout=_build.NVCC_TIMEOUT_S)
    return time.perf_counter() - t0


def split(out_dir: Path) -> float:
    _build.BUILD_DIR = out_dir
    return _build.build().seconds


def main() -> int:
    times = {"single": [], "split": []}
    for way in ("single", "split", "split", "single"):
        with tempfile.TemporaryDirectory(dir=_build.PACKAGE_DIR) as tmp:
            times[way].append((single if way == "single" else split)(Path(tmp)))
    print(json.dumps({"phase": "build_times", "sources": len(_build.sources()),
                      "cpus": os.cpu_count(), "single_s": times["single"],
                      "split_s": times["split"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
