"""Model-directory layout helpers of `wast3d_tpu/train/checkpoint.py`."""

from __future__ import annotations

import os
from typing import Optional


def find_max_iteration(model_path: str) -> Optional[int]:
    """Largest N of `<model_path>/point_cloud/iteration_N`, or None."""
    pc_dir = os.path.join(model_path, "point_cloud")
    if not os.path.isdir(pc_dir):
        return None
    iters = [int(d.split("_")[-1]) for d in os.listdir(pc_dir)
             if d.startswith("iteration_")]
    return max(iters) if iters else None
