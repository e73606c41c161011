"""Ball coverage of the content domain.

Port of `wast3d_tpu/stylize/coverage.py` (notebook 11 cells 20-22):
`cluster_radius` (smallest and largest over points of the farthest-point
distance of the style patch) and the greedy `sample_circles` cover: take
the first uncovered point, take everything within radius r (doubling r
until at least `min_points_per_cluster` points fall inside), repeat. The
greedy loop is sequential and stays on the host; the distances run on the
device.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from wast3d_tpu_torch.device import DeviceLike, resolve_device
from wast3d_tpu_torch.ops.knn import pairwise_sq_dists


def cluster_radius(points: np.ndarray, block: int = 4096,
                   device: DeviceLike = None) -> tuple:
    """(inner_diameter, outer_diameter): min and max over points of the
    largest distance to another point (notebook 11 cell 20)."""
    dev = resolve_device(device)
    pts = torch.as_tensor(np.asarray(points, np.float32), device=dev)
    max_d2 = torch.cat([pairwise_sq_dists(pts[s:s + block], pts).amax(dim=1)
                        for s in range(0, len(pts), block)])
    max_d = np.sqrt(max_d2.cpu().numpy().astype(np.float64))
    return float(max_d.min()), float(max_d.max())


def sample_circles(points: np.ndarray, r: float, min_points_per_cluster: int = 40,
                   device: DeviceLike = None) -> List[np.ndarray]:
    """Greedy ball cover (notebook 11 cell 21). Returns the index array of
    each ball; balls overlap and their union covers every point."""
    dev = resolve_device(device)
    n = len(points)
    pts = torch.as_tensor(np.asarray(points, np.float32), device=dev)
    covered = np.zeros(n, dtype=bool)
    circles = []
    while not covered.all():
        q_idx = int(np.argmin(covered))
        d2_row = pairwise_sq_dists(pts[q_idx:q_idx + 1], pts)[0].cpu().numpy()
        r_ = r
        inside = np.zeros(0, np.int64)
        while len(inside) < min_points_per_cluster:
            inside = np.nonzero(d2_row <= r_ * r_)[0]
            r_ *= 2
        covered[inside] = True
        circles.append(inside)
    return circles


def filter_circles(circles: List[np.ndarray], min_points: int = 21) -> List[np.ndarray]:
    """Drop tiny balls (cell 22: `len(x) > 21`)."""
    return [c for c in circles if len(c) > min_points]
