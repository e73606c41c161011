"""K-means clustering: k-means++ seeding on the host, Lloyd on the device.

Port of `wast3d_tpu/ops/kmeans.py` (the reference's sklearn KMeans for
content and style clustering). The seeding is the JAX package's numpy code,
unchanged, so the same seed picks the same initial centres. Lloyd's
assignment is the matrix-product distance of `ops/knn.py`; the update is
the one-hot sum of JAX (a [K, N] x [N, D] product and a column sum), which
adds in a fixed order on the card, where `index_add_` would use float
atomics and move the centres from run to run.
`kmeans_best` keeps the lowest-inertia of n_init runs (sklearn's n_init).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from wast3d_tpu_torch.device import DeviceLike, resolve_device
from wast3d_tpu_torch.ops.knn import pairwise_sq_dists


def kmeans_pp_init(points: np.ndarray, k: int, rng: np.random.Generator,
                   mask: Optional[np.ndarray] = None) -> np.ndarray:
    """Host-side k-means++ seeding (sequential by nature)."""
    pts = np.asarray(points)
    if mask is not None:
        pts = pts[np.asarray(mask)]
    n = len(pts)
    centers = np.empty((k, pts.shape[1]), pts.dtype)
    centers[0] = pts[rng.integers(n)]
    d2 = ((pts - centers[0]) ** 2).sum(1)
    for i in range(1, k):
        probs = d2 / max(d2.sum(), 1e-12)
        centers[i] = pts[rng.choice(n, p=probs)]
        d2 = np.minimum(d2, ((pts - centers[i]) ** 2).sum(1))
    return centers


def lloyd(points: torch.Tensor, init_centers: torch.Tensor, iters: int = 100,
          mask: Optional[torch.Tensor] = None):
    """Lloyd's iterations. Returns (centers [K, D], labels [N] int64,
    inertia [] float32). Invalid points (mask False) take label -1 and do
    not move centres; a centre with no points stays where it is."""
    n, kc = points.shape[0], init_centers.shape[0]
    valid = (torch.ones(n, dtype=torch.bool, device=points.device) if mask is None
             else mask.to(torch.bool))
    w = valid.to(torch.float32)[:, None]
    centers = init_centers
    for _ in range(iters):
        labels = torch.argmin(pairwise_sq_dists(points, centers), dim=1)
        one_hot = torch.nn.functional.one_hot(labels, kc).to(torch.float32) * w
        sums = one_hot.T @ points
        counts = one_hot.sum(dim=0)[:, None]
        centers = torch.where(counts > 0, sums / torch.clamp_min(counts, 1), centers)
    d2 = pairwise_sq_dists(points, centers)
    best, labels = torch.min(d2, dim=1)
    labels = torch.where(valid, labels, -1)
    inertia = torch.sum(torch.where(valid, best, 0.0))
    return centers, labels, inertia


def kmeans(points, k: int, iters: int = 100, seed: int = 0,
           mask: Optional[np.ndarray] = None,
           device: DeviceLike = None) -> Tuple[np.ndarray, np.ndarray]:
    """One seeded run. Returns (centers, labels) as numpy."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    init = kmeans_pp_init(np.asarray(points), k, rng, mask)
    centers, labels, _ = lloyd(
        torch.as_tensor(np.asarray(points, np.float32), device=dev),
        torch.as_tensor(np.asarray(init, np.float32), device=dev), iters,
        None if mask is None else torch.as_tensor(np.asarray(mask), device=dev))
    return centers.cpu().numpy(), labels.cpu().numpy()


def kmeans_best(points, k: int, n_init: int = 20, iters: int = 100, seed: int = 0,
                mask: Optional[np.ndarray] = None,
                device: DeviceLike = None) -> Tuple[np.ndarray, np.ndarray]:
    """Best of n_init seeded runs by inertia (sklearn n_init semantics)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    pts = torch.as_tensor(np.asarray(points, np.float32), device=dev)
    mask_t = None if mask is None else torch.as_tensor(np.asarray(mask), device=dev)
    best = None
    for _ in range(n_init):
        init = kmeans_pp_init(np.asarray(points), k, rng, mask)
        centers, labels, inertia = lloyd(
            pts, torch.as_tensor(np.asarray(init, np.float32), device=dev), iters, mask_t)
        inertia = float(inertia)
        if best is None or inertia < best[0]:
            best = (inertia, centers.cpu().numpy(), labels.cpu().numpy())
    return best[1], best[2]
