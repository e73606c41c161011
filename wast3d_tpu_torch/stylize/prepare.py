"""Content-scene preparation: clustering, outlier removal, density subsample.

Port of `wast3d_tpu/stylize/prepare.py` (notebook 11 cells 5-6,
`prepare_scene`, `remove_outliers`, `sample_points_by_density`):
- K-means over the content positions (per-cluster work bounds the O(n^2)
  neighbourhood math);
- outlier removal: drop points whose k-th-NN distance is not below the q
  quantile (k = 30);
- inverse-density subsampling: ~1/10 of each cluster, with probability
  inversely proportional to the neighbour count within `radius`, counted
  against every 10th point as the reference does.

The JAX package pins this math to its CPU backend to avoid per-shape TPU
compiles; the port runs it on the device it is given. Random draws are
numpy `default_rng`, as in JAX, so the same seed keeps the same points.
Clusters are padded to power-of-two buckets with masks exactly as in JAX,
so the padded kNN sees the same columns.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from wast3d_tpu_torch.device import DeviceLike, resolve_device
from wast3d_tpu_torch.ops.kmeans import kmeans
from wast3d_tpu_torch.ops.knn import knn_sq_dists, pairwise_sq_dists


def _bucket(n: int, minimum: int = 64) -> int:
    """Next power-of-two size at or above n (at least `minimum`)."""
    b = minimum
    while b < n:
        b *= 2
    return b


def _pad_points(points: np.ndarray, cap: int, dev: torch.device):
    padded = np.pad(np.asarray(points, np.float32), ((0, cap - len(points)), (0, 0)))
    mask = np.zeros(cap, bool)
    mask[: len(points)] = True
    return torch.as_tensor(padded, device=dev), torch.as_tensor(mask, device=dev)


def _kth_nn(pts: torch.Tensor, mask: torch.Tensor, k: int) -> torch.Tensor:
    """[cap] distance of each (padded) point to its k-th nearest valid point
    (itself included, as in JAX)."""
    d2, _ = knn_sq_dists(pts, pts, k=k, query_mask=mask, data_mask=mask)
    return torch.sqrt(d2[:, k - 1])


def _density_counts(pts: torch.Tensor, mask: torch.Tensor, radius: float) -> torch.Tensor:
    """[cap] neighbours within `radius` among every 10th (valid) point."""
    d2 = pairwise_sq_dists(pts, pts[::10])
    return torch.sum((d2 <= radius * radius) & mask[::10][None, :], dim=1)


def remove_outliers(points: np.ndarray, kth_neighbor: int = 30, q: float = 0.925,
                    device: DeviceLike = None) -> np.ndarray:
    """Indices of the points whose k-th-NN distance is below the q quantile."""
    dev = resolve_device(device)
    n = len(points)
    k = min(kth_neighbor, n)
    pts, mask = _pad_points(points, _bucket(n), dev)
    kth = _kth_nn(pts, mask, k).cpu().numpy()[:n]
    return np.nonzero(kth < np.quantile(kth, q))[0]


def _density_sample(counts: np.ndarray, num_samples: Optional[int], seed: int) -> np.ndarray:
    n = len(counts)
    inv = 1.0 / (counts + 1.0)
    probs = inv / inv.sum()
    rng = np.random.default_rng(seed)
    return rng.choice(n, size=n // 10 if num_samples is None else num_samples,
                      replace=True, p=probs)


def sample_points_by_density(points: np.ndarray, num_samples: Optional[int] = None,
                             radius: float = 0.05, seed: int = 0,
                             device: DeviceLike = None) -> np.ndarray:
    """Inverse-density sampling (against every 10th point's neighbour count)."""
    dev = resolve_device(device)
    n = len(points)
    pts, mask = _pad_points(points, _bucket(n), dev)
    counts = _density_counts(pts, mask, radius).cpu().numpy()[:n]
    return _density_sample(counts, num_samples, seed)


def _per_cluster(points: np.ndarray, clusters: List[np.ndarray], stage, dev: torch.device):
    """stage(padded points, mask, n) -> [bucket] for each cluster, each on its
    own power-of-two bucket, read back in one host transfer. Returns the
    clusters' [n] results as numpy arrays."""
    if not clusters:
        return []
    out = [stage(*_pad_points(points[ci], _bucket(len(ci)), dev), len(ci))[: len(ci)]
           for ci in clusters]
    flat = torch.cat(out).cpu().numpy()
    return np.split(flat, np.cumsum([len(ci) for ci in clusters])[:-1])


def prepare_scene(points: np.ndarray, num_clusters: int = 40,
                  num_samples: Optional[int] = None, radius: float = 0.05,
                  q: float = 0.925, kth_neighbor: int = 30, seed: int = 0,
                  device: DeviceLike = None) -> np.ndarray:
    """Clean and subsample the content scene. Returns the indices into
    `points` of the retained 'domain' points (notebook 11 `prepare_scene`).

    Per cluster, as JAX's sequential form: `remove_outliers`, then
    `sample_points_by_density` of what is left, each cluster padded to its
    own bucket. Each stage runs over every cluster before one host transfer
    brings its results back. The JAX package also has a batched form (all
    clusters in one bucket under `lax.map`, to share one TPU compile);
    eager PyTorch compiles nothing, so the port has this one form. From the
    same k-means labels it picks what both of JAX's forms pick."""
    dev = resolve_device(device)
    points = np.asarray(points, np.float32)
    _, labels = kmeans(points, num_clusters, iters=100, seed=seed, device=dev)
    clusters = [np.nonzero(labels == lbl)[0] for lbl in range(num_clusters)]
    clusters = [ci for ci in clusters if len(ci) >= 2]
    kth = _per_cluster(points, clusters,
                       lambda p, m, n: _kth_nn(p, m, min(kth_neighbor, n)), dev)
    clean = [ci[k < np.quantile(k, q)] for ci, k in zip(clusters, kth)]
    clean = [ci for ci in clean if len(ci) >= 2]
    counts = _per_cluster(points, clean, lambda p, m, n: _density_counts(p, m, radius), dev)
    kept = [ci[_density_sample(c, num_samples, seed)] for ci, c in zip(clean, counts)]
    return np.concatenate(kept) if kept else np.zeros(0, np.int64)
