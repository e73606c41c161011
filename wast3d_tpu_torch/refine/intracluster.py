"""Intracluster pairwise-distance statistics and loss.

Port of `wast3d_tpu/refine/intracluster.py` (the reference
`get_intracluster_stats`, `train_st.py:102-171`, and the loss it feeds,
`:305-318`): for each cluster, the pairwise L2-distance matrix of a
per-Gaussian attribute within that cluster; the loss is the per-cluster
mean squared deviation of the predicted matrix from a ground-truth one,
averaged over clusters.

As in JAX, clusters are packed once into a [K, cap] member-index grid with a
mask for the rag, and all K matrices come from one batched matrix-product
distance ([K, cap, cap], invalid pairs 0), where the reference loops over
clusters producing ragged [m_k, m_k] tensors.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from wast3d_tpu_torch.device import DeviceLike, resolve_device
from wast3d_tpu_torch.ops.knn import pairwise_sq_dists


class ClusterPack(NamedTuple):
    """Static packing of ragged cluster membership."""

    member_idx: torch.Tensor  # [K, cap] int64 indices into the value rows
    member_mask: torch.Tensor  # [K, cap] bool
    counts: torch.Tensor  # [K] int32 true member counts (before truncation)


def pack_clusters(cluster_ids: np.ndarray, num_clusters: int,
                  cap: Optional[int] = None, device: DeviceLike = None) -> ClusterPack:
    """Group row indices by cluster id (host side, once per scene), on
    `device` (None means CUDA).

    cluster_ids: [N] ints in [0, num_clusters) (the reference's ids are
    1-based; callers convert). cap defaults to the largest cluster, rounded
    up to a multiple of 8."""
    dev = resolve_device(device)
    ids = np.asarray(cluster_ids)
    order = np.argsort(ids, kind="stable")
    sorted_ids = ids[order]
    starts = np.searchsorted(sorted_ids, np.arange(num_clusters))
    ends = np.searchsorted(sorted_ids, np.arange(num_clusters) + 1)
    counts = (ends - starts).astype(np.int32)
    if cap is None:
        cap = max(8, int(-(-int(counts.max(initial=1)) // 8) * 8))
    idx = np.zeros((num_clusters, cap), np.int64)
    msk = np.zeros((num_clusters, cap), bool)
    for k in range(num_clusters):
        m = min(int(counts[k]), cap)
        idx[k, :m] = order[starts[k]:starts[k] + m]
        msk[k, :m] = True
    return ClusterPack(torch.from_numpy(idx).to(dev), torch.from_numpy(msk).to(dev),
                       torch.from_numpy(counts).to(dev))


def _pair_mask(pack: ClusterPack) -> torch.Tensor:
    return pack.member_mask[:, :, None] & pack.member_mask[:, None, :]


def intracluster_pairwise_dists(values: torch.Tensor, pack: ClusterPack) -> torch.Tensor:
    """All clusters' pairwise L2 distance matrices: values [N, ...] rows ->
    [K, cap, cap], masked pairs 0 (the reference's per-cluster
    `torch.cdist(group, group)`)."""
    v = values.reshape(values.shape[0], -1)
    grouped = v[pack.member_idx]  # [K, cap, d]
    d2 = pairwise_sq_dists(grouped, grouped)
    # The 1e-24 floor keeps the (zero) diagonal's gradient finite: sqrt'(0)
    # is infinite.
    return torch.sqrt(torch.clamp_min(d2, 1e-24)) * _pair_mask(pack)


def intracluster_stats_loss(values: torch.Tensor, gt_dists: torch.Tensor,
                            pack: ClusterPack) -> torch.Tensor:
    """Per cluster, the mean over valid pairs of the squared (pred - GT)
    distance deviation, averaged over clusters."""
    pred = intracluster_pairwise_dists(values, pack)
    pair_mask = _pair_mask(pack).to(torch.float32)
    sq = (pred - gt_dists * pair_mask) ** 2
    per_cluster = torch.sum(sq, dim=(1, 2)) / torch.clamp_min(
        torch.sum(pair_mask, dim=(1, 2)), 1.0)
    return torch.mean(per_cluster)


def get_intracluster_stats(scene, cluster_ids: np.ndarray,
                           attrbs: tuple = ("xyz",),
                           num_clusters: Optional[int] = None,
                           cap: Optional[int] = None) -> dict:
    """The reference-shaped entry point: attribute -> [K, cap, cap]
    pairwise-distance batch (masked instead of ragged), on the scene's
    device."""
    ids = np.asarray(cluster_ids)
    if num_clusters is None:
        num_clusters = int(ids.max()) + 1
    pack = pack_clusters(ids, num_clusters, cap, device=scene.device)
    return {attr: intracluster_pairwise_dists(getattr(scene, attr), pack)
            for attr in attrbs}
