"""Cluster teleport: arrange style Gaussians along the content scene.

Port of `wast3d_tpu/refine/teleport.py` (the reference
`init_content_gaussian`, `train_st.py:73-100`): k-means both scenes
(K = 500), then translate each style Gaussian by (content cluster centre -
its own cluster centre), pairing style cluster i with content cluster i as
the reference does. The seeding is the JAX package's numpy k-means++, so
both packages start Lloyd from the same centres (`ops/kmeans.py`).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from wast3d_tpu_torch.ops.kmeans import kmeans
from wast3d_tpu_torch.scene.gaussians import GaussianScene


def cluster_teleport(
    content: GaussianScene,
    style: GaussianScene,
    num_clusters: int = 500,
    seed: int = 0,
) -> Tuple[GaussianScene, np.ndarray]:
    """Returns (teleported style scene, style cluster labels [N] numpy,
    -1 for dead slots). k-means runs on the style scene's device."""
    dev = style.device
    cnt_mask = content.mask.cpu().numpy()
    stl_mask = style.mask.cpu().numpy()
    cnt_centers, _ = kmeans(content.xyz.detach().cpu().numpy(), num_clusters, iters=100,
                            seed=seed, mask=cnt_mask, device=dev)
    stl_xyz = style.xyz.detach().cpu().numpy()
    stl_centers, stl_labels = kmeans(stl_xyz, num_clusters, iters=100, seed=seed + 1,
                                     mask=stl_mask, device=dev)
    labels = np.where(stl_labels >= 0, stl_labels, 0)
    shift = cnt_centers[labels] - stl_centers[labels]
    new_xyz = stl_xyz + np.where(stl_mask[:, None], shift, 0.0).astype(np.float32)
    return style.replace(xyz=torch.from_numpy(new_xyz).to(dev)), stl_labels
