"""Style-scene clustering and cluster export (.npz patches).

Port of `wast3d_tpu/stylize/cluster.py` (the reference's
`aux_save_clusters_clean.py:31-183`): K-means (n_init=20, max_iter=100)
over the Gaussian positions, each cluster re-centred on its centroid, all
six attribute arrays written to `cluster_{i}.npz` under the reference's key
names (`NPZ_KEYS`), so patches move freely between the reference, the JAX
package and the port.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from wast3d_tpu_torch.ops.kmeans import kmeans_best
from wast3d_tpu_torch.scene.gaussians import GaussianScene

NPZ_KEYS = ("_xyz", "_features_dc", "_features_rest", "_rotation",
            "_scaling", "_opacity")


def cluster_scene(scene: GaussianScene, num_clusters: int, n_init: int = 20,
                  iters: int = 100, seed: int = 0):
    """K-means over the scene's valid Gaussian positions, on the scene's
    device. Returns (centers [K, 3], labels [N] with -1 for masked rows)."""
    return kmeans_best(scene.xyz.detach().cpu().numpy(), num_clusters, n_init=n_init,
                       iters=iters, seed=seed, mask=scene.mask.cpu().numpy(),
                       device=scene.device)


def export_clusters(scene: GaussianScene, output_dir: str, num_clusters: int,
                    n_init: int = 20, seed: int = 0) -> List[str]:
    """Cluster and write one npz per cluster (re-centred xyz)."""
    os.makedirs(output_dir, exist_ok=True)
    centers, labels = cluster_scene(scene, num_clusters, n_init=n_init, seed=seed)
    arrays = {
        "_xyz": scene.xyz, "_features_dc": scene.features_dc,
        "_features_rest": scene.features_rest, "_rotation": scene.rotation,
        "_scaling": scene.scaling, "_opacity": scene.opacity,
    }
    arrays = {k: v.detach().cpu().numpy() for k, v in arrays.items()}
    paths = []
    for i in range(num_clusters):
        idx = np.nonzero(labels == i)[0]
        out = {k: v[idx] for k, v in arrays.items()}
        out["_xyz"] = out["_xyz"] - centers[i][None, :]  # recentre
        path = os.path.join(output_dir, f"cluster_{i}.npz")
        np.savez(path, **out)
        paths.append(path)
    return paths


class StylePatch:
    """A loaded style cluster: re-centred points and their attributes, as
    float32 numpy arrays."""

    def __init__(self, arrays: dict):
        self.xyz = np.asarray(arrays["_xyz"], np.float32)
        self.features_dc = np.asarray(arrays["_features_dc"], np.float32)
        self.features_rest = np.asarray(arrays["_features_rest"], np.float32)
        self.rotation = np.asarray(arrays["_rotation"], np.float32)
        self.scaling = np.asarray(arrays["_scaling"], np.float32)
        self.opacity = np.asarray(arrays["_opacity"], np.float32)

    def __len__(self):
        return len(self.xyz)

    def select(self, idx: np.ndarray) -> "StylePatch":
        return StylePatch({k: getattr(self, k[1:])[idx] for k in NPZ_KEYS})


def load_cluster(path: str) -> StylePatch:
    """Load a cluster npz (notebook 11 cell 10)."""
    with np.load(path) as f:
        return StylePatch(dict(f))
