"""Merge the fitted patches into one scene, with the Voronoi de-overlap.

Port of `wast3d_tpu/stylize/merge.py` (notebook 11 cells 36-39):
- merge: every ball's fitted points in one scene; each inherits the style
  patch's per-point attributes with `features_rest` zeroed and the log
  scaling multiplied by `merge_scale_factor` (0.885) (cell 36);
- de-overlap (`find_overlapping_gaussians`, cell 38): each domain point
  goes to its nearest patch centroid (a Voronoi partition of the domain);
  a fitted point is kept iff its nearest domain point's cell is its own
  patch's.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from wast3d_tpu_torch.config import StylizeConfig
from wast3d_tpu_torch.device import DeviceLike, resolve_device
from wast3d_tpu_torch.ops.knn import knn_sq_dists
from wast3d_tpu_torch.scene.gaussians import GaussianScene, from_arrays
from wast3d_tpu_torch.stylize.cluster import StylePatch


def find_retained_indices(domain: np.ndarray, fitted_list: List[np.ndarray],
                          device: DeviceLike = None) -> List[np.ndarray]:
    """Voronoi retain (cell 38): the indices kept of each patch."""
    dev = resolve_device(device)
    centroids = np.stack([f.mean(axis=0) for f in fitted_list], axis=0)
    dom = torch.as_tensor(np.asarray(domain, np.float32), device=dev)
    _, dom_to_centroid = knn_sq_dists(dom, torch.as_tensor(centroids, dtype=torch.float32,
                                                           device=dev), k=1)
    dom_to_centroid = dom_to_centroid[:, 0].cpu().numpy()
    retained = []
    for patch_idx, fitted in enumerate(fitted_list):
        _, nn_dom = knn_sq_dists(torch.as_tensor(np.asarray(fitted, np.float32), device=dev),
                                 dom, k=1)
        retained.append(np.nonzero(dom_to_centroid[nn_dom[:, 0].cpu().numpy()] == patch_idx)[0])
    return retained


def merge_patches(patch: StylePatch, fitted_list: List[np.ndarray],
                  domain: Optional[np.ndarray] = None,
                  cfg: StylizeConfig = StylizeConfig(), deoverlap: bool = True,
                  max_sh_degree: int = 3, device: DeviceLike = None) -> GaussianScene:
    """The stylized GaussianScene (on `device`) from the fitted ball point sets."""
    dev = resolve_device(device)
    if deoverlap and domain is not None and len(fitted_list) > 1:
        retained = find_retained_indices(domain, fitted_list, device=dev)
    else:
        retained = [np.arange(len(f)) for f in fitted_list]
    xyz, f_dc, f_rest, rot, scal, opac = [], [], [], [], [], []
    for fitted, keep in zip(fitted_list, retained):
        if len(keep) == 0:
            continue
        xyz.append(np.asarray(fitted)[keep])
        f_dc.append(patch.features_dc[keep])
        f_rest.append(np.zeros_like(patch.features_rest[keep]))  # cell 36: * 0
        rot.append(patch.rotation[keep])
        scal.append(patch.scaling[keep] * cfg.merge_scale_factor)  # cell 36
        opac.append(patch.opacity[keep])
    return from_arrays(
        xyz=np.concatenate(xyz), features_dc=np.concatenate(f_dc),
        features_rest=np.concatenate(f_rest), scaling=np.concatenate(scal),
        rotation=np.concatenate(rot), opacity=np.concatenate(opac),
        max_sh_degree=max_sh_degree, device=dev)
