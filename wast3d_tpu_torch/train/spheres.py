"""Sphere-regulariser losses for style-scene training.

Port of `wast3d_tpu/train/spheres.py` (the reference's style-reconstruction
scripts):
- `train_spheres.py:107-127`: isotropy = mean over Gaussians of the
  (unbiased) std of the 3 log-scales; uniformity = mean over dims of the
  (unbiased) std across Gaussians. Weights 1e-1 / 1e-2.
- `train_spheres_anisotropic.py:97-145`: anisotropy hinge on the max/min
  ratio of sigmoid(log-scale) with threshold r (1.3), weight 1e-1; plus an
  (unhinged L2) min-scale target pulling the least sigmoid scale to 1,
  weight 5e-1. The `_simple` variant (`:109-130`) drops the min-scale term
  (lambda_min_scale = 0).

The port's scene holds exactly its Gaussians, so every row is active and
the JAX package's masked means are plain means over the same rows. A scene
carried across from JAX may still hold dead slots until its first densify
step (`scene/gaussians.py`), so the losses take the scene's mask as JAX's
do and count only its rows.
"""

from __future__ import annotations

import torch

from wast3d_tpu_torch.scene.gaussians import GaussianScene


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    m = mask.to(x.dtype)
    return torch.sum(x * m) / torch.clamp_min(torch.sum(m), 1.0)


def scaling_isotropy_loss(scaling_log: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """mean_i std_dims(log-scale_i), unbiased std (torch's default)."""
    mean_d = torch.mean(scaling_log, dim=1, keepdim=True)
    var = torch.sum((scaling_log - mean_d) ** 2, dim=1) / (scaling_log.shape[1] - 1)
    return _masked_mean(torch.sqrt(var + 1e-12), mask)


def scaling_uniformity_loss(scaling_log: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """mean_dims std_i(log-scale[:, d]) over the active Gaussians, unbiased."""
    m = mask.to(scaling_log.dtype)[:, None]
    n = torch.clamp_min(torch.sum(m), 2.0)
    mean_i = torch.sum(scaling_log * m, dim=0) / n
    var = torch.sum(((scaling_log - mean_i) ** 2) * m, dim=0) / (n - 1.0)
    return torch.mean(torch.sqrt(var + 1e-12))


def scaling_anisotropy_loss(scaling_log: torch.Tensor, mask: torch.Tensor,
                            ratio: float = 1.3) -> torch.Tensor:
    """mean(max(residue, r) - r), residue = max(sig(s)) / (min(sig(s)) + eps)."""
    sig = torch.sigmoid(scaling_log)
    residue = torch.amax(sig, dim=-1) / (torch.amin(sig, dim=-1) + 1e-6)
    return _masked_mean(torch.clamp_min(residue, ratio) - ratio, mask)


def scaling_min_val_loss(scaling_log: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """sqrt(mean((1 - min(sig(s)))^2)), the unhinged L2 variant the reference
    settled on (`train_spheres_anisotropic.py:124-128`)."""
    sig_min = torch.amin(torch.sigmoid(scaling_log), dim=-1)
    return torch.sqrt(_masked_mean((1.0 - sig_min) ** 2, mask) + 1e-12)


def sphere_regularizer(scene: GaussianScene, cfg) -> torch.Tensor:
    """The combined sphere loss of a `config.SphereConfig`."""
    return sphere_loss(scene.scaling, scene.mask, cfg)


def sphere_loss(s: torch.Tensor, m: torch.Tensor, cfg) -> torch.Tensor:
    """`sphere_regularizer` of log-scales s [N, 3] and mask m [N]."""
    loss = torch.zeros((), dtype=s.dtype, device=s.device)
    if cfg.anisotropic:
        loss = loss + cfg.lambda_anisotropy * scaling_anisotropy_loss(s, m, cfg.anisotropy_ratio)
        if cfg.lambda_min_scale:
            loss = loss + cfg.lambda_min_scale * scaling_min_val_loss(s, m)
    else:
        loss = loss + cfg.lambda_isotropy * scaling_isotropy_loss(s, m)
        loss = loss + cfg.lambda_uniformity * scaling_uniformity_loss(s, m)
    return loss
