"""Classic Gatys neural style transfer on images (sanity reference).

Port of `wast3d_tpu/models/nst.py` (the reference `nerf2nerf/nst.py:34-111`
and the `test_simple_NST` control of `train_st_sphere4_vgg.py`): optimise a
generated image directly against VGG content + Gram style losses, the
known-good baseline for the VGG loss plumbing. Adam is JAX's own loop
(beta 0.9 / 0.999, eps 1e-8 outside the root, bias corrections in
float32), on autograd.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from wast3d_tpu_torch.device import DeviceLike, resolve_device
from wast3d_tpu_torch.ops import vgg as vgg_mod


def style_transfer(
    content_image: np.ndarray,
    style_image: np.ndarray,
    steps: int = 200,
    lr: float = 4e-3,
    alpha: float = 8.0,
    beta: float = 70.0,
    weights_path: Optional[str] = None,
    *,
    device: DeviceLike = None,
):
    """Run NST on `device` (None means CUDA); returns (stylized [H, W, 3]
    clipped to [0, 1], losses [steps]) as numpy. Weights as in the
    reference (lr 0.004, alpha 8, beta 70)."""
    dev = resolve_device(device)
    params = vgg_mod.to_device(vgg_mod.load_weights(weights_path), dev)
    c = torch.as_tensor(content_image, dtype=torch.float32, device=dev)
    s = torch.as_tensor(style_image, dtype=torch.float32, device=dev)
    with torch.no_grad():
        content_feats = vgg_mod.get_features(params, c)
        style_feats = vgg_mod.get_features(params, s)
    img = c.clone()
    mu, nu = torch.zeros_like(img), torch.zeros_like(img)
    losses = []
    for t in range(1, steps + 1):
        x = img.detach().requires_grad_(True)
        feats = vgg_mod.get_features(params, x)
        loss = (alpha * vgg_mod.content_loss(content_feats, feats)
                + beta * vgg_mod.style_loss(style_feats, feats))
        (g,) = torch.autograd.grad(loss, [x])
        with torch.no_grad():
            mu = 0.9 * mu + 0.1 * g
            nu = 0.999 * nu + 0.001 * g * g
            b1 = float(np.float32(1) - np.float32(0.9) ** np.float32(t))
            b2 = float(np.float32(1) - np.float32(0.999) ** np.float32(t))
            img = img - lr * (mu / b1) / (torch.sqrt(nu / b2) + 1e-8)
        losses.append(loss.detach())
    return (torch.clamp(img, 0, 1).cpu().numpy(),
            torch.stack(losses).cpu().numpy() if losses else np.zeros(0, np.float32))
