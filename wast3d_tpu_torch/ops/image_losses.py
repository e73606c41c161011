"""Image-space losses: L1/L2, windowed SSIM, PSNR, total variation.

Port of `wast3d_tpu/ops/image_losses.py` (the reference `loss_utils.py`):
images are [H, W, C]; SSIM uses an 11-tap Gaussian window with sigma 1.5,
per-channel zero-padded same-size filtering, C1 = 0.01^2, C2 = 0.03^2.

The separable blur is written as explicit shifted multiply-adds, as the
JAX package writes it, and not as a grouped `conv2d`: on the card a float32
convolution goes through cuDNN in TF32 by default
(`torch.backends.cudnn.allow_tf32`), which keeps about three decimal digits.
Elementwise ops stay in full float32 without touching global settings.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def l1_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - gt))


def l2_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - gt) ** 2)


def mse(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - gt) ** 2)


def psnr(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """20 log10(1 / sqrt(mse))."""
    return 20.0 * torch.log10(1.0 / torch.sqrt(mse(pred, gt)))


def _gaussian_window(size: int, sigma: float, device) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - size // 2
    g = torch.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return g / torch.sum(g)


def _depthwise_blur(img: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """Separable same-size zero-padded filter of [H, W, C], as 2 x k
    shifted multiply-adds (module docstring)."""
    k = window.shape[0]
    r = k // 2
    h, w = img.shape[0], img.shape[1]
    x = F.pad(img, (0, 0, 0, 0, r, r))
    out = sum(window[i] * x[i:i + h] for i in range(k))
    x = F.pad(out, (0, 0, r, r))
    return sum(window[i] * x[:, i:i + w] for i in range(k))


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM over [H, W, C] (or [H, W]) images."""
    if img1.dim() == 2:
        img1, img2 = img1[..., None], img2[..., None]
    w = _gaussian_window(window_size, sigma, img1.device)
    mu1 = _depthwise_blur(img1, w)
    mu2 = _depthwise_blur(img2, w)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _depthwise_blur(img1 * img1, w) - mu1_sq
    sigma2_sq = _depthwise_blur(img2 * img2, w) - mu2_sq
    sigma12 = _depthwise_blur(img1 * img2, w) - mu12
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu12 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return torch.mean(ssim_map)


def tv_loss(img: torch.Tensor) -> torch.Tensor:
    """Total variation, absolute-value form, over the first two (spatial)
    dims: 0.5 (mean |dy| + mean |dx|), the reference's second (winning)
    definition."""
    dy = img[1:, :] - img[:-1, :]
    dx = img[:, 1:] - img[:, :-1]
    return 0.5 * (torch.mean(torch.abs(dy)) + torch.mean(torch.abs(dx)))


def tv_loss_sq(img: torch.Tensor) -> torch.Tensor:
    """Squared-difference total variation: mean dy^2 + mean dx^2 (the
    reference's shadowed first definition)."""
    dy = img[1:, :] - img[:-1, :]
    dx = img[:, 1:] - img[:, :-1]
    return torch.mean(dy ** 2) + torch.mean(dx ** 2)


def photometric_loss(pred: torch.Tensor, gt: torch.Tensor,
                     lambda_dssim: float = 0.2) -> torch.Tensor:
    """(1 - lambda) L1 + lambda (1 - SSIM), the 3DGS reconstruction loss."""
    return (1.0 - lambda_dssim) * l1_loss(pred, gt) + lambda_dssim * (
        1.0 - ssim(pred, gt))
