"""Depth-map utilities: depth -> 3D points, depth -> normals, blur.

Port of `wast3d_tpu/ops/depth.py` (the reference's kornia
`depth_to_normals`): normals from the central-difference gradients of the
back-projected point map. Differentiable, so the depth -> normals -> style
loss chain reaches the Gaussian means through the render's depth channel.

The blur is written as shifted multiply-adds over a zero-padded map (JAX's
SAME convolution pads with zeros), not as a `conv2d`, so it stays in full
float32 on the card whatever cuDNN's TF32 setting is.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _spatial_gradient(x: torch.Tensor):
    """Central-difference gradients (edges replicated), [H, W] -> (dx, dy)."""
    xp = F.pad(x[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    dx = 0.5 * (xp[1:-1, 2:] - xp[1:-1, :-2])
    dy = 0.5 * (xp[2:, 1:-1] - xp[:-2, 1:-1])
    return dx, dy


def depth_to_3d(depth: torch.Tensor, fx, fy, cx, cy) -> torch.Tensor:
    """[H, W] depth -> [H, W, 3] camera-space points (pinhole K)."""
    h, w = depth.shape
    u = torch.arange(w, dtype=torch.float32, device=depth.device)[None, :]
    v = torch.arange(h, dtype=torch.float32, device=depth.device)[:, None]
    x = (u - cx) / fx * depth
    y = (v - cy) / fy * depth
    return torch.stack([x, y, depth], dim=-1)


def depth_to_normals(depth: torch.Tensor, fx, fy, cx=None, cy=None) -> torch.Tensor:
    """[H, W] depth -> [H, W, 3] unit normals (camera space): the normalised
    cross product of the point map's u and v derivatives. cx, cy default to
    the image centre."""
    h, w = depth.shape
    cx = (w - 1) / 2.0 if cx is None else cx
    cy = (h - 1) / 2.0 if cy is None else cy
    pts = depth_to_3d(depth, fx, fy, cx, cy)
    grads = [_spatial_gradient(pts[..., c]) for c in range(3)]
    du = torch.stack([g[0] for g in grads], dim=-1)
    dv = torch.stack([g[1] for g in grads], dim=-1)
    n = torch.linalg.cross(du, dv, dim=-1)
    # The epsilon sits inside the root, as in JAX: where n == 0 (flat or
    # empty regions) the gradient stays finite; normalising by norm + eps
    # would give 0/0 there.
    return n * torch.rsqrt(torch.sum(n * n, dim=-1, keepdim=True) + 1e-12)


def gaussian_blur(img: torch.Tensor, sigma: float, radius: int = None) -> torch.Tensor:
    """Separable Gaussian blur of an [H, W] map, zero-padded to the same
    size (the reference's depth-target smoothing)."""
    if radius is None:
        radius = max(1, int(3 * sigma))
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=img.device)
    k = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    k = k / k.sum()
    h, w = img.shape
    taps = 2 * radius + 1
    xp = F.pad(img, (0, 0, radius, radius))
    out = sum(k[i] * xp[i:i + h] for i in range(taps))
    xp = F.pad(out, (radius, radius))
    return sum(k[i] * xp[:, i:i + w] for i in range(taps))
