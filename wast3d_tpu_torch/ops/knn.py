"""Exact nearest-neighbour distances for the scale initialisation.

Port of `wast3d_tpu/ops/knn.py::mean_sq_dist_to_3nn` (the reference's
`distCUDA2`, exact instead of Morton-approximate). The JAX package has no
Pallas kernel here; the port computes blocks of query rows against all
points with the same ||a||^2 + ||b||^2 - 2 a.b expansion (a matrix product,
full float32 by PyTorch's default) and takes the 3 smallest per row with
`topk`. Memory is O(block x N).
"""

from __future__ import annotations

from typing import Optional

import torch

_BIG = 1e30


def mean_sq_dist_to_3nn(points: torch.Tensor, mask: Optional[torch.Tensor] = None,
                        block: int = 1024) -> torch.Tensor:
    """[N] mean squared distance to the 3 nearest other points; masked-out
    points are never neighbours and get _BIG."""
    n = points.shape[0]
    p2 = torch.sum(points * points, dim=-1)
    out = torch.empty((n,), dtype=torch.float32, device=points.device)
    for s in range(0, n, block):
        e = min(n, s + block)
        q = points[s:e]
        d = torch.clamp_min(p2[s:e, None] + p2[None, :] - 2.0 * (q @ points.T), 0.0)
        if mask is not None:
            d = torch.where(mask[None, :], d, torch.full_like(d, _BIG))
        rows = torch.arange(e - s, device=points.device)
        d[rows, rows + s] = _BIG  # never its own neighbour
        k = min(3, n)
        best = torch.topk(d, k, dim=1, largest=False).values
        if k < 3:
            best = torch.cat([best, best.new_full((e - s, 3 - k), _BIG)], dim=1)
        out[s:e] = best.mean(dim=1)
    if mask is not None:
        out = torch.where(mask, out, torch.full_like(out, _BIG))
    return out
