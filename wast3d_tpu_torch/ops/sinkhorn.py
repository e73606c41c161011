"""Entropic optimal transport: log-domain Sinkhorn in a fixed number of steps.

Port of `wast3d_tpu/ops/sinkhorn.py`, the differentiable stand-in for the
reference's POT `ot.emd2` on sampled point subsets. The iterations are a
Python loop of row and column log-sum-exp reductions; autograd
differentiates through every iterate, as JAX does through its scan.

The log-sum-exp is `jax.nn.logsumexp`'s formula, log(sum(exp(a - max))) +
max with the max detached, differentiated by autograd. `torch.logsumexp`
computes the same value, but its backward, exp(a - result), loses
precision that the iterations amplify: through 80 iterations at epsilon
0.01 its gradient was 1.3e-4 of max |g| from float64, against 1.5e-5 for
this formula and 3.2e-5 for JAX's (24 points, CPU).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from wast3d_tpu_torch.ops.knn import pairwise_sq_dists


def cost_matrix(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared euclidean cost (POT `ot.dist` default), in JAX's
    matrix-product form."""
    return pairwise_sq_dists(x, y)


def _logsumexp(a: torch.Tensor, dim: int) -> torch.Tensor:
    m = torch.amax(a, dim=dim, keepdim=True).detach()
    return (torch.log(torch.sum(torch.exp(a - m), dim=dim, keepdim=True)) + m).squeeze(dim)


def sinkhorn(
    cost: torch.Tensor,
    a: Optional[torch.Tensor] = None,
    b: Optional[torch.Tensor] = None,
    epsilon: float = 0.01,
    iters: int = 100,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Log-domain Sinkhorn on an [n, m] cost; a / b are the marginals
    (default uniform). Returns (transport_cost, f, g): the entropic OT cost
    <P, C> and the dual potentials."""
    n, m = cost.shape
    dev = cost.device
    loga = torch.log(torch.full((n,), 1.0 / n, device=dev) if a is None else a)
    logb = torch.log(torch.full((m,), 1.0 / m, device=dev) if b is None else b)
    f = torch.zeros(n, device=dev)
    g = torch.zeros(m, device=dev)
    for _ in range(iters):
        f = -epsilon * _logsumexp((g[None, :] + epsilon * logb[None, :] - cost) / epsilon, 1)
        g = -epsilon * _logsumexp((f[:, None] + epsilon * loga[:, None] - cost) / epsilon, 0)
    log_p = (f[:, None] + g[None, :] - cost) / epsilon + loga[:, None] + logb[None, :]
    return torch.sum(torch.exp(log_p) * cost), f, g


def emd2_approx(x: torch.Tensor, y: torch.Tensor, epsilon: float = 0.01,
                iters: int = 200) -> torch.Tensor:
    """Differentiable stand-in for POT `ot.emd2(uniform, uniform, dist(x,y))`
    (squared-euclidean ground cost, uniform marginals)."""
    c = cost_matrix(x, y)
    # Scale-aware epsilon: entropic blur proportional to the cost scale.
    scale = (torch.mean(c) + 1e-12).detach()
    cost, _, _ = sinkhorn(c / scale, epsilon=epsilon, iters=iters)
    return cost * scale
