"""Numerical debug utilities.

Port of `wast3d_tpu/utils/debug.py`:
- `nan_check(tree, name)`: a host-side NaN/Inf sweep over nested dicts,
  lists, tuples, NamedTuples and dataclasses of tensors (or arrays, or
  floats); it raises `FloatingPointError` naming each bad leaf's path as
  `jax.tree_util.keystr` writes it for the same structure (`['key']`,
  `[0]`, `.field`; dict keys in sorted order, as JAX flattens them);
- `debug_groups_loss()`: the cluster pairwise-distance sanity optimisation,
  with JAX's numpy seed and Adam;
- `standardize_xyz` / `destandardize_xyz`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _leaves(tree, path=""):
    """(keystr path, leaf) in JAX's flattening order; None has no leaves."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _leaves(getattr(tree, f), f"{path}.{f}")
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from _leaves(x, f"{path}[{i}]")
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name), f"{path}.{f.name}")
    else:
        yield path, tree


def _finite(leaf) -> bool:
    if isinstance(leaf, torch.Tensor):
        return not leaf.is_floating_point() or bool(torch.isfinite(leaf).all())
    arr = np.asarray(leaf)
    return arr.dtype.kind != "f" or bool(np.isfinite(arr).all())


def nan_check(tree, name: str = "tree") -> bool:
    """Host-side NaN/Inf sweep; returns True if clean, raises otherwise."""
    bad = [path for path, leaf in _leaves(tree) if not _finite(leaf)]
    if bad:
        raise FloatingPointError(f"non-finite values in {name}: {bad}")
    return True


def debug_groups_loss(n: int = 8, k: int = 2, steps: int = 200, lr: float = 0.01,
                      seed: int = 0) -> float:
    """Cluster pairwise-difference loss sanity: optimise random points so
    each cluster's pairwise distance matrix matches a zero target (collapse
    clusters), with JAX's draws and Adam. Returns the final loss (it should
    approach 0)."""
    rng = np.random.default_rng(seed)
    data = torch.from_numpy(rng.uniform(size=(n, 3)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, k, n))

    def loss_fn(x):
        loss = torch.zeros((), dtype=torch.float32)
        diff = x[:, None, :] - x[None, :, :]
        d = torch.sqrt(torch.sum(diff ** 2, -1) + 1e-12)
        for c in range(k):
            m = (labels == c).to(torch.float32)
            w = m[:, None] * m[None, :]
            loss = loss + torch.mean(torch.square(d * w))
        return loss

    mu, nu = torch.zeros_like(data), torch.zeros_like(data)
    t = torch.zeros((), dtype=torch.float32)
    loss = torch.zeros(())
    for _ in range(steps):
        x = data.clone().requires_grad_(True)
        loss = loss_fn(x)
        (g,) = torch.autograd.grad(loss, x)
        t = t + 1
        mu = 0.9 * mu + 0.1 * g
        nu = 0.999 * nu + 0.001 * g * g
        data = data - lr * (mu / (1 - 0.9 ** t)) / (torch.sqrt(nu / (1 - 0.999 ** t)) + 1e-8)
    return float(loss.detach())


def standardize_xyz(xyz: torch.Tensor, mask=None):
    """(xyz - mean) / std over the active points (population std + 1e-8),
    and the mean and std for the inverse."""
    if mask is None:
        mean = torch.mean(xyz, dim=0)
        std = torch.std(xyz, dim=0, unbiased=False) + 1e-8
    else:
        m = mask.to(torch.float32)[:, None]
        n = torch.clamp(m.sum(), min=1.0)
        mean = torch.sum(xyz * m, dim=0) / n
        std = torch.sqrt(torch.sum(((xyz - mean) ** 2) * m, dim=0) / n) + 1e-8
    return (xyz - mean) / std, mean, std


def destandardize_xyz(xyz_std, mean, std):
    return xyz_std * std + mean
