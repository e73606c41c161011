"""Exact nearest-neighbour distances: the scale initialisation and the
stylization's kNN.

Port of `wast3d_tpu/ops/knn.py`. The JAX package has no Pallas kernel here.
Distances use the same ||a||^2 + ||b||^2 - 2 a.b expansion as JAX, with the
cross term as a float32 matrix product (full float32: PyTorch's default,
`torch.backends.cuda.matmul.allow_tf32 = False`, which the port never
changes). Nothing materialises more than a block of the N x M matrix:
`knn_sq_dists` folds a running top-k over column blocks (O(N (k + block))),
`knn_sq_dists_sort` sorts blocks of query rows (O(row_block M)).

Ties keep the JAX order. `jax.lax.top_k` and `jax.lax.sort` put the lower
index first among equal values, so both functions select with a stable
ascending `torch.sort`: equal distances come out in column order.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

_BIG = 1e30


def pairwise_sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., N, D] x [..., M, D] -> [..., N, M] squared euclidean distances
    (matrix-product form, clamped at 0); leading dimensions broadcast."""
    a2 = torch.sum(a * a, dim=-1, keepdim=True)
    b2 = torch.sum(b * b, dim=-1).unsqueeze(-2)
    cross = a @ b.transpose(-1, -2)
    return torch.clamp_min(a2 + b2 - 2.0 * cross, 0.0)


def _take_k(d: torch.Tensor, idx: torch.Tensor, k: int):
    """The k smallest of each row of d with their entries of idx; ties in
    column order (stable sort)."""
    sd, pos = torch.sort(d, dim=1, stable=True)
    return sd[:, :k], torch.gather(idx, 1, pos[:, :k])


def knn_sq_dists(query: torch.Tensor, data: torch.Tensor, k: int,
                 query_mask: Optional[torch.Tensor] = None,
                 data_mask: Optional[torch.Tensor] = None,
                 exclude_self: bool = False,
                 block: int = 2048,
                 best: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                 row_offset: int = 0,
                 col_offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """k smallest squared distances (ascending) and their indices [N, k]
    (int64) from each query [N, D] to data [M, D].

    Invalid data points (data_mask False) are never neighbours: they, and
    the padding of data to a multiple of `block`, sit at _BIG. Invalid
    queries return _BIG. exclude_self drops the (i, i) pair (query is data).
    Rows with fewer than k valid neighbours keep the initial (_BIG, 0)
    entries, as in JAX.

    For one block of a larger, sharded set (`parallel/ring.py`): query row
    i and data column j are rows `row_offset + i` and `col_offset + j` of
    the whole sets (the indices returned, and what exclude_self compares),
    and `best` is a running (distances, indices) [N, k] to fold into in
    place of the initial entries."""
    n, m = query.shape[0], data.shape[0]
    dev = query.device
    pad = (-m) % block
    data_p = torch.nn.functional.pad(data, (0, 0, 0, pad))
    dmask = torch.arange(m + pad, device=dev) < m
    if data_mask is not None:
        dmask[:m] &= data_mask.to(torch.bool)
    q2 = torch.sum(query * query, dim=-1, keepdim=True)
    rows = torch.arange(n, device=dev)[:, None] + row_offset
    if best is None:
        best_d = torch.full((n, k), _BIG, dtype=torch.float32, device=dev)
        best_i = torch.zeros((n, k), dtype=torch.int64, device=dev)
    else:
        best_d, best_i = best
    for s in range(0, m + pad, block):
        cols = data_p[s:s + block]
        c2 = torch.sum(cols * cols, dim=-1)
        d = torch.clamp_min(q2 + c2[None, :] - 2.0 * (query @ cols.T), 0.0)
        d = torch.where(dmask[None, s:s + block], d, _BIG)
        col_idx = torch.arange(s, s + block, device=dev)[None, :] + col_offset
        if exclude_self:
            d = torch.where(col_idx == rows, _BIG, d)
        best_d, best_i = _take_k(torch.cat([best_d, d], 1),
                                 torch.cat([best_i, col_idx.expand(n, block)], 1), k)
    if query_mask is not None:
        best_d = torch.where(query_mask.to(torch.bool)[:, None], best_d, _BIG)
    return best_d, best_i


def knn_sq_dists_sort(query: torch.Tensor, data: torch.Tensor, k: int,
                      query_mask: Optional[torch.Tensor] = None,
                      data_mask: Optional[torch.Tensor] = None,
                      exclude_self: bool = False,
                      row_block: int = 2048) -> Tuple[torch.Tensor, torch.Tensor]:
    """`knn_sq_dists` by a full stable sort of each query row instead of a
    folded top-k: the same contract and results, cheaper when k is large
    (the descriptor build's k = 2000). Memory O(row_block M)."""
    n, m = query.shape[0], data.shape[0]
    dev = query.device
    d2 = torch.sum(data * data, dim=-1)
    dmask = (torch.ones(m, dtype=torch.bool, device=dev) if data_mask is None
             else data_mask.to(torch.bool))
    col_idx = torch.arange(m, device=dev)
    best_d = torch.empty((n, k), dtype=torch.float32, device=dev)
    best_i = torch.empty((n, k), dtype=torch.int64, device=dev)
    for s in range(0, n, row_block):
        qb = query[s:s + row_block]
        q2 = torch.sum(qb * qb, dim=-1, keepdim=True)
        d = torch.clamp_min(q2 + d2[None, :] - 2.0 * (qb @ data.T), 0.0)
        d = torch.where(dmask[None, :], d, _BIG)
        if exclude_self:
            rows = torch.arange(s, s + qb.shape[0], device=dev)[:, None]
            d = torch.where(col_idx[None, :] == rows, _BIG, d)
        sd, si = torch.sort(d, dim=1, stable=True)
        best_d[s:s + qb.shape[0]] = sd[:, :k]
        best_i[s:s + qb.shape[0]] = si[:, :k]
    if query_mask is not None:
        best_d = torch.where(query_mask.to(torch.bool)[:, None], best_d, _BIG)
    return best_d, best_i


def mean_sq_dist_to_3nn(points: torch.Tensor, mask: Optional[torch.Tensor] = None,
                        block: int = 1024) -> torch.Tensor:
    """[N] mean squared distance to the 3 nearest other points; masked-out
    points are never neighbours and get _BIG. (The reference's `distCUDA2`,
    exact instead of Morton-approximate; `topk` here, since only the values
    are used.)"""
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
