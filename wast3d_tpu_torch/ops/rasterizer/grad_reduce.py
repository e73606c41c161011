"""K3, the per-Gaussian segment sum of duplicate gradients: CUDA kernel
wrapper, its plain version, and the rank-major reductions around it.

Port of `wast3d_tpu/ops/rasterizer/grad_reduce.py`. The blend backward gives
one gradient row per sorted duplicate (tile-major order); training needs
their sums per Gaussian, i.e. `zeros[n1, C].at[rank].add(d)`. The sum is
taken deterministically: the ranks are sorted (`torch.sort`, stable), which
makes each Gaussian's duplicates one contiguous segment, and `segment_sum`
(K3, `csrc/segsum.cu`) adds every segment in a fixed order. No float atomics
are involved, so two runs give the same bits.

The three rank-major reductions differ, as in the JAX package, in how the
rows reach rank-major order:
  "segsum"              sort, then a K-row gather into that order, then K3;
  "segsum_sortpayload"  sort, then K3 reads the f32 rows through the sort's
                        permutation (no gathered copy); the exact f32 tier
                        and the default on the card;
  "segsum_sortpacked"   as "segsum" with each value rounded to bf16 before
                        the f32 sum (half the bytes through the gather).
"scatter" is the plain `index_add_`, for tests and checks only (on CUDA it
uses float atomics, so its bits vary from run to run).

`segment_sum` launches K3 for CUDA tensors (counted in
`segment_sum.launches`) and takes `segment_sum_reference` for CPU tensors or
when `plain=True` is asked (renderer="torch").
"""

from __future__ import annotations

from typing import Optional

import torch

GRAD_REDUCES = ("segsum", "segsum_sortpayload", "segsum_sortpacked", "scatter")
DEFAULT = "segsum_sortpayload"
MAX_COLS = 16


def _check(rows, sorted_ranks, n1, perm, plain):
    real = (torch.float32, torch.float64) if plain else (torch.float32,)
    if rows.dim() != 2 or rows.dtype not in real or (rows.numel() and rows.stride(1) != 1):
        raise ValueError(f"rows must be [K, C] float32 with unit column stride "
                         f"(float64 too for the plain version), got "
                         f"{rows.dtype} {tuple(rows.shape)} strides {rows.stride()}")
    if not 1 <= rows.shape[1] <= MAX_COLS:
        raise ValueError(f"rows must have 1..{MAX_COLS} columns, got {rows.shape[1]}")
    k = sorted_ranks.shape[0]
    if sorted_ranks.dtype != torch.int32 or sorted_ranks.dim() != 1:
        raise ValueError(f"sorted_ranks must be [K] int32, got {sorted_ranks.dtype}")
    if perm is None and rows.shape[0] != k:
        raise ValueError(f"rows has {rows.shape[0]} rows for {k} ranks")
    if perm is not None and (perm.dtype != torch.int64 or tuple(perm.shape) != (k,)):
        raise ValueError(f"perm must be [{k}] int64, got {perm.dtype} {tuple(perm.shape)}")
    for name, t in (("sorted_ranks", sorted_ranks), ("perm", perm)):
        if t is not None and (t.device != rows.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous on {rows.device}")
    if n1 < 0:
        raise ValueError(f"n1 must be >= 0, got {n1}")


def segment_sum(rows: torch.Tensor, sorted_ranks: torch.Tensor, n1: int,
                perm: Optional[torch.Tensor] = None,
                plain: bool = False) -> torch.Tensor:
    """K3. out [n1, C]: row r is the sum of the rows of rank r, taken in
    ascending position. `sorted_ranks` [K] int32 ascending; the i-th of them
    belongs to `rows[i]`, or to `rows[perm[i]]` when `perm` is given."""
    dev = rows.device
    plain = plain or dev.type == "cpu"
    _check(rows, sorted_ranks, n1, perm, plain)
    if plain:
        return segment_sum_reference(rows, sorted_ranks, n1, perm)
    if dev.type != "cuda":
        raise ValueError(f"segment_sum runs on cuda or cpu, not {dev}")
    if sorted_ranks.shape[0] >= 2 ** 31 or n1 >= 2 ** 31:
        raise ValueError("segment_sum takes fewer than 2^31 rows")
    from wast3d_tpu_torch import _build

    lib = _build.load_library()
    c = rows.shape[1]
    out = torch.empty((n1, c), dtype=torch.float32, device=dev)
    if n1 == 0:
        return out
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    err = lib.w3d_segsum(
        rows.data_ptr(), rows.stride(0), None if perm is None else perm.data_ptr(),
        sorted_ranks.data_ptr(), sorted_ranks.shape[0], n1, c, out.data_ptr(),
        index, torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"segment_sum kernel launch failed: CUDA error {err} "
            f"({lib.w3d_error_string(err).decode()})")
    segment_sum.launches += 1
    return out


segment_sum.launches = 0


def segment_sum_reference(rows: torch.Tensor, sorted_ranks: torch.Tensor,
                          n1: int, perm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of K3: the same sums accumulated in float64
    (`index_add_`) and rounded once to the dtype of `rows` (float32 or
    float64); runs on any device."""
    g = rows if perm is None else rows[perm]
    out = torch.zeros((n1, g.shape[1]), dtype=torch.float64, device=rows.device)
    return out.index_add_(0, sorted_ranks, g.to(torch.float64)).to(rows.dtype)


def sort_ranks(rank: torch.Tensor):
    """(sorted ranks [K] int32, permutation [K] int64); stable, so equal
    ranks keep their tile-major order."""
    return torch.sort(rank.to(torch.int32), stable=True)


def segment_reduce_by_rank(d: torch.Tensor, rank: torch.Tensor, n1: int,
                           plain: bool = False) -> torch.Tensor:
    """K3a's wrapper: sort, K-row gather into rank-major order, K3."""
    sorted_ranks, perm = sort_ranks(rank)
    return segment_sum(d[perm], sorted_ranks, n1, plain=plain)


def segment_reduce_by_rank_sortpayload(d: torch.Tensor, rank: torch.Tensor,
                                       n1: int, plain: bool = False) -> torch.Tensor:
    """K3b's wrapper: sort, then K3 reads the f32 rows through the sort's
    permutation; no gathered copy of the rows is made."""
    sorted_ranks, perm = sort_ranks(rank)
    return segment_sum(d, sorted_ranks, n1, perm=perm, plain=plain)


def segment_reduce_by_rank_sortpacked(d: torch.Tensor, rank: torch.Tensor,
                                      n1: int, plain: bool = False) -> torch.Tensor:
    """K3c's wrapper: each value rounded to bf16 (~2^-9 relative) before the
    f32 segment sum, as the JAX default does; the gather moves bf16."""
    sorted_ranks, perm = sort_ranks(rank)
    g = d.to(torch.bfloat16)[perm].to(torch.float32)
    return segment_sum(g, sorted_ranks, n1, plain=plain)


def scatter_add(d: torch.Tensor, rank: torch.Tensor, n1: int,
                plain: bool = False) -> torch.Tensor:
    """The plain reduction, `zeros[n1, C].index_add_(0, rank, d)`."""
    del plain
    return torch.zeros((n1, d.shape[1]), dtype=d.dtype,
                       device=d.device).index_add_(0, rank, d)


REDUCERS = {
    "segsum": segment_reduce_by_rank,
    "segsum_sortpayload": segment_reduce_by_rank_sortpayload,
    "segsum_sortpacked": segment_reduce_by_rank_sortpacked,
    "scatter": scatter_add,
}


def reduce(d: torch.Tensor, rank: torch.Tensor, n1: int, mode: str,
           plain: bool = False) -> torch.Tensor:
    """[n1, C] = zeros.at[rank].add(d) by the reduction `mode`."""
    if mode not in REDUCERS:
        raise ValueError(f"grad_reduce must be one of {GRAD_REDUCES}, got {mode!r}")
    return REDUCERS[mode](d, rank, n1, plain=plain)
