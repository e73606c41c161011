"""K3, the per-Gaussian segment sum of duplicate gradients: CUDA kernel
wrapper, its plain version, and the rank-major reductions around it.

Port of `wast3d_tpu/ops/rasterizer/grad_reduce.py`. The blend backward gives
one gradient row per sorted duplicate (tile-major order); training needs
their sums per Gaussian, i.e. `zeros[n1, C].at[rank].add(d)`. The sum is
taken deterministically, as segments (`Segments`, CSR style): `segment_sum`
(K3, `csrc/segsum.cu`) computes

    out[r] = sum over p in [offsets[s], offsets[s + 1]) of rows[idx[p]],
    s = row_map[r] (s = r without a row map), in ascending p,

with no float atomics, so two runs give the same bits. The offsets are
given, or are those of `segment_of`, each position's segment in ascending
order (K3 finds where each segment starts and ends first); `idx` is given,
or is the inverse of a permutation `perm` (K3 inverts it first), or is the
identity. Where the segments come from is the route:
  bare rank  `rank_segments`: a stable `torch.sort` of the ranks gives
             `idx`, and one `torch.searchsorted` of 0..n1 in the sorted
             ranks gives the offsets; for callers that have only `rank`;
  binning    `binning_segments`: the binning listed each Gaussian's
             duplicates together before its tile sort, in ascending tile
             id (`binning.py`): `segment_of` is that list's Gaussian
             indices, the row map is the depth order (output rows are depth
             ranks), and `perm` is the tile sort's permutation. No work
             happens before K3; the render path's backward uses it.
Both routes give every rank the same duplicates in the same order (a rank's
duplicates, sorted stably, come in ascending tile id too), so K3 returns
the same bits on either.

The three rank-major reductions differ, as in the JAX package, in how the
rows reach rank-major order:
  "segsum"              a K-row gather into that order, then K3;
  "segsum_sortpayload"  K3 reads the f32 rows through `idx` (no gathered
                        copy); the exact f32 tier and the default on the card;
  "segsum_sortpacked"   as "segsum" with each value rounded to bf16 before
                        the f32 sum (half the bytes through the gather).
"scatter" is the plain `index_add_`, for tests and checks only (on CUDA it
uses float atomics, so its bits vary from run to run).

`segment_sum` launches K3 for CUDA tensors (counted in
`segment_sum.launches`) and takes `segment_sum_reference` for CPU tensors or
when `plain=True` is asked (renderer="torch").
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

GRAD_REDUCES = ("segsum", "segsum_sortpayload", "segsum_sortpacked", "scatter")
DEFAULT = "segsum_sortpayload"
MAX_COLS = 16


class Segments(NamedTuple):
    """The segments K3 sums (module docstring)."""

    offsets: Optional[torch.Tensor]  # [S + 1] int32, ascending (segment_of None)
    row_map: Optional[torch.Tensor]  # [n1] int64: row r sums segment row_map[r]; None: r
    idx: Optional[torch.Tensor]  # [K] int32: position p reads rows[idx[p]]
    perm: Optional[torch.Tensor]  # [K] int64 permutation whose inverse is idx (idx None)
    # [K] int64, ascending in [0, n1): position p lies in segment
    # segment_of[p] (offsets None; needs a row map, and S = n1)
    segment_of: Optional[torch.Tensor] = None

    @property
    def n1(self) -> int:
        return (self.offsets.shape[0] - 1 if self.row_map is None
                else self.row_map.shape[0])


def _check(rows, seg, plain):
    real = (torch.float32, torch.float64) if plain else (torch.float32,)
    if rows.dim() != 2 or rows.dtype not in real or (rows.numel() and rows.stride(1) != 1):
        raise ValueError(f"rows must be [K, C] float32 with unit column stride "
                         f"(float64 too for the plain version), got "
                         f"{rows.dtype} {tuple(rows.shape)} strides {rows.stride()}")
    if not 1 <= rows.shape[1] <= MAX_COLS:
        raise ValueError(f"rows must have 1..{MAX_COLS} columns, got {rows.shape[1]}")
    if not isinstance(seg, Segments):
        raise ValueError(f"segments must be Segments, got {type(seg).__name__}")
    for name, dtype in (("offsets", torch.int32), ("row_map", torch.int64),
                        ("idx", torch.int32), ("perm", torch.int64),
                        ("segment_of", torch.int64)):
        t = getattr(seg, name)
        if t is None:
            continue
        if t.dtype != dtype or t.dim() != 1:
            raise ValueError(f"{name} must be 1-D {dtype}, got {t.dtype} {tuple(t.shape)}")
        if t.device != rows.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {rows.device}")
    if (seg.offsets is None) == (seg.segment_of is None) or (
            seg.offsets is not None and seg.offsets.shape[0] < 1):
        raise ValueError("segments need one of offsets [S + 1] and segment_of")
    if seg.segment_of is not None and seg.row_map is None:
        raise ValueError("segment_of needs a row map")
    if seg.idx is not None and seg.perm is not None:
        raise ValueError("segments take at most one of idx and perm")
    if (seg.perm is not None and seg.segment_of is not None
            and seg.perm.shape != seg.segment_of.shape):
        raise ValueError("perm and segment_of must have one entry per position")
    if max(rows.shape[0], seg.n1 + 1) >= 2 ** 31:
        raise ValueError("segment_sum takes fewer than 2^31 rows")


def _vector_rows(rows: torch.Tensor) -> bool:
    """Whether K3 may read each row as 16-byte loads: rows 16-byte aligned
    and every row's columns up to the next multiple of 4 inside the storage
    (the extra columns are read and never used)."""
    k, c = rows.shape
    if k == 0 or rows.stride(0) % 4 != 0 or rows.data_ptr() % 16 != 0:
        return False
    last = rows.storage_offset() + (k - 1) * rows.stride(0) + -(-c // 4) * 4
    return last * 4 <= rows.untyped_storage().nbytes()


def segment_sum(rows: torch.Tensor, seg: Segments, plain: bool = False) -> torch.Tensor:
    """K3. out [seg.n1, C] (module docstring); an empty segment gives zeros."""
    dev = rows.device
    plain = plain or dev.type == "cpu"
    _check(rows, seg, plain)
    if plain:
        return segment_sum_reference(rows, seg)
    if dev.type != "cuda":
        raise ValueError(f"segment_sum runs on cuda or cpu, not {dev}")
    from wast3d_tpu_torch import _build

    lib = _build.load_library()
    n1, c = seg.n1, rows.shape[1]
    out = torch.empty((n1, c), dtype=torch.float32, device=dev)
    if n1 == 0:
        return out
    if seg.segment_of is not None and seg.segment_of.shape[0] == 0:
        return out.zero_()  # no positions: every segment is empty
    # K3's first pass writes the inverse of perm and the bounds of
    # segment_of into one scratch: [K] idx, then [2, n1] bounds.
    k = next((t.shape[0] for t in (seg.perm, seg.segment_of) if t is not None), 0)
    idx_len = k if seg.perm is not None else 0
    bounds_len = 2 * n1 if seg.segment_of is not None else 0
    scratch = torch.empty(idx_len + bounds_len, dtype=torch.int32, device=dev)
    idx = seg.idx if seg.perm is None else scratch[:idx_len]
    bounds = scratch[idx_len:] if bounds_len else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    index = dev.index if dev.index is not None else torch.cuda.current_device()
    err = lib.w3d_segsum(
        rows.data_ptr(), rows.stride(0), int(_vector_rows(rows)), ptr(idx), ptr(seg.perm),
        ptr(seg.segment_of), k, ptr(seg.offsets), ptr(bounds), ptr(seg.row_map), n1, c,
        out.data_ptr(), index, torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"segment_sum kernel launch failed: CUDA error {err} "
            f"({lib.w3d_error_string(err).decode()})")
    segment_sum.launches += 1
    return out


segment_sum.launches = 0


def source_index(seg: Segments) -> Optional[torch.Tensor]:
    """[K] int64: the row that position p reads (None: p itself)."""
    if seg.perm is not None:
        k = seg.perm.shape[0]
        return torch.empty_like(seg.perm).scatter_(
            0, seg.perm, torch.arange(k, dtype=torch.int64, device=seg.perm.device))
    return None if seg.idx is None else seg.idx.to(torch.int64)


def segment_offsets(seg: Segments) -> torch.Tensor:
    """[S + 1] int32: the offsets, given or those of `segment_of`."""
    if seg.offsets is not None:
        return seg.offsets
    needles = torch.arange(seg.n1 + 1, device=seg.segment_of.device)
    return torch.searchsorted(seg.segment_of, needles, out_int32=True)


def segment_bounds(seg: Segments):
    """([n1] lo, [n1] hi) int64: each output row's range of positions."""
    offsets = segment_offsets(seg).to(torch.int64)
    if seg.row_map is None:
        return offsets[:-1], offsets[1:]
    return offsets[seg.row_map], offsets[seg.row_map + 1]


def segment_sum_reference(rows: torch.Tensor, seg: Segments) -> torch.Tensor:
    """Plain PyTorch version of K3: the same sums accumulated in float64
    (`index_add_`) and rounded once to the dtype of `rows` (float32 or
    float64); runs on any device."""
    lo, hi = segment_bounds(seg)
    n1, length = lo.shape[0], hi - lo
    out_row = torch.repeat_interleave(torch.arange(n1, device=rows.device), length)
    first = torch.cumsum(length, 0) - length
    p = lo[out_row] + torch.arange(out_row.shape[0], device=rows.device) - first[out_row]
    src = source_index(seg)
    src = p if src is None else src[p]
    out = torch.zeros((n1, rows.shape[1]), dtype=torch.float64, device=rows.device)
    return out.index_add_(0, out_row, rows[src].to(torch.float64)).to(rows.dtype)


def rank_segments(rank: torch.Tensor, n1: int) -> Segments:
    """The bare-rank route: a stable sort of `rank` (equal ranks keep their
    tile-major order) and the segment offsets by one searchsorted."""
    sorted_ranks, perm = torch.sort(rank.to(torch.int32), stable=True)
    needles = torch.arange(n1 + 1, dtype=torch.int32, device=rank.device)
    offsets = torch.searchsorted(sorted_ranks, needles, out_int32=True)
    return Segments(offsets, None, perm.to(torch.int32), None)


def binning_segments(sort_perm: torch.Tensor, presort_gauss: torch.Tensor,
                     depth_order: torch.Tensor) -> Segments:
    """The binning route (module docstring), from `Binning.sort_perm`,
    `.presort_gauss` and `.depth_order`: output row r is Gaussian
    depth_order[r]. Nothing is computed here."""
    return Segments(None, depth_order, None, sort_perm, presort_gauss)


def reduce_segments(d: torch.Tensor, seg: Segments, mode: str,
                    plain: bool = False) -> torch.Tensor:
    """[n1, C] segment sums of the rows `d` [K, C] (tile-major) by one of
    the three rank-major reductions (module docstring)."""
    if mode == "segsum_sortpayload":
        return segment_sum(d, seg, plain=plain)
    if mode not in ("segsum", "segsum_sortpacked"):
        raise ValueError(f"no segment reduction {mode!r}")
    packed = mode == "segsum_sortpacked"
    # sortpacked: each value rounded to bf16 (~2^-9 relative) before the f32
    # sum, as the JAX default does; the gather moves bf16
    g = d.to(torch.bfloat16) if packed else d
    src = source_index(seg)
    g = g if src is None else g[src]
    g = g.to(torch.float32) if packed else g
    return segment_sum(g, seg._replace(idx=None, perm=None), plain=plain)


def segment_reduce_by_rank(d: torch.Tensor, rank: torch.Tensor, n1: int,
                           plain: bool = False) -> torch.Tensor:
    """K3a's wrapper: the bare-rank route, a K-row gather, K3."""
    return reduce_segments(d, rank_segments(rank, n1), "segsum", plain)


def segment_reduce_by_rank_sortpayload(d: torch.Tensor, rank: torch.Tensor,
                                       n1: int, plain: bool = False) -> torch.Tensor:
    """K3b's wrapper: the bare-rank route, K3 reading the f32 rows through
    the sort's permutation; no gathered copy of the rows is made."""
    return reduce_segments(d, rank_segments(rank, n1), "segsum_sortpayload", plain)


def segment_reduce_by_rank_sortpacked(d: torch.Tensor, rank: torch.Tensor,
                                      n1: int, plain: bool = False) -> torch.Tensor:
    """K3c's wrapper: the bare-rank route on bf16-rounded values."""
    return reduce_segments(d, rank_segments(rank, n1), "segsum_sortpacked", plain)


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
    """[n1, C] = zeros.at[rank].add(d) by the reduction `mode`, the segment
    modes on the bare-rank route."""
    if mode not in REDUCERS:
        raise ValueError(f"grad_reduce must be one of {GRAD_REDUCES}, got {mode!r}")
    return REDUCERS[mode](d, rank, n1, plain=plain)
