"""Tile binning: duplicate Gaussians into (tile, depth)-sorted lists.

Port of `wast3d_tpu/ops/rasterizer/binning.py` with dynamic sizes. The JAX
version works inside static capacities (a phased emission grid, a
`dup_capacity` prefix, a `max_tiles_per_gaussian` ceiling) because XLA needs
static shapes, and flags truncation in the `overflow*` fields. Here every
size follows the data:

1. Depth pre-sort (invalid Gaussians last); a duplicate's within-tile depth
   position is its *rank* in that order.
2. Each Gaussian's covered tile rect from the tight extents
   (`compute_rects`), expanded to one entry per tile.
3. The exact per-tile ellipse cull: a duplicate whose Gaussian cannot reach
   alpha >= 1/255 anywhere in the tile's sample box is dropped (the blend
   skips it at every pixel, so the output is unchanged).
4. One `torch.sort` on the int64 key `tile * N + rank`. The key is 64 bits
   wide, so it cannot wrap the way a packed u32 key can. Keys are unique
   (a Gaussian covers a tile once), so the order is fixed.
5. One `torch.searchsorted` of the needles `tile * N` for the tile ranges.

Before the sort the kept duplicates are listed Gaussian-major: Gaussian by
Gaussian in index order, each one's tiles in ascending tile id (its rect
is row-major). That is the grouping the training backward needs: a
Gaussian's duplicates, in the order a stable sort of `rank` would give
them. `Binning` keeps it for `grad_reduce`'s binning route at no cost to
serving: the sort's permutation (`sort_perm`, returned by `torch.sort`
anyway) and the pre-sort list's Gaussian indices (`presort_gauss`, already
computed). Each Gaussian's segment bounds and the inverse permutation are
left to the backward (K3's first pass finds both).

Nothing is ever truncated, so `overflow`, `overflow_emit`, `overflow_dup`
and `overflow_rect` are always False; they stay in `Binning` so callers
read the same fields as in the JAX package. When the JAX binning does not
overflow, both give the same sorted (tile, rank) sequence and tile ranges.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

TILE = 16


class Binning(NamedTuple):
    gauss_idx: torch.Tensor  # [K] original Gaussian index per sorted duplicate
    tile_of_dup: torch.Tensor  # [K] tile id per sorted duplicate
    tile_start: torch.Tensor  # [T] int32 range starts into the sorted list
    tile_end: torch.Tensor  # [T] int32 range ends
    num_duplicates: torch.Tensor  # [] int64, == K
    overflow: torch.Tensor  # [] bool, always False (module docstring)
    overflow_emit: torch.Tensor
    overflow_dup: torch.Tensor
    overflow_rect: torch.Tensor
    depth_order: torch.Tensor  # [N] Gaussian index by depth (invalid last)
    rank: torch.Tensor  # [K] index into depth_order
    rank_of: torch.Tensor  # [N] inverse of depth_order
    # Port only (module docstring): sorted position p holds pre-sort
    # duplicate sort_perm[p]; pre-sort duplicate q is of Gaussian
    # presort_gauss[q] (ascending).
    sort_perm: torch.Tensor  # [K] int64
    presort_gauss: torch.Tensor  # [K] int64


def tile_grid(width: int, height: int) -> tuple:
    return (-(-width // TILE), -(-height // TILE))


def compute_rects(means2d, radii, grid_x: int, grid_y: int,
                  ext_x=None, ext_y=None):
    """Per-Gaussian covered tile rect [xmin, xmax) x [ymin, ymax); radii==0
    (or a zero extent) gives an empty rect. ext_x/ext_y are the tight
    half-extents from `preprocess`; they default to the square of radii."""
    mx, my = means2d[:, 0], means2d[:, 1]
    rx = (radii if ext_x is None else ext_x).to(torch.float32)
    ry = (radii if ext_y is None else ext_y).to(torch.float32)

    def cell(v, hi):
        return torch.clamp(torch.floor(v / TILE), 0, hi).to(torch.int64)

    xmin = cell(mx - rx, grid_x)
    ymin = cell(my - ry, grid_y)
    xmax = cell(mx + rx + TILE - 1, grid_x)
    ymax = cell(my + ry + TILE - 1, grid_y)
    empty = (radii <= 0) | (rx <= 0) | (ry <= 0)
    zero = torch.zeros_like(xmin)
    return (torch.where(empty, zero, xmin), torch.where(empty, zero, ymin),
            torch.where(empty, zero, xmax), torch.where(empty, zero, ymax))


def _tile_cull_keep(tx, ty, g, means2d, conics, opacities, jitter_margin):
    """Exact per-tile ellipse cull for duplicates (tile tx/ty of Gaussian
    g): keep iff the mean lies in the tile's sample box or the minimum of
    Q(d) = A dx^2 + 2B dx dy + C dy^2 over the box edges is <= tau =
    2 ln(255 opa) + 1e-3. The box is the pixel centres [t*16, t*16+15],
    widened by `jitter_margin` on the low side (offsets lie in (-1, 0]).
    The 1e-3 slack keeps the decision conservative against the blend's own
    f32 evaluation. Same f32 formula, term for term, as the JAX cull."""
    a = conics[g, 0]
    b = conics[g, 1]
    c = conics[g, 2]
    boc = b / torch.clamp_min(c, 1e-12)
    boa = b / torch.clamp_min(a, 1e-12)
    tau = 2.0 * torch.log(torch.clamp_min(255.0 * opacities[g], 1e-12)) + 1e-3
    mx, my = means2d[g, 0], means2d[g, 1]
    txf = (tx * TILE).to(torch.float32)
    tyf = (ty * TILE).to(torch.float32)
    x0 = txf - jitter_margin - mx
    x1 = txf + (TILE - 1) - mx
    y0 = tyf - jitter_margin - my
    y1 = tyf + (TILE - 1) - my

    def edge_x(cx):
        dy = torch.minimum(torch.maximum(-boc * cx, y0), y1)
        return (a * cx + 2.0 * b * dy) * cx + c * dy * dy

    def edge_y(cy):
        dx = torch.minimum(torch.maximum(-boa * cy, x0), x1)
        return (c * cy + 2.0 * b * dx) * cy + a * dx * dx

    qmin = torch.minimum(torch.minimum(edge_x(x0), edge_x(x1)),
                         torch.minimum(edge_y(y0), edge_y(y1)))
    inside = (x0 <= 0) & (x1 >= 0) & (y0 <= 0) & (y1 >= 0)
    return inside | (qmin <= tau)


def bin_gaussians(
    means2d: torch.Tensor,
    depths: torch.Tensor,
    radii: torch.Tensor,
    width: int,
    height: int,
    ext_x: Optional[torch.Tensor] = None,
    ext_y: Optional[torch.Tensor] = None,
    conics: Optional[torch.Tensor] = None,
    opacities: Optional[torch.Tensor] = None,
    jitter_margin: float = 0.0,
) -> Binning:
    """Build the depth-sorted per-tile lists. Passing conics and opacities
    turns on the exact tile cull; pass jitter_margin=1.0 when the render
    uses sampling offsets."""
    n = means2d.shape[0]
    dev = means2d.device
    grid_x, grid_y = tile_grid(width, height)
    num_tiles = grid_x * grid_y

    iota = torch.arange(n, device=dev)
    inf = torch.full_like(depths, float("inf"))
    order = torch.argsort(torch.where(radii > 0, depths, inf), stable=True)
    rank_of = torch.empty_like(order)
    rank_of[order] = iota

    xmin, ymin, xmax, ymax = compute_rects(means2d, radii, grid_x, grid_y,
                                           ext_x=ext_x, ext_y=ext_y)
    rect_w = xmax - xmin
    touched = rect_w * (ymax - ymin)

    # One entry per (Gaussian, covered tile), row-major within the rect.
    g = torch.repeat_interleave(iota, touched)
    first = torch.cumsum(touched, 0) - touched
    r = torch.arange(g.shape[0], device=dev) - first[g]
    rw = rect_w[g]
    tx = xmin[g] + r % rw
    ty = ymin[g] + r // rw
    if conics is not None and opacities is not None:
        keep = _tile_cull_keep(tx, ty, g, means2d, conics, opacities,
                               jitter_margin)
        tx, ty, g = tx[keep], ty[keep], g[keep]

    key = (ty * grid_x + tx) * n + rank_of[g]
    sorted_key, sort_perm = torch.sort(key)
    rank = sorted_key % n
    needles = torch.arange(num_tiles + 1, device=dev) * n
    bounds = torch.searchsorted(sorted_key, needles).to(torch.int32)
    false = torch.zeros((), dtype=torch.bool, device=dev)
    return Binning(
        gauss_idx=order[rank],
        tile_of_dup=sorted_key // n,
        tile_start=bounds[:-1].contiguous(),
        tile_end=bounds[1:].contiguous(),
        num_duplicates=torch.tensor(sorted_key.shape[0], device=dev),
        overflow=false,
        overflow_emit=false,
        overflow_dup=false,
        overflow_rect=false,
        depth_order=order,
        rank=rank,
        rank_of=rank_of,
        sort_perm=sort_perm,
        presort_gauss=g,
    )
