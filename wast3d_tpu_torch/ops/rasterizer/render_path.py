"""Render path: binning -> sorted rows -> K1 -> image, differentiable.

Port of `wast3d_tpu/ops/rasterizer/pallas_path.py::render_pallas`, in the
exact f32 tier (K1, K2) and the bf16 tier (`fast_chain`: K1f, K2f).
Per-Gaussian rows are packed once, reordered by depth (one N-row gather),
then gathered by rank into the sorted duplicate rows (one K-row gather)
that K1 walks. In the bf16 tier those rows are recentred on the owning
tile's pixel origin in f32 and then rounded to bf16 (`fast_rows`, JAX
`pallas_path.py:205-229`): rounding first would cost up to 2 pixels at
x ~ 800, where bf16's spacing is 4. K1 composites the background and writes
the image layout itself, so no untile pass follows.

Without jitter, a render through the kernels evaluates power on the quad
route (K1q, K1fq; `blend.py`) when `quad_power` is set, as JAX's does; the
backward is the tier's.

Gradients (JAX `_sorted_gather`, `pallas_path.py:24-97`): the blend's
backward is K2 (`blend.blend`); the K-row gather's backward is the
per-Gaussian reduction of `grad_reduce` (K3 by default) on the binning
route (each Gaussian's duplicates as the binning listed them, no sort of
the ranks), never autograd's `index_put_(accumulate=True)`, which would use
float atomics on CUDA; the depth reorder is a permutation, so its backward
is the exact inverse gather through `rank_of`. In the bf16 tier the
rounding's backward makes the per-duplicate gradients bf16 values, as JAX's
VJP does (`pallas_blend.py:934-937`); K3 and the gathers take them as they
are.

`pack_gather` (the bf16 tier only, forward only) builds the bf16 rows with
Kg (`pack_gather.py`) from 24-byte split-bf16 rows gathered by rank, with
JAX's roundings (`pallas_path.py:150-190`), in place of the f32 gather and
`fast_rows`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from wast3d_tpu_torch.ops.rasterizer import blend as blend_mod
from wast3d_tpu_torch.ops.rasterizer import grad_reduce as reduce_mod
from wast3d_tpu_torch.ops.rasterizer import pack_gather as pack_mod
from wast3d_tpu_torch.ops.rasterizer.binning import TILE, Binning, bin_gaussians, tile_grid
from wast3d_tpu_torch.ops.rasterizer.preprocess import Preprocessed


class RenderOutput(NamedTuple):
    color: torch.Tensor  # [H,W,3]
    depth: torch.Tensor  # [H,W]
    final_T: torch.Tensor  # [H,W]
    binning: Binning


GRAD_COLS = 10  # rows' columns with a gradient (the last two are padding)


class _Permute(torch.autograd.Function):
    """x[order] for a permutation `order` whose inverse is `inverse`; the
    backward is the exact gather grad[inverse]."""

    @staticmethod
    def forward(ctx, x, order, inverse):
        ctx.save_for_backward(inverse)
        return x[order]

    @staticmethod
    def backward(ctx, grad):
        (inverse,) = ctx.saved_tensors
        return grad[inverse], None, None


class _SortedGather(torch.autograd.Function):
    """source[binning.rank], the K-row gather; the backward sums the
    duplicate rows of each source row with `grad_reduce` on the binning
    route (module docstring), or with `index_add_` for "scatter". K3 finds
    the segments' bounds and inverts the tile sort itself, so a render
    without a backward never pays for them."""

    @staticmethod
    def forward(ctx, source, binning, grad_reduce, plain):
        ctx.save_for_backward(binning.rank, binning.sort_perm, binning.presort_gauss,
                              binning.depth_order)
        ctx.n1, ctx.grad_reduce, ctx.plain = source.shape[0], grad_reduce, plain
        return source[binning.rank]

    @staticmethod
    def backward(ctx, d_sorted):
        rank, sort_perm, presort_gauss, depth_order = ctx.saved_tensors
        if ctx.grad_reduce == "scatter":
            d = reduce_mod.scatter_add(d_sorted[:, :GRAD_COLS], rank, ctx.n1)
        else:
            segments = reduce_mod.binning_segments(sort_perm, presort_gauss, depth_order)
            d = reduce_mod.reduce_segments(d_sorted[:, :GRAD_COLS], segments,
                                           ctx.grad_reduce, plain=ctx.plain)
        pad = d_sorted.shape[1] - GRAD_COLS
        return torch.nn.functional.pad(d, (0, pad)), None, None, None


def sorted_rows(prep: Preprocessed, binning: Binning,
                grad_reduce: str = reduce_mod.DEFAULT,
                plain: bool = False) -> torch.Tensor:
    """[K, 12] f32 rows in (tile, depth) order: mx, my, A, B, C, opa,
    depth, r, g, b, 0, 0. Differentiable (module docstring); `plain` makes
    the gather's backward use K3's plain version."""
    zero = torch.zeros_like(prep.depths)
    packed = torch.stack(
        [prep.means2d[:, 0], prep.means2d[:, 1],
         prep.conics[:, 0], prep.conics[:, 1], prep.conics[:, 2],
         prep.opacities, prep.depths,
         prep.colors[:, 0], prep.colors[:, 1], prep.colors[:, 2], zero, zero],
        dim=1)  # [N, 12]
    source = _Permute.apply(packed, binning.depth_order, binning.rank_of)
    return _SortedGather.apply(source, binning, grad_reduce, plain)


def fast_rows(rows: torch.Tensor, tile_of_dup: torch.Tensor, width: int) -> torch.Tensor:
    """The bf16 tier's rows (`blend.py`): [K, 12] f32 rows in image
    coordinates, each of the tile `tile_of_dup` of a `width`-pixel-wide
    grid, to [K, 16] bf16 with the means recentred on the tile's pixel
    origin in f32 before the rounding, and six zero columns. Differentiable:
    the gradient that comes back is rounded to bf16 values."""
    grid_x = tile_grid(width, 1)[0]
    origin = torch.stack([tile_of_dup % grid_x, tile_of_dup // grid_x], dim=1) * TILE
    local = torch.cat([rows[:, :2] - origin.to(rows.dtype), rows[:, 2:10]], dim=1)
    return torch.nn.functional.pad(local.to(torch.bfloat16), (0, blend_mod.ROW_FAST - 10))


def packed_rows(prep: Preprocessed, binning: Binning, width: int,
                plain: bool = False) -> torch.Tensor:
    """The bf16 tier's [K, 16] rows through Kg (`pack_gather.py`), or its
    plain version with `plain`. Forward only: raises if autograd would have
    to differentiate it."""
    fields = (prep.means2d, prep.conics, prep.opacities, prep.depths, prep.colors)
    if torch.is_grad_enabled() and any(t.requires_grad for t in fields):
        raise ValueError("pack_gather is forward only (serving): render under "
                         "torch.no_grad() or with inputs that need no gradient")
    fn = pack_mod.pack_gather_reference if plain else pack_mod.pack_gather
    return fn(*fields, binning.depth_order, binning.rank, binning.tile_of_dup, width)


def bin_and_pack(prep: Preprocessed, width: int, height: int,
                 jittered: bool = False, tile_cull: bool = True,
                 grad_reduce: str = reduce_mod.DEFAULT, plain: bool = False,
                 fast: bool = False, pack_gather: bool = False):
    """Binning and the sorted rows: (Binning, rows [K, 12] f32, or with
    `fast` the bf16 tier's [K, 16] bf16 rows, through Kg with
    `pack_gather`)."""
    if pack_gather and not fast:
        raise ValueError("pack_gather requires fast_chain (bf16 tier)")
    binning = bin_gaussians(
        prep.means2d, prep.depths, prep.radii, width, height,
        ext_x=prep.extent_x, ext_y=prep.extent_y,
        conics=prep.conics if tile_cull else None,
        opacities=prep.opacities if tile_cull else None,
        jitter_margin=1.0 if jittered else 0.0,
    )
    if pack_gather:
        return binning, packed_rows(prep, binning, width, plain)
    rows = sorted_rows(prep, binning, grad_reduce, plain)
    if fast:
        rows = fast_rows(rows, binning.tile_of_dup, width)
    return binning, rows


def render_sorted(
    prep: Preprocessed,
    width: int,
    height: int,
    bg_color: torch.Tensor,
    sampling_offsets: Optional[torch.Tensor] = None,
    tile_cull: bool = True,
    use_kernel: bool = True,
    grad_reduce: str = reduce_mod.DEFAULT,
    fast_chain: bool = False,
    pack_gather: bool = False,
    quad_power: bool = False,
) -> RenderOutput:
    """Bin, gather and blend. `use_kernel=False` calls the plain versions
    of K1, K2, K3 and Kg directly (renderer="torch"); `fast_chain` blends in
    the bf16 tier, on rows from Kg with `pack_gather`. `quad_power` takes the
    quad route's forward (K1q, K1fq) where JAX takes it
    (`pallas_path.py:254-259`): through the kernels and without jitter."""
    binning, rows = bin_and_pack(prep, width, height,
                                 sampling_offsets is not None, tile_cull,
                                 grad_reduce, plain=not use_kernel, fast=fast_chain,
                                 pack_gather=pack_gather)
    out = blend_mod.blend(rows, binning.tile_start, binning.tile_end, width,
                          height, bg_color, sampling_offsets, use_kernel, fast_chain, quad_power)
    return RenderOutput(out.color, out.depth, out.final_T, binning)
