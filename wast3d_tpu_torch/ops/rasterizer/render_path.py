"""Render path: binning -> sorted rows -> K1 -> image, differentiable.

Port of `wast3d_tpu/ops/rasterizer/pallas_path.py::render_pallas` for the
exact f32 tier. Per-Gaussian rows are packed once, reordered by depth (one
N-row gather), then gathered by rank into the sorted duplicate rows (one
K-row gather) that K1 walks. K1 composites the background and writes the
image layout itself, so no untile pass follows.

Gradients (JAX `_sorted_gather`, `pallas_path.py:24-97`): the blend's
backward is K2 (`blend.blend`); the K-row gather's backward is the
per-Gaussian reduction of `grad_reduce` (K3 by default), never autograd's
`index_put_(accumulate=True)`, which would use float atomics on CUDA; the
depth reorder is a permutation, so its backward is the exact inverse
gather through `rank_of`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from wast3d_tpu_torch.ops.rasterizer import blend as blend_mod
from wast3d_tpu_torch.ops.rasterizer import grad_reduce as reduce_mod
from wast3d_tpu_torch.ops.rasterizer.binning import Binning, bin_gaussians
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
    """source[rank], the K-row gather; the backward sums the duplicate rows
    of each source row with `grad_reduce` (module docstring)."""

    @staticmethod
    def forward(ctx, source, rank, grad_reduce, plain):
        ctx.save_for_backward(rank)
        ctx.n1, ctx.grad_reduce, ctx.plain = source.shape[0], grad_reduce, plain
        return source[rank]

    @staticmethod
    def backward(ctx, d_sorted):
        (rank,) = ctx.saved_tensors
        d = reduce_mod.reduce(d_sorted[:, :GRAD_COLS], rank, ctx.n1,
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
    return _SortedGather.apply(source, binning.rank, grad_reduce, plain)


def bin_and_pack(prep: Preprocessed, width: int, height: int,
                 jittered: bool = False, tile_cull: bool = True,
                 grad_reduce: str = reduce_mod.DEFAULT, plain: bool = False):
    """Binning and the sorted rows: (Binning, rows [K, 12])."""
    binning = bin_gaussians(
        prep.means2d, prep.depths, prep.radii, width, height,
        ext_x=prep.extent_x, ext_y=prep.extent_y,
        conics=prep.conics if tile_cull else None,
        opacities=prep.opacities if tile_cull else None,
        jitter_margin=1.0 if jittered else 0.0,
    )
    return binning, sorted_rows(prep, binning, grad_reduce, plain)


def render_sorted(
    prep: Preprocessed,
    width: int,
    height: int,
    bg_color: torch.Tensor,
    sampling_offsets: Optional[torch.Tensor] = None,
    tile_cull: bool = True,
    use_kernel: bool = True,
    grad_reduce: str = reduce_mod.DEFAULT,
) -> RenderOutput:
    """Bin, gather and blend. `use_kernel=False` calls the plain versions
    of K1, K2 and K3 directly (renderer="torch")."""
    binning, rows = bin_and_pack(prep, width, height,
                                 sampling_offsets is not None, tile_cull,
                                 grad_reduce, plain=not use_kernel)
    out = blend_mod.blend(rows, binning.tile_start, binning.tile_end, width,
                          height, bg_color, sampling_offsets, use_kernel)
    return RenderOutput(out.color, out.depth, out.final_T, binning)
