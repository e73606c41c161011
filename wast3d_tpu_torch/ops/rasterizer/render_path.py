"""Forward render path: binning -> sorted rows -> K1 -> image.

Port of `wast3d_tpu/ops/rasterizer/pallas_path.py::render_pallas` for the
exact f32 tier. Per-Gaussian rows are packed once, reordered by depth (one
N-row gather), then gathered by rank into the sorted duplicate rows (one
K-row gather) that K1 walks. K1 composites the background and writes the
image layout itself, so no untile pass follows.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from wast3d_tpu_torch.ops.rasterizer import blend as blend_mod
from wast3d_tpu_torch.ops.rasterizer.binning import Binning, bin_gaussians
from wast3d_tpu_torch.ops.rasterizer.preprocess import Preprocessed


class RenderOutput(NamedTuple):
    color: torch.Tensor  # [H,W,3]
    depth: torch.Tensor  # [H,W]
    final_T: torch.Tensor  # [H,W]
    binning: Binning


def sorted_rows(prep: Preprocessed, binning: Binning) -> torch.Tensor:
    """[K, 12] f32 rows in (tile, depth) order: mx, my, A, B, C, opa,
    depth, r, g, b, 0, 0."""
    zero = torch.zeros_like(prep.depths)
    packed = torch.stack(
        [prep.means2d[:, 0], prep.means2d[:, 1],
         prep.conics[:, 0], prep.conics[:, 1], prep.conics[:, 2],
         prep.opacities, prep.depths,
         prep.colors[:, 0], prep.colors[:, 1], prep.colors[:, 2], zero, zero],
        dim=1)  # [N, 12]
    return packed[binning.depth_order][binning.rank].contiguous()


def bin_and_pack(prep: Preprocessed, width: int, height: int,
                 jittered: bool = False, tile_cull: bool = True):
    """Binning and the sorted rows: (Binning, rows [K, 12])."""
    binning = bin_gaussians(
        prep.means2d, prep.depths, prep.radii, width, height,
        ext_x=prep.extent_x, ext_y=prep.extent_y,
        conics=prep.conics if tile_cull else None,
        opacities=prep.opacities if tile_cull else None,
        jitter_margin=1.0 if jittered else 0.0,
    )
    return binning, sorted_rows(prep, binning)


def render_sorted(
    prep: Preprocessed,
    width: int,
    height: int,
    bg_color: torch.Tensor,
    sampling_offsets: Optional[torch.Tensor] = None,
    tile_cull: bool = True,
    use_kernel: bool = True,
) -> RenderOutput:
    """Bin, gather and blend. `use_kernel=False` calls the plain version
    of K1 directly (renderer="torch")."""
    binning, rows = bin_and_pack(prep, width, height,
                                 sampling_offsets is not None, tile_cull)
    blend = blend_mod.blend_fwd if use_kernel else blend_mod.blend_fwd_reference
    out = blend(rows, binning.tile_start, binning.tile_end, width, height,
                bg_color, sampling_offsets)
    return RenderOutput(out.color, out.depth, out.final_T, binning)
