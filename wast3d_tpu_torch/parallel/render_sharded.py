"""Tile-partitioned rendering of a scene sharded over the model axis.

Port of `wast3d_tpu/parallel/render_sharded.py`. Each rank of the model
axis holds a contiguous slice of the scene's rows and owns a contiguous
strip of the screen's tile rows (the tile grid padded to a multiple of the
axis, `padded_grid`):
  1. each rank preprocesses its own rows and bins them against the whole
     padded grid (`render_path.bin_and_pack`: binning and the sorted rows);
  2. each duplicate's row, tile and depth go to the owner of its tile with
     one `all_to_all`; the binning's list is tile-sorted and the strips are
     contiguous, so each destination's duplicates are one segment, and the
     counts are exchanged first, so no bucket has a capacity: nothing is
     dropped (`overflow_route` is always False, and
     `RasterizeSettings.route_capacity` is a no-op, like the other
     capacities);
  3. the owner sorts what it received by (tile, depth, arrival), which with
     contiguous row slices is the single-device order (tile, depth, row);
  4. it blends its strip with K1 (K1f under `fast_chain`), called as
     `render_path.render_sorted` calls them, on the strip as an image of its
     own, whose first image row (a multiple of 16) `blend` takes as
     `row0`: on the direct route the f32 means are shifted up by it; the
     bf16 tier's rows are recentred on each tile's origin
     (`render_path.fast_rows`) before the shift matters. Through the
     kernels it takes the quad route (K1q, K1fq) whenever `quad_power` is
     set, as JAX's strip path does; K1q recentres the unshifted f32 means
     on each tile's image origin, one rounding, as JAX's strip path
     subtracts the global tile origin (`parallel/render_sharded.py:169-173`).
The render comes back as this rank's strip; `render` / `depth` /
`final_T` of rank r are rows [r h, (r + 1) h) of the padded image.

Backward, by autograd: K2 on the strip gives the rows' gradients, the
reverse all_to_all returns them to their senders in the senders' sorted
order, and the sender's sorted gather sums them per Gaussian with K3 on
the binning route (`render_path._SortedGather`). Pixel jitter is not
threaded through the strip path, as in JAX.
"""

from __future__ import annotations

from typing import Optional

import torch

from wast3d_tpu_torch.ops.rasterizer import api as raster_api
from wast3d_tpu_torch.ops.rasterizer import blend as blend_mod
from wast3d_tpu_torch.ops.rasterizer import render_path
from wast3d_tpu_torch.ops.rasterizer.binning import TILE, tile_grid
from wast3d_tpu_torch.parallel import collectives as C
from wast3d_tpu_torch.parallel.mesh import axis_group, axis_index, axis_size


def padded_grid(width: int, height: int, num_shards: int):
    """The tile grid with grid_y padded to a multiple of num_shards, so that
    every shard owns an equal, contiguous strip of tile rows."""
    grid_x, grid_y = tile_grid(width, height)
    return grid_x, -(-grid_y // num_shards) * num_shards


def route_rows(rows: torch.Tensor, tile_of_dup: torch.Tensor, tiles_per_shard: int, group):
    """Send each sorted duplicate's row [K, C] and tile to the owner of its
    tile. Returns the received rows (on their autograd path) and their
    tiles, counted from the owner's first tile."""
    p = torch.distributed.get_world_size(group)
    dest = tile_of_dup // tiles_per_shard
    send = torch.bincount(dest, minlength=p).tolist()
    recv = C.exchange_counts(send, group)
    got_rows = C.all_to_all(rows, send, recv, group)
    got_tile = C.all_to_all(tile_of_dup - dest * tiles_per_shard, send, recv, group)
    return got_rows, got_tile


def render_tile_sharded(
    camera,
    scene,
    bg_color,
    mesh,
    settings: raster_api.RasterizeSettings = raster_api.RasterizeSettings(),
    means2d_offset: Optional[torch.Tensor] = None,
) -> dict:
    """Render this rank's rows of a model-sharded scene (on the rank's
    device) into this rank's strip of the image. Returns `api.render`'s
    dict with `render` [h, W, 3], `depth` and `final_T` [h, W] (the strip,
    h = height_pad / model), `radii` / `visibility_filter` of this rank's
    rows, the overflow flags (always False), `overflow_route` (always
    False) and `height_pad`, the padded image height. `means2d_offset`
    ([rows, 2] zeros) is the screen-space gradient tap, as in `api.render`."""
    if settings.renderer == "oracle":
        raise ValueError("the tile-sharded render has no oracle; use 'pallas' or 'tiled'")
    use_kernel = raster_api.use_kernels(settings.renderer)
    group = axis_group(mesh, "model")
    p, me = axis_size(mesh, "model"), axis_index(mesh, "model")
    dev = scene.device
    width, height = camera.width, camera.height
    grid_x, grid_y_pad = padded_grid(width, height, p)
    strip_h = grid_y_pad // p * TILE
    tiles_per_shard = grid_x * grid_y_pad // p
    camera = camera.to(dev)
    bg = torch.as_tensor(bg_color, dtype=torch.float32).to(dev).contiguous()

    # The padding widens the tile grid only: preprocess keeps the camera's height.
    prep = raster_api.preprocess_scene(camera, scene)
    if means2d_offset is not None:
        prep = prep._replace(means2d=prep.means2d + means2d_offset)
    binning, rows = render_path.bin_and_pack(
        prep, width, grid_y_pad * TILE, tile_cull=settings.tile_cull,
        grad_reduce=settings.grad_reduce, plain=not use_kernel)
    got, tile = route_rows(rows, binning.tile_of_dup, tiles_per_shard, group)

    # (tile, depth, arrival): two stable sorts, depth first.
    by_depth = torch.argsort(got[:, blend_mod.R_DEPTH].detach(), stable=True)
    order = by_depth[torch.argsort(tile[by_depth], stable=True)]
    inverse = torch.empty_like(order)
    inverse[order] = torch.arange(order.shape[0], device=dev)
    rows_sorted = render_path._Permute.apply(got, order, inverse)
    tile = tile[order]
    bounds = torch.searchsorted(tile, torch.arange(tiles_per_shard + 1, device=dev)).to(
        torch.int32)
    blend_rows = rows_sorted
    if settings.fast_chain:
        blend_rows = render_path.fast_rows(rows_sorted, tile + me * tiles_per_shard, width)
    # the quad route whenever quad_power is set (no jitter here), as JAX's
    # strip path takes it (`parallel/render_sharded.py:184-187`)
    out = blend_mod.blend(blend_rows, bounds[:-1].contiguous(), bounds[1:].contiguous(),
                          width, strip_h, bg, None, use_kernel, settings.fast_chain,
                          settings.quad_power, row0=me * strip_h)
    false = torch.zeros((), dtype=torch.bool, device=dev)
    return {
        "render": out.color,
        "depth": out.depth,
        "final_T": out.final_T,
        "radii": prep.radii,
        "visibility_filter": prep.radii > 0,
        "overflow": false,
        "overflow_emit": false,
        "overflow_rect": false,
        "overflow_route": false,
        "height_pad": grid_y_pad * TILE,
    }
