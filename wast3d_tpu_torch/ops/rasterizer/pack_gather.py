"""Kg, the bf16 tier's serving gather (`RasterizeSettings.pack_gather`):
the CUDA kernel's wrapper and its plain version.

Port of the `pack_gather` branch of
`wast3d_tpu/ops/rasterizer/pallas_path.py::render_pallas` (:150-190), which
is XLA in the JAX package, not a `pallas_call`. It gives the rows that K1f
reads ([K, 16] bf16, `render_path.fast_rows`'s layout) from 24 bytes a
duplicate, and with JAX's roundings, which differ from `fast_rows` by one
bf16 step on a share of the means:

  pack, per Gaussian in depth order: hi = bf(m), lo = bf(m - f32(hi)) for
    each mean coordinate m, the eight other fields rounded to bf16 (12 bf16,
    24 bytes), and a zero sentinel row after the N rows;
  gather, per duplicate k: the packed row of `binning.rank[k]`, the means
    recentred on the tile of `binning.tile_of_dup[k]` as
    bf((f32(hi) - ox) + f32(lo)), in that order; where `fast_rows` rounds
    m - ox once, this rounds m to hi + lo first.

bf rounds to bfloat16 to nearest, ties to even. `pack_gather` launches the
kernel (`csrc/pack_gather.cu`: a pack over N, then a gather over K; one
count in `pack_gather.launches` a call) on CUDA tensors and takes
`pack_gather_reference` on CPU tensors; nothing falls back from one to the
other. Forward only: JAX's bitcast is not differentiable, and
`render_path.bin_and_pack` raises under autograd.
"""

from __future__ import annotations

import torch

from wast3d_tpu_torch.ops.rasterizer.binning import TILE, tile_grid
from wast3d_tpu_torch.ops.rasterizer.blend import ROW_FAST

PACKED = 12  # bf16 elements of a packed row (24 bytes)


def _check(means2d, conics, opacities, depths, colors, depth_order, rank, tile_of_dup):
    n = means2d.shape[0]
    dev = means2d.device
    want = [("means2d", means2d, torch.float32, (n, 2)),
            ("conics", conics, torch.float32, (n, 3)),
            ("opacities", opacities, torch.float32, (n,)),
            ("depths", depths, torch.float32, (n,)),
            ("colors", colors, torch.float32, (n, 3)),
            ("depth_order", depth_order, torch.int64, (n,)),
            ("rank", rank, torch.int64, None),
            ("tile_of_dup", tile_of_dup, torch.int64, tuple(rank.shape))]
    for name, t, dtype, shape in want:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, means2d on {dev}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if rank.dim() != 1:
        raise ValueError(f"rank must be [K], got {tuple(rank.shape)}")


def pack_gather(means2d: torch.Tensor, conics: torch.Tensor, opacities: torch.Tensor,
                depths: torch.Tensor, colors: torch.Tensor, depth_order: torch.Tensor,
                rank: torch.Tensor, tile_of_dup: torch.Tensor, width: int) -> torch.Tensor:
    """Kg: [K, 16] bf16 rows (module docstring) from the preprocessed fields
    ([N, 2], [N, 3], [N], [N], [N, 3] float32), the depth order [N] and,
    per duplicate, its rank and tile ([K] int64) on a `width`-pixel-wide
    grid. CUDA tensors launch the kernel; CPU tensors take
    `pack_gather_reference`."""
    _check(means2d, conics, opacities, depths, colors, depth_order, rank, tile_of_dup)
    dev = means2d.device
    if dev.type == "cpu":
        return pack_gather_reference(means2d, conics, opacities, depths, colors, depth_order,
                                     rank, tile_of_dup, width)
    if dev.type != "cuda":
        raise ValueError(f"pack_gather runs on cuda or cpu, not {dev}")
    from wast3d_tpu_torch import _build

    lib = _build.load_library()
    n, k = means2d.shape[0], rank.shape[0]
    fields = [t.contiguous() for t in (means2d, conics, opacities, depths, colors, depth_order)]
    if fields[0].data_ptr() % 8:  # the kernel reads each mean as one 8-byte float2
        fields[0] = fields[0].clone()
    packed = torch.empty((n + 1, PACKED // 2), dtype=torch.int32, device=dev)
    rows = torch.empty((k, ROW_FAST), dtype=torch.bfloat16, device=dev)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.w3d_pack_rows(*(t.data_ptr() for t in fields), packed.data_ptr(), n, index,
                            stream)
    if err == 0:
        err = lib.w3d_gather_rows(packed.data_ptr(), rank.contiguous().data_ptr(),
                                  tile_of_dup.contiguous().data_ptr(), rows.data_ptr(), k,
                                  tile_grid(width, 1)[0], index, stream)
    if err != 0:
        raise RuntimeError(f"pack_gather kernel launch failed: CUDA error {err} "
                           f"({lib.w3d_error_string(err).decode()})")
    pack_gather.launches += 1
    return rows


pack_gather.launches = 0


def pack_rows_reference(means2d, conics, opacities, depths, colors, depth_order):
    """The pack: [N + 1, 12] bf16, Gaussians in depth order, then the zero
    sentinel row."""
    mx, my = means2d[:, 0], means2d[:, 1]
    hx, hy = mx.to(torch.bfloat16), my.to(torch.bfloat16)
    lx = (mx - hx.to(torch.float32)).to(torch.bfloat16)
    ly = (my - hy.to(torch.float32)).to(torch.bfloat16)
    rest = torch.stack([conics[:, 0], conics[:, 1], conics[:, 2], opacities, depths,
                        colors[:, 0], colors[:, 1], colors[:, 2]], dim=1).to(torch.bfloat16)
    cols = torch.cat([torch.stack([hx, lx, hy, ly], dim=1), rest], dim=1)[depth_order]
    return torch.cat([cols, cols.new_zeros((1, PACKED))])


def pack_gather_reference(means2d, conics, opacities, depths, colors, depth_order, rank,
                          tile_of_dup, width):
    """Plain PyTorch version of Kg, with its roundings in its order; runs
    on any device."""
    src = pack_rows_reference(means2d, conics, opacities, depths, colors, depth_order)[rank]
    grid_x = tile_grid(width, 1)[0]
    ox = ((tile_of_dup % grid_x) * TILE).to(torch.float32)
    oy = ((tile_of_dup // grid_x) * TILE).to(torch.float32)
    f = src.to(torch.float32)
    mx = ((f[:, 0] - ox) + f[:, 1]).to(torch.bfloat16)
    my = ((f[:, 2] - oy) + f[:, 3]).to(torch.bfloat16)
    rows = torch.cat([mx[:, None], my[:, None], src[:, 4:]], dim=1)
    return torch.nn.functional.pad(rows, (0, ROW_FAST - rows.shape[1]))
