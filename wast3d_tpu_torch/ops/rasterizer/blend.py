"""K1 and K2, the per-tile alpha blend forward and backward: CUDA kernel
wrappers, their plain versions, and the autograd function around them.

`blend_fwd` (K1) and `blend_bwd` (K2) replace
`wast3d_tpu/ops/rasterizer/pallas_blend.py::blend` and its VJP (exact f32
tier). For a CUDA tensor each launches its hand-written kernel
(`csrc/blend_fwd.cu`, `csrc/blend_bwd.cu`) or raises; for a CPU tensor it
runs its plain PyTorch version (`blend_fwd_reference`,
`blend_bwd_reference`). Nothing falls back from one to the other. `blend`
is the differentiable op: K1 forward, K2 backward (or both plain versions).

Inputs (one layout for both; the bf16 tier's rows below):
  rows    [K, 12] f32, the sorted duplicates: mx, my, A, B, C, opa, depth,
          r, g, b, pad, pad; means in image pixel coordinates.
  starts, ends  [T] int32, each tile's range [start, end) into `rows`;
          tiles are row-major over the ceil(W/16) x ceil(H/16) grid.
  bg      [3] f32 background colour.
  offsets [H, W, 2] f32 per-pixel sample offsets (jitter), or None.
Outputs, in image layout with the background composited:
  color [H, W, 3], depth [H, W] (sum of depth * alpha * T), final_T [H, W].

Per pixel, entries are taken front to back: alpha = min(0.99,
opa * exp(power)) with power = -1/2 (A dx^2 + C dy^2) - B dx dy; an entry is
skipped if power > 0 or alpha < 1/255; the walk stops *before* the entry
that would take T below 1e-4.

The backward takes the cotangents of colour, depth and final_T and returns
the gradient of `rows` [K, 12] (columns 10 and 11 zero). It recomputes alpha
and T front to back and uses the TPU kernel's identity
    dL/dalpha_i = q_i T_i - (S_total - prefix_i(q w)) / (1 - alpha_i)
with q = dcolor . rgb + ddepth * depth, w = alpha T, the inclusive prefix in
walk order, and S_total = dcolor . acc + ddepth * depth + T_final * dT_eff,
where acc = colour - T_final bg and dT_eff = dfinal_T + dcolor . bg undo the
background composite that K1 does itself. The alpha clamp at 0.99, skipped
entries and entries at or after the stop get no alpha gradient.

The bf16 tier (`fast_chain`, JAX's serving default): `blend_fwd_fast` (K1f)
and `blend_bwd_fast` (K2f) replace the `fast=True` bodies of the same two TPU
kernels, with the plain versions `blend_fwd_fast_reference` and
`blend_bwd_fast_reference`. They read JAX's bf16 rows
(`pallas_path.py:205-229`):
  rows    [K, 16] bfloat16: mx, my, A, B, C, opa, depth, r, g, b, six zeros
          (32 bytes), the means recentred on the owning tile's pixel origin
          in f32 before the rounding (`render_path.fast_rows`);
and sample each pixel at its tile-local position (x - tile x, y - tile y,
plus jitter, in f32). Per (pixel, entry), in this order, with bf(x) x rounded
to bfloat16 (to nearest, ties to even) and E, L the tables below:
  power   JAX's bf16 chain (`_chunk_quantities_fast`,
          `pallas_blend.py:301-310`), each operation evaluated as XLA
          evaluates a bf16 operation, the f32 operation and then bf():
          dx = bf(mx - bf(px)), dy = bf(my - bf(py)), Ah = bf(-A/2),
          Ch = bf(-C/2), Bn = -B, then power = bf(bf(bf(bf(Ah dx) dx) +
          bf(bf(Ch dy) dy)) + bf(bf(Bn dx) dy)) (`_fast_power`; the quad
          route below computes power in f32 another way and then rounds it
          once, bf(power));
  alpha = min(bf(0.99), bf(opa E[bf(power)])), bf(0.99) = 0.98828125;
          skipped where power > 0 or alpha < 1/255 (f32 compares);
  s     = L[alpha];
  T     = E[bf(logT)], logT the f32 running sum of s over the entries taken
          so far, added in walk order;
  the pixel stops before the entry where bf(T bf(1 - alpha)) < 1e-4;
  w     = bf(alpha T); colour and depth add w rgb, w depth in f32, one entry
          at a time (each product is exact in f32).
final_T = exp(logT) in f32, and colour + final_T bg. Every product of two
bf16 values is exact in f32, so one rounding of it is what a bf16 multiply
does; the kernels round at these points with bf16x2 instructions and the
plain versions with `.to(torch.bfloat16)`.
  E[x] = bf(exp(x)) for bf16 x <= 0: 1 for |x| < 2^-9 (where exp rounds to
         1), a table for 2^-9 <= |x| < 16, and 0 beyond (|x| >= 16, inf,
         NaN: exp(-16) < 1.2e-7, so the entry is skipped, or the pixel stops,
         as with exp itself).
  L[a] = bf(log1p(-a)) for every bf16 alpha in [1/255, 0.98828125].
`fast_tables` builds both once, in f32 with `torch.exp` / `torch.log1p`, and
the kernels and the plain versions read the same tensor, so their
transcendentals agree bit for bit. The backward recomputes alpha and T
exactly so (its stops are the forward's), takes the moments of dL/dpower on
f32 dx = mx - px and dy = my - py, as JAX's backward does
(`pallas_blend.py:714-715`), and takes q = dcolour . rgb +
ddepth depth with every product and sum rounded (r, g, b, depth order; the
cotangents rounded first), q w = bf(q w) and its prefix as an f32 running
sum, q T = bf(q T); the division, dL/dpower, the moment sums and every
accumulator stay f32, and the row gradient is rounded to bf16 into [K, 16]
(JAX rounds it to its rows' dtype, `pallas_blend.py:934-937`). The clamp
test is JAX's in both tiers, alpha < 0.99 in f32, which the bf16 clamp
0.98828125 always passes: in this tier an alpha at the clamp keeps its power
and opacity gradient, as in JAX's fast backward (ROADMAP queue 3).

The quad route (JAX's `quad_power`, `pallas_blend.py:172-226`, `:341-388`),
taken in both tiers by jitter-off renders through the kernels:
`blend_fwd_quad` (K1q) and `blend_fwd_fast_quad` (K1fq), with the plain
versions `blend_fwd_reference(..., quad=True)` and
`blend_fwd_fast_reference(..., quad=True)`, evaluate power as JAX's matrix
unit does, from each pixel's monomials m = (px^2, py^2, px py, px, py, 1) at
tile-local integer coordinates (exact: px, py < 16) and each entry's
coefficients, from the mean recentred on the tile's pixel origin (the f32
tier's rows are in image coordinates: mx - tile x and my - tile y in f32, one
rounding each, as JAX packs them, the tile's y taken in the image, where a
tile-sharded strip's frame starts at image row `row0`), each operation
rounded:
  c = (Ah, Ch, Bn, (-2 Ah) mx - Bn my, (-2 Ch) my - Bn mx,
       ((Ah mx) mx + (Ch my) my) + (Bn mx) my);
each coefficient is split into bf16 parts, hi = bf(c), mid = bf(c - hi),
lo = bf((c - hi) - mid) in the f32 tier and hi, lo = bf(c - hi) in the bf16
tier (`_split2`, `pallas_blend.py:102-105`); each part's sum is taken in the
order of m, d = ((((c0 m0 + c1 m1) + c2 m2) + c3 m3) + c4 m4) + c5, where
every product is exact in f32 (bf16 times an integer below 256), so a chain
of FMAs gives the same bits; power = (d_hi + d_mid) + d_lo (d_hi + d_lo),
JAX's own grouping, then JAX's clamp, power = min(power, 0) + max(power - eps, 0), eps = 1e-3
(0.05) in f32, NaN kept. An entry is skipped where this power > 0, so one
whose power lies in (0, eps] is taken at alpha = opa. Past power the bf16
tier is the one above; the f32 tier is the direct one with NaN kept by the
clamp at 0.99 and every operation rounded: T and colour are carried one
entry at a time in walk order (T <- T (1 - alpha), colour += w rgb). The
backward recomputes the direct form in both tiers, on the
outputs of the quad forward, as JAX's does (`pallas_blend.py:891-895`).

K1q and K1fq sum the parts' products on the tensor cores (`mma.sync`, bf16
in, f32 accumulation: K1q hi|mid in one m16n8k16 and lo in one m16n8k8 onto
that sum, K1fq hi|lo in one m16n8k16), as JAX's matrix unit sums them, in
the hardware's order and rounding, so they are not bit-equal to the plain
versions. The error model of that sum, from Fasi, Higham, Mikaitis and
Pranesh ("Numerical behavior of NVIDIA tensor cores", PeerJ Computer
Science 7:e330, 2021), taken conservatively for Hopper: products of bf16
values are exact; the products and the accumulator C are added in blocks,
their significands aligned to the block's largest exponent and truncated,
and the block's sum truncated to f32; the paper found blocks of 4 (V100,
T4) and 8 (A100), Hopper's are not published, so take blocks of one
product, each costing at most two units of 2^-23 of the magnitudes summed:
an MMA of depth K lands within 2 K 2^-23 (|C| + sum |a_i b_i|) of its exact
sum (`MMA_UNIT`, `QUAD_MMA_DEPTHS`). Against the exact power P on the
tile-local mean, with S = `quad_term_bound`, the kernels' power is within
105 u S (K1q) and 1.28 2^-16 S (K1fq), u = 2^-24 (`QUAD_POWER_ERR`: the
coefficients' roundings, the split's remainder and the MMA, derived beside
`cull_prelude` in csrc/blend_fwd.cu), and within `quad_mma_bound` of the
plain version's power; the quad cull's margin (`QUAD_MARGIN`) is over twice
what that moves Q = -2 power.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch.autograd.function import once_differentiable

from wast3d_tpu_torch.ops.rasterizer.binning import TILE, tile_grid

ROW = 12
R_MX, R_MY, R_A, R_B, R_C, R_OPA, R_DEPTH, R_R, R_G, R_B2 = range(10)
ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
T_EPS = 1e-4
PIXELS = TILE * TILE
CHUNK = 32  # entry slots per step of the plain version
WARP = 32
WARPS = PIXELS // WARP  # K1's warps per tile
WARP_W, WARP_H = 8, 4  # each warp's pixels
# [WARPS, WARP]: the tile pixel (row-major, 16 y + x) of each of K1's
# threads; warp w holds the 8 x 4 pixels at (8 (w % 2), 4 (w // 2)).
WARP_PIXELS = torch.stack([
    (WARP_H * (w // 2) + torch.arange(WARP) // WARP_W) * TILE
    + WARP_W * (w % 2) + torch.arange(WARP) % WARP_W for w in range(WARPS)])
# K1's cull constants (csrc/blend_fwd.cu), as float32 values.
U = 2.0 ** -24  # the unit roundoff of f32
OPA_CULL = float(torch.tensor(1.0 / 255.0, dtype=torch.float32)
                 * torch.tensor(1.0 - 64.0 * U, dtype=torch.float32))
CONIC_MIN = float(torch.tensor(1e-30, dtype=torch.float32))
TERM_MAX = float(torch.tensor(1e30, dtype=torch.float32))
# The bf16 tier: its rows, its clamp, and K1f's cull, whose margins cover the
# bf16 roundings of exp and the product with opacity (on tau), of the samples
# (the box widened by FAST_BOX of its largest coordinate) and of power's chain
# (FAST_TERM of the box's largest term sum); derived beside `cull_prelude` in
# csrc/blend_fwd.cu.
ROW_FAST = 16
ALPHA_MAX_BF16 = float(torch.tensor(ALPHA_MAX).to(torch.bfloat16))  # 0.98828125
TAU_FAST, TAU_FAST_REL = 2.0 ** -5, 2.0 ** -7
FAST_BOX, FAST_TERM = 2.0 ** -8, 2.0 ** -4
# The tables (module docstring), one bf16 tensor: E at [0, EXP_SIZE), L at
# [EXP_SIZE, TABLE_USED), zeros to TABLE_SIZE (a whole number of 16-byte
# words). A bf16 value's bits: EXP_LO of 2^-9, EXP_HI of 16, LOG_LO of the
# least bf16 >= 1/255, LOG_HI one past 0.98828125's. E[x] is
# table[clamp((bits(x) & 0x7fff) - EXP_LO + 1, 0, EXP_SIZE - 1)], L[a] is
# table[EXP_SIZE + bits(a) - LOG_LO].
EXP_LO, EXP_HI = 0x3B00, 0x4180
LOG_LO, LOG_HI = 0x3B81, 0x3F7E
EXP_SIZE = EXP_HI - EXP_LO + 2  # 1 below the range, 0 above it
TABLE_USED = EXP_SIZE + LOG_HI - LOG_LO
TABLE_SIZE = -(-TABLE_USED // 8) * 8
# The quad route (module docstring), by tier (fast): bf16 parts of each
# coefficient, JAX's skip allowance eps as a float32 value, the depths of the
# MMAs that sum the parts' products on the tensor cores and their error per
# unit of depth (two units of 2^-23), the kernels' error in power per unit of
# `quad_term_bound`, and the quad cull's margin on Q per unit of it (derived
# beside `cull_prelude` in csrc/blend_fwd.cu).
QUAD_PARTS = {False: 3, True: 2}
QUAD_EPS = {False: float(torch.tensor(1e-3, dtype=torch.float32)),
            True: float(torch.tensor(0.05, dtype=torch.float32))}
QUAD_MMA_DEPTHS = {False: (16, 8), True: (16,)}
MMA_UNIT = 2.0 * 2.0 ** -23
QUAD_POWER_ERR = {False: 105.0 * U, True: 1.28 * 2.0 ** -16}
QUAD_MARGIN = {False: 2.0 ** -15, True: 2.0 ** -13}
QUAD_SPAN = TILE - 1  # the largest tile-local pixel coordinate


def _from_bits(bits: torch.Tensor) -> torch.Tensor:
    """Non-negative bf16 values from their bit patterns (below 0x8000)."""
    return bits.to(torch.int16).view(torch.bfloat16)


def _bits(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns of bf16 values."""
    return x.view(torch.int16).to(torch.int32) & 0xFFFF


_TABLES = {}


def fast_tables(device=None) -> torch.Tensor:
    """[TABLE_SIZE] bfloat16: the tables E and L (module docstring), built in
    f32 on the CPU and kept once per device; the kernels and the plain
    versions read the same tensor."""
    dev = torch.device("cpu" if device is None else device)
    if dev not in _TABLES:
        x = -_from_bits(torch.arange(EXP_LO, EXP_HI)).to(torch.float32)
        a = _from_bits(torch.arange(LOG_LO, LOG_HI)).to(torch.float32)
        _TABLES[dev] = torch.cat([
            torch.ones(1), torch.exp(x), torch.zeros(1), torch.log1p(-a),
            torch.zeros(TABLE_SIZE - TABLE_USED)]).to(torch.bfloat16).to(dev)
    return _TABLES[dev]


def exp_table(x: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """E[x] as f32 for bf16 x (any sign; the tier meets x <= 0)."""
    idx = ((_bits(x) & 0x7FFF) - (EXP_LO - 1)).clamp(0, EXP_SIZE - 1)
    return tables[idx.long()].to(torch.float32)


def log1m_table(alpha: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """L[alpha] as f32 for bf16 alpha in [1/255, 0.98828125]; values
    outside that range give the nearest end's entry."""
    idx = (_bits(alpha) - LOG_LO).clamp(0, LOG_HI - LOG_LO - 1) + EXP_SIZE
    return tables[idx.long()].to(torch.float32)


class BlendOutput(NamedTuple):
    color: torch.Tensor  # [H, W, 3]
    depth: torch.Tensor  # [H, W]
    final_T: torch.Tensor  # [H, W]


def _check_inputs(rows, starts, ends, width, height, bg, offsets, plain=False, fast=False,
                  quad=False, row0=0):
    """Validate the kernels' inputs: [K, 12] f32 rows, or [K, 16] bf16 rows
    in the bf16 tier (`fast`). The plain f32 versions (`plain=True`) also
    take float64 rows, bg and offsets, for finite-difference checks. The
    quad route (`quad`) samples integer pixel positions: no offsets. `row0`,
    the f32 quad route's first image row, is a non-negative multiple of 16."""
    if quad and offsets is not None:
        raise ValueError("the quad route samples integer pixel positions: offsets must be None")
    if row0 and (fast or not quad or row0 < 0 or row0 % TILE):
        raise ValueError(f"row0 {row0}: the f32 quad route's first image row, a "
                         f"non-negative multiple of {TILE}")
    dev = rows.device
    grid_x, grid_y = tile_grid(width, height)
    num_tiles = grid_x * grid_y
    real = (torch.float32, torch.float64) if plain and not fast else (torch.float32,)
    row_types, row_width = ((torch.bfloat16,), ROW_FAST) if fast else (real, ROW)
    want = [
        ("rows", rows, row_types, None),
        ("starts", starts, (torch.int32,), (num_tiles,)),
        ("ends", ends, (torch.int32,), (num_tiles,)),
        ("bg", bg, real, (3,)),
    ]
    if offsets is not None:
        want.append(("offsets", offsets, real, (height, width, 2)))
    if rows.dim() != 2 or rows.shape[1] != row_width:
        raise ValueError(f"rows must be [K, {row_width}], got {tuple(rows.shape)}")
    for name, t, dtypes, shape in want:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, rows on {dev}")
        if t.dtype not in dtypes:
            raise ValueError(f"{name} must be {' or '.join(map(str, dtypes))}, "
                             f"got {t.dtype}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return num_tiles


def _kernel_call(entry, rows, starts, ends, offsets, bg, fast, outs, width, height,
                 num_tiles, extra=()):
    """Call the C entry `entry` of K1, K1f, K2 or K2f (or their quad
    forwards) on CUDA tensors: the inputs, the bf16 tier's tables, the
    tensors `outs`, then the sizes, the ints `extra` (K1q's row0), device and
    stream; raises on a failed launch."""
    from wast3d_tpu_torch import _build

    dev = rows.device
    if dev.type != "cuda":
        raise ValueError(f"the blend kernels run on cuda or cpu, not {dev}")
    lib = _build.load_library()
    tables = (fast_tables(dev).data_ptr(),) if fast else ()
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    err = getattr(lib, entry)(
        rows.data_ptr(), starts.data_ptr(), ends.data_ptr(),
        None if offsets is None else offsets.data_ptr(), bg.data_ptr(), *tables,
        *(t.data_ptr() for t in outs), width, height, tile_grid(width, height)[0],
        num_tiles, *extra, index, torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"{entry} kernel launch failed: CUDA error {err} "
            f"({lib.w3d_error_string(err).decode()})")


def _launch_fwd(entry, rows, starts, ends, width, height, bg, offsets, num_tiles, fast,
                extra=()):
    """Launch K1, K1f, K1q or K1fq (the C entry `entry`) on CUDA tensors."""
    out = BlendOutput(*(torch.empty(shape, dtype=torch.float32, device=rows.device)
                        for shape in ((height, width, 3), (height, width), (height, width))))
    _kernel_call(entry, rows, starts, ends, offsets, bg, fast, out, width, height, num_tiles,
                 extra)
    return out


def blend_fwd(rows: torch.Tensor, starts: torch.Tensor, ends: torch.Tensor,
              width: int, height: int, bg: torch.Tensor,
              offsets: Optional[torch.Tensor] = None) -> BlendOutput:
    """K1. CUDA tensors launch the kernel (counted in `blend_fwd.launches`);
    CPU tensors take `blend_fwd_reference`."""
    num_tiles = _check_inputs(rows, starts, ends, width, height, bg, offsets)
    if rows.device.type == "cpu":
        return blend_fwd_reference(rows, starts, ends, width, height, bg, offsets)
    out = _launch_fwd("w3d_blend_fwd", rows, starts, ends, width, height, bg, offsets,
                      num_tiles, fast=False)
    blend_fwd.launches += 1
    return out


blend_fwd.launches = 0


def blend_fwd_fast(rows: torch.Tensor, starts: torch.Tensor, ends: torch.Tensor,
                   width: int, height: int, bg: torch.Tensor,
                   offsets: Optional[torch.Tensor] = None) -> BlendOutput:
    """K1f, the bf16 tier of K1 (module docstring), on [K, 16] bf16 rows.
    CUDA tensors launch the kernel (counted in `blend_fwd_fast.launches`);
    CPU tensors take `blend_fwd_fast_reference`."""
    num_tiles = _check_inputs(rows, starts, ends, width, height, bg, offsets, fast=True)
    if rows.device.type == "cpu":
        return blend_fwd_fast_reference(rows, starts, ends, width, height, bg, offsets)
    out = _launch_fwd("w3d_blend_fwd_fast", rows, starts, ends, width, height, bg, offsets,
                      num_tiles, fast=True)
    blend_fwd_fast.launches += 1
    return out


blend_fwd_fast.launches = 0


def blend_fwd_quad(rows: torch.Tensor, starts: torch.Tensor, ends: torch.Tensor,
                   width: int, height: int, bg: torch.Tensor,
                   offsets: Optional[torch.Tensor] = None, row0: int = 0) -> BlendOutput:
    """K1q, K1 on the quad route (module docstring), on K1's rows; `offsets`
    must be None. The frame is image rows [row0, row0 + height) (row0 a
    multiple of 16: a tile-sharded strip's first row), the rows' means in
    image coordinates. CUDA tensors launch the kernel (counted in
    `blend_fwd_quad.launches`); CPU tensors take `blend_fwd_reference(...,
    quad=True)`."""
    num_tiles = _check_inputs(rows, starts, ends, width, height, bg, offsets, quad=True,
                              row0=row0)
    if rows.device.type == "cpu":
        return blend_fwd_reference(rows, starts, ends, width, height, bg, quad=True, row0=row0)
    out = _launch_fwd("w3d_blend_fwd_quad", rows, starts, ends, width, height, bg, None,
                      num_tiles, fast=False, extra=(row0,))
    blend_fwd_quad.launches += 1
    return out


blend_fwd_quad.launches = 0


def blend_fwd_fast_quad(rows: torch.Tensor, starts: torch.Tensor, ends: torch.Tensor,
                        width: int, height: int, bg: torch.Tensor,
                        offsets: Optional[torch.Tensor] = None) -> BlendOutput:
    """K1fq, K1f on the quad route (module docstring), on K1f's bf16 rows;
    `offsets` must be None. CUDA tensors launch the kernel (counted in
    `blend_fwd_fast_quad.launches`); CPU tensors take
    `blend_fwd_fast_reference(..., quad=True)`."""
    num_tiles = _check_inputs(rows, starts, ends, width, height, bg, offsets, fast=True,
                              quad=True)
    if rows.device.type == "cpu":
        return blend_fwd_fast_reference(rows, starts, ends, width, height, bg, quad=True)
    out = _launch_fwd("w3d_blend_fwd_fast_quad", rows, starts, ends, width, height, bg, None,
                      num_tiles, fast=True)
    blend_fwd_fast_quad.launches += 1
    return out


blend_fwd_fast_quad.launches = 0


def _bf(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16 (to nearest, ties to even) and back to x's
    dtype: one rounding point of the bf16 tier."""
    return x.to(torch.bfloat16).to(x.dtype)


def _running_sum(init: torch.Tensor, x: torch.Tensor, product: bool = False) -> torch.Tensor:
    """[..., G + 1]: init, init + x[..., 0], (init + x[..., 0]) + x[..., 1],
    ..., added one at a time in x's dtype, as the kernels add (a cumsum may
    add in another order or in a wider type); multiplied with `product`."""
    out = [init]
    for g in range(x.shape[-1]):
        out.append(out[-1] * x[..., g] if product else out[-1] + x[..., g])
    return torch.stack(out, dim=-1)


def _fast_power(mx, my, a, b, c, px, py):
    """The bf16 tier's direct power (module docstring), JAX's bf16 chain
    with each operation evaluated in f32 and rounded to bf16, from the rows'
    bf16 values as f32 and f32 samples px, py (broadcast together); f32
    values, each a bf16."""
    dx, dy = _bf(mx - _bf(px)), _bf(my - _bf(py))
    ah, ch, bn = _bf(-0.5 * a), _bf(-0.5 * c), -b
    return _bf(_bf(_bf(_bf(ah * dx) * dx) + _bf(_bf(ch * dy) * dy)) + _bf(_bf(bn * dx) * dy))


def _quad_coefficients(mx, my, a, b, c):
    """[..., 6]: the quad route's coefficients of power in the pixel
    monomials (module docstring) for tile-local means, each operation
    rounded in the inputs' dtype (JAX's c8, `pallas_blend.py:198-206`)."""
    ah, ch, bn = -0.5 * a, -0.5 * c, -b
    return torch.stack([ah, ch, bn, (-2.0 * ah) * mx - bn * my, (-2.0 * ch) * my - bn * mx,
                        ((ah * mx) * mx + (ch * my) * my) + (bn * mx) * my], dim=-1)


def _split(c: torch.Tensor, parts: int):
    """c as `parts` bf16 values (in c's dtype): hi = bf(c), then the
    rounding of what is left, (c - hi) - mid, ... (`_split2`)."""
    out, rest = [], c
    for _ in range(parts):
        out.append(_bf(rest))
        rest = rest - out[-1]
    return out


def _quad_sum(coef, px, py, fast):
    """The quad route's power before JAX's clamp (module docstring), from
    coef [..., 6] (the entries' coefficients) at tile-local samples px, py
    broadcast against coef's leading dimensions."""
    mono = (px * px, py * py, px * py, px, py)
    power = None
    for part in _split(coef, QUAD_PARTS[fast]):
        d = part[..., 0] * mono[0]
        for k in range(1, 5):
            d = d + part[..., k] * mono[k]
        d = d + part[..., 5]
        power = d if power is None else power + d
    return power


def quad_mma_bound(coef, px, py, fast):
    """The most by which K1q's (K1fq's with `fast`) raw power can differ
    from `_quad_sum`'s, broadcast as `_quad_sum`: the kernel's MMAs
    (`QUAD_MMA_DEPTHS`, each within MMA_UNIT times its depth of the
    magnitudes it sums, at most those of every part's terms, M = sum over
    parts and monomials of |part| m) and the plain version's own f32 sums
    (five a part and the parts' two, within 8u M), from the exact sum of the
    parts' products."""
    mono = (px * px, py * py, px * py, px, py, torch.ones_like(px))
    m = None
    for part in _split(coef, QUAD_PARTS[fast]):
        for k in range(6):
            t = (part[..., k] * mono[k]).abs()
            m = t if m is None else m + t
    return (MMA_UNIT * sum(QUAD_MMA_DEPTHS[fast]) + 8.0 * U) * m


def _quad_power(coef, px, py, fast):
    """`_quad_sum` clamped with the tier's allowance."""
    power = _quad_sum(coef, px, py, fast)
    zero = torch.zeros_like(power)
    eps = torch.tensor(QUAD_EPS[fast], dtype=power.dtype, device=power.device)
    return torch.minimum(power, zero) + torch.maximum(power - eps, zero)


def quad_term_bound(mx, my, a, b, c):
    """The quad cull's bound on the magnitudes of power's expansion over a
    tile (tile-local means; `cull_prelude` in csrc/blend_fwd.cu): S = 225
    (|A|/2 + |C|/2 + |B|) + 15 (|A mx| + |B my| + |C my| + |B mx|) + |A|/2
    mx^2 + |C|/2 my^2 + |B mx my|."""
    ah, ch, bb = 0.5 * a.abs(), 0.5 * c.abs(), b.abs()
    s = float(QUAD_SPAN)
    return ((s * s) * (ah + ch + bb)
            + s * ((a * mx).abs() + (b * my).abs() + (c * my).abs() + (b * mx).abs())
            + (ah * mx * mx + ch * my * my + bb * (mx * my).abs()))


def _pixel_coords(width, height, offsets, device, local=False):
    """[T, 256] sample coordinates per tile pixel (image coordinates plus
    jitter; tile-local ones, x - tile x and y - tile y plus jitter, with
    `local`, as the bf16 tier takes them) and the [T, 256] mask of pixels
    inside the image."""
    grid_x, grid_y = tile_grid(width, height)
    t = torch.arange(grid_x * grid_y, device=device)
    p = torch.arange(PIXELS, device=device)
    x = (t % grid_x)[:, None] * TILE + (p % TILE)[None, :]
    y = (t // grid_x)[:, None] * TILE + (p // TILE)[None, :]
    inside = (x < width) & (y < height)
    if local:
        px, py = (v.to(torch.float32).expand(len(t), PIXELS)
                  for v in ((p % TILE)[None, :], (p // TILE)[None, :]))
    else:
        px, py = x.to(torch.float32), y.to(torch.float32)
    if offsets is not None:
        flat = (y.clamp(max=height - 1) * width + x.clamp(max=width - 1))
        off = offsets.reshape(-1, 2)[flat]
        zero = torch.zeros_like(px)
        px = px + torch.where(inside, off[..., 0], zero)
        py = py + torch.where(inside, off[..., 1], zero)
    return px, py, inside


class WalkCounts(NamedTuple):
    """What K1's walk does on given inputs (`warp_walk_counts`)."""
    evaluated_pairs: int  # (pixel, entry) pairs evaluated: up to and including the stop
    warp_iterations: int  # (warp, entry) iterations with every entry walked
    warp_iterations_culled: int  # the same, the culled entries left out
    contributing_pairs: int  # (pixel, entry) pairs that add weight alpha T


def _chunk(rows, idx, in_range, px, py, state, fast, quad=False, origin=None):
    """The recompute of one chunk of CHUNK entry slots for A tiles, shared by
    the plain forward and backward. idx [A, G] entries, each tile's last
    entry in place of those out of range (`in_range`), px, py [A, P] samples
    (tile-local in the bf16 tier and on the quad route), state [A, P] the T
    carried in (log T with `fast`); `quad` takes the quad route's power, on
    means recentred by `origin` (x [A], y [A], the tiles' pixel origins) in
    the f32 tier. Returns the rows r [A, G, width] (f32 values in the bf16
    tier), dx, dy (None on the quad route), alpha (0 where skipped), skip, T
    before each entry and the stop test, all [A, P, G], and where T is
    carried one entry at a time (the bf16 tier: the running log T; the f32
    quad route: the running T) that sequence [A, P, G + 1] (else None)."""
    r = rows[idx]
    if fast:
        r = r.to(torch.float32)
    a = r[:, None, :, R_A]
    b = r[:, None, :, R_B]
    c = r[:, None, :, R_C]
    opa = r[:, None, :, R_OPA]
    if quad:
        dx = dy = None
        mx, my = r[..., R_MX], r[..., R_MY]
        if not fast:
            mx, my = mx - origin[0][:, None], my - origin[1][:, None]
        coef = _quad_coefficients(mx, my, r[..., R_A], r[..., R_B], r[..., R_C])
        power = _quad_power(coef[:, None], px[:, :, None], py[:, :, None], fast)
    else:
        dx = r[:, None, :, R_MX] - px[:, :, None]  # [A, P, G]
        dy = r[:, None, :, R_MY] - py[:, :, None]
        if fast:
            power = _fast_power(r[:, None, :, R_MX], r[:, None, :, R_MY], a, b, c,
                                px[:, :, None], py[:, :, None])
        else:
            power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    if fast:
        tables = fast_tables(rows.device)
        alpha = torch.clamp_max(_bf(opa * exp_table(power.to(torch.bfloat16), tables)),
                                ALPHA_MAX_BF16)
    else:
        alpha = torch.clamp_max(opa * torch.exp(power), ALPHA_MAX)
    skip = (power > 0.0) | (alpha < ALPHA_MIN) | ~in_range[:, None, :]
    zero = torch.zeros_like(alpha)
    alpha = torch.where(skip, zero, alpha)
    if fast:
        s = torch.where(skip, zero, log1m_table(alpha.to(torch.bfloat16), tables))
        log_prev = _running_sum(state, s)  # [A, P, G + 1]
        t_prev = exp_table(log_prev[..., :-1].to(torch.bfloat16), tables)
        test_t = _bf(t_prev * _bf(1.0 - alpha))
        return r, dx, dy, alpha, skip, t_prev, test_t, log_prev
    one_m = 1.0 - alpha
    if quad:
        t_seq = _running_sum(state, one_m, product=True)  # [A, P, G + 1]
        return r, dx, dy, alpha, skip, t_seq[..., :-1], t_seq[..., 1:], t_seq
    cp = torch.cumprod(one_m, dim=-1)
    t_prev = state[..., None] * torch.cat([torch.ones_like(cp[..., :1]), cp[..., :-1]], dim=-1)
    return r, dx, dy, alpha, skip, t_prev, t_prev * one_m, None


def _walk(rows, starts, ends, width, height, offsets, keep=None, fast=False, quad=False,
          row0=0):
    """The plain blend over all pixels of all tiles at once, CHUNK entry
    slots per step (`_chunk`, on the quad route with `quad`, the tiles'
    origins in the image whose row `row0` is the frame's first); T (log T with
    `fast`) and `done` carry from chunk to chunk. Returns per-tile colour,
    depth, T and the `WalkCounts` (the warp counts only when `keep`, [K,
    WARPS] bool from `warp_keep_reference`, is given; else 0)."""
    dev = rows.device
    dt = torch.float32 if fast else rows.dtype
    px, py, inside = _pixel_coords(width, height, offsets, dev, local=fast or quad)
    num_tiles = px.shape[0]
    grid_x = tile_grid(width, height)[0]
    tiles = torch.arange(num_tiles, device=dev)
    origins = ((tiles % grid_x * TILE).to(dt), (row0 + tiles // grid_x * TILE).to(dt))
    starts, ends = starts.long(), ends.long()
    lengths = ends - starts
    # T, or log T in the bf16 tier
    t_run = torch.full((num_tiles, PIXELS), 0.0 if fast else 1.0, dtype=dt, device=dev)
    done = ~inside  # pixels beyond the image take part in nothing
    color = torch.zeros((num_tiles, PIXELS, 3), dtype=dt, device=dev)
    depth = torch.zeros((num_tiles, PIXELS), dtype=dt, device=dev)
    pairs = torch.zeros((), dtype=torch.int64, device=dev)
    contributing = torch.zeros((), dtype=torch.int64, device=dev)
    iters = torch.zeros((), dtype=torch.int64, device=dev)
    iters_culled = torch.zeros((), dtype=torch.int64, device=dev)
    slot = torch.arange(CHUNK, device=dev)
    max_len = int(lengths.max()) if num_tiles else 0
    for c0 in range(0, max_len, CHUNK):
        ti = torch.nonzero((lengths > c0) & ~done.all(dim=1)).squeeze(1)
        if ti.numel() == 0:
            break
        idx = starts[ti, None] + c0 + slot[None, :]  # [A, G]
        in_range = idx < ends[ti, None]
        r, _, _, alpha, skip, t_prev, test_t, running = _chunk(
            rows, torch.minimum(idx, ends[ti, None] - 1), in_range, px[ti], py[ti],
            t_run[ti], fast, quad, (origins[0][ti], origins[1][ti]))
        done_before = done[ti][..., None]
        stop = torch.cumsum((test_t < T_EPS).to(torch.int32), dim=-1) > 0
        done_g = done_before | stop
        w = alpha * t_prev
        w = torch.where(done_g, torch.zeros_like(alpha), _bf(w) if fast else w)
        if running is not None:
            # one entry at a time, in walk order, as the kernel adds
            rgbd = r[..., [R_R, R_G, R_B2, R_DEPTH]]  # [A, G, 4]
            acc = torch.cat([color[ti], depth[ti][..., None]], dim=-1)  # [A, P, 4]
            for g in range(w.shape[-1]):
                acc = acc + w[..., g, None] * rgbd[:, None, g]
            color[ti], depth[ti] = acc[..., :3], acc[..., 3]
            # T (log T) after the chunk: the running value up to the pixel's
            # stop (done_g is a prefix of False then True along the chunk)
            taken = (~done_g).sum(dim=-1, keepdim=True)
            t_run[ti] = running.gather(-1, taken)[..., 0]
        else:
            color[ti] += torch.einsum("apg,agc->apc", w, r[..., R_R:R_B2 + 1])
            depth[ti] += torch.einsum("apg,ag->ap", w, r[..., R_DEPTH])
            kept = torch.where(done_g, torch.zeros_like(alpha), alpha)
            t_run[ti] = t_run[ti] * torch.prod(1.0 - kept, dim=-1)
        # an entry is evaluated unless the pixel stopped at an earlier one
        stopped_earlier = done_before | torch.cat(
            [torch.zeros_like(stop[..., :1]), stop[..., :-1]], dim=-1)
        evaluated = ~stopped_earlier & in_range[:, None, :]  # [A, P, G]
        pairs += evaluated.sum()
        contributing += (~skip & ~done_g).sum()
        if keep is not None:
            # a warp issues an entry while any of its 32 pixels walks
            live = evaluated[:, WARP_PIXELS.to(dev)].any(dim=2)  # [A, W, G]
            kept = keep[torch.minimum(idx, ends[ti, None] - 1)].permute(0, 2, 1)
            iters += live.sum()
            iters_culled += (live & kept).sum()
        done[ti] = done_g[..., -1]
    counts = WalkCounts(int(pairs), int(iters), int(iters_culled), int(contributing))
    if fast:
        t_run = torch.exp(t_run)
    return color, depth, t_run, counts


def _untile(x, width, height):
    grid_x, grid_y = tile_grid(width, height)
    ch = x.shape[-1]
    img = x.reshape(grid_y, grid_x, TILE, TILE, ch).permute(0, 2, 1, 3, 4)
    return img.reshape(grid_y * TILE, grid_x * TILE, ch)[:height, :width]


def blend_fwd_reference(rows: torch.Tensor, starts: torch.Tensor,
                        ends: torch.Tensor, width: int, height: int,
                        bg: torch.Tensor,
                        offsets: Optional[torch.Tensor] = None,
                        quad: bool = False, row0: int = 0) -> BlendOutput:
    """Plain PyTorch version of K1: same inputs, same outputs, same skip and
    stop rules in the same order; runs on any device, in float32 or
    float64. `quad`: the plain version of K1q, the quad route (module
    docstring; no offsets), with its `row0`."""
    return _blend_plain(rows, starts, ends, width, height, bg, offsets, False, quad, row0)


def blend_fwd_fast_reference(rows: torch.Tensor, starts: torch.Tensor,
                             ends: torch.Tensor, width: int, height: int,
                             bg: torch.Tensor,
                             offsets: Optional[torch.Tensor] = None,
                             quad: bool = False) -> BlendOutput:
    """Plain PyTorch version of K1f: the bf16 tier's rows, tables and
    rounding points (module docstring), its sums of log-transmittance, colour
    and depth added one entry at a time in walk order as the kernel adds
    them. `quad`: the plain version of K1fq, the quad route (no offsets)."""
    return _blend_plain(rows, starts, ends, width, height, bg, offsets, True, quad)


def _blend_plain(rows, starts, ends, width, height, bg, offsets, fast, quad=False, row0=0):
    _check_inputs(rows, starts, ends, width, height, bg, offsets, plain=True, fast=fast,
                  quad=quad, row0=row0)
    color, depth, t_run, _ = _walk(rows, starts, ends, width, height, offsets, fast=fast,
                                   quad=quad, row0=row0)
    color = color + t_run[..., None] * bg
    return BlendOutput(
        color=_untile(color, width, height).contiguous(),
        depth=_untile(depth[..., None], width, height)[..., 0].contiguous(),
        final_T=_untile(t_run[..., None], width, height)[..., 0].contiguous(),
    )


def evaluated_pairs(rows: torch.Tensor, starts: torch.Tensor,
                    ends: torch.Tensor, width: int, height: int,
                    offsets: Optional[torch.Tensor] = None, fast: bool = False) -> int:
    """Number of (pixel, entry) pairs K1 (K1f with `fast`) evaluates on these
    inputs: every entry in range up to and including the one where the pixel
    stops. Used to state the kernel's operation count."""
    return _walk(rows, starts, ends, width, height, offsets, fast=fast)[3].evaluated_pairs


# ---- K1's per-warp cull, plain ----------------------------------------------

def warp_boxes(width: int, height: int,
               offsets: Optional[torch.Tensor] = None,
               device=None, local: bool = False) -> torch.Tensor:
    """[T, WARPS, 4] f32 sample box of each warp of each tile: x0, x1, y0,
    y1, the least and greatest sample position (pixel plus offset;
    tile-local with `local`, as K1f samples) over the warp's pixels
    (`WARP_PIXELS`) inside the image; (inf, -inf, inf, -inf) for a warp with
    no pixel inside."""
    dev = offsets.device if offsets is not None else device
    px, py, inside = (v[:, WARP_PIXELS.to(dev)]
                      for v in _pixel_coords(width, height, offsets, dev, local))  # [T, W, 32]
    inf = torch.full_like(px, float("inf"))
    return torch.stack([torch.where(inside, px, inf).amin(-1),
                        torch.where(inside, px, -inf).amax(-1),
                        torch.where(inside, py, inf).amin(-1),
                        torch.where(inside, py, -inf).amax(-1)], dim=-1)


def _culled(r, box, fast=False, quad=False):
    """K1's cull (`cull_prelude` and `culled` in csrc/blend_fwd.cu, where the
    margin is derived), in float32 in the kernel's order of operations: r
    [E, >= 6] rows (f32 values), box [E, W, 4]; [E, W] True where no sample
    of the box can take the entry. `fast`: K1f's cull, with the bf16 tier's
    wider margin and its opacity threshold, 1/255 itself, and (not on the
    quad route) for the bf16 chain the box widened by FAST_BOX of its
    largest coordinate and FAST_TERM of its largest term sum on the
    threshold. `quad`: the quad route's, on tile-local means and boxes, its
    margin wider by the tier's `QUAD_MARGIN` times `quad_term_bound`."""
    # per entry: 1/A, 1/C and tau' (+inf: never culled; -inf: culled by opa)
    mx, my, a, b, c, opa = (r[:, i, None] for i in range(6))
    cullable = (torch.isfinite(r[:, :6]).all(dim=1)[:, None] & (a > CONIC_MIN)
                & (c > CONIC_MIN) & (a * c * (1.0 - 16.0 * U) > b * b))
    tau = 2.0 * torch.log(255.0 * opa)
    tau = tau + 8.0 * U * tau.abs()
    if fast:
        tau = tau + (TAU_FAST + TAU_FAST_REL * tau.abs())
    if quad:
        tau = tau + QUAD_MARGIN[fast] * quad_term_bound(mx, my, a, b, c)
    opa_cull = ALPHA_MIN if fast else OPA_CULL
    tau = torch.where(cullable, torch.where(opa < opa_cull, -math.inf, tau), math.inf)
    ia, ic = 1.0 / a, 1.0 / c
    # per box
    x0, x1, y0, y1 = box.unbind(-1)
    chain = fast and not quad
    if chain:  # the bf16 chain's samples, bf(px) and bf(py)
        sx = FAST_BOX * torch.maximum(x0.abs(), x1.abs())
        sy = FAST_BOX * torch.maximum(y0.abs(), y1.abs())
        x0, x1, y0, y1 = x0 - sx, x1 + sx, y0 - sy, y1 + sy
    dx0, dx1 = mx - x1, mx - x0
    dy0, dy1 = my - y1, my - y0
    ex = torch.maximum(dx0.abs(), dx1.abs())
    ey = torch.maximum(dy0.abs(), dy1.abs())
    tmax = a * ex * ex + c * ey * ey + 2.0 * b.abs() * ex * ey

    def quad(dx, dy):
        return a * dx * dx + 2.0 * b * dx * dy + c * dy * dy

    def clamp(v, lo, hi):
        return torch.fmin(torch.fmax(v, lo), hi)

    qmin = torch.fmin(
        torch.fmin(quad(dx0, clamp(-b * dx0 * ic, dy0, dy1)),
                   quad(dx1, clamp(-b * dx1 * ic, dy0, dy1))),
        torch.fmin(quad(clamp(-b * dy0 * ia, dx0, dx1), dy0),
                   quad(clamp(-b * dy1 * ia, dx0, dx1), dy1)))
    mean_inside = (dx0 <= 0) & (dx1 >= 0) & (dy0 <= 0) & (dy1 >= 0)
    qmin = torch.where(mean_inside, torch.zeros_like(qmin), qmin)
    threshold = tau + 64.0 * U * (tmax + 1.0)
    if chain:
        threshold = threshold + FAST_TERM * tmax
    return (tmax < TERM_MAX) & (qmin > threshold)


def warp_keep_reference(rows: torch.Tensor, starts: torch.Tensor,
                        ends: torch.Tensor, width: int, height: int,
                        offsets: Optional[torch.Tensor] = None,
                        fast: bool = False, quad: bool = False) -> torch.Tensor:
    """[K, WARPS] bool: K1's cull (K1f's with `fast`, on its bf16 rows and
    tile-local samples; K1q's or K1fq's with `quad`, on tile-local means and
    samples), plain. keep[k, w] is True where entry k lies in a tile's
    range, warp w of that tile has a pixel inside the image, and the entry is
    not culled for the warp's sample box (`_culled`): the (entry, warp) pairs
    the kernel walks until the warp's pixels stop."""
    if quad and offsets is not None:
        raise ValueError("the quad route samples integer pixel positions: offsets must be None")
    rows = rows.to(torch.float32)
    dev = rows.device
    starts, ends = starts.long(), ends.long()
    counts = ends - starts
    tile = torch.repeat_interleave(torch.arange(len(starts), device=dev), counts)
    # the rows of every range, in order: start + position within the range
    first = torch.cumsum(counts, 0) - counts  # each range's first position
    entry = starts[tile] + torch.arange(len(tile), device=dev) - first[tile]
    boxes = warp_boxes(width, height, offsets, dev, local=fast or quad)[tile]  # [E, W, 4]
    live = boxes[..., 0] <= boxes[..., 1]  # the warp has a pixel inside
    r = rows[entry]
    if quad and not fast:  # the means recentred on the tile, as K1q stages them
        grid_x = tile_grid(width, height)[0]
        r = torch.cat([r[:, :1] - (tile % grid_x * TILE).to(r.dtype)[:, None],
                       r[:, 1:2] - (tile // grid_x * TILE).to(r.dtype)[:, None], r[:, 2:]], 1)
    keep = torch.zeros((rows.shape[0], WARPS), dtype=torch.bool, device=dev)
    keep[entry] = live & ~_culled(r, boxes, fast, quad)
    return keep


def warp_walk_counts(rows: torch.Tensor, starts: torch.Tensor,
                     ends: torch.Tensor, width: int, height: int,
                     offsets: Optional[torch.Tensor] = None,
                     fast: bool = False, quad: bool = False) -> WalkCounts:
    """K1's (K1f's with `fast`; on the quad route with `quad`) work on these
    inputs (`WalkCounts`), from its plain versions: (warp, entry) iterations
    without and with the cull, and the (pixel, entry) pairs evaluated and
    contributing. For PERF.md's counts and the kernel's bounds."""
    keep = warp_keep_reference(rows, starts, ends, width, height, offsets, fast, quad)
    return _walk(rows, starts, ends, width, height, offsets, keep, fast, quad)[3]


# ---- K2: backward -----------------------------------------------------------

def _check_outputs(name, t, dtype, width, height):
    for field, x, shape in zip(BlendOutput._fields, t,
                               ((height, width, 3), (height, width), (height, width))):
        if x.dtype != dtype or tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"{name}.{field} must be contiguous {dtype} {shape}, "
                             f"got {x.dtype} {tuple(x.shape)}")


def _check_bwd(rows, starts, ends, width, height, bg, offsets, out, grads, plain=False,
               fast=False):
    num_tiles = _check_inputs(rows, starts, ends, width, height, bg, offsets, plain, fast)
    dtype = torch.float32 if fast else rows.dtype
    _check_outputs("out", out, dtype, width, height)
    _check_outputs("grads", grads, dtype, width, height)
    return num_tiles


def blend_bwd(rows: torch.Tensor, starts: torch.Tensor, ends: torch.Tensor,
              width: int, height: int, bg: torch.Tensor,
              offsets: Optional[torch.Tensor], out: BlendOutput,
              grads: BlendOutput) -> torch.Tensor:
    """K2. `out` is K1's output on these inputs, `grads` the cotangents of
    its three fields. Returns d rows [K, 12]. CUDA tensors launch the
    kernel (counted in `blend_bwd.launches`); CPU tensors take
    `blend_bwd_reference`."""
    num_tiles = _check_bwd(rows, starts, ends, width, height, bg, offsets, out, grads)
    if rows.device.type == "cpu":
        return blend_bwd_reference(rows, starts, ends, width, height, bg, offsets,
                                   out, grads)
    drows = torch.zeros_like(rows)
    _kernel_call("w3d_blend_bwd", rows, starts, ends, offsets, bg, False,
                 (*out, *grads, drows), width, height, num_tiles)
    blend_bwd.launches += 1
    return drows


blend_bwd.launches = 0


def blend_bwd_fast(rows: torch.Tensor, starts: torch.Tensor, ends: torch.Tensor,
                   width: int, height: int, bg: torch.Tensor,
                   offsets: Optional[torch.Tensor], out: BlendOutput,
                   grads: BlendOutput) -> torch.Tensor:
    """K2f, the bf16 tier of K2 (module docstring); `out` is K1f's output on
    these inputs. Returns d rows [K, 16] bf16 (columns 10-15 zero). CUDA
    tensors launch the kernel (counted in `blend_bwd_fast.launches`); CPU
    tensors take `blend_bwd_fast_reference`."""
    num_tiles = _check_bwd(rows, starts, ends, width, height, bg, offsets, out, grads,
                           fast=True)
    if rows.device.type == "cpu":
        return blend_bwd_fast_reference(rows, starts, ends, width, height, bg, offsets,
                                        out, grads)
    drows = torch.zeros_like(rows)
    _kernel_call("w3d_blend_bwd_fast", rows, starts, ends, offsets, bg, True,
                 (*out, *grads, drows), width, height, num_tiles)
    blend_bwd_fast.launches += 1
    return drows


blend_bwd_fast.launches = 0


def _tile(img, width, height):
    """[H, W, C] image -> [T, 256, C] per-tile pixels, zero beyond the image
    (the inverse of `_untile`)."""
    grid_x, grid_y = tile_grid(width, height)
    ch = img.shape[-1]
    pad = img.new_zeros((grid_y * TILE, grid_x * TILE, ch))
    pad[:height, :width] = img
    t = pad.reshape(grid_y, TILE, grid_x, TILE, ch).permute(0, 2, 1, 3, 4)
    return t.reshape(grid_x * grid_y, PIXELS, ch)


def blend_bwd_reference(rows: torch.Tensor, starts: torch.Tensor,
                        ends: torch.Tensor, width: int, height: int,
                        bg: torch.Tensor, offsets: Optional[torch.Tensor],
                        out: BlendOutput, grads: BlendOutput) -> torch.Tensor:
    """Plain PyTorch version of K2: the same walk as `blend_fwd_reference`
    (CHUNK entry slots per step, T and `done` carried), the same identity
    and the same per-entry sums; runs on any device, in float32 or
    float64."""
    return _bwd_plain(rows, starts, ends, width, height, bg, offsets, out, grads, fast=False)


def blend_bwd_fast_reference(rows: torch.Tensor, starts: torch.Tensor,
                             ends: torch.Tensor, width: int, height: int,
                             bg: torch.Tensor, offsets: Optional[torch.Tensor],
                             out: BlendOutput, grads: BlendOutput) -> torch.Tensor:
    """Plain PyTorch version of K2f: `blend_bwd_reference` with the bf16
    tier's recompute (that of `blend_fwd_fast_reference`), its rounding of
    q, q w and q T, and its row gradient rounded into [K, 16] bf16 (module
    docstring); log-transmittance and the q w prefix are added one entry at
    a time in walk order."""
    return _bwd_plain(rows, starts, ends, width, height, bg, offsets, out, grads, fast=True)


def _bwd_plain(rows, starts, ends, width, height, bg, offsets, out, grads, fast):
    _check_bwd(rows, starts, ends, width, height, bg, offsets, out, grads, plain=True,
               fast=fast)
    dev = rows.device
    dt = torch.float32 if fast else rows.dtype
    px, py, inside = _pixel_coords(width, height, offsets, dev, local=fast)
    gc = _tile(grads.color, width, height)  # [T, P, 3]
    gd = _tile(grads.depth[..., None], width, height)[..., 0]
    t_fin = _tile(out.final_T[..., None], width, height)[..., 0]
    acc = _tile(out.color, width, height) - t_fin[..., None] * bg
    dt_eff = _tile(grads.final_T[..., None], width, height)[..., 0] + (gc * bg).sum(-1)
    s_total = ((gc * acc).sum(-1) + gd * _tile(out.depth[..., None], width, height)[..., 0]
               + t_fin * dt_eff)

    num_tiles = px.shape[0]
    starts, ends = starts.long(), ends.long()
    lengths = ends - starts
    # T, or log T in the bf16 tier
    t_run = torch.full((num_tiles, PIXELS), 0.0 if fast else 1.0, dtype=dt, device=dev)
    prefix = torch.zeros((num_tiles, PIXELS), dtype=dt, device=dev)
    done = ~inside
    drows = torch.zeros((rows.shape[0], ROW_FAST if fast else rows.shape[1]),
                        dtype=rows.dtype, device=dev)
    slot = torch.arange(CHUNK, device=dev)
    max_len = int(lengths.max()) if num_tiles else 0
    for c0 in range(0, max_len, CHUNK):
        ti = torch.nonzero((lengths > c0) & ~done.all(dim=1)).squeeze(1)
        if ti.numel() == 0:
            break
        idx = starts[ti, None] + c0 + slot[None, :]  # [A, G]
        in_range = idx < ends[ti, None]
        r, dx, dy, alpha, skip, t_prev, test_t, log_prev = _chunk(
            rows, torch.minimum(idx, ends[ti, None] - 1), in_range, px[ti], py[ti],
            t_run[ti], fast)
        one_m = 1.0 - alpha
        stop = torch.cumsum((test_t < T_EPS).to(torch.int32), dim=-1) > 0
        done_g = done[ti][..., None] | stop
        live = ~done_g & ~skip
        zero = torch.zeros_like(alpha)
        w = alpha * t_prev
        w = torch.where(live, _bf(w) if fast else w, zero)
        rgb = r[:, None, :, R_R:R_B2 + 1]  # [A, 1, G, 3]
        g_c = gc[ti][:, :, None, :]  # [A, P, 1, 3]
        g_d = gd[ti][..., None]  # [A, P, 1]
        if fast:
            # every product and sum rounded, in the order r, g, b, depth
            prod = _bf(rgb * _bf(g_c))
            q = _bf(_bf(_bf(prod[..., 0] + prod[..., 1]) + prod[..., 2])
                    + _bf(r[:, None, :, R_DEPTH] * _bf(g_d)))
            qw = _bf(q * w)
            prefix_incl = _running_sum(prefix[ti], qw)[..., 1:]
            q_t = _bf(q * t_prev)
        else:
            q = (rgb * g_c).sum(-1) + r[:, None, :, R_DEPTH] * g_d
            qw = q * w
            prefix_incl = prefix[ti][..., None] + torch.cumsum(qw, dim=-1)
            q_t = q * t_prev
        dpow = torch.where(
            live & (alpha < ALPHA_MAX),
            (q_t - (s_total[ti][..., None] - prefix_incl) / one_m) * alpha,
            zero)
        sd = dpow.sum(1)  # [A, G]
        sx = (dpow * dx).sum(1)
        sy = (dpow * dy).sum(1)
        sxx = (dpow * dx * dx).sum(1)
        sxy = (dpow * dx * dy).sum(1)
        syy = (dpow * dy * dy).sum(1)
        ra, rb, rc, opa = r[..., R_A], r[..., R_B], r[..., R_C], r[..., R_OPA]
        vals = torch.stack([
            -(ra * sx + rb * sy), -(rc * sy + rb * sx), -0.5 * sxx, -sxy, -0.5 * syy,
            torch.where(opa > 0.0, sd / torch.where(opa > 0.0, opa, torch.ones_like(opa)),
                        torch.zeros_like(sd)),
            (w * g_d).sum(1), *(w[..., None] * g_c).sum(1).unbind(-1),
        ], dim=-1)  # [A, G, 10]
        drows[idx[in_range], :10] = vals[in_range].to(drows.dtype)
        if fast:
            t_run[ti] = log_prev.gather(-1, (~done_g).sum(dim=-1, keepdim=True))[..., 0]
        else:
            kept = torch.where(done_g, zero, alpha)
            t_run[ti] = t_run[ti] * torch.prod(1.0 - kept, dim=-1)
        prefix[ti] = prefix_incl[..., -1]
        done[ti] = done_g[..., -1]
    return drows


# (forward, backward) by (use_kernel, fast); the quad route's forwards are
# K1q and K1fq (their plain versions on CPU tensors), its backward the pair's
_PAIRS = {(True, False): (blend_fwd, blend_bwd),
          (False, False): (blend_fwd_reference, blend_bwd_reference),
          (True, True): (blend_fwd_fast, blend_bwd_fast),
          (False, True): (blend_fwd_fast_reference, blend_bwd_fast_reference)}


class _Blend(torch.autograd.Function):
    """K1 forward, K2 backward (K1f, K2f with `fast`; K1q or K1fq forward
    with `quad`; or their plain versions); see `blend`. `image_rows`, K1q's
    input, are `rows` with the means unshifted by `row0`."""

    @staticmethod
    def forward(ctx, rows, starts, ends, width, height, bg, offsets, use_kernel, fast, quad,
                image_rows, row0):
        if quad and fast:
            out = blend_fwd_fast_quad(rows, starts, ends, width, height, bg)
        elif quad:
            out = blend_fwd_quad(image_rows, starts, ends, width, height, bg, row0=row0)
        else:
            out = _PAIRS[use_kernel, fast][0](rows, starts, ends, width, height, bg, offsets)
        ctx.save_for_backward(rows, starts, ends, bg, offsets, *out)
        ctx.width, ctx.height, ctx.pair = width, height, (use_kernel, fast)
        return tuple(out)

    @staticmethod
    @once_differentiable
    def backward(ctx, dcolor, ddepth, dfinal_t):
        rows, starts, ends, bg, offsets, color, depth, final_t = ctx.saved_tensors
        drows = _PAIRS[ctx.pair][1](
            rows, starts, ends, ctx.width, ctx.height, bg, offsets,
            BlendOutput(color, depth, final_t),
            BlendOutput(dcolor.contiguous(), ddepth.contiguous(), dfinal_t.contiguous()))
        return (drows,) + (None,) * 11


def blend(rows: torch.Tensor, starts: torch.Tensor, ends: torch.Tensor,
          width: int, height: int, bg: torch.Tensor,
          offsets: Optional[torch.Tensor] = None,
          use_kernel: bool = True, fast: bool = False, quad_power: bool = False,
          row0: int = 0) -> BlendOutput:
    """The differentiable blend: K1 forward and K2 backward, gradient to
    `rows` only; `fast` takes the bf16 tier, K1f and K2f, on [K, 16] bf16
    rows (whose gradient is bf16 too). `quad_power` takes the quad route's
    forward, K1q or K1fq, with the tier's backward, where JAX takes it:
    through the kernels (`use_kernel`) and without jitter (`offsets` None).
    `use_kernel=False` runs the plain versions (on any device); with
    `use_kernel=True` each wrapper still takes its plain version for CPU
    tensors. `row0`: the frame's first image row (a multiple of 16: a
    tile-sharded strip's); f32 rows keep their means in image coordinates,
    which the direct route takes shifted up by row0 and K1q recentres on
    each tile's image origin, one rounding, as JAX's strip path does; bf16
    rows are tile-local already and take no shift."""
    quad = quad_power and use_kernel and offsets is None
    shifted = rows
    if row0 and not fast:
        shifted = torch.cat([rows[:, :1], rows[:, 1:2] - float(row0), rows[:, 2:]], 1)
    return BlendOutput(*_Blend.apply(shifted, starts, ends, width, height, bg, offsets,
                                     use_kernel, fast, quad, rows.detach(),
                                     row0 if quad and not fast else 0))
