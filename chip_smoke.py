#!/usr/bin/env python3
"""Drive the port's serving, training, stylization and WaSt-3D pipeline paths
on one CUDA card and check them.

    python3 chip_smoke.py             # the checks below
    python3 chip_smoke.py --profile   # build, then only a torch.profiler
                                      # trace of the 200k / 800x800 train step
    python3 chip_smoke.py --only k3_cases,eval_entry_point
                                      # build, then only the named phases
                                      # (no result line)

Builds the port's CUDA kernels from `wast3d_tpu_torch/csrc/` (one `nvcc`
per source, all started together, then a link) and holds each kernel
against its plain PyTorch version on the card: K1 (blend forward), K2
(blend backward), their bf16 tier K1f and K2f (`fast_chain`, on the bf16
rows that `render_path` builds; K1f bit for bit), and K3 (per-Gaussian
gradient segment sum), each on small seeded cases, each also run twice for
bitwise equality (K1 and K1f also against themselves with the per-warp
cull off, `w3d_blend_fwd_walk_all` and `w3d_blend_fwd_fast_walk_all`: the
same bits, and on `cull_edges`, rows built to test the cull at its edges;
K3 also on the render path's route, from the binning's own segments,
against the bare-rank route: the same bits). Then the serving path: the
golden scene through the kernel and through the per-pixel oracle, K1 and
the K2 + K3 gradient against the oracle (`oracle_cases`), the
200k-Gaussian / 800x800 scene of `bench.py` timed (K1 with its counts of
walked entries and a hash of its output, and held to less than 0.85 of its
device time with the cull off; then in the bf16 tier, K1f and K1 timed in
one call, K1f held to the same share of its own walk of every entry), and
the user's render entry point (`wast3d_tpu_torch.cli.render`, by default
in the bf16 tier, then with `--no-fast`, then with `--batch 3`), and
`api.render`'s colour and covariance options at that size, with the
gradient of the precomputed colours through K2 and K3 (`api_options`).
Then the training
path: 20 timed train steps on the same scene with a stage split, K2 and K3
against their plain versions at that size, the same steps in the bf16 tier
(K2f and K2 timed in one call), and the user's train entry point
(`wast3d_tpu_torch.cli.train`, ~300 iterations with densify) on a
Blender-format dataset. Then the stylization path: K4 (pair-descriptor
loss) and K5 (its gradient), both on the fit's pair list, against their
plain versions on seeded cases (K4 also against the dense one),
twice each for bitwise equality, alone at the production shape
(Mp = 16384, 8 balls), and against float64 where points nearly coincide; a port-only mirror of `tools/stylize_gate.py` at the
JAX record's configuration; the user's stylize entry point
(`wast3d_tpu_torch.cli.stylize`) at Mp = 16384, where K4/K5 carry the fit;
the cluster geometry-transfer ladder (v0, v1, v4 at 4,096 points,
`geom_transfer`); and the style sweep (`wast3d_tpu_torch.cli.sweep`, four
styles at Mp = 16384 through K4/K5, `sweep_entry_point`).
Last, the WaSt-3D run (`wast3d_tpu_torch.cli.pipeline`: content and
sphere-regularised style training, cluster export, stylization, turntable)
on two 800x800 datasets, which launches K1 to K5. Then evaluation, with the
TF32 flags at PyTorch's defaults: `cli.render` in both tiers, `render_set`
with depth PNGs and `cli.metrics` (`wast3d_tpu_torch.cli.metrics`), whose
card numbers are held to the CPU's on the same PNGs; and image-space
refinement (`wast3d_tpu_torch.refine.drivers.refine` in its five modes,
K1, K2, K3 once a step each) with `cluster_teleport` and the intracluster
statistics. Last, `parallel/` on two ranks sharing the card (spawned
processes in a gloo group; NCCL refuses two ranks on one GPU): the
tile-sharded frame in both tiers against `api.render`, a tile-sharded
step's gradients against one device's, the ring 3-NN at 200k, the
halo-exchange loss, and the frame on a one-rank nccl group
(`parallel_cases`); then `ShardedTrainer` over the data axis on the train
entry point's dataset, `fit_all_balls(mesh)` at Mp = 16384 and
`stylize_sweep(mesh)` on four styles, each against the one-device path
(`parallel_entry_point`). Their times are two ranks sharing one H100 through
gloo's host staging, not scaling figures.
Each entry point runs with the kernels' launch counts set to 0 just before
it and read just after. Every phase prints one
JSON line with its numbers and seconds; any failure raises and the script
exits non-zero. The last lines are the card's name and power limit as
nvidia-smi prints them, one `{"kernels": [...]}` line, and
`{"ok": true, "device": {...}}`.

Without CUDA, or without the rest of the repository beside it, the script
exits non-zero and prints no result. It imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import faulthandler
import hashlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
WATCHDOG_S = 1100  # dump every thread's stack and exit rather than hang

# NVIDIA H100 SXM data sheet: HBM rate and f32 (non-tensor-core) peak.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# K1 per (pixel, entry) pair: ~25 f32 operations plus one expf, counted as
# one more (csrc/blend_fwd.cu). The bound counts the pairs that add to the
# pixel (`k1_bound_contrib_ms`); `k1_bound_ms` counts every evaluated pair,
# as before the cull, and is kept for comparison with earlier runs.
K1_OPS_PER_PAIR = 26
# K1 at 200k / 800x800 must take less than this share of its device time
# with the cull off: the cull skips ~56% of the walk's iterations there.
K1_CULL_MAX_TIME_SHARE = 0.85
# K2 per evaluated pair (csrc/blend_bwd.cu): the recompute of power, alpha
# and T (~18 with the expf), q and its prefix (9), dL/dpower with its
# division (7), the ten per-pixel values (12), their sum over the tile's
# pixels (10 additions), and ~4 compares and selects.
K2_OPS_PER_PAIR = 60
K2_TOL = 1e-3  # K2 vs plain: max error per column over that column's max |value|
# K3 vs float64 index_add_: each row within the worst-case error of a float32
# sum of its segment (`compare_k3`); a single rounding can reach the bound,
# so the slack only covers the float64 reference's own rounding.
K3_BOUND_SLACK = 1.0 + 1e-6
GRAD_COLS = 10  # gradient columns of the [K, 12] rows that K3 reduces
TRAIN_ITERS = 300  # train entry point: densify at 200 and 300
# K4 / K5 vs plain: the JAX package's own tolerances for its kernel against
# the streaming path (tests/test_stylize.py::test_desc_kernel_matches_streaming).
K45_LOSS_RTOL = 1e-5
K45_GRAD_ATOL_REL = 1e-4  # of the plain gradient's max |value|
# K4 / K5 vs float64 on near-coincident points: each kernel and its plain
# version are one float32 evaluation of the same formula, so either may land
# nearer the float64 value by a few roundings; the kernel may exceed the
# plain version's error by this much (of max |g|, or relative for the loss).
NEAR_SLACK_REL = 1e-6
# Float operations per pair, counted in the sources: K4 (csrc/desc_loss.cu,
# the pairs j > i of the list) spends ~20 on W_ij + W_ji (4 conversions, 4
# products, 3 sums) and T (3 differences, 3 squares, 2 sums, a root) once
# per pair and ~13 per ball on D (9), the difference, its square, the
# weight and the sum; K5 (csrc/desc_grad.cu, every entry) ~20 on W (both
# directions) and T, ~20 per ball on the differences, D, R and the three
# products and sums.
K4_OPS_PER_PAIR, K4_OPS_PER_PAIR_BALL = 20, 13
K5_OPS_PER_PAIR, K5_OPS_PER_PAIR_BALL = 20, 20
STYLE_MP = 16384  # cli.stylize's default --max_style_points
STYLE_BATCH = 8  # cli.stylize's default --batch_size
STYLE_FIT_STEPS = 1000
# The JAX stylize gate's record (runs/stylegate_r5_head/stylize_gate.json,
# TPU v5e; quality numbers of the reference, not the port's): 12 balls,
# descriptor loss 16.6x lower, edge-length W1 2.3x lower, coverage 1.000.
JAX_GATE = {"balls": 12, "desc_loss_reduction_x": 16.6, "edge_w1_reduction_x": 2.3,
            "domain_coverage_frac": 1.0}
GATE_MIN = {"desc_loss_reduction_x": 12.0, "edge_w1_reduction_x": 1.5,
            "domain_coverage_frac": 0.99}
ENTRY_STYLE_M = 18_000  # cleaning keeps ~16.6k, cli.stylize subsamples to 16384
N_INIT = 100_000  # train entry point: random init cloud, as the Blender loader makes it

FULL_N = 200_000  # bench.py's scene at BENCH_N=200000, BENCH_RES=800x800
FULL_RES = 800
WARMUP, FRAMES = 3, 20
TOL_MAX, TOL_MEAN, TOL_DEPTH = 2e-3, 1e-5, 2e-2
# The bf16 tier against its plain versions. K1f must equal its plain version
# bit for bit (`compare_k1`): both round at the same points, in the same
# order, and read the same tables. K2f sums its moments over the tile's
# pixels in another order than its plain version, so a row gradient may land
# one bf16 step (2^-8 of itself) away.
K2F_TOL = 1e-2  # of each gradient column's max |value|
CLI_TIER_TOL = 3e-2  # `cli.render` --fast against --no-fast, the tier's own bound
# K1f and K2f per pair: the operations of the function (`blend.py`'s module
# docstring), each table lookup counted as one, those on two bf16 operands
# (the products, min, 1 - alpha, q's sums, and rounding power) at the bf16x2
# rate, twice the f32 rate (two lanes per instruction), the rest at the f32
# rate. K1f per contributing pair: f32 dx, dy and power (11), the skip and
# stop compares (3), three lookups (E[power], E[logT], L[alpha]), rounding
# log T (1), four f32 multiply-adds (8) and the log T sum (1): 27; bf16:
# rounding power, opa E, min, 1 - alpha, T (1 - alpha), alpha T: 6. K2f per
# evaluated pair: the same recompute (f32 11 + 3 + 3 + 1 + 1, bf16 6), q (4
# products, 3 sums) and q w, q T (bf16 9), the prefix sum, 1 - alpha, the
# difference, division, subtraction and product of dL/dpower and the clamp
# test (f32 7), the nine products of the ten values and their ten sums over
# the tile's pixels (f32 19): f32 45, bf16 15.
K1F_OPS_PER_PAIR = {"f32": 27, "bf16": 6}
K2F_OPS_PER_PAIR = {"f32": 45, "bf16": 15}
BF16X2_OPS_PER_S = 2 * F32_OPS_PER_S
FAST_ROW_BYTES = 32  # [K, 16] bf16 rows


def fast_ops_ms(ops_per_pair, pairs):
    """Least time for `pairs` pairs of the bf16 tier's operations at the
    card's f32 and bf16x2 rates."""
    return (ops_per_pair["f32"] / F32_OPS_PER_S
            + ops_per_pair["bf16"] / BF16X2_OPS_PER_S) * pairs * 1e3


PIPELINE_ITERS = 300  # cli.pipeline: iterations of each reconstruction
PIPELINE_FRAMES = 8  # cli.pipeline: turntable frames
PIPELINE_CLUSTERS = 12  # style clusters: cluster 0 holds ~3,500 of the 60,000 points
STYLE_SCENE_N = 60_000  # the pipeline's style scene: a seeded torus
# cli.metrics on the card against evaluate_dir on the CPU, on the same PNGs:
# the same float32 formulas in another summation order.
EVAL_TOL = {"PSNR": 1e-3, "SSIM": 1e-5, "LPIPS_PROXY": 1e-5}
# LPIPS_PROXY is ~2e-5 on these views, under its absolute limit whatever the
# precision, so it is also held relative to its value. On these views an
# NVIDIA H100 80GB HBM3 (700 W) gave a float32 LPIPS 1.6e-7 of itself from
# the CPU's, and with its convolutions in TF32 4.7e-5
# (`lpips_unguarded_tf32_vs_cpu_rel`); the limit sits ~15-20x from each.
LPIPS_REL_TOL = 3e-6
REFINE_STEPS = 10  # refine: steps of each mode
REFINE_VIEWS = 3  # refine: views around the shell, each a K1 render of the jittered copy
DEPTH_BLUR_SIGMA = 2.0  # refine: the target depth is the jittered copy's, blurred
TELEPORT_K = 500  # refine: cluster_teleport's K, the reference's
# A teleported style cluster's mean minus its content centre is its style
# mean minus its style centre, up to two float32 roundings of coordinates
# below 2.5 (ulp 2.4e-7): held to TELEPORT_SHIFT_TOL. That remainder is
# Lloyd's own: after 100 iterations a member still switching clusters moves
# its mean by about its distance from the centre over the count, below
# 0.08 / 100 here: the mean must lie within TELEPORT_MEAN_TOL of the centre.
TELEPORT_SHIFT_TOL = 1e-6
TELEPORT_MEAN_TOL = 1e-3


# `device_ms`'s profiler sessions since the last emitted line: all, and those
# that recorded nothing and were taken again.
PROFILER_SESSIONS = {"profiler_sessions": 0, "profiler_empty_sessions": 0}


def emit(phase: str, t0: float, **numbers) -> None:
    numbers["seconds"] = time.perf_counter() - t0
    if PROFILER_SESSIONS["profiler_sessions"]:
        numbers.update(PROFILER_SESSIONS)
        PROFILER_SESSIONS.update(profiler_sessions=0, profiler_empty_sessions=0)
    print(json.dumps({"phase": phase, **numbers}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---- scenes (numpy, seeded) ------------------------------------------------

def scene_arrays(xyz, rgb, scale, opacity):
    """Per-Gaussian arrays in the PLY parameterisation (log scale, logit
    opacity, SH DC from RGB, zero higher SH, identity rotations)."""
    from wast3d_tpu_torch.core.sh import rgb_to_sh

    n = len(xyz)
    opacity = np.asarray(opacity, np.float64)
    return dict(
        xyz=np.asarray(xyz, np.float32),
        features_dc=rgb_to_sh(np.asarray(rgb, np.float32))[:, None, :].astype(np.float32),
        features_rest=np.zeros((n, 15, 3), np.float32),
        scaling=np.log(np.asarray(scale, np.float32)),
        rotation=np.tile(np.array([[1, 0, 0, 0]], np.float32), (n, 1)),
        opacity=np.log(opacity / (1.0 - opacity)).astype(np.float32),
    )


def random_scene(n=200, seed=0):
    rng = np.random.default_rng(seed)
    return scene_arrays(
        xyz=rng.normal(size=(n, 3)) * 1.2 * np.array([1, 1, 0.5]),
        rgb=rng.uniform(0.1, 0.9, (n, 3)), scale=rng.uniform(0.03, 0.12, (n, 3)),
        opacity=rng.uniform(0.3, 0.95, (n, 1)))


def saturating_scene(n=100, seed=4):
    rng = np.random.default_rng(seed)
    xyz = np.concatenate([rng.normal(size=(n, 2)) * 0.05, np.linspace(-1, 1, n)[:, None]], 1)
    return scene_arrays(xyz=xyz, rgb=rng.uniform(0.2, 1.0, (n, 3)),
                        scale=np.full((n, 3), 0.3), opacity=np.full((n, 1), 0.95))


def corner_scene(n=6, seed=5):
    """A few small splats in one corner of the view: most tiles stay empty."""
    rng = np.random.default_rng(seed)
    xyz = np.concatenate([rng.uniform(-1.6, -1.3, (n, 2)), np.zeros((n, 1))], 1)
    return scene_arrays(xyz=xyz, rgb=rng.uniform(0.2, 1.0, (n, 3)),
                        scale=np.full((n, 3), 0.05), opacity=np.full((n, 1), 0.8))


def bench_scene(n=FULL_N, seed=0):
    """The seeded sphere shell of bench.py::_build, SH degree 3."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)).astype(np.float32)
    pts /= np.maximum(np.linalg.norm(pts, axis=1, keepdims=True), 1e-6)
    pts *= rng.uniform(0.8, 1.2, (n, 1)).astype(np.float32)
    size_scale = (200_000 / n) ** 0.5
    rgb = rng.uniform(0.2, 0.8, (n, 3))
    scale = rng.uniform(0.004, 0.012, (n, 3)) * size_scale
    opacity = rng.uniform(0.4, 0.9, (n, 1))
    return scene_arrays(xyz=pts, rgb=rgb, scale=scale, opacity=opacity)


def make_scene(arrays, device, sh_degree=3):
    from wast3d_tpu_torch.scene.gaussians import from_arrays

    return from_arrays(**arrays, max_sh_degree=3, active_sh_degree=sh_degree, device=device)


def view_camera(w, h, device, eye=(0, 0, -5), fov=0.8):
    from wast3d_tpu_torch.core.camera import look_at_camera

    return look_at_camera(eye=list(eye), target=[0, 0, 0], up=[0, -1, 0], fovx=fov,
                          fovy=fov, width=w, height=h, device=device)


# ---- K1 against its plain version ----------------------------------------

def kernel_inputs(scene, cam, offsets=None, fast=False):
    """The exact inputs the main path hands K1 (K1f, on its bf16 rows, with
    `fast`) for this view."""
    from wast3d_tpu_torch.ops.rasterizer import api, render_path

    prep = api.preprocess_scene(cam, scene)
    binning, rows = render_path.bin_and_pack(prep, cam.width, cam.height,
                                             jittered=offsets is not None, fast=fast)
    return rows, binning.tile_start, binning.tile_end, cam.width, cam.height, offsets


def k1_walk_all(rows, starts, ends, w, h, bg, offsets, fast=False):
    """K1 (K1f with `fast`) with its cull off (`w3d_blend_fwd_walk_all`,
    `w3d_blend_fwd_fast_walk_all`: every warp walks every entry), on inputs
    the wrapper has checked. Launched only here, to show that the cull
    changes no bit; counted nowhere."""
    from wast3d_tpu_torch import _build
    from wast3d_tpu_torch.ops.rasterizer.binning import tile_grid
    from wast3d_tpu_torch.ops.rasterizer.blend import BlendOutput, fast_tables

    lib = _build.load_library()
    dev = rows.device
    out = BlendOutput(*(torch.empty(shape, device=dev) for shape in ((h, w, 3), (h, w), (h, w))))
    grid_x, grid_y = tile_grid(w, h)
    entry = lib.w3d_blend_fwd_fast_walk_all if fast else lib.w3d_blend_fwd_walk_all
    tables = (fast_tables(dev).data_ptr(),) if fast else ()
    err = entry(
        rows.data_ptr(), starts.data_ptr(), ends.data_ptr(),
        None if offsets is None else offsets.data_ptr(), bg.data_ptr(), *tables,
        *(t.data_ptr() for t in out), w, h, grid_x, grid_x * grid_y,
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"K1 walk-all launch failed: CUDA error {err}")
    return out


def bitwise_equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def sha256_of(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def k1_pair(fast):
    """(kernel wrapper, plain version, name, (max, mean, depth) tolerances)
    of K1, or of K1f with `fast`, whose tolerance is bitwise equality."""
    from wast3d_tpu_torch.ops.rasterizer import blend

    if fast:
        return (blend.blend_fwd_fast, blend.blend_fwd_fast_reference, "K1f", (0.0, 0.0, 0.0))
    return blend.blend_fwd, blend.blend_fwd_reference, "K1", (TOL_MAX, TOL_MEAN, TOL_DEPTH)


def compare_k1(inputs, bg, fast=False):
    """Kernel twice, the kernel with its cull off, and the plain version on
    the same inputs (K1, or K1f with `fast`); raises past tolerance (for K1f,
    on any bit that differs from its plain version: the two round at the
    same points and read the same tables), or if the two kernel runs or the
    kernel and its walk-all differ in any bit. Returns ({field: (max, mean)}
    absolute errors, the kernel's output, whether kernel and plain version
    agree bit for bit)."""
    fwd, plain, name, (tol_max, tol_mean, tol_depth) = k1_pair(fast)
    rows, starts, ends, w, h, offsets = inputs
    k = fwd(rows, starts, ends, w, h, bg, offsets)
    k_again = fwd(rows, starts, ends, w, h, bg, offsets)
    walk_all = k1_walk_all(rows, starts, ends, w, h, bg, offsets, fast)
    p = plain(rows, starts, ends, w, h, bg, offsets)
    torch.cuda.synchronize()
    if not bitwise_equal(k, k_again):
        raise AssertionError(f"{name}: two runs on the same inputs differ")
    if not bitwise_equal(k, walk_all):
        raise AssertionError(f"{name}: the culled walk and the walk of every entry differ")
    errs = {}
    for field, a, b in zip(("color", "depth", "final_T"), k, p):
        if not torch.isfinite(a).all():
            raise AssertionError(f"{name} {field}: non-finite values")
        d = (a - b).abs()
        errs[field] = (float(d.max()) if d.numel() else 0.0,
                       float(d.mean()) if d.numel() else 0.0)
    for field in ("color", "final_T"):
        mx, mean = errs[field]
        if mx > tol_max or mean > tol_mean:
            raise AssertionError(f"{name} {field} vs plain: max {mx} mean {mean} "
                                 f"(limits {tol_max}, {tol_mean})")
    if errs["depth"][0] > tol_depth:
        raise AssertionError(f"{name} depth vs plain: max {errs['depth'][0]} "
                             f"(limit {tol_depth})")
    bitwise = bitwise_equal(k, p)
    if fast and not bitwise:
        raise AssertionError(f"{name}: not bit-equal to its plain version")
    return errs, k, bitwise


def k1_cases(device, fast=False):
    """The small cases' background and {name: K1's inputs} (K1f's, with its
    bf16 rows, with `fast`)."""
    bg = torch.tensor([0.2, 0.5, 0.9], device=device)

    def inputs(scene, cam, offsets=None):
        return kernel_inputs(scene, cam, offsets, fast)

    cases = {}
    cases["random_64"] = inputs(make_scene(random_scene(), device), view_camera(64, 64, device))
    cases["nonmultiple_50x34"] = inputs(make_scene(random_scene(seed=1), device),
                                        view_camera(50, 34, device))
    cases["saturating_32"] = inputs(make_scene(saturating_scene(), device),
                                    view_camera(32, 32, device))
    off = -np.random.default_rng(7).uniform(0, 1, (48, 64, 2)).astype(np.float32)
    cases["jitter_64x48"] = inputs(make_scene(random_scene(seed=2), device),
                                   view_camera(64, 48, device), torch.from_numpy(off).to(device))
    cases["empty_tiles_96"] = inputs(make_scene(corner_scene(), device),
                                     view_camera(96, 96, device))
    behind = random_scene(seed=3)
    behind["xyz"][:, 2] = -9.0  # everything behind the camera: no rows at all
    cases["no_rows_64"] = inputs(make_scene(behind, device), view_camera(64, 64, device))
    return bg, cases


def cull_edges_case(device, w=64, h=48, per_tile=150, seed=9, fast=False):
    """K1 inputs (K1f's with `fast`: the same rows recentred and rounded by
    `render_path.fast_rows`) built as rows, to test the cull at its edges: per tile,
    thin rotated splats (|B| near sqrt(AC)) with opacities from 1/255 to
    2/255, some exactly 1/255 and some just below, jitter offsets in
    [-1, 1], and hand-made rows the cull must keep: conics that are not
    positive definite, infinite A or B, and A too large for the cull's
    terms. Each infinite row's mean lies beyond every sample of its tile,
    so that dx and dy are never 0 and kernel and plain version take the
    same infinities. Returns (inputs, index of the hand-made rows)."""
    from wast3d_tpu_torch.ops.rasterizer.binning import TILE, tile_grid

    rng = np.random.default_rng(seed)
    grid_x, grid_y = tile_grid(w, h)
    a255 = float(np.float32(1.0 / 255.0))
    rows, special, starts, ends = [], [], [], []
    for t in range(grid_x * grid_y):
        x0, y0 = (t % grid_x) * TILE, (t // grid_x) * TILE
        theta = rng.uniform(0, np.pi, per_tile)
        l1 = 1.0 / rng.uniform(3.0, 30.0, per_tile) ** 2
        l2 = 1.0 / rng.uniform(0.2, 1.5, per_tile) ** 2
        cs_, sn = np.cos(theta), np.sin(theta)
        opa = rng.uniform(a255, 2 * a255, per_tile)
        opa[::10] = a255
        opa[5::10] = a255 * (1 - rng.uniform(0, 1e-6, len(opa[5::10])))
        thin = np.zeros((per_tile, 12))
        thin[:, 0] = x0 + rng.uniform(-6, 22, per_tile)
        thin[:, 1] = y0 + rng.uniform(-6, 22, per_tile)
        thin[:, 2] = l1 * cs_ ** 2 + l2 * sn ** 2
        thin[:, 3] = (l1 - l2) * sn * cs_
        thin[:, 4] = l1 * sn ** 2 + l2 * cs_ ** 2
        thin[:, 5] = opa
        thin[:, 6] = rng.uniform(1, 5, per_tile)
        thin[:, 7:10] = rng.uniform(0.1, 0.9, (per_tile, 3))
        cx, cy = x0 + 5.25, y0 + 9.75  # inside the tile
        ox, oy = x0 - 2.5, y0 - 2.5  # beyond every sample of the tile
        inf = np.inf
        hand = np.array([  # mx, my, A, B, C, opa
            [cx, cy, 0.3, 0.0, -0.05, 0.6],  # indefinite
            [cx, cy, 0.1, 0.2, 0.1, 0.5],  # B^2 > AC
            [cx, cy, -0.1, 0.0, -0.1, 0.7],  # negative definite
            [cx, cy, 0.2, 0.3, 0.2, a255 * 0.999],  # not positive definite, opa < 1/255
            [ox, oy, inf, 0.0, 0.1, 0.8],
            [ox, oy, 0.1, inf, 0.1, 0.8],
            [ox, oy, 0.1, -inf, 0.1, 0.8],
            [ox, oy, 0.1, 0.0, inf, 0.8],
            [ox, oy, 1e32, 0.0, 0.1, 0.8],  # finite, but past the cull's 1e30 bound on terms
        ])
        extra = np.zeros((len(hand), 12))
        extra[:, :6] = hand
        extra[:, 6] = rng.uniform(1, 5, len(hand))
        extra[:, 7:10] = rng.uniform(0.1, 0.9, (len(hand), 3))
        tile_rows = np.concatenate([thin, extra])
        order = rng.permutation(len(tile_rows))
        starts.append(sum(len(r) for r in rows))
        special.extend(starts[-1] + np.flatnonzero(order >= per_tile))
        rows.append(tile_rows[order])
        ends.append(starts[-1] + len(tile_rows))
    off = rng.uniform(-1, 1, (h, w, 2))
    as_t = lambda a, dt: torch.from_numpy(np.asarray(a, dt)).to(device)  # noqa: E731
    rows = as_t(np.concatenate(rows), np.float32)
    if fast:
        from wast3d_tpu_torch.ops.rasterizer.render_path import fast_rows

        tiles = torch.repeat_interleave(torch.arange(len(starts), device=device),
                                        torch.tensor(np.subtract(ends, starts), device=device))
        rows = fast_rows(rows, tiles, w)
    inputs = (rows, as_t(starts, np.int32), as_t(ends, np.int32), w, h, as_t(off, np.float32))
    return inputs, torch.from_numpy(np.asarray(special, np.int64)).to(device)


def phase_k1_cases(device, fast=False):
    """K1 (K1f with `fast`) against its plain version on the seven cases."""
    from wast3d_tpu_torch.ops.rasterizer.blend import warp_boxes, warp_keep_reference

    t0 = time.perf_counter()
    bg, cases = k1_cases(device, fast)
    cases["cull_edges"], special = cull_edges_case(device, fast=fast)
    out = {}
    for name, inputs in cases.items():
        rows, starts, ends = inputs[:3]
        errs, k, bitwise = compare_k1(inputs, bg, fast)
        out[name] = {"K": int(rows.shape[0]),
                     "empty_tiles": int((ends == starts).sum()),
                     "final_T_min": float(k.final_T.min()),
                     "bitwise_equal_to_plain": bitwise,
                     **{f"{f}_max": e[0] for f, e in errs.items()},
                     **{f"{f}_mean": e[1] for f, e in errs.items()}}
    if out["empty_tiles_96"]["empty_tiles"] == 0:
        raise AssertionError("the empty-tiles case has no empty tile")
    if out["saturating_32"]["final_T_min"] >= 1e-3:
        raise AssertionError("the saturating case never reached the early stop")
    # The cull on the edge case, by its plain version: it must cull some
    # (entry, warp) pairs, keep some, and keep every hand-made row.
    rows, starts, ends, w, h, offsets = cases["cull_edges"]
    keep = warp_keep_reference(rows, starts, ends, w, h, offsets, fast)
    tiles = torch.repeat_interleave(torch.arange(len(starts), device=device),
                                    (ends - starts).long())  # the rows are the tiles' ranges
    boxes = warp_boxes(w, h, offsets, device, local=fast)
    live = (boxes[..., 0] <= boxes[..., 1])[tiles]  # [K, warps]: the warp has a pixel inside
    kept, culled = int((keep & live).sum()), int((~keep & live).sum())
    if kept == 0 or culled == 0:
        raise AssertionError(f"cull_edges: {kept} (entry, warp) pairs kept, {culled} culled; "
                             f"the case must have both")
    if not bool(keep[special][live[special]].all()):
        raise AssertionError("cull_edges: a hand-made row the cull must keep is culled")
    out["cull_edges"].update(pairs_kept=kept, pairs_culled=culled,
                             hand_made_rows=int(special.numel()))
    tol_max, tol_mean, tol_depth = k1_pair(fast)[3]
    emit("k1_fast_vs_plain" if fast else "k1_vs_plain", t0, cases=out,
         tolerance="bitwise" if fast else {"color_final_T_max": tol_max, "mean": tol_mean,
                                           "depth_max": tol_depth},
         runs_bitwise_equal=True, walk_all_bitwise_equal=True)


# ---- K2 and K3 against their plain versions -------------------------------

def k2_cotangents(h, w, device, seed):
    """Seeded cotangents of colour, depth and final_T."""
    from wast3d_tpu_torch.ops.rasterizer.blend import BlendOutput

    rng = np.random.default_rng(seed)
    arrays = (rng.normal(size=(h, w, 3)), rng.normal(size=(h, w)) * 0.1,
              rng.normal(size=(h, w)))
    return BlendOutput(*(torch.from_numpy(a.astype(np.float32)).to(device) for a in arrays))


def k2_pair(fast):
    """(forward kernel, backward kernel, backward plain version, name,
    tolerance) of K2, or of K2f with `fast`."""
    from wast3d_tpu_torch.ops.rasterizer import blend

    if fast:
        return (blend.blend_fwd_fast, blend.blend_bwd_fast, blend.blend_bwd_fast_reference,
                "K2f", K2F_TOL)
    return blend.blend_fwd, blend.blend_bwd, blend.blend_bwd_reference, "K2", K2_TOL


def compare_k2(inputs, bg, grads, fast=False):
    """K2 (K2f with `fast`) twice and its plain version on the same inputs
    (K1's, or K1f's, output as the forward); raises past its tolerance or
    if the two kernel runs differ in any bit. Returns (max error over
    columns, relative to each column's max; the kernel's output)."""
    fwd, bwd, plain, name, tol = k2_pair(fast)
    rows, starts, ends, w, h, offsets = inputs
    out = fwd(rows, starts, ends, w, h, bg, offsets)
    k = bwd(rows, starts, ends, w, h, bg, offsets, out, grads)
    k_again = bwd(rows, starts, ends, w, h, bg, offsets, out, grads)
    p = plain(rows, starts, ends, w, h, bg, offsets, out, grads)
    torch.cuda.synchronize()
    if not torch.isfinite(k).all():
        raise AssertionError(f"{name}: non-finite values")
    if not torch.equal(k, k_again):
        raise AssertionError(f"{name}: two runs on the same inputs differ")
    if k.numel() and (k[:, GRAD_COLS:] != 0).any():
        raise AssertionError(f"{name}: padding columns not zero")
    rel = 0.0
    k32, p32 = k.float(), p.float()  # K2f's rows are bf16
    for col in range(GRAD_COLS):
        scale = float(p32[:, col].abs().max()) if p.numel() else 0.0
        err = float((k32[:, col] - p32[:, col]).abs().max()) if p.numel() else 0.0
        rel = max(rel, err / scale if scale > 0 else err)
    if rel > tol:
        raise AssertionError(f"{name} vs plain: {rel} of the column max (limit {tol})")
    return rel, k


def phase_k2_cases(device, fast=False):
    """K2 (K2f with `fast`) against its plain version on the six K1 cases
    that have finite rows, over two backgrounds."""
    t0 = time.perf_counter()
    _, cases = k1_cases(device, fast)
    out = {}
    for bg_value in (0.0, 1.0):
        bg = torch.full((3,), bg_value, device=device)
        for i, (name, inputs) in enumerate(cases.items()):
            rows, _, _, w, h, _ = inputs
            rel, k = compare_k2(inputs, bg, k2_cotangents(h, w, device, seed=i), fast)
            out[f"{name}_bg{int(bg_value)}"] = {
                "K": int(rows.shape[0]), "max_rel_err": rel,
                "max_abs_grad": float(k.abs().max()) if k.numel() else 0.0}
    emit("k2_fast_vs_plain" if fast else "k2_vs_plain", t0, cases=out,
         tolerance_rel_to_column_max=k2_pair(fast)[4], runs_bitwise_equal=True)


def k3_case_arrays():
    """Seeded edge cases of `tests/test_grad_reduce.py` (d, ranks, n1)."""
    rng = np.random.default_rng(0)
    cases = {}
    for k, n1 in ((64, 40), (1000, 300), (5000, 4000)):
        cases[f"random_{k}_{n1}"] = (rng.normal(size=(k, GRAD_COLS)),
                                     rng.integers(0, n1, k), n1)
    cases["giant_segment"] = (np.ones((2000, GRAD_COLS)) * np.linspace(0.5, 1.5, GRAD_COLS),
                              np.full(2000, 7), 100)
    ranks = np.sort(rng.choice(100_000, size=512, replace=False))
    rng.shuffle(ranks)
    cases["sparse_jumps"] = (rng.normal(size=(512, GRAD_COLS)), ranks, 100_000)
    cases["n1_multiple_of_128"] = (rng.normal(size=(300, GRAD_COLS)),
                                   rng.integers(0, 256, 300), 256)
    cases["k_zero"] = (np.zeros((0, GRAD_COLS)), np.zeros(0), 50)
    return cases


def compare_k3(d, rank, n1, mode, segments=None):
    """One rank-major reduction twice (on the bare-rank route, or on
    `segments`) against float64 `index_add_`; raises
    if the two runs differ in any bit or if a row's error exceeds the
    worst-case bound of summing its segment in float32 in some order,
    gamma_(n-1) sum |values| with gamma_m = m u / (1 - m u), u = 2^-24 and
    n the segment's length (times K3_BOUND_SLACK). The bf16
    wrapper is held to the float64 sum of the bf16-rounded values. Returns
    the largest error as a fraction of that bound."""
    from wast3d_tpu_torch.ops.rasterizer import grad_reduce

    def run():
        if segments is None:
            return grad_reduce.reduce(d, rank, n1, mode)
        return grad_reduce.reduce_segments(d, segments, mode)

    a, b = run(), run()
    ref_in = d.to(torch.bfloat16).to(torch.float32) if mode == "segsum_sortpacked" else d
    ref = torch.zeros((n1, d.shape[1]), dtype=torch.float64, device=d.device)
    ref.index_add_(0, rank, ref_in.to(torch.float64))
    mag = torch.zeros_like(ref).index_add_(0, rank, ref_in.to(torch.float64).abs())
    count = torch.zeros(n1, dtype=torch.float64, device=d.device).index_add_(
        0, rank, torch.ones_like(rank, dtype=torch.float64))
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        raise AssertionError(f"K3 ({mode}): two runs on the same inputs differ")
    nu = (count - 1).clamp_min(1)[:, None] * 2.0 ** -24
    bound = nu / (1.0 - nu) * mag  # gamma_(n-1), the recursive-summation bound
    err = (a.to(torch.float64) - ref).abs()
    if bool((err[mag == 0] != 0).any()):
        raise AssertionError(f"K3 ({mode}): a row with no duplicates is not zero")
    ratio = float((err[mag > 0] / bound[mag > 0]).max()) if bool((mag > 0).any()) else 0.0
    if ratio > K3_BOUND_SLACK:
        raise AssertionError(f"K3 ({mode}) vs float64 index_add_: {ratio} of the float32 "
                             f"summation bound (limit {K3_BOUND_SLACK})")
    return ratio


def phase_k3_cases(device):
    from wast3d_tpu_torch.ops.rasterizer import grad_reduce

    t0 = time.perf_counter()
    out = {}
    for name, (d, ranks, n1) in k3_case_arrays().items():
        dt = torch.from_numpy(d.astype(np.float32)).to(device)
        rt = torch.from_numpy(ranks.astype(np.int64)).to(device)
        out[name] = {"K": int(d.shape[0]), "n1": n1, **{
            mode: compare_k3(dt, rt, n1, mode)
            for mode in ("segsum", "segsum_sortpayload", "segsum_sortpacked")}}
    # The render path's layout: 10 of 12 columns (row stride 12, 16-byte
    # loads) read through idx, against the gathered rows (stride 10, scalar
    # loads): the same sums in the same order, so the same bits. Segments
    # of 1 to 400 rows, so both the thread and the warp split run.
    rng = np.random.default_rng(1)
    full = torch.from_numpy(rng.normal(size=(30000, 12)).astype(np.float32)).to(device)
    rank = torch.from_numpy(np.minimum(rng.geometric(0.004, 30000), 700) - 1).to(device)
    seg = grad_reduce.rank_segments(rank, 700)
    view = full[:, :GRAD_COLS]
    if not grad_reduce._vector_rows(view):
        raise AssertionError("K3: the render path's rows do not take 16-byte loads")
    a = grad_reduce.segment_sum(view, seg)
    b = grad_reduce.segment_sum(view[seg.idx].contiguous(), seg._replace(idx=None))
    c = grad_reduce.segment_sum(view, seg._replace(idx=None, perm=torch.argsort(seg.idx)))
    # The same segments as each position's segment (the binning route's
    # form), output rows in a shuffled order.
    shuffle = torch.from_numpy(rng.permutation(700)).to(device)
    by_position = grad_reduce.Segments(None, shuffle, seg.idx, None,
                                       rank[seg.idx.long()].contiguous())
    e = grad_reduce.segment_sum(view, by_position)
    none = grad_reduce.segment_sum(view, by_position._replace(
        idx=None, segment_of=rank[:0].contiguous()))
    ref = grad_reduce.segment_sum_reference(view, seg)
    torch.cuda.synchronize()
    if bool(none.any()):
        raise AssertionError("K3: segments with no positions are not zero")
    if not (torch.equal(a, b) and torch.equal(a, c) and torch.equal(a[shuffle], e)):
        raise AssertionError("K3: 16-byte and scalar loads, idx and the inverse of perm, or "
                             "offsets and segment_of give different bits")
    strided_err = float((a - ref).abs().max())
    if strided_err > 1e-4:
        raise AssertionError(f"K3 on strided rows: {strided_err}")
    emit("k3_vs_index_add_f64", t0, cases=out, strided_idx_max_abs_err=strided_err,
         longest_segment_strided_case=int(torch.diff(seg.offsets).max()),
         vector_and_scalar_loads_bitwise_equal=True, idx_and_inverted_perm_bitwise_equal=True,
         offsets_and_segment_of_bitwise_equal=True,
         error_as_fraction_of_f32_summation_bound=True, limit=K3_BOUND_SLACK,
         runs_bitwise_equal=True)


# ---- golden scene ------------------------------------------------------------

def psnr(a, b) -> float:
    return float(20.0 * math.log10(1.0 / math.sqrt(float(((a - b) ** 2).mean()))))


def phase_golden(device, renderer="cuda"):
    from wast3d_tpu_torch.core.camera import make_camera
    from wast3d_tpu_torch.ops.rasterizer import api
    from wast3d_tpu_torch.scene.ply import load_ply

    t0 = time.perf_counter()
    gold = os.path.join(ROOT, "tests", "golden")
    data = np.load(os.path.join(gold, "render.npz"))
    scene = load_ply(os.path.join(gold, "scene.ply"), device=device).replace(active_sh_degree=3)
    cam = make_camera(data["R"], data["t"], fovx=float(data["fov"][0]),
                      fovy=float(data["fov"][1]), width=int(data["wh"][0]),
                      height=int(data["wh"][1]), device=device)
    out = api.render(cam, scene, torch.zeros(3), device=device,
                     settings=api.RasterizeSettings(renderer=renderer))
    color = out["render"].cpu().numpy()
    p = psnr(color, data["color"])
    d_err = float(np.abs(out["depth"].cpu().numpy() - data["depth"]).max())
    if not np.isfinite(color).all() or color.shape != data["color"].shape:
        raise AssertionError(f"golden render: shape {color.shape} or non-finite values")
    if not (p > 45.0 and d_err < 2e-2):
        raise AssertionError(f"golden gate failed: PSNR {p} (> 45), depth err {d_err} (< 2e-2)")
    emit("golden", t0, renderer=renderer, psnr=p, depth_max_err=d_err,
         n_gaussians=scene.capacity, width=cam.width, height=cam.height)


# ---- the oracle and render's options ---------------------------------------

ORACLE_N, ORACLE_RES = 2_000, 256  # K1 against the oracle
ORACLE_GRAD_CASES = ((40, 32, 4), (200, 64, 5))  # (n, res, seed): JAX's case first
ORACLE_GRAD_ATOL = 5e-5  # tests/test_rasterizer.py's tiled-vs-oracle gradient bound
OPTION_GRAD_TOL = 1e-3  # override_color's gradient, K2 + K3 vs plain: of each column's max


def xyz_grad(scene, cam, settings, device, target, bg):
    """d mean((render - target)^2) / d xyz through `api.render`."""
    from wast3d_tpu_torch.ops.rasterizer import api

    xyz = scene.xyz.clone().requires_grad_(True)
    out = api.render(cam, scene.replace(xyz=xyz), bg, settings=settings, device=device)
    (g,) = torch.autograd.grad(torch.mean((out["render"] - target) ** 2), [xyz])
    return g


def tile_edge_pixels(h, w, device):
    """[H, W] bool: the pixels in the first column or row of their tile."""
    ys = torch.arange(h, device=device)[:, None] % 16 == 0
    xs = torch.arange(w, device=device)[None, :] % 16 == 0
    return ys | xs


def phase_oracle_cases(device, n=ORACLE_N, res=ORACLE_RES):
    """The per-pixel oracle on the card as a second check of K1 and K2 that
    does not rest on their plain versions: the golden gate through the
    oracle; K1 (`api.render`, renderer "pallas") against the oracle on
    seeded scenes of `n` Gaussians at res x res, jitter off and on, within
    K1's limits; and the xyz gradient through K2 and K3 against the
    oracle's on JAX's own case (40 Gaussians at 32x32) within its 5e-5,
    with the largest difference at 200 Gaussians / 64x64 reported.

    Under jitter the binning (JAX's, reproduced) can leave out of a tile a
    Gaussian whose 1/255 contour reaches that tile's first column or row
    only through the jittered sample: the tight extent's +1 pixel for
    jitter is lost to the rect's rounding (`binning.compute_rects` includes
    tile t only if 16 t + 1 <= mean + extent). JAX's tiled renderer differs
    from JAX's oracle the same way on the same scene. So under jitter K1's
    limits hold on the pixels off the tiles' first column and row, and the
    tile-edge pixels' largest difference is reported. Returns {kernel
    name: launches} of the phase."""
    from wast3d_tpu_torch.ops.rasterizer import api

    t0 = time.perf_counter()
    phase_golden(device, renderer="oracle")
    reset_kernel_counts()
    kernel, oracle = api.RasterizeSettings(), api.RasterizeSettings(renderer="oracle")
    fwd = {}
    for jitter in (False, True):
        scene = make_scene(random_scene(n, seed=11 + int(jitter)), device, sh_degree=0)
        cam = view_camera(res, res, device)
        offsets = None
        if jitter:
            offsets = api.random_sampling_offsets(
                torch.Generator(device=device).manual_seed(3), res, res)
        bg = torch.tensor([0.2, 0.5, 0.8], device=device)
        with torch.no_grad():
            k = api.render(cam, scene, bg, settings=kernel, sampling_offsets=offsets,
                           device=device)
            o = api.render(cam, scene, bg, settings=oracle, sampling_offsets=offsets,
                           device=device)
        held = (~tile_edge_pixels(res, res, device) if jitter
                else torch.ones((res, res), dtype=torch.bool, device=device))
        errs = {key: float((k[key] - o[key]).abs()[held].max())
                for key in ("render", "final_T", "depth")}
        errs["render_mean"] = float((k["render"] - o["render"]).abs().mean())
        errs["final_T_over_1e-3"] = int(((k["final_T"] - o["final_T"]).abs() > 1e-3).sum())
        if jitter:
            edge = ~held
            errs["tile_edge_render_max"] = float((k["render"] - o["render"]).abs()[edge].max())
            errs["tile_edge_over_limit"] = int(
                ((k["render"] - o["render"]).abs().amax(-1) > TOL_MAX)[edge].sum())
        errs["covered_share"] = float((o["final_T"] < 0.5).float().mean())
        if not (errs["render"] <= TOL_MAX and errs["final_T"] <= TOL_MAX
                and errs["depth"] <= TOL_DEPTH and errs["covered_share"] > 0.1):
            raise AssertionError(f"K1 vs oracle, jitter {jitter}: {errs} (limits {TOL_MAX}, "
                                 f"depth {TOL_DEPTH})")
        fwd[f"jitter_{jitter}"] = errs
    grads = {}
    for gn, gres, seed in ORACLE_GRAD_CASES:
        scene = make_scene(random_scene(gn, seed=seed), device, sh_degree=0)
        cam = view_camera(gres, gres, device)
        target = torch.zeros((gres, gres, 3), device=device)
        bg = torch.zeros(3, device=device)
        g_k = xyz_grad(scene, cam, kernel, device, target, bg)
        g_o = xyz_grad(scene, cam, oracle, device, target, bg)
        torch.cuda.synchronize()
        grads[f"{gn}_at_{gres}"] = {"max_abs_diff": float((g_k - g_o).abs().max()),
                                    "max_abs_grad": float(g_o.abs().max())}
    jax_case = grads[f"{ORACLE_GRAD_CASES[0][0]}_at_{ORACLE_GRAD_CASES[0][1]}"]
    if not (jax_case["max_abs_diff"] <= ORACLE_GRAD_ATOL and jax_case["max_abs_grad"] > 0):
        raise AssertionError(f"K2 + K3 xyz gradient vs oracle: {grads} "
                             f"(limit {ORACLE_GRAD_ATOL} on JAX's case)")
    launches = kernel_counts()
    if any(launches[k] == 0 for k in TRAIN_KERNELS):
        raise AssertionError(f"oracle cases: a kernel was never launched: {launches}")
    emit("oracle_cases", t0, n_gaussians=n, width=res, height=res, k1_vs_oracle=fwd,
         limits={"color_final_T": TOL_MAX, "depth": TOL_DEPTH,
                 "xyz_grad_abs_jax_case": ORACLE_GRAD_ATOL},
         xyz_grad_vs_oracle=grads, launches=launches)
    return launches


def phase_api_options(device, n=FULL_N, res=FULL_RES):
    """`api.render`'s colour and covariance options at 200k / 800x800
    (bench.py's shell and camera): renders with `convert_shs_python`, with
    `compute_cov3d_python` and with `override_color` set to the default
    path's colours, each against the default render within K1's limits
    (and whether they are bit-equal); then the gradient with respect to
    `override_color` through K2 and K3 against renderer "tiled" on the
    card, each column within OPTION_GRAD_TOL of its max. The counts are set
    to 0 just before and read just after: K1, K2 and K3 must launch.
    Returns {kernel name: launches}."""
    from wast3d_tpu_torch.ops.rasterizer import api

    t0 = time.perf_counter()
    scene = make_scene(bench_scene(n), device)
    cam = view_camera(res, res, device, eye=(0, 0, -3), fov=0.9)
    bg = torch.zeros(3, device=device)
    with torch.no_grad():
        colors = api.preprocess_scene(cam, scene).colors.contiguous()
    cot = torch.from_numpy(np.random.default_rng(7).normal(
        size=(res, res, 3)).astype(np.float32)).to(device)
    t_setup = time.perf_counter() - t0

    reset_kernel_counts()
    with torch.no_grad():
        base = api.render(cam, scene, bg, device=device)
        variants = {"convert_shs_python": api.render(cam, scene, bg, convert_shs_python=True,
                                                     device=device),
                    "compute_cov3d_python": api.render(cam, scene, bg,
                                                       compute_cov3d_python=True,
                                                       device=device),
                    "override_color": api.render(cam, scene, bg, 1.0, colors, device=device)}
    renders = {}
    for name, out in variants.items():
        errs = {key: float((out[key] - base[key]).abs().max())
                for key in ("render", "final_T", "depth")}
        errs["bit_equal"] = all(torch.equal(out[key], base[key])
                                for key in ("render", "final_T", "depth"))
        if not (errs["render"] <= TOL_MAX and errs["final_T"] <= TOL_MAX
                and errs["depth"] <= TOL_DEPTH):
            raise AssertionError(f"{name} vs the default render: {errs}")
        renders[name] = errs

    def color_grad(renderer):
        c = colors.clone().requires_grad_(True)
        out = api.render(cam, scene, bg, 1.0, c, api.RasterizeSettings(renderer=renderer),
                         device=device)
        (g,) = torch.autograd.grad((out["render"] * cot).sum(), [c])
        return g

    g_k = color_grad("pallas")
    torch.cuda.synchronize()
    launches = kernel_counts()
    g_p = color_grad("tiled")
    rel = []
    for col in range(3):
        scale = float(g_p[:, col].abs().max())
        rel.append(float((g_k[:, col] - g_p[:, col]).abs().max()) / scale)
    if not (max(rel) <= OPTION_GRAD_TOL and bool(torch.isfinite(g_k).all())):
        raise AssertionError(f"override_color gradient, K2 + K3 vs tiled: {rel} of the "
                             f"column max (limit {OPTION_GRAD_TOL})")
    if any(launches[k] == 0 for k in TRAIN_KERNELS):
        raise AssertionError(f"api options: a kernel was never launched: {launches}")
    emit("api_options", t0, n_gaussians=n, width=res, height=res,
         vs_default_render=renders, override_color_grad_rel_err=rel,
         grad_tolerance_rel_to_column_max=OPTION_GRAD_TOL, launches=launches,
         setup_s=t_setup)
    return launches


# ---- full width --------------------------------------------------------------

def cuda_time_ms(fn, reps):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps):
    """The host's time to issue one call of `fn`, the device left to run
    behind it (no synchronisation inside the timed loop)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    issued = (time.perf_counter() - t) / reps * 1e3
    torch.cuda.synchronize()
    return issued


def phase_full_width(device, n=FULL_N, res=FULL_RES, warmup=WARMUP, frames=FRAMES):
    """Frames through `api.render`, then K1 alone against its plain version
    and its bound at this frame's inputs. Returns K1's kernels-line entry."""
    from wast3d_tpu_torch.ops.rasterizer import api, render_path
    from wast3d_tpu_torch.ops.rasterizer.blend import (
        blend_fwd, blend_fwd_reference, warp_walk_counts)

    t0 = time.perf_counter()
    scene = make_scene(bench_scene(n), device)
    cam = view_camera(res, res, device, eye=(0, 0, -3), fov=0.9)
    bg = torch.zeros(3, device=device)
    settings = api.RasterizeSettings(renderer="cuda")
    t_setup = time.perf_counter() - t0

    before = blend_fwd.launches
    frame_ms = []
    for i in range(warmup + frames):
        torch.cuda.synchronize()
        f0 = time.perf_counter()
        out = api.render(cam, scene, bg, settings=settings, device=device)
        torch.cuda.synchronize()
        if i >= warmup:
            frame_ms.append((time.perf_counter() - f0) * 1e3)
    launched = blend_fwd.launches - before
    if launched != warmup + frames:
        raise AssertionError(f"K1 launched {launched} times for {warmup + frames} frames")
    img = out["render"]
    if img.shape != (res, res, 3) or not torch.isfinite(img).all():
        raise AssertionError(f"frame: shape {tuple(img.shape)} or non-finite values")
    visible = int(out["visibility_filter"].sum())

    # Stage breakdown (CUDA events around each stage of the same path).
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    stage = {"preprocess": [], "binning_gather": [], "blend_k1": []}
    for _ in range(5):
        ev[0].record()
        prep = api.preprocess_scene(cam, scene)
        ev[1].record()
        binning, rows = render_path.bin_and_pack(prep, res, res)
        ev[2].record()
        blend_fwd(rows, binning.tile_start, binning.tile_end, res, res, bg)
        ev[3].record()
        torch.cuda.synchronize()
        for k, (a, b) in zip(stage, zip(ev[:-1], ev[1:])):
            stage[k].append(a.elapsed_time(b))

    inputs = (rows, binning.tile_start, binning.tile_end, res, res, bg)
    k1_ms = cuda_time_ms(lambda: blend_fwd(*inputs), 50)
    k1_device_ms = kernel_device_ms(lambda: blend_fwd(*inputs), "blend_fwd_kernel")
    walk_all_ms = cuda_time_ms(lambda: k1_walk_all(*inputs, None), 50)
    walk_all_device_ms = kernel_device_ms(lambda: k1_walk_all(*inputs, None), "blend_fwd_kernel")
    plain_ms = cuda_time_ms(lambda: blend_fwd_reference(*inputs), 3)
    errs, k, _ = compare_k1(inputs[:5] + (None,), bg)
    counts = warp_walk_counts(*inputs[:5])
    K, tiles = int(rows.shape[0]), int(binning.tile_start.shape[0])
    bytes_moved = 48 * K + 8 * tiles + 12 + 20 * res * res
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = K1_OPS_PER_PAIR * counts.evaluated_pairs / F32_OPS_PER_S * 1e3
    contrib_ops_ms = K1_OPS_PER_PAIR * counts.contributing_pairs / F32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, contrib_ops_ms)  # the work this run's data needs
    median = statistics.median(frame_ms)
    emit("full_width", t0, n_gaussians=n, visible=visible, width=res, height=res,
         sh_degree=3, duplicates_K=K, tiles=tiles, setup_s=t_setup,
         frame_ms_median=median, frame_ms_min=min(frame_ms), frame_ms_max=max(frame_ms),
         frames=frames, warmup=warmup, mpix_per_s=res * res / (median * 1e-3) / 1e6,
         stage_ms_median={k: statistics.median(v) for k, v in stage.items()},
         k1_ms=k1_ms, k1_device_ms=k1_device_ms, k1_walk_all_ms=walk_all_ms,
         k1_walk_all_device_ms=walk_all_device_ms, plain_ms=plain_ms,
         k1_bound_ms=max(bytes_ms, ops_ms), k1_bound_bytes_ms=bytes_ms, k1_bound_ops_ms=ops_ms,
         k1_bound_contrib_ms=bound_ms, k1_bound_contrib_ops_ms=contrib_ops_ms,
         evaluated_pairs=counts.evaluated_pairs,
         warp_iterations=counts.warp_iterations,
         warp_iterations_culled=counts.warp_iterations_culled,
         contributing_pairs=counts.contributing_pairs,
         k1_rows_sha256=sha256_of([rows, binning.tile_start, binning.tile_end]),
         k1_output_sha256=sha256_of(k), k1_launches_in_frames=launched,
         **{f"k1_{f}_max_err": e[0] for f, e in errs.items()})
    # The card's own cull at work: the iteration counts above are the plain
    # `warp_keep_reference`'s, and a cull that kept every entry would change
    # no bit, only the time (0.131 against 0.200 ms when it was measured).
    if not k1_device_ms < K1_CULL_MAX_TIME_SHARE * walk_all_device_ms:
        raise AssertionError(f"K1 {k1_device_ms:.4f} ms against {walk_all_device_ms:.4f} ms "
                             "with its cull off: the cull culls nothing on the card")
    return {"name": "blend_fwd", "route": "cuda", "source": "wast3d_tpu_torch/csrc/blend_fwd.cu",
            "replaces": "wast3d_tpu/ops/rasterizer/pallas_blend.py:402",
            "launches": None, "max_abs_err": max(e[0] for e in errs.values()),
            "ms": k1_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= contrib_ops_ms else "operations",
            "library_ms": None}


def phase_full_width_fast(device, n=FULL_N, res=FULL_RES, warmup=WARMUP, frames=FRAMES):
    """Frames through `api.render` in the bf16 tier (`fast_chain`), then K1f
    alone at this frame's inputs (its bf16 rows): against its plain version
    and against K1 on the same frame's f32 rows, both kernels timed in this
    call by events and by device. Returns K1f's kernels-line entry."""
    from wast3d_tpu_torch.ops.rasterizer import api, render_path
    from wast3d_tpu_torch.ops.rasterizer.blend import (
        blend_fwd, blend_fwd_fast, blend_fwd_fast_reference, fast_tables, warp_walk_counts)

    t0 = time.perf_counter()
    scene = make_scene(bench_scene(n), device)
    cam = view_camera(res, res, device, eye=(0, 0, -3), fov=0.9)
    bg = torch.zeros(3, device=device)
    settings = api.RasterizeSettings(renderer="pallas", fast_chain=True)

    before = dict(kernel_counts())
    frame_ms = []
    for i in range(warmup + frames):
        torch.cuda.synchronize()
        f0 = time.perf_counter()
        out = api.render(cam, scene, bg, settings=settings, device=device)
        torch.cuda.synchronize()
        if i >= warmup:
            frame_ms.append((time.perf_counter() - f0) * 1e3)
    launched = {k: v - before[k] for k, v in kernel_counts().items()}
    if launched != only(blend_fwd_fast=warmup + frames):
        raise AssertionError(f"launches {launched} for {warmup + frames} fast frames")
    img = out["render"]
    if img.shape != (res, res, 3) or not torch.isfinite(img).all():
        raise AssertionError(f"fast frame: shape {tuple(img.shape)} or non-finite values")

    prep = api.preprocess_scene(cam, scene)
    binning, rows = render_path.bin_and_pack(prep, res, res, fast=True)
    inputs = (rows, binning.tile_start, binning.tile_end, res, res, bg)
    inputs32 = (render_path.bin_and_pack(prep, res, res)[1],) + inputs[1:]
    k1_ms = cuda_time_ms(lambda: blend_fwd(*inputs32), 50)
    k1f_ms = cuda_time_ms(lambda: blend_fwd_fast(*inputs), 50)
    k1_device_ms = kernel_device_ms(lambda: blend_fwd(*inputs32), "blend_fwd_kernel")
    k1f_device_ms = kernel_device_ms(lambda: blend_fwd_fast(*inputs), "blend_fwd_fast_kernel")
    walk_all_device_ms = kernel_device_ms(lambda: k1_walk_all(*inputs, None, True),
                                          "blend_fwd_fast_kernel")
    plain_ms = cuda_time_ms(lambda: blend_fwd_fast_reference(*inputs), 3)
    errs, kf, bitwise = compare_k1(inputs[:5] + (None,), bg, fast=True)
    k = blend_fwd(*inputs32)
    vs_k1 = {f: (float((a - b).abs().max()), float((a - b).abs().mean()))
             for f, a, b in zip(("color", "depth", "final_T"), kf, k)}
    counts = warp_walk_counts(*inputs[:5], fast=True)
    K, tiles = int(rows.shape[0]), int(binning.tile_start.shape[0])
    table_bytes = fast_tables(device).numel() * 2
    bytes_ms = ((FAST_ROW_BYTES * K + table_bytes + 8 * tiles + 12 + 20 * res * res)
                / HBM_BYTES_PER_S * 1e3)
    ops_ms = fast_ops_ms(K1F_OPS_PER_PAIR, counts.contributing_pairs)
    bound_ms = max(bytes_ms, ops_ms)
    emit("full_width_fast", t0, n_gaussians=n, width=res, height=res, duplicates_K=K,
         frame_ms_median=statistics.median(frame_ms), frame_ms_min=min(frame_ms),
         frame_ms_max=max(frame_ms), frames=frames, launches_in_frames=launched,
         k1f_ms=k1f_ms, k1f_device_ms=k1f_device_ms, k1_ms_same_call=k1_ms,
         k1_device_ms_same_call=k1_device_ms, k1f_walk_all_device_ms=walk_all_device_ms,
         plain_ms=plain_ms, k1f_bound_ms=bound_ms, k1f_bound_bytes_ms=bytes_ms,
         k1f_bound_ops_ms=ops_ms, evaluated_pairs=counts.evaluated_pairs,
         contributing_pairs=counts.contributing_pairs,
         warp_iterations=counts.warp_iterations,
         warp_iterations_culled=counts.warp_iterations_culled,
         k1f_output_sha256=sha256_of(kf), k1f_bitwise_equal_to_plain=bitwise,
         **{f"k1f_vs_plain_{f}_max": e[0] for f, e in errs.items()},
         **{f"k1f_vs_plain_{f}_mean": e[1] for f, e in errs.items()},
         **{f"k1f_vs_k1_{f}_max": e[0] for f, e in vs_k1.items()},
         **{f"k1f_vs_k1_{f}_mean": e[1] for f, e in vs_k1.items()})
    # K1f's own cull at work, held as K1's is in `full_width`
    if not k1f_device_ms < K1_CULL_MAX_TIME_SHARE * walk_all_device_ms:
        raise AssertionError(f"K1f {k1f_device_ms:.4f} ms against {walk_all_device_ms:.4f} ms "
                             "with its cull off: the cull culls nothing on the card")
    return {"name": "blend_fwd_fast", "route": "cuda",
            "source": "wast3d_tpu_torch/csrc/blend_fwd.cu",
            "replaces": "wast3d_tpu/ops/rasterizer/pallas_blend.py:276",
            "launches": None, "max_abs_err": max(e[0] for e in errs.values()),
            "ms": k1f_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None}


# ---- entry point -------------------------------------------------------------

def write_blender_dataset(src, scene, device, res, n_train=4, n_test=2, fovx=0.9):
    """Views on a circle around the scene at distance 3; ground truth from
    the plain renderer (renderer="torch") of the same cameras the loader
    builds."""
    from wast3d_tpu_torch.ops.rasterizer import api
    from wast3d_tpu_torch.scene import datasets
    from wast3d_tpu_torch.eval.render_sets import save_image
    from wast3d_tpu_torch.utils.png import write_png

    os.makedirs(src, exist_ok=True)
    blank = np.zeros((res, res, 3), np.uint8)

    def frames(prefix, count, phase):
        out = []
        for i in range(count):
            a = phase + 2 * math.pi * i / count
            eye = np.array([3 * math.sin(a), 0.3, -3 * math.cos(a)])
            z = eye / np.linalg.norm(eye)  # OpenGL: camera looks down -z
            x = np.cross([0.0, 1.0, 0.0], z)
            x /= np.linalg.norm(x)
            c2w = np.eye(4)
            c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x, np.cross(z, x), z, eye
            write_png(os.path.join(src, f"{prefix}_{i}.png"), blank)
            out.append({"file_path": f"./{prefix}_{i}", "transform_matrix": c2w.tolist()})
        return out

    for split, prefix, count, phase in (("train", "r", n_train, 0.0), ("test", "t", n_test, 0.4)):
        with open(os.path.join(src, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": fovx, "frames": frames(prefix, count, phase)}, f)
    info = datasets.load_scene_info(src, eval_split=True)
    for infos in (info.train_cameras, info.test_cameras):
        for ci, (cam, _) in zip(infos, datasets.build_cameras(infos, device=device)):
            out = api.render(cam, scene, torch.zeros(3), device=device,
                             settings=api.RasterizeSettings(renderer="torch"))
            save_image(os.path.join(src, ci.image_name + ".png"), out["render"].cpu().numpy())
    return n_train + n_test


def rendered_pngs(model, split, count, res):
    """The renders and ground truth `cli.render` wrote for a split, as
    {file: (render, gt)} int32 arrays."""
    from wast3d_tpu_torch.utils.png import read_png

    base = os.path.join(model, split, "ours_1")
    ren = sorted(os.listdir(os.path.join(base, "renders")))
    gt = sorted(os.listdir(os.path.join(base, "gt")))
    if len(ren) != count or ren != gt:
        raise AssertionError(f"{split}: renders {ren} gt {gt} (want {count} each)")
    out = {}
    for f in ren:
        a = read_png(os.path.join(base, "renders", f)).astype(np.int32)
        if a.shape != (res, res, 3):
            raise AssertionError(f"{split}/{f}: shape {a.shape}")
        out[f] = (a, read_png(os.path.join(base, "gt", f)).astype(np.int32))
    return out


def phase_entry_point(device, n=FULL_N, res=FULL_RES):
    """The user's render entry point in both tiers: `cli.render` as a user
    calls it (the bf16 tier, K1f, by default), then with `--no-fast` (K1),
    then by default with `--batch 3` (views in groups of three through
    `render_batch`), with every kernel's count set to 0 just before each
    and read just after. Each tier's PNGs are held to its plain renders
    (the dataset's ground truth for K1; the plain fast render of each
    camera for K1f), the two tiers to each other, and `--batch 3`'s PNGs
    must equal the default run's bit for bit. Returns ({kernel name:
    launches} of the default run, of the --no-fast run)."""
    import shutil

    from wast3d_tpu_torch.cli import render as cli
    from wast3d_tpu_torch.eval.render_sets import save_image
    from wast3d_tpu_torch.ops.rasterizer import api
    from wast3d_tpu_torch.scene import datasets
    from wast3d_tpu_torch.scene.ply import save_ply
    from wast3d_tpu_torch.utils.png import read_png

    t0 = time.perf_counter()
    scene = make_scene(bench_scene(n), device)
    with tempfile.TemporaryDirectory(prefix="w3d_chip_smoke_") as tmp:
        src = os.path.join(tmp, "scene")
        models = {tier: os.path.join(tmp, f"model_{tier}")
                  for tier in ("fast", "f32", "fast_batch3")}
        views = write_blender_dataset(src, scene, device, res)
        save_ply(scene, os.path.join(models["fast"], "point_cloud", "iteration_1",
                                     "point_cloud.ply"))
        shutil.copytree(models["fast"], models["f32"])
        shutil.copytree(models["fast"], models["fast_batch3"])
        # the plain fast renders of the same cameras, as PNG bytes
        info = datasets.load_scene_info(src, eval_split=True)
        plain_fast = {}
        for split, infos in (("train", info.train_cameras), ("test", info.test_cameras)):
            for i, (cam, _) in enumerate(datasets.build_cameras(infos, device=device)):
                out = api.render(cam, scene, torch.zeros(3), device=device,
                                 settings=api.RasterizeSettings(renderer="torch",
                                                                fast_chain=True))
                path = os.path.join(tmp, f"plain_fast_{split}_{i}.png")
                save_image(path, out["render"].cpu().numpy())
                plain_fast[split, f"{i:05d}.png"] = read_png(path).astype(np.int32)
        t_setup = time.perf_counter() - t0

        launches, cli_s = {}, {}
        for tier, extra in (("fast", []), ("f32", ["--no-fast"]),
                            ("fast_batch3", ["--batch", "3"])):
            reset_kernel_counts()
            t1 = time.perf_counter()
            cli.main(["-m", models[tier], "-s", src, *extra, "--device", device.type])
            torch.cuda.synchronize()
            cli_s[tier] = time.perf_counter() - t1
            launches[tier] = kernel_counts()

        worst, tiers_worst, psnrs, written = {"fast": 0, "f32": 0}, 0, [], {}
        batch_equal = True
        for split, count in (("train", views - 2), ("test", 2)):
            fast = rendered_pngs(models["fast"], split, count, res)
            f32 = rendered_pngs(models["f32"], split, count, res)
            batched = rendered_pngs(models["fast_batch3"], split, count, res)
            batch_equal = batch_equal and all(np.array_equal(batched[f][0], fast[f][0])
                                              for f in fast)
            written[split] = len(fast)
            for f, (a, gt) in f32.items():
                worst["f32"] = max(worst["f32"], int(np.abs(a - gt).max()))
                if (a != gt).any():
                    psnrs.append(psnr(a / 255.0, gt / 255.0))
                b = fast[f][0]
                worst["fast"] = max(worst["fast"], int(np.abs(b - plain_fast[split, f]).max()))
                tiers_worst = max(tiers_worst, int(np.abs(a - b).max()))
    if (launches["fast"] != only(blend_fwd_fast=views)
            or launches["f32"] != only(blend_fwd=views)
            or launches["fast_batch3"] != only(blend_fwd_fast=views)):
        raise AssertionError(f"launches {launches} for {views} views (want K1f, then K1, "
                             f"then K1f, once each)")
    if not batch_equal:
        raise AssertionError("cli.render --batch 3 wrote other PNGs than --batch 1")
    if max(worst.values()) > 2:
        raise AssertionError(f"entry point renders differ from the plain renders by "
                             f"{worst}/255")
    if tiers_worst / 255.0 > CLI_TIER_TOL:
        raise AssertionError(f"--fast and --no-fast renders differ by {tiers_worst}/255 "
                             f"(limit {CLI_TIER_TOL})")
    emit("entry_point", t0, views=views, width=res, height=res, launches=launches,
         written=written, max_png_diff_vs_plain=worst, max_png_diff_fast_vs_f32=tiers_worst,
         batch3_pngs_bit_equal=batch_equal,
         min_psnr_f32_vs_plain=min(psnrs) if psnrs else None,  # None: all identical
         setup_s=t_setup, cli_s=cli_s)
    return launches["fast"], launches["f32"]


# ---- training at full width -----------------------------------------------

def perturbed(arrays, seed=1, sigma=0.002):
    rng = np.random.default_rng(seed)
    out = dict(arrays)
    out["xyz"] = (arrays["xyz"] + rng.normal(size=arrays["xyz"].shape) * sigma).astype(np.float32)
    return out


def instrumented_step(state, cam, gt, bg, opt_cfg, settings, res):
    """One train step written out as `train.reconstruct.train_step` runs
    it, with CUDA events between its stages and gradient hooks marking the
    stages inside the backward. Returns {stage: ms}."""
    from wast3d_tpu_torch.ops.image_losses import photometric_loss
    from wast3d_tpu_torch.ops.rasterizer import api, blend as blend_mod, render_path
    from wast3d_tpu_torch.train import densify as densify_mod
    from wast3d_tpu_torch.train.optim import make_optimizer

    names = ("start", "forward", "loss", "loss_bwd", "k2_blend_bwd",
             "gather_bwd_k3", "preprocess_bwd", "adam_stats")
    ev = {k: torch.cuda.Event(enable_timing=True) for k in names}
    scene = state.scene
    opt = make_optimizer(opt_cfg, 1.0)
    params = {k: v.detach().requires_grad_(True) for k, v in scene.params().items()}
    m2d = torch.zeros((scene.capacity, 2), device=scene.device, requires_grad=True)
    ev["start"].record()
    prep = api.preprocess_scene(cam, scene.with_params(params))
    prep = prep._replace(means2d=prep.means2d + m2d)
    binning, rows = render_path.bin_and_pack(prep, res, res, grad_reduce=settings.grad_reduce)
    out = blend_mod.blend(rows, binning.tile_start, binning.tile_end, res, res, bg)
    ev["forward"].record()
    loss = photometric_loss(out.color, gt, opt_cfg.lambda_dssim)
    ev["loss"].record()
    out.color.register_hook(lambda g: ev["loss_bwd"].record())
    rows.register_hook(lambda g: ev["k2_blend_bwd"].record())
    prep.conics.register_hook(lambda g: ev["gather_bwd_k3"].record())
    leaves = list(params.values()) + [m2d]
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    ev["preprocess_bwd"].record()
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]
    opt.update(dict(zip(params, grads[:-1])), state.opt_state, scene.params(), state.step + 1)
    densify_mod.add_stats(state.stats, grads[-1], prep.radii, prep.radii > 0, res, res)
    ev["adam_stats"].record()
    torch.cuda.synchronize()
    return {b: ev[a].elapsed_time(ev[b]) for a, b in zip(names[:-1], names[1:])}


def phase_train_full_width(device, n=FULL_N, res=FULL_RES, warmup=WARMUP, steps=FRAMES):
    """`train_step` on the 200k / 800x800 scene (jitter off, as `bench.py`
    times it), then K2 and K3 alone at that step's inputs against their
    plain versions and bounds. Returns the kernels-line entries of K2, K3."""
    from wast3d_tpu_torch.config import OptimizationConfig
    from wast3d_tpu_torch.ops.image_losses import photometric_loss
    from wast3d_tpu_torch.ops.rasterizer import api, grad_reduce, render_path
    from wast3d_tpu_torch.ops.rasterizer.blend import (
        BlendOutput, blend_bwd, blend_bwd_reference, blend_fwd, evaluated_pairs)
    from wast3d_tpu_torch.train import reconstruct as R

    t0 = time.perf_counter()
    scene = make_scene(bench_scene(n), device)
    cam = view_camera(res, res, device, eye=(0, 0, -3), fov=0.9)
    bg = torch.zeros(3, device=device)
    settings = api.RasterizeSettings(renderer="cuda")
    opt_cfg = OptimizationConfig()
    with torch.no_grad():
        gt = api.render(cam, make_scene(perturbed(bench_scene(n)), device), bg,
                        settings=settings, device=device)["render"]
    state = R.init_train_state(scene, opt_cfg, 1.0)
    t_setup = time.perf_counter() - t0

    counts = kernel_counts()
    step_ms, losses = [], []
    for i in range(warmup + steps):
        torch.cuda.synchronize()
        f0 = time.perf_counter()
        state, aux = R.train_step(state, cam, gt, bg, None, opt_cfg=opt_cfg, settings=settings,
                                  width=res, height=res, jitter=False)
        torch.cuda.synchronize()
        losses.append(float(aux["loss"]))
        if i >= warmup:
            step_ms.append((time.perf_counter() - f0) * 1e3)
    launched = {k: v - counts[k] for k, v in kernel_counts().items() if k in TRAIN_KERNELS}
    if any(v != warmup + steps for v in launched.values()):
        raise AssertionError(f"launches {launched} for {warmup + steps} train steps")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"train loss did not fall: {losses[0]} -> {losses[-1]}")
    for name, t in state.scene.params().items():
        if not torch.isfinite(t).all():
            raise AssertionError(f"non-finite {name} after {warmup + steps} steps")

    stages = [instrumented_step(state, cam, gt, bg, opt_cfg, settings, res) for _ in range(5)]
    stage_ms = {k: statistics.median(s[k] for s in stages) for k in stages[0]}

    # K2 and K3 alone, at this step's inputs.
    prep = api.preprocess_scene(cam, state.scene)
    binning, rows = render_path.bin_and_pack(prep, res, res)
    starts, ends = binning.tile_start, binning.tile_end
    out = blend_fwd(rows, starts, ends, res, res, bg)
    color = out.color.clone().requires_grad_(True)
    (dcolor,) = torch.autograd.grad(photometric_loss(color, gt, opt_cfg.lambda_dssim), [color])
    grads = BlendOutput(dcolor.contiguous(), torch.zeros_like(out.depth),
                        torch.zeros_like(out.final_T))
    k2_args = (rows, starts, ends, res, res, bg, None, out, grads)
    k2_ms = cuda_time_ms(lambda: blend_bwd(*k2_args), 20)
    _, k2_device_ms = device_ms(lambda: blend_bwd(*k2_args))
    k2_plain_ms = cuda_time_ms(lambda: blend_bwd_reference(*k2_args), 2)
    k2_err, drows = compare_k2((rows, starts, ends, res, res, None), bg, grads)
    pairs = evaluated_pairs(rows, starts, ends, res, res)
    K, tiles = int(rows.shape[0]), int(starts.shape[0])
    k2_bytes = 48 * K * 2 + 40 * res * res + 8 * tiles + 12
    k2_bytes_ms = k2_bytes / HBM_BYTES_PER_S * 1e3
    k2_ops_ms = K2_OPS_PER_PAIR * pairs / F32_OPS_PER_S * 1e3

    # K3 on the render path's route (segments from the binning) and on the
    # bare-rank route, same rows: the same bits.
    d = drows[:, :GRAD_COLS]
    rank = binning.rank
    n1 = int(state.scene.capacity)

    def binning_segments():
        return grad_reduce.binning_segments(binning.sort_perm, binning.presort_gauss,
                                            binning.depth_order)

    seg, bare = binning_segments(), grad_reduce.rank_segments(rank, n1)
    k3_out = grad_reduce.segment_sum(d, seg)
    k3_out2 = grad_reduce.segment_sum(d, seg)
    k3_bare = grad_reduce.segment_sum(d, bare)
    routes_equal = {mode: bool(torch.equal(
        grad_reduce.reduce_segments(d, seg, mode), grad_reduce.reduce(d, rank, n1, mode)))
        for mode in ("segsum", "segsum_sortpayload", "segsum_sortpacked")}
    torch.cuda.synchronize()
    if not (torch.equal(k3_out, k3_out2) and torch.equal(k3_out, k3_bare)
            and all(routes_equal.values())):
        raise AssertionError(f"K3: the binning and bare-rank routes, or two runs, differ "
                             f"in some bit ({routes_equal})")
    seg_len = torch.diff(grad_reduce.segment_offsets(seg))
    longest = int(seg_len.max())
    # K3 on the binning route is the whole reduction: one call, two kernels
    # (the segments' bounds and the inverse of the tile sort's permutation,
    # then the sums) after zeroing the bounds.
    k3_ms = cuda_time_ms(lambda: grad_reduce.segment_sum(d, binning_segments()), 50)
    k3_kernels, k3_device_ms = device_ms(
        lambda: grad_reduce.segment_sum(d, binning_segments()))
    # Event times of a few small kernels hold the host's time to issue them.
    k3_host_ms = host_ms(lambda: grad_reduce.segment_sum(d, binning_segments()), 50)
    index_add_host_ms = host_ms(lambda: torch.zeros((n1, GRAD_COLS), device=device)
                                .index_add_(0, rank, d), 50)
    k3_bare_kernel_ms = kernel_device_ms(
        lambda: grad_reduce.segment_sum(d, bare), "segsum_kernel")
    k3_plain_ms = cuda_time_ms(lambda: grad_reduce.segment_sum_reference(d, seg), 5)
    bare_whole_ms = cuda_time_ms(lambda: grad_reduce.reduce(d, rank, n1, grad_reduce.DEFAULT), 20)
    index_add_ms = cuda_time_ms(lambda: torch.zeros((n1, GRAD_COLS), device=device)
                                .index_add_(0, rank, d), 20)
    k3_contiguous_ms = kernel_device_ms(  # "segsum" / "segsum_sortpacked" read gathered rows
        lambda rm=d[grad_reduce.source_index(seg)].contiguous(): grad_reduce.segment_sum(
            rm, seg._replace(perm=None)), "segsum_kernel")
    # Device busy time of each whole reduction (the event times above also
    # hold the host's launch gaps between small kernels).
    busy = {name: device_ms(fn)[1] for name, fn in (
        ("bare_rank_route_reduction", lambda: grad_reduce.reduce(
            d, rank, n1, grad_reduce.DEFAULT)),
        ("index_add_", lambda: torch.zeros((n1, GRAD_COLS), device=device)
         .index_add_(0, rank, d)))}
    reduce_ms = {mode: cuda_time_ms(
        (lambda: grad_reduce.reduce(d, rank, n1, "scatter")) if mode == "scatter" else
        (lambda m=mode: grad_reduce.reduce_segments(d, binning_segments(), m)), 20)
        for mode in grad_reduce.GRAD_REDUCES}
    k3_err = compare_k3(d, rank, n1, grad_reduce.DEFAULT, segments=seg)
    # in: rows K x 40, the permutation K x 8, the pre-sort Gaussian indices
    # K x 8, the depth order n1 x 8; out n1 x 40
    k3_bytes = K * (4 * GRAD_COLS + 16) + n1 * (8 + 4 * GRAD_COLS)
    k3_bytes_ms = k3_bytes / HBM_BYTES_PER_S * 1e3
    k3_ops_ms = K * GRAD_COLS / F32_OPS_PER_S * 1e3
    median = statistics.median(step_ms)
    emit("train_full_width", t0, n_gaussians=n, width=res, height=res, sh_degree=3,
         jitter=False, grad_reduce=settings.grad_reduce, setup_s=t_setup, warmup=warmup,
         steps=steps, step_ms_median=median, step_ms_min=min(step_ms),
         step_ms_max=max(step_ms), steps_per_s=1e3 / median, loss_first=losses[0],
         loss_last=losses[-1], launches_in_steps=launched,
         stage_ms_median=stage_ms, duplicates_K=K, evaluated_pairs=pairs,
         k2_ms=k2_ms, k2_device_ms=k2_device_ms, k2_plain_ms=k2_plain_ms,
         k2_bound_bytes_ms=k2_bytes_ms, k2_bound_ops_ms=k2_ops_ms, k2_max_rel_err=k2_err,
         k3_ms=k3_ms, k3_device_ms=k3_device_ms, k3_device_ms_by_kernel=k3_kernels,
         k3_host_issue_ms=k3_host_ms, index_add_host_issue_ms=index_add_host_ms,
         k3_bare_rank_segments_kernel_ms=k3_bare_kernel_ms, device_busy_ms=busy,
         k3_plain_ms=k3_plain_ms,
         k3_bare_rank_whole_reduction_ms=bare_whole_ms,
         index_add_ms=index_add_ms, k3_contiguous_rows_ms=k3_contiguous_ms,
         reduce_ms_by_mode=reduce_ms, k3_routes_bitwise_equal=routes_equal,
         k3_longest_segment=longest, k3_segments_over_32=int((seg_len > 32).sum()),
         k3_bound_bytes_ms=k3_bytes_ms, k3_bound_ops_ms=k3_ops_ms,
         k3_err_fraction_of_f32_bound=k3_err)
    k2 = {"name": "blend_bwd", "route": "cuda", "source": "wast3d_tpu_torch/csrc/blend_bwd.cu",
          "replaces": "wast3d_tpu/ops/rasterizer/pallas_blend.py:543", "launches": None,
          "max_abs_err": float((drows - blend_bwd_reference(*k2_args)).abs().max()),
          "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": max(k2_bytes_ms, k2_ops_ms),
          "bound_by": "bytes" if k2_bytes_ms >= k2_ops_ms else "operations",
          "library_ms": None}
    k3_ref = torch.zeros((n1, GRAD_COLS), dtype=torch.float64, device=device).index_add_(
        0, rank, d.to(torch.float64))
    k3 = {"name": "segment_sum", "route": "cuda", "source": "wast3d_tpu_torch/csrc/segsum.cu",
          "replaces": "wast3d_tpu/ops/rasterizer/grad_reduce.py:65", "launches": None,
          "max_abs_err": float((k3_out.to(torch.float64) - k3_ref).abs().max()),
          "ms": k3_ms, "plain_ms": k3_plain_ms, "bound_ms": max(k3_bytes_ms, k3_ops_ms),
          "bound_by": "bytes" if k3_bytes_ms >= k3_ops_ms else "operations",
          "library_ms": index_add_ms}
    return k2, k3


def phase_train_full_width_fast(device, n=FULL_N, res=FULL_RES, warmup=WARMUP, steps=FRAMES):
    """`train_step` in the bf16 tier (K1f forward, K2f backward, K3) on the
    200k / 800x800 scene, jitter off, with every kernel's count set to 0
    just before the steps and read just after; then K2f alone at that
    step's inputs, timed as K2 is (and K2 beside it), against its plain
    version and bound. Returns K2f's kernels-line entry, with its launches
    from the steps."""
    from wast3d_tpu_torch.config import OptimizationConfig
    from wast3d_tpu_torch.ops.image_losses import photometric_loss
    from wast3d_tpu_torch.ops.rasterizer import api, render_path
    from wast3d_tpu_torch.ops.rasterizer.blend import (
        BlendOutput, blend_bwd, blend_bwd_fast, blend_bwd_fast_reference, blend_fwd,
        blend_fwd_fast, evaluated_pairs, fast_tables)
    from wast3d_tpu_torch.train import reconstruct as R

    t0 = time.perf_counter()
    scene = make_scene(bench_scene(n), device)
    cam = view_camera(res, res, device, eye=(0, 0, -3), fov=0.9)
    bg = torch.zeros(3, device=device)
    settings = api.RasterizeSettings(renderer="pallas", fast_chain=True)
    opt_cfg = OptimizationConfig()
    with torch.no_grad():
        gt = api.render(cam, make_scene(perturbed(bench_scene(n)), device), bg,
                        settings=api.RasterizeSettings(renderer="cuda"), device=device)["render"]
    state = R.init_train_state(scene, opt_cfg, 1.0)

    reset_kernel_counts()
    step_ms, losses = [], []
    for i in range(warmup + steps):
        torch.cuda.synchronize()
        f0 = time.perf_counter()
        state, aux = R.train_step(state, cam, gt, bg, None, opt_cfg=opt_cfg, settings=settings,
                                  width=res, height=res, jitter=False)
        torch.cuda.synchronize()
        losses.append(float(aux["loss"]))
        if i >= warmup:
            step_ms.append((time.perf_counter() - f0) * 1e3)
    launched = kernel_counts()
    want = only(blend_fwd_fast=warmup + steps, blend_bwd_fast=warmup + steps,
                segment_sum=warmup + steps)
    if launched != want:
        raise AssertionError(f"launches {launched} for {warmup + steps} fast train steps, "
                             f"want {want}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"fast train loss did not fall: {losses[0]} -> {losses[-1]}")

    prep = api.preprocess_scene(cam, state.scene)
    binning, rows = render_path.bin_and_pack(prep, res, res, fast=True)
    rows32 = render_path.bin_and_pack(prep, res, res)[1]
    starts, ends = binning.tile_start, binning.tile_end
    out = blend_fwd_fast(rows, starts, ends, res, res, bg)
    color = out.color.clone().requires_grad_(True)
    (dcolor,) = torch.autograd.grad(photometric_loss(color, gt, opt_cfg.lambda_dssim), [color])
    grads = BlendOutput(dcolor.contiguous(), torch.zeros_like(out.depth),
                        torch.zeros_like(out.final_T))
    args = (rows, starts, ends, res, res, bg, None, out, grads)
    k2f_ms = cuda_time_ms(lambda: blend_bwd_fast(*args), 20)
    _, k2f_device_ms = device_ms(lambda: blend_bwd_fast(*args))
    out32 = blend_fwd(rows32, starts, ends, res, res, bg)
    args32 = (rows32,) + args[1:7] + (out32, grads)
    k2_ms = cuda_time_ms(lambda: blend_bwd(*args32), 20)
    _, k2_device_ms = device_ms(lambda: blend_bwd(*args32))
    plain_ms = cuda_time_ms(lambda: blend_bwd_fast_reference(*args), 2)
    rel, drows = compare_k2((rows, starts, ends, res, res, None), bg, grads, fast=True)
    plain = blend_bwd_fast_reference(*args)
    pairs = evaluated_pairs(rows, starts, ends, res, res, fast=True)
    K, tiles = int(rows.shape[0]), int(starts.shape[0])
    table_bytes = fast_tables(device).numel() * 2
    bytes_ms = ((FAST_ROW_BYTES * K * 2 + table_bytes + 40 * res * res + 8 * tiles + 12)
                / HBM_BYTES_PER_S * 1e3)
    ops_ms = fast_ops_ms(K2F_OPS_PER_PAIR, pairs)
    emit("train_full_width_fast", t0, n_gaussians=n, width=res, height=res, jitter=False,
         steps=steps, warmup=warmup, step_ms_median=statistics.median(step_ms),
         step_ms_min=min(step_ms), step_ms_max=max(step_ms), loss_first=losses[0],
         loss_last=losses[-1], launches_in_steps=launched, duplicates_K=K,
         evaluated_pairs=pairs, k2f_ms=k2f_ms, k2f_device_ms=k2f_device_ms,
         k2_ms_same_call=k2_ms, k2_device_ms_same_call=k2_device_ms, k2f_plain_ms=plain_ms,
         k2f_bound_bytes_ms=bytes_ms, k2f_bound_ops_ms=ops_ms, k2f_max_rel_err=rel)
    return {"name": "blend_bwd_fast", "route": "cuda",
            "source": "wast3d_tpu_torch/csrc/blend_bwd.cu",
            "replaces": "wast3d_tpu/ops/rasterizer/pallas_blend.py:644",
            "launches": launched["blend_bwd_fast"],
            "max_abs_err": float((drows.float() - plain.float()).abs().max()),
            "ms": k2f_ms, "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None}


TRAIN_KERNELS = ("blend_fwd", "blend_bwd", "segment_sum")


def _counted():
    from wast3d_tpu_torch.ops.rasterizer import blend
    from wast3d_tpu_torch.ops.rasterizer.grad_reduce import segment_sum
    from wast3d_tpu_torch.ops.rasterizer.pack_gather import pack_gather
    from wast3d_tpu_torch.stylize.desc_kernel import desc_grad, desc_loss

    return {"blend_fwd": blend.blend_fwd, "blend_bwd": blend.blend_bwd,
            "blend_fwd_fast": blend.blend_fwd_fast, "blend_bwd_fast": blend.blend_bwd_fast,
            "segment_sum": segment_sum, "desc_loss": desc_loss, "desc_grad": desc_grad,
            "pack_gather": pack_gather}


def only(**launches):
    """Every counted kernel's launches: those given, the rest 0."""
    return {k: launches.get(k, 0) for k in _counted()}


def kernel_counts():
    return {k: fn.launches for k, fn in _counted().items()}


def reset_kernel_counts():
    for fn in _counted().values():
        fn.launches = 0


def longest_segment(scene, src, device):
    """The longest segment K3 sums for `scene` over the dataset's views:
    the render path's segments, binned as a training step bins them (tile
    cull, jitter margin 1). Run after the timed entry point, untimed."""
    from wast3d_tpu_torch.ops.rasterizer import grad_reduce
    from wast3d_tpu_torch.ops.rasterizer.api import preprocess_scene
    from wast3d_tpu_torch.ops.rasterizer.binning import bin_gaussians
    from wast3d_tpu_torch.scene import datasets

    info = datasets.load_scene_info(src, eval_split=True)
    longest = 0
    for infos in (info.train_cameras, info.test_cameras):
        for cam, _ in datasets.build_cameras(infos, device=device):
            prep = preprocess_scene(cam, scene)
            b = bin_gaussians(prep.means2d, prep.depths, prep.radii, cam.width, cam.height,
                              ext_x=prep.extent_x, ext_y=prep.extent_y, conics=prep.conics,
                              opacities=prep.opacities, jitter_margin=1.0)
            seg = grad_reduce.binning_segments(b.sort_perm, b.presort_gauss, b.depth_order)
            longest = max(longest, int(torch.diff(grad_reduce.segment_offsets(seg)).max()))
    return longest


def phase_train_entry_point(device, n=FULL_N, res=FULL_RES, iters=TRAIN_ITERS):
    """`cli.train` on a 6-view 800x800 Blender dataset of the bench scene,
    from a random 100k-point init, with densify at 200 and 300.
    Every kernel's count is set to 0 just before and read just after.
    Returns {kernel name: launches}."""
    from wast3d_tpu_torch.cli import train as cli
    from wast3d_tpu_torch.core.sh import sh_to_rgb
    from wast3d_tpu_torch.scene.datasets import store_ply_points
    from wast3d_tpu_torch.scene.ply import load_ply

    t0 = time.perf_counter()
    scene = make_scene(bench_scene(n), device)
    with tempfile.TemporaryDirectory(prefix="w3d_chip_smoke_train_") as tmp:
        src, model = os.path.join(tmp, "scene"), os.path.join(tmp, "model")
        views = write_blender_dataset(src, scene, device, res)
        del scene
        # The Blender loader's random init (a 100k-point cube of side 2.6 with
        # near-grey colours), written here from a seed so that runs repeat.
        rng = np.random.default_rng(2)
        store_ply_points(os.path.join(src, "points3d.ply"),
                         rng.random((N_INIT, 3)) * 2.6 - 1.3,
                         sh_to_rgb(rng.random((N_INIT, 3)) / 255.0) * 255)
        t_setup = time.perf_counter() - t0

        reset_kernel_counts()
        t1 = time.perf_counter()
        cli.main(["-s", src, "-m", model, "--iterations", str(iters),
                  "--save_iterations", str(iters), "--densify_from_iter", "100",
                  "--densification_interval", "100", "--quiet", "--device", device.type])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t1
        launches = kernel_counts()

        log = [json.loads(line) for line in open(os.path.join(model, "log.jsonl"))]
        losses = [(e["iter"], e["loss"]) for e in log if "loss" in e]
        densify = [(e["iter"], e["n"]) for e in log if e.get("event") == "densify"]
        report = [e for e in log if "psnr_train" in e]
        ply = os.path.join(model, "point_cloud", f"iteration_{iters}", "point_cloud.ply")
        final = load_ply(ply, device=device)
        n_final = final.capacity
        finite = all(bool(torch.isfinite(getattr(final, f)).all())
                     for f in ("xyz", "scaling", "rotation", "opacity", "features_dc"))
        longest = longest_segment(final, src, device)
    report_renders = min(5, views)  # report(): PSNR over train_cams[:5] (no test split)
    if [it for it, _ in densify] != [200, 300]:
        raise AssertionError(f"densify fired at {densify}, want iterations 200 and 300")
    if not (len(losses) >= 2 and losses[-1][1] < losses[0][1]):
        raise AssertionError(f"train loss did not fall: {losses}")
    if n_final == N_INIT or not finite:
        raise AssertionError(f"N {N_INIT} -> {n_final}, finite {finite}")
    want = only(blend_fwd=iters + report_renders, blend_bwd=iters, segment_sum=iters)
    if launches != want:
        raise AssertionError(f"launches {launches}, want {want} (one K1, K2, K3 per step, "
                             f"plus K1 for {report_renders} report renders)")
    emit("train_entry_point", t0, views=views, width=res, height=res, iterations=iters,
         launches=launches, launches_per_step={k: (v - (report_renders if k == "blend_fwd"
                                                       else 0)) / iters
                                               for k, v in launches.items()},
         losses=losses, densify_n=densify, n_init=N_INIT, n_final=n_final,
         psnr_train=report[-1]["psnr_train"] if report else None,
         k3_longest_segment_final_model=longest, setup_s=t_setup, cli_s=cli_s,
         iters_per_s=iters / cli_s)
    return launches


# ---- viewers, Kg (pack_gather), native IO --------------------------------------

FIXTURES = os.path.join(ROOT, "tests", "torch_fixtures")
JPEG_MAX_DIFF, JPEG_MEAN_DIFF = 2, 0.05  # the decoder against PIL's decode, uint8 units
COLMAP_POINTS = 20_000  # points3D.bin through the native reader and through Python
# K1f's frame with pack_gather against the frame without it: JAX's own bounds
# (tests/test_pallas_blend.py::test_pack_gather_matches_fast_chain).
PACK_TOL, PACK_DEPTH_TOL = 1.5e-2, 3e-2
KG_CASES = ((200, 3), (120, 0))  # JAX's cases at 80 x 48: (Gaussians, seed)
VIEWER_ORBITS = ((0.3, 0.1, 3.0), (1.2, -0.2, 2.6), (2.5, 0.4, 3.4))  # yaw, pitch, radius
VIEWER_REPS = 10  # frame ms: median of 10, host clocks
VIEW_UP_S = 60  # cli.view must answer /info within this
GUI_TRAIN_ITERS = 100  # cli.train --port on the COLMAP + JPEG fixture
GUI_REQUEST_EVERY_S = 0.2  # the live-view client's pause between frames
# tests/test_sibr_protocol.py's canonical SIBR request: every key the
# reference's viewer hook reads, the matrices row-major. Sized to the frame
# here; its view puts the scene behind the camera, so its frame is the
# background, and an orbit camera's request follows it.
SIBR_CANONICAL = {
    "resolution_x": 8, "resolution_y": 6, "train": True, "fov_y": 0.8, "fov_x": 0.9,
    "z_near": 0.01, "z_far": 100.0, "shs_python": False, "rot_scale_python": False,
    "keep_alive": True, "scaling_modifier": 1.0,
    "view_matrix": [0.936, 0.0, 0.352, 0.0, 0.062, 0.984, -0.166, 0.0,
                    -0.347, 0.178, 0.921, 0.0, 0.1, -0.2, 4.0, 1.0],
    "view_projection_matrix": [1.77, 0.0, 0.35, 0.35, 0.11, 1.86, -0.16, -0.16,
                               -0.65, 0.33, 0.92, 0.92, 0.18, -0.37, 3.99, 4.0]}


class _NoPil:
    """A `sys.meta_path` finder that refuses PIL, as on a machine without it."""

    def find_spec(self, name, path=None, target=None):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError(f"{name} is blocked: this run must not need PIL")
        return None


@contextlib.contextmanager
def without_pil():
    """PIL unimportable inside the block (its loaded modules set aside)."""
    saved = {k: sys.modules.pop(k) for k in list(sys.modules)
             if k == "PIL" or k.startswith("PIL.")}
    finder = _NoPil()
    sys.meta_path.insert(0, finder)
    try:
        yield
    finally:
        sys.meta_path.remove(finder)
        sys.modules.update(saved)


@contextlib.contextmanager
def no_native():
    """The numpy fallbacks of the native fast paths, as WAST3D_NO_NATIVE
    gives them."""
    from wast3d_tpu_torch import native

    old = os.environ.get("WAST3D_NO_NATIVE")
    os.environ["WAST3D_NO_NATIVE"] = "1"
    native._tried, native._lib = False, None
    try:
        yield
    finally:
        if old is None:
            del os.environ["WAST3D_NO_NATIVE"]
        else:
            os.environ["WAST3D_NO_NATIVE"] = old
        native._tried, native._lib = False, None


def fixture_jpegs():
    """(name, JPEG path, PNG of PIL's decode) of every committed JPEG fixture."""
    out = []
    for d, _, files in os.walk(FIXTURES):
        for f in files:
            if f.endswith(".jpg"):
                name = f[:-4]
                out.append((name, os.path.join(d, f),
                            os.path.join(FIXTURES, "pil_decode", name + ".png")))
    if not out:
        raise AssertionError(f"no JPEG fixtures under {FIXTURES}")
    return sorted(out)


def phase_io(device, n=FULL_N):
    """The native host library (`g++`): the 200k shell's PLY and a COLMAP
    points3D.bin by native and by numpy, and each committed JPEG fixture
    against PIL's decode of it. Returns the largest JPEG's decode ms."""
    from wast3d_tpu_torch import native
    from wast3d_tpu_torch.scene import colmap, ply
    from wast3d_tpu_torch.utils.png import read_png

    del device  # host IO
    t0 = time.perf_counter()
    if not native.available():
        raise AssertionError("the native library did not build or load: on the card the "
                             "numpy fallback must not hide a broken g++ build")
    lib = os.path.relpath(native.library()._name, ROOT)
    with tempfile.TemporaryDirectory(prefix="w3d_chip_smoke_io_") as tmp:
        path = os.path.join(tmp, "shell.ply")
        ply.save_ply(make_scene(bench_scene(n), "cpu"), path)
        if native.read_ply_f32(path) is None:
            raise AssertionError("the native PLY reader declined the shell's PLY")
        t = time.perf_counter()
        fast = ply.load_ply_arrays(path)
        native_ply_s = time.perf_counter() - t
        with no_native():
            t = time.perf_counter()
            slow = ply.load_ply_arrays(path)
            numpy_ply_s = time.perf_counter() - t
        ply_equal = all(fast[k].dtype == slow[k].dtype and np.array_equal(fast[k], slow[k])
                        for k in slow)
        rng = np.random.default_rng(4)
        xyz = rng.normal(size=(COLMAP_POINTS, 3))
        rgb = rng.integers(0, 256, (COLMAP_POINTS, 3))
        cpath = os.path.join(tmp, "points3D.bin")
        colmap.write_points3d_binary(xyz, rgb, cpath)
        t = time.perf_counter()
        a = colmap.read_points3d_binary(cpath)
        native_colmap_s = time.perf_counter() - t
        with no_native():
            t = time.perf_counter()
            b = colmap.read_points3d_binary(cpath)
            python_colmap_s = time.perf_counter() - t
        colmap_equal = (all(np.array_equal(x, y) for x, y in zip(a, b))
                        and np.array_equal(a[0], xyz) and np.array_equal(a[1], rgb))
    jpegs = {}
    for name, jpg, png_path in fixture_jpegs():
        times = []
        for _ in range(5):
            t = time.perf_counter()
            got = native.read_jpeg(jpg)
            times.append((time.perf_counter() - t) * 1e3)
        want = read_png(png_path)
        if got.shape != want.shape:
            raise AssertionError(f"{name}: decoded {got.shape}, PIL {want.shape}")
        d = np.abs(got.astype(np.int32) - want.astype(np.int32))
        jpegs[name] = {"shape": list(got.shape), "max": int(d.max()), "mean": float(d.mean()),
                       "equal_share": float((d == 0).mean()),
                       "decode_ms_median": statistics.median(times)}
    largest = max(jpegs, key=lambda k: np.prod(jpegs[k]["shape"]))
    emit("io", t0, library=lib, n_gaussians=n, ply_bit_equal=ply_equal,
         native_ply_s=native_ply_s, numpy_ply_s=numpy_ply_s, colmap_points=COLMAP_POINTS,
         colmap_equal=colmap_equal, native_colmap_s=native_colmap_s,
         python_colmap_s=python_colmap_s, jpegs=jpegs, largest_jpeg=largest,
         largest_decode_ms=jpegs[largest]["decode_ms_median"])
    bad = {k: v for k, v in jpegs.items()
           if v["max"] > JPEG_MAX_DIFF or v["mean"] > JPEG_MEAN_DIFF}
    if not ply_equal or not colmap_equal or bad:
        raise AssertionError(f"native IO: PLY equal {ply_equal}, COLMAP equal {colmap_equal}, "
                             f"JPEGs beyond max {JPEG_MAX_DIFF} / mean {JPEG_MEAN_DIFF}: {bad}")
    return jpegs[largest]["decode_ms_median"]


def kg_args(scene, cam):
    """Kg's inputs for this view, as the render path hands them over."""
    from wast3d_tpu_torch.ops.rasterizer import api, render_path

    with torch.no_grad():
        prep = api.preprocess_scene(cam, scene)
        binning, _ = render_path.bin_and_pack(prep, cam.width, cam.height, fast=True)
    return (prep.means2d, prep.conics, prep.opacities, prep.depths, prep.colors,
            binning.depth_order, binning.rank, binning.tile_of_dup, cam.width), prep, binning


def compare_kg(args):
    """(bit-equal to the plain version, bit-equal to a second run)."""
    from wast3d_tpu_torch.ops.rasterizer.pack_gather import pack_gather, pack_gather_reference

    a, b = pack_gather(*args), pack_gather(*args)
    p = pack_gather_reference(*args)
    return (torch.equal(a.view(torch.int16), p.view(torch.int16)),
            torch.equal(a.view(torch.int16), b.view(torch.int16)))


def phase_pack_gather(device, n=FULL_N, res=FULL_RES, warmup=WARMUP, frames=FRAMES):
    """Kg against its plain version on seeded cases and at 200k / 800²,
    then K1f frames with `pack_gather` (the main path of Kg) against the
    frame without it, and Kg's times beside the f32 gather + `fast_rows`
    that it replaces. Returns Kg's kernels-line entry."""
    from wast3d_tpu_torch.ops.rasterizer import api, render_path
    from wast3d_tpu_torch.ops.rasterizer.pack_gather import pack_gather, pack_gather_reference

    t0 = time.perf_counter()
    split = {}
    cases = {}
    for cn, seed in KG_CASES:
        scene = make_scene(random_scene(cn, seed), device)
        cases[f"jax_{cn}_seed{seed}"] = compare_kg(kg_args(scene, view_camera(80, 48, device))[0])
    cases["saturating"] = compare_kg(kg_args(make_scene(saturating_scene(), device),
                                             view_camera(32, 32, device))[0])
    cases["corner"] = compare_kg(kg_args(make_scene(corner_scene(), device),
                                         view_camera(64, 48, device))[0])
    scene = make_scene(bench_scene(n), device)
    cam = view_camera(res, res, device, eye=(0, 0, -3), fov=0.9)
    args, prep, binning = kg_args(scene, cam)
    cases["full_width"] = compare_kg(args)
    split["cases_s"] = time.perf_counter() - t0

    bg = torch.zeros(3, device=device)
    fast = api.RasterizeSettings(renderer="pallas", fast_chain=True)
    packed = fast._replace(pack_gather=True)
    frame_ms = []
    with torch.no_grad():
        ref = api.render(cam, scene, bg, settings=fast, device=device)
        before = dict(kernel_counts())
        for i in range(warmup + frames):
            torch.cuda.synchronize()
            f0 = time.perf_counter()
            out = api.render(cam, scene, bg, settings=packed, device=device)
            torch.cuda.synchronize()
            if i >= warmup:
                frame_ms.append((time.perf_counter() - f0) * 1e3)
        launched = {k: v - before[k] for k, v in kernel_counts().items()}
        split["frames_s"] = time.perf_counter() - t0 - split["cases_s"]
        diffs = {f: float((out[f] - ref[f]).abs().max()) for f in ("render", "final_T", "depth")}
        depth_ok = bool(((out["depth"] - ref["depth"]).abs()
                         <= PACK_DEPTH_TOL + PACK_DEPTH_TOL * ref["depth"].abs()).all())
        frame_bits = all(torch.equal(out[f], ref[f]) for f in ("render", "final_T", "depth"))
        kg_ms = cuda_time_ms(lambda: pack_gather(*args), 50)
        _, kg_device_ms = device_ms(lambda: pack_gather(*args))
        plain_ms = cuda_time_ms(lambda: pack_gather_reference(*args), 5)
        library_ms = cuda_time_ms(lambda: render_path.fast_rows(
            render_path.sorted_rows(prep, binning), binning.tile_of_dup, res), 50)
        _, library_device_ms = device_ms(lambda: render_path.fast_rows(
            render_path.sorted_rows(prep, binning), binning.tile_of_dup, res))
    N, K = int(prep.means2d.shape[0]), int(binning.rank.shape[0])
    # The function's bytes: each input read once (the five fields, the depth
    # order, rank and tile), each output row written once; the two passes
    # also write and read the 24-byte packed rows (`design_bytes`).
    in_bytes = sum(t.numel() * t.element_size() for t in args[:8])
    out_bytes = K * FAST_ROW_BYTES
    bytes_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    design_bytes = in_bytes + out_bytes + 24 * (N + 1) + 24 * K
    ops_ms = (12 * N + 8 * K) / F32_OPS_PER_S * 1e3  # roundings, one subtraction; two subs, two adds
    bound_ms = max(bytes_ms, ops_ms)
    emit("pack_gather", t0, n_gaussians=n, width=res, height=res, duplicates_K=K,
         cases_bit_equal_to_plain={k: v[0] for k, v in cases.items()},
         cases_bit_equal_run_to_run={k: v[1] for k, v in cases.items()},
         frames=frames, launches_in_frames=launched,
         frame_ms_median=statistics.median(frame_ms), frame_ms_min=min(frame_ms),
         frame_vs_no_pack_gather_max=diffs, frame_bit_equal_to_no_pack_gather=frame_bits,
         kg_ms=kg_ms, kg_device_ms=kg_device_ms, plain_ms=plain_ms,
         f32_gather_fast_rows_ms=library_ms, f32_gather_fast_rows_device_ms=library_device_ms,
         kg_bound_ms=bound_ms, kg_bound_bytes_ms=bytes_ms, kg_bound_ops_ms=ops_ms,
         kg_bytes=in_bytes + out_bytes, kg_design_bytes=design_bytes,
         kg_design_bytes_ms=design_bytes / HBM_BYTES_PER_S * 1e3,
         timing_s=time.perf_counter() - t0 - split["cases_s"] - split["frames_s"], **split)
    if not all(a and b for a, b in cases.values()):
        raise AssertionError(f"Kg against its plain version / itself: {cases}")
    if launched != only(blend_fwd_fast=warmup + frames, pack_gather=warmup + frames):
        raise AssertionError(f"launches {launched} for {warmup + frames} pack_gather frames")
    if not (diffs["render"] <= PACK_TOL and diffs["final_T"] <= PACK_TOL and depth_ok):
        raise AssertionError(f"pack_gather frame beyond JAX's bounds of the fast frame: {diffs}")
    return {"name": "pack_gather", "route": "cuda",
            "source": "wast3d_tpu_torch/csrc/pack_gather.cu",
            "replaces": "wast3d_tpu/ops/rasterizer/pallas_path.py:150",
            "launches": launched["pack_gather"], "max_abs_err": 0.0 if cases["full_width"][0]
            else None, "ms": kg_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms}


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http_get(url, timeout=60.0) -> bytes:
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.read()


def sibr_request(cam, width, height):
    """A SIBR viewer request (`tests/test_sibr_protocol.py`'s format) for the
    port camera `cam`: its matrices in the viewer's GL convention (columns
    1, 2 of the view and 1 of the view-projection negated; the server
    negates them back)."""
    view = cam.view_transform.cpu().numpy().copy()
    proj = cam.full_proj_transform.cpu().numpy().copy()
    view[:, 1:3] *= -1
    proj[:, 1] *= -1
    return {"resolution_x": width, "resolution_y": height, "train": True,
            "fov_y": cam.fovy, "fov_x": cam.fovx, "z_near": cam.znear, "z_far": cam.zfar,
            "shs_python": False, "rot_scale_python": False, "keep_alive": True,
            "scaling_modifier": 1.0, "view_matrix": view.reshape(-1).tolist(),
            "view_projection_matrix": proj.reshape(-1).tolist()}


def sibr_frame(msg: dict) -> bytes:
    body = json.dumps(msg).encode("utf-8")
    return len(body).to_bytes(4, "little") + body


def recv_exact(sock, count) -> bytes:
    buf = b""
    while len(buf) < count:
        chunk = sock.recv(count - len(buf))
        if not chunk:
            raise ConnectionError("closed")
        buf += chunk
    return buf


def sibr_reply(sock, width, height, verify: str):
    """One framed reply: (rgb bytes or None for a keep-alive, verify string)."""
    rgb = recv_exact(sock, width * height * 3) if width else None
    vlen = int.from_bytes(recv_exact(sock, 4), "little")
    return rgb, recv_exact(sock, vlen).decode("ascii") if vlen else ""


def gui_camera_render(req, scene, settings, bg, device):
    """The frame a SIBR request should get, rendered here: the port's Camera
    from `GuiCamera`'s matrices, `api.render`, clipped, times 255, uint8."""
    from wast3d_tpu_torch.core.camera import Camera
    from wast3d_tpu_torch.ops.rasterizer import api
    from wast3d_tpu_torch.viewer.network_gui import GuiCamera

    g = GuiCamera(req)
    cam = Camera(torch.from_numpy(g.view_transform).to(device),
                 torch.from_numpy(g.full_proj_transform).to(device),
                 torch.from_numpy(np.asarray(g.camera_center, np.float32)).to(device),
                 float(g.fovx), float(g.fovy), float(g.znear), float(g.zfar), g.width, g.height)
    with torch.no_grad():
        out = api.render(cam, scene, bg, settings=settings, device=device)
    return (np.clip(out["render"].cpu().numpy(), 0, 1) * 255).astype(np.uint8)


def phase_viewer_entry_point(device, n=FULL_N, res=FULL_RES):
    """The viewers at full width, each with the launch counts set to 0 just
    before it and read just after: the web viewer (`web.serve_scene`, three
    800² orbits through K1f, bit-equal to in-process renders), `cli.view` as
    a subprocess, the SIBR server (`network_gui`, K1), `cli.train --port` on
    the COLMAP + JPEG fixture with a live-view client, the nerfstudio
    outputs (K1), and `utils.profiling`."""
    import importlib.util
    import shutil
    import socket
    import threading
    import urllib.error

    from wast3d_tpu_torch.cli import train as cli_train
    from wast3d_tpu_torch.ops.rasterizer import api
    from wast3d_tpu_torch.train.checkpoint import save_point_cloud
    from wast3d_tpu_torch.utils import png, profiling
    from wast3d_tpu_torch.viewer import nerfstudio_shim, network_gui, web

    t0 = time.perf_counter()
    numbers = {"n_gaussians": n, "res": res,
               "pil_installed": importlib.util.find_spec("PIL") is not None}
    scene = make_scene(bench_scene(n), device)
    bg = torch.zeros(3, device=device)
    view_settings = api.RasterizeSettings(renderer="pallas", dup_capacity=1 << 21,
                                          fast_chain=True)  # cli.view's defaults
    f32 = api.RasterizeSettings()  # the training settings: K1

    # -- the web viewer, in process
    t1 = time.perf_counter()
    wants = [web.render_orbit_frame(scene, y, p, r, res, settings=view_settings, device=device)
             for y, p, r in VIEWER_ORBITS]
    srv = web.serve_scene(scene, port=free_port(), settings=view_settings, background=True,
                          device=device)
    try:
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        page = http_get(base + "/")
        info = json.loads(http_get(base + "/info"))
        urls = [f"{base}/frame?yaw={y!r}&pitch={p!r}&radius={r!r}&res={res}"
                for y, p, r in VIEWER_ORBITS]
        reset_kernel_counts()
        blobs = [http_get(u) for u in urls]
        web_launches = kernel_counts()
        web_equal = [bool(np.array_equal(png.decode_png(b), w)) for b, w in zip(blobs, wants)]
        render_ms, encode_ms, http_ms = [], [], []
        for _ in range(VIEWER_REPS):
            t = time.perf_counter()
            frame = web.render_orbit_frame(scene, *VIEWER_ORBITS[0], res, settings=view_settings,
                                           device=device)
            render_ms.append((time.perf_counter() - t) * 1e3)
            t = time.perf_counter()
            png.encode_png(frame)
            encode_ms.append((time.perf_counter() - t) * 1e3)
            t = time.perf_counter()
            http_get(urls[0])
            http_ms.append((time.perf_counter() - t) * 1e3)
        try:
            http_get(base + "/nope")
            not_found = None
        except urllib.error.HTTPError as e:
            not_found = e.code
    finally:
        srv.shutdown()
        srv.server_close()
    numbers.update(web_info=info, web_page_has_frame_url=b"/frame?" in page,
                   web_frames_bit_equal=web_equal, web_launches=web_launches,
                   web_not_found=not_found, frame_render_ms_median=statistics.median(render_ms),
                   frame_png_encode_ms_median=statistics.median(encode_ms),
                   frame_http_round_trip_ms_median=statistics.median(http_ms),
                   web_s=time.perf_counter() - t1)
    if (info != {"num_gaussians": n} or not all(web_equal) or not_found != 404
            or web_launches != only(blend_fwd_fast=len(VIEWER_ORBITS))):
        raise AssertionError(f"web viewer: {numbers}")

    with tempfile.TemporaryDirectory(prefix="w3d_chip_smoke_view_") as tmp:
        # -- cli.view, as a user starts it
        t1 = time.perf_counter()
        model = os.path.join(tmp, "model")
        save_point_cloud(model, 1, scene)
        port = free_port()
        log_path = os.path.join(tmp, "view.log")
        with open(log_path, "w") as log:
            env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
            proc = subprocess.Popen([sys.executable, "-m", "wast3d_tpu_torch.cli.view", "-m", model,
                                     "--port", str(port), "--device", device.type], cwd=ROOT,
                                    stdout=log, stderr=subprocess.STDOUT, env=env)
        try:
            view_info = None
            while time.perf_counter() - t1 < VIEW_UP_S and proc.poll() is None:
                try:
                    view_info = json.loads(http_get(f"http://127.0.0.1:{port}/info", 2.0))
                    break
                except OSError:
                    time.sleep(0.2)
            up_s = time.perf_counter() - t1
            if view_info is None:
                raise AssertionError(f"cli.view did not answer /info in {VIEW_UP_S} s "
                                     f"(exit {proc.poll()}): {open(log_path).read()[-2000:]}")
            y, p, r = VIEWER_ORBITS[0]
            view_blob = http_get(f"http://127.0.0.1:{port}/frame?yaw={y!r}&pitch={p!r}"
                                 f"&radius={r!r}&res={res}")
        finally:
            proc.terminate()
            try:
                proc.wait(10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(10)
        view_equal = bool(np.array_equal(png.decode_png(view_blob), wants[0]))
        numbers.update(cli_view_up_s=up_s, cli_view_info=view_info,
                       cli_view_frame_bit_equal=view_equal, cli_view_s=time.perf_counter() - t1)
        if view_info != {"num_gaussians": n} or not view_equal:
            raise AssertionError(f"cli.view: info {view_info}, frame equal {view_equal}")

        # -- the SIBR server, at 800 x 800, through K1
        t1 = time.perf_counter()
        verify = "/chip_smoke/model"
        canonical = dict(SIBR_CANONICAL, resolution_x=res, resolution_y=res)
        want_canonical = gui_camera_render(canonical, scene, f32, bg, device)
        req = sibr_request(web.orbit_camera(*VIEWER_ORBITS[1], res, device=device), res, res)
        want = gui_camera_render(req, scene, f32, bg, device)
        gui = network_gui.NetworkGUI(host="127.0.0.1", port=free_port(), verify=verify)
        replies = {}

        def sibr_client():
            with socket.create_connection(("127.0.0.1", gui.port), timeout=30) as s:
                s.settimeout(30)
                s.sendall(sibr_frame(canonical))
                replies["canonical"] = sibr_reply(s, res, res, verify)
                s.sendall(sibr_frame(req))
                replies["frame"] = sibr_reply(s, res, res, verify)
                s.sendall(sibr_frame(dict(req, resolution_x=0, resolution_y=0)))
                replies["keep_alive"] = sibr_reply(s, 0, 0, verify)

        client = threading.Thread(target=sibr_client, daemon=True)
        try:
            client.start()
            reset_kernel_counts()
            deadline = time.perf_counter() + 30
            while "frame" not in replies and client.is_alive() and time.perf_counter() < deadline:
                network_gui.serve_scene(gui, scene, settings=f32, bg_color=bg, device=device)
                time.sleep(0.005)
            sibr_launches = kernel_counts()
            client.join(30)
        finally:
            gui.stop()
        if client.is_alive():
            raise AssertionError("the SIBR client did not finish within 30 s")
        rgb, got_verify = replies.get("frame", (None, None))
        sibr_equal = rgb == want.tobytes()
        rgb0, verify0 = replies.get("canonical", (None, None))
        canonical_equal = rgb0 == want_canonical.tobytes() and verify0 == verify
        keep = replies.get("keep_alive")
        numbers.update(sibr_frame_bytes=None if rgb is None else len(rgb),
                       sibr_canonical_frame_bit_equal=canonical_equal,
                       sibr_frame_bit_equal=sibr_equal, sibr_verify=got_verify,
                       sibr_keep_alive=keep, sibr_launches=sibr_launches,
                       sibr_frame_mean=float(want.mean()), sibr_s=time.perf_counter() - t1)
        if (not sibr_equal or not canonical_equal or got_verify != verify
                or keep != (None, verify) or sibr_launches != only(blend_fwd=2)
                or want.max() == 0):
            raise AssertionError(f"SIBR server: {numbers}")

        # -- cli.train --port on the COLMAP + JPEG fixture, with a live-view client
        t1 = time.perf_counter()
        src, model = os.path.join(tmp, "colmap_jpeg"), os.path.join(tmp, "trained")
        shutil.copytree(os.path.join(FIXTURES, "colmap_jpeg"), src)
        port = free_port()
        report_renders = 2 * min(5, 6)  # two reports, each over train_cams[:5] of the 6 views
        live = {"frames": 0, "framing_ok": True, "stop": False, "errors": []}
        from wast3d_tpu_torch.scene import datasets

        with without_pil():
            first = datasets.read_colmap_scene(src).train_cameras[:1]  # the first view's camera
        cam = datasets.build_cameras(first, device="cpu")[0][0]
        w, h = cam.width, cam.height
        request = sibr_request(cam, w, h)

        def live_client():
            deadline = time.perf_counter() + 60
            while not live["stop"] and time.perf_counter() < deadline:
                try:
                    s = socket.create_connection(("127.0.0.1", port), timeout=10)
                    break
                except OSError:
                    time.sleep(0.05)
            else:
                return
            live["sock"] = s
            with s:
                s.settimeout(10)
                while not live["stop"]:
                    try:
                        s.sendall(sibr_frame(request))
                        rgb, v = sibr_reply(s, w, h, "")
                    except OSError as e:  # shut down after training: a request unserved
                        live["errors"].append(repr(e))
                        return
                    live["framing_ok"] &= len(rgb) == w * h * 3 and v == ""
                    live["frames"] += 1
                    time.sleep(GUI_REQUEST_EVERY_S)

        client = threading.Thread(target=live_client, daemon=True)
        reset_kernel_counts()
        client.start()
        try:
            with without_pil():  # the JPEGs decode natively
                cli_train.main(["-s", src, "-m", model, "--iterations", str(GUI_TRAIN_ITERS),
                                "--save_iterations", str(GUI_TRAIN_ITERS // 2),
                                str(GUI_TRAIN_ITERS), "--port", str(port), "--quiet",
                                "--device", device.type])
            torch.cuda.synchronize()
        finally:
            live["stop"] = True
        cli_s = time.perf_counter() - t1
        train_launches = kernel_counts()
        # Every frame served is a K1 launch beyond the steps and the reports:
        # let the client read each of them, then unblock its last request.
        served = train_launches["blend_fwd"] - GUI_TRAIN_ITERS - report_renders
        deadline = time.perf_counter() + 10
        while live["frames"] < served and client.is_alive() and time.perf_counter() < deadline:
            time.sleep(0.01)
        if "sock" in live:
            try:
                live["sock"].shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        client.join(15)
        if client.is_alive():
            raise AssertionError("the live-view client did not stop within 15 s")
        log = [json.loads(line) for line in open(os.path.join(model, "log.jsonl"))]
        reports = [(e["iter"], e["psnr_train"]) for e in log if "psnr_train" in e]
        losses = [(e["iter"], e["loss"]) for e in log if "loss" in e]
    frames = live["frames"]
    want_launches = only(blend_fwd=GUI_TRAIN_ITERS + frames + report_renders,
                         blend_bwd=GUI_TRAIN_ITERS, segment_sum=GUI_TRAIN_ITERS)
    numbers.update(train_iterations=GUI_TRAIN_ITERS, train_frames_served=frames,
                   train_framing_ok=live["framing_ok"], train_client_errors=live["errors"],
                   train_launches=train_launches, train_reports_psnr=reports,
                   train_losses=losses, train_cli_s=cli_s)
    if (frames == 0 or not live["framing_ok"] or train_launches != want_launches
            or len(reports) != 2 or not reports[1][1] > reports[0][1]):
        raise AssertionError(f"cli.train --port: {numbers}, want launches {want_launches}")

    # -- nerfstudio's outputs, through K1, against the plain render's
    t1 = time.perf_counter()
    cam = view_camera(res, res, device, eye=(0, 0, -3), fov=0.9)
    with torch.no_grad():
        reset_kernel_counts()
        ns = nerfstudio_shim.render_viewer_outputs(scene, cam, [0, 0, 0], device=device)
        torch.cuda.synchronize()
        ns_launches = kernel_counts()
        plain = nerfstudio_shim.render_viewer_outputs(
            scene, cam, [0, 0, 0], settings=api.RasterizeSettings(renderer="tiled"),
            device=device)
    ns_diff = {k: float((ns[k] - plain[k]).abs().max()) for k in ns}
    ns_mean = {k: float((ns[k] - plain[k]).abs().mean()) for k in ns}
    depth = api.render(cam, scene, bg, settings=f32, device=device)["depth"]  # K1's, raw
    # The near-plane clamp (depth < 2 -> 1e10) is a step: a pixel whose depth
    # K1 and the plain version put on either side of 2 (within K1's depth
    # limit of it) flips between 1/2 and 1e-10. Hold the inverse depth where
    # both sides agree on the clamp, and the flips to that band.
    clamped_k1, clamped_plain = (ns["depth"][..., 0] < 1e-9), (plain["depth"][..., 0] < 1e-9)
    flips = clamped_k1 != clamped_plain
    same = ~flips
    ns_diff["depth"] = float((ns["depth"][..., 0] - plain["depth"][..., 0])[same].abs().max())
    flips_in_band = bool(((depth[flips] - 2.0).abs() <= TOL_DEPTH).all())
    fg = depth > 0
    inner = fg.clone()
    for dy, dx in ((1, 0), (-1, 0), (0, 1), (0, -1)):
        inner &= torch.roll(fg, (dy, dx), (0, 1))
    inner[0, :] = inner[-1, :] = inner[:, 0] = inner[:, -1] = False
    norms = torch.linalg.norm(ns["rgb"] * 2 - 1, dim=-1)[inner]
    unit_err = float((norms - 1).abs().max())
    numbers.update(ns_launches=ns_launches, ns_vs_tiled_max=ns_diff, ns_vs_tiled_mean=ns_mean,
                   ns_clamp_flips=int(flips.sum()), ns_clamp_flips_within_depth_limit=flips_in_band,
                   ns_normals_unit_err=unit_err, ns_foreground_pixels=int(inner.sum()),
                   ns_s=time.perf_counter() - t1)
    if (ns_launches != only(blend_fwd=1) or ns_diff["rgb1"] > TOL_MAX
            or ns_diff["depth"] > TOL_DEPTH or not flips_in_band or unit_err > 1e-5
            or int(inner.sum()) == 0):
        raise AssertionError(f"nerfstudio outputs: {numbers}")

    # -- utils.profiling around one K1f frame
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="w3d_chip_smoke_trace_") as tmp:
        with profiling.trace(tmp):
            web.render_orbit_frame(scene, *VIEWER_ORBITS[0], res, settings=view_settings,
                                   device=device)
        traces = [os.path.join(tmp, f) for f in os.listdir(tmp)]
        names_k1f = any("blend_fwd_fast_kernel" in open(f).read() for f in traces)
    mem = profiling.device_memory_stats(device)
    numbers.update(trace_files=len(traces), trace_names_k1f=names_k1f, memory=mem,
                   profiling_s=time.perf_counter() - t1)
    if (len(traces) != 1 or not names_k1f
            or not 0 < mem.get("bytes_in_use", 0) <= mem.get("bytes_limit", 0)):
        raise AssertionError(f"profiling: {numbers}")
    emit("viewer_entry_point", t0, **numbers)
    return train_launches


# ---- the WaSt-3D pipeline -----------------------------------------------------

def torus_scene(n=STYLE_SCENE_N, seed=3, major=1.0, minor=0.35):
    """A seeded torus about the y axis: the pipeline's style scene, of
    another shape than the content shell."""
    rng = np.random.default_rng(seed)
    u, v = rng.uniform(0, 2 * np.pi, n), rng.uniform(0, 2 * np.pi, n)
    ring = major + minor * np.cos(v)
    xyz = np.stack([ring * np.cos(u), minor * np.sin(v), ring * np.sin(u)], 1)
    rgb = np.stack([0.5 + 0.4 * np.cos(u), 0.5 + 0.4 * np.sin(3 * v), 0.5 + 0.3 * np.sin(u)], 1)
    return scene_arrays(xyz=xyz, rgb=rgb, scale=rng.uniform(0.006, 0.015, (n, 3)),
                        opacity=rng.uniform(0.5, 0.9, (n, 1)))


def phase_pipeline_entry_point(device, iters=PIPELINE_ITERS, frames=PIPELINE_FRAMES,
                               clusters=PIPELINE_CLUSTERS, n=FULL_N, style_n=STYLE_SCENE_N,
                               res=FULL_RES):
    """`cli.pipeline`, the WaSt-3D run, on two 6-view 800x800 Blender
    datasets: the 200k shell as content and a 60k-point torus as style, each
    with its own points as the initial cloud. Cut from 30k iterations to
    `iters` each and from 60 turntable frames to `frames`; `clusters` style
    clusters, so that cluster 0 holds more than 2,048 points and K4/K5 carry
    its fit. Every kernel's count is set to 0 just before the CLI and read
    just after: K1, K2, K3 (training, report renders, turntable), K4, K5
    (stylization). Returns {kernel name: launches}."""
    from wast3d_tpu_torch.cli import pipeline as cli
    from wast3d_tpu_torch.core.sh import sh_to_rgb
    from wast3d_tpu_torch.scene.datasets import store_ply_points
    from wast3d_tpu_torch.scene.ply import load_ply
    from wast3d_tpu_torch.config import StylizeConfig
    from wast3d_tpu_torch.stylize.cluster import load_cluster
    from wast3d_tpu_torch.stylize.fit import KERNEL_MIN_MP, padded_patch_size
    from wast3d_tpu_torch.stylize.pipeline import clean_style_patch
    from wast3d_tpu_torch.utils.png import read_png

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="w3d_chip_smoke_pipeline_") as tmp:
        data = {}
        for name, arrays in (("content", bench_scene(n)), ("style", torus_scene(style_n))):
            data[name] = os.path.join(tmp, name)
            write_blender_dataset(data[name], make_scene(arrays, device), device, res)
            rgb = np.clip(sh_to_rgb(arrays["features_dc"][:, 0, :]), 0.0, 1.0) * 255.0
            store_ply_points(os.path.join(data[name], "points3d.ply"), arrays["xyz"], rgb)
        work = os.path.join(tmp, "work")
        t_setup = time.perf_counter() - t0

        reset_kernel_counts()
        t1 = time.perf_counter()
        report = cli.main(["--content_data", data["content"], "--style_data", data["style"],
                           "--workdir", work, "--iterations", str(iters),
                           "--num_clusters", str(clusters),
                           "--turntable_frames", str(frames), "--device", device.type])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t1
        launches = kernel_counts()

        patch = load_cluster(os.path.join(work, "style_clusters", "cluster_0.npz"))
        cluster0 = len(patch)
        # the patch the fit saw (cleaned as stylize_scene cleans it) and its padded size
        cleaned = len(clean_style_patch(patch, device=device))
        mp = padded_patch_size(cleaned, StylizeConfig().desc_block)
        out = load_ply(os.path.join(work, "stylized.ply"), device=device)
        finite = bool(torch.isfinite(out.xyz).all())
        turntable = os.path.join(work, "turntable")
        written = sorted(os.listdir(turntable))
        lit = [int(read_png(os.path.join(turntable, f)).max()) for f in written]
        shapes = {read_png(os.path.join(turntable, f)).shape for f in written}
    want_zero = ("blend_fwd_fast", "blend_bwd_fast", "pack_gather")
    if (any(launches[k] == 0 for k in launches if k not in want_zero)
            or any(launches[k] for k in want_zero)
            or not launches["blend_bwd"] == launches["segment_sum"] == 2 * iters):
        raise AssertionError(f"launches {launches}: want K1-K5 all launched, K2 = K3 = "
                             f"{2 * iters} (two reconstructions), no bf16-tier kernel")
    if cluster0 <= KERNEL_MIN_MP or not finite or out.capacity == 0:
        raise AssertionError(f"cluster 0 has {cluster0} points (want > {KERNEL_MIN_MP}); stylized "
                             f"{out.capacity} Gaussians, finite {finite}")
    # 800 x 800: spiral_path's default size
    if len(written) != frames or shapes != {(800, 800, 3)} or min(lit) == 0:
        raise AssertionError(f"turntable: {written}, shapes {shapes}, brightest {lit}")
    emit("pipeline_entry_point", t0, iterations=iters, num_clusters=clusters,
         turntable_frames=frames, width=res, height=res, content_n=report["content_n"],
         style_n_after_stage_2=report["style_n"], cluster_0_n=cluster0,
         patch_cleaned_n=cleaned, padded_mp=mp, stylized_n=report["stylized_n"],
         frames_written=len(written), stage_s=report["stage_s"], launches=launches,
         setup_s=t_setup, cli_s=cli_s)
    return launches


# ---- evaluation and refinement ------------------------------------------------

@contextlib.contextmanager
def torch_default_tf32():
    """cuDNN and matmul TF32 flags at PyTorch's defaults (cuDNN TF32 on,
    matmul off) for the block, as a user's process has them; this script's
    own (both off) come back after it."""
    knobs = (torch.backends.cudnn, torch.backends.cuda.matmul)
    saved = [k.allow_tf32 for k in knobs]
    for k, v in zip(knobs, (True, False)):
        k.allow_tf32 = v
    try:
        yield
    finally:
        for k, v in zip(knobs, saved):
            k.allow_tf32 = v


def rel_diff(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


@contextlib.contextmanager
def unguarded_convolutions():
    """VGG / LPIPS convolutions under the caller's TF32 flags: `full_f32`
    replaced by a no-op for the block (a diagnostic of what it guards)."""
    from wast3d_tpu_torch.ops import vgg

    guard = vgg.full_f32
    vgg.full_f32 = contextlib.nullcontext
    try:
        yield
    finally:
        vgg.full_f32 = guard


def phase_eval_entry_point(device, n=FULL_N, res=FULL_RES):
    """The evaluation chain as a user runs it, with the TF32 flags at
    PyTorch's defaults: `cli.render` of the bench shell on a 6-view 800x800
    Blender dataset of its jittered copy, in both tiers (K1f by default, K1 with --no-fast), then
    `render_set(save_depth=True)` of the test split (K1), then `cli.metrics
    -m` on both models. Each has the kernel counts set to 0 just before and
    read just after. The card's metrics are held to `evaluate_dir` on the
    CPU on the same PNGs (`EVAL_TOL`). Returns {step: launches}."""
    import shutil

    from wast3d_tpu_torch.cli import metrics as cli_metrics
    from wast3d_tpu_torch.cli import render as cli_render
    from wast3d_tpu_torch.eval.metrics import evaluate_dir
    from wast3d_tpu_torch.eval.render_sets import render_set
    from wast3d_tpu_torch.ops.lpips import LPIPS
    from wast3d_tpu_torch.ops.rasterizer import api
    from wast3d_tpu_torch.scene import datasets
    from wast3d_tpu_torch.scene.ply import save_ply
    from wast3d_tpu_torch.utils.png import read_png

    t0 = time.perf_counter()
    scene = make_scene(bench_scene(n), device)
    with tempfile.TemporaryDirectory(prefix="w3d_chip_smoke_eval_") as tmp:
        src = os.path.join(tmp, "scene")
        models = {tier: os.path.join(tmp, f"model_{tier}") for tier in ("fast", "f32")}
        # ground truth from the sigma = 0.002 jittered copy, so that every
        # metric is finite and away from its limit
        views = write_blender_dataset(src, make_scene(perturbed(bench_scene(n)), device),
                                      device, res)
        save_ply(scene, os.path.join(models["fast"], "point_cloud", "iteration_1",
                                     "point_cloud.ply"))
        shutil.copytree(models["fast"], models["f32"])
        info = datasets.load_scene_info(src, eval_split=True)
        test_cams = datasets.build_cameras(info.test_cameras, device=device)
        t_setup = time.perf_counter() - t0

        launches, step_s = {}, {}

        def counted(step, fn):
            reset_kernel_counts()
            t1 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            step_s[step] = time.perf_counter() - t1
            launches[step] = kernel_counts()
            return out

        with torch_default_tf32():
            flags = {"cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
                     "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32}
            for tier, extra in (("fast", []), ("f32", ["--no-fast"])):
                counted(f"render_{tier}", lambda: cli_render.main(
                    ["-m", models[tier], "-s", src, *extra, "--device", device.type]))
            base = counted("render_set_depth", lambda: render_set(
                models["f32"], "test", 1, test_cams, scene, torch.zeros(3, device=device),
                api.RasterizeSettings(), save_depth=True, device=device))
            results = counted("metrics", lambda: cli_metrics.main(
                ["-m", models["fast"], models["f32"], "--device", device.type]))
        depth_files = sorted(os.listdir(os.path.join(base, "depth")))
        depth_pngs = [read_png(os.path.join(base, "depth", f)) for f in depth_files]
        on_disk = {tier: [json.load(open(os.path.join(models[tier], name)))
                          for name in ("results.json", "per_view.json")] for tier in models}
        t1 = time.perf_counter()
        cpu = {tier: evaluate_dir(os.path.join(models[tier], "test", "ours_1"), device="cpu")
               for tier in models}
        cpu_s = time.perf_counter() - t1
        # what the guard prevents: the same LPIPS with `full_f32` bypassed,
        # under the default flags (reported, not held)
        view = os.path.join(models["f32"], "test", "ours_1")
        pair = [read_png(os.path.join(view, d, "00000.png")).astype(np.float32) / 255.0
                for d in ("renders", "gt")]
        with torch_default_tf32(), unguarded_convolutions(), torch.no_grad():
            unguarded = float(LPIPS(device=device)(*pair))
        unguarded_rel = rel_diff(unguarded, cpu["f32"]["per_view"]["LPIPS_PROXY"]["00000.png"])
    n_test = len(test_cams)
    want = {"render_fast": only(blend_fwd_fast=views), "render_f32": only(blend_fwd=views),
            "render_set_depth": only(blend_fwd=n_test), "metrics": only()}
    if launches != want:
        raise AssertionError(f"launches {launches}, want {want}")
    if (depth_files != [f"{i:05d}.png" for i in range(n_test)]
            or any(d.shape != (res, res, 3) or d.min() != 0 or d.max() < 254
                   or not (d == d[..., :1]).all() for d in depth_pngs)):
        raise AssertionError(f"depth PNGs {depth_files}: "
                             f"{[(d.shape, int(d.min()), int(d.max())) for d in depth_pngs]}")
    keys, names = list(EVAL_TOL), [f"{i:05d}.png" for i in range(n_test)]
    worst, lpips_rel = dict.fromkeys(keys, 0.0), 0.0
    for tier, (res_json, per_view) in on_disk.items():
        if (res_json != results[models[tier]] or list(res_json) != ["ours_1"]
                or list(res_json["ours_1"]) != ["SSIM", "PSNR", "LPIPS_PROXY"]
                or list(per_view) != ["ours_1"]
                or list(per_view["ours_1"]) != list(res_json["ours_1"])
                or any(list(v) != names for v in per_view["ours_1"].values())):
            raise AssertionError(f"{tier}: results.json {res_json}, per_view.json {per_view}")
        for key in keys:
            for name in names:
                if not math.isfinite(per_view["ours_1"][key][name]):
                    raise AssertionError(f"{tier}: {key} of {name} is not finite: {per_view}")
                worst[key] = max(worst[key], abs(per_view["ours_1"][key][name]
                                                 - cpu[tier]["per_view"][key][name]))
            lpips_rel = max(lpips_rel, rel_diff(per_view["ours_1"]["LPIPS_PROXY"][name],
                                                cpu[tier]["per_view"]["LPIPS_PROXY"][name]))
    if any(worst[k] > EVAL_TOL[k] for k in keys) or lpips_rel > LPIPS_REL_TOL:
        raise AssertionError(f"card metrics differ from the CPU's by {worst}, LPIPS by "
                             f"{lpips_rel} of itself (limits {EVAL_TOL}, {LPIPS_REL_TOL})")
    evaluated = len(models) * n_test
    emit("eval_entry_point", t0, views=views, width=res, height=res, tf32_flags=flags,
         launches=launches, step_s=step_s, results={t: results[m] for t, m in models.items()},
         max_card_vs_cpu=worst, limits=EVAL_TOL, lpips_card_vs_cpu_rel=lpips_rel,
         lpips_rel_limit=LPIPS_REL_TOL, lpips_unguarded_tf32_vs_cpu_rel=unguarded_rel,
         views_evaluated=evaluated,
         metrics_s_per_view=step_s["metrics"] / evaluated, cpu_metrics_s=cpu_s,
         setup_s=t_setup)
    return launches


def procedural_style_image(res, seed=5):
    """A seeded [res, res, 3] image: three oblique colour waves and noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:res, 0:res] / res
    waves = [0.5 + 0.4 * np.sin(2 * np.pi * (f * x + g * y) + ph)
             for f, g, ph in rng.uniform([2, -6, 0], [9, 6, 6], (3, 3))]
    img = np.stack(waves, -1) + rng.normal(0, 0.05, (res, res, 3))
    return np.clip(img, 0, 1).astype(np.float32)


def phase_refine_entry_point(device, n=FULL_N, res=FULL_RES, steps=REFINE_STEPS,
                             k=TELEPORT_K, style_n=STYLE_SCENE_N):
    """`refine.drivers.refine` in its five modes with the default settings
    on the 200k shell at 800x800 (3 views; ground truth a K1 render of the
    sigma = 0.002 jittered copy, the target depth that render's depth
    blurred, a seeded procedural style image), `steps` steps each, with the
    counts set to 0 just before each mode and read just after; then
    `cluster_teleport` of the pipeline's 60k torus onto the shell (K = 500)
    and `get_intracluster_stats` on the result. Each step's time is taken on
    the host around a synchronised `refine_step`. Returns {mode: launches}."""
    from wast3d_tpu_torch.config import OptimizationConfig
    from wast3d_tpu_torch.ops.depth import gaussian_blur
    from wast3d_tpu_torch.ops.rasterizer import api
    from wast3d_tpu_torch.refine import drivers, teleport
    from wast3d_tpu_torch.refine.intracluster import get_intracluster_stats
    from wast3d_tpu_torch.train.reconstruct import init_train_state

    t0 = time.perf_counter()
    scene = make_scene(bench_scene(n), device)
    jittered = make_scene(perturbed(bench_scene(n)), device)
    bg = torch.zeros(3, device=device)
    cameras, depths = [], []
    for i in range(REFINE_VIEWS):
        a = 2 * math.pi * i / REFINE_VIEWS
        cam = view_camera(res, res, device, eye=(3 * math.sin(a), 0.3, -3 * math.cos(a)),
                          fov=0.9)
        with torch.no_grad():
            out = api.render(cam, jittered, bg, device=device)
        cameras.append((cam, out["render"]))
        depths.append(gaussian_blur(out["depth"], DEPTH_BLUR_SIGMA))
    style = procedural_style_image(res)
    opt_cfg = OptimizationConfig()

    def depth_mse(sc):
        with torch.no_grad():
            return float(np.mean([float(torch.mean(
                (api.render(cam, sc, bg, device=device)["depth"] - d) ** 2))
                for (cam, _), d in zip(cameras, depths)]))

    t_setup = time.perf_counter() - t0
    plain_step, step_ms = drivers.refine_step, []

    def timed_step(*args, **kwargs):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = plain_step(*args, **kwargs)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        return out

    modes, launches = {}, {}
    drivers.refine_step = timed_step
    try:
        for mode in drivers.RefineMode:
            state = init_train_state(scene, opt_cfg, 1.0)
            before = depth_mse(state.scene) if mode is drivers.RefineMode.DEPTH_TARGET else None
            step_ms.clear()
            reset_kernel_counts()
            state, losses = drivers.refine(state, cameras, mode, steps, style_image=style,
                                           target_depths=depths, opt_cfg=opt_cfg)
            torch.cuda.synchronize()
            launches[mode.value] = kernel_counts()
            finite = all(bool(torch.isfinite(v).all()) for v in state.scene.params().values())
            modes[mode.value] = {"losses": losses, "step_ms_median": statistics.median(step_ms),
                                 "step_ms": list(step_ms), "params_finite": finite}
            if before is not None:
                modes[mode.value]["depth_mse"] = [before, depth_mse(state.scene)]
    finally:
        drivers.refine_step = plain_step

    want = only(blend_fwd=steps, blend_bwd=steps, segment_sum=steps)
    bad = {m: v for m, v in launches.items() if v != want}
    if bad:
        raise AssertionError(f"launches {bad}, want {want} in every mode")
    for m, r in modes.items():
        if not (all(math.isfinite(x) for x in r["losses"]) and r["params_finite"]):
            raise AssertionError(f"{m}: losses {r['losses']}, finite params {r['params_finite']}")
    mse = modes[drivers.RefineMode.DEPTH_TARGET.value]["depth_mse"]
    if not mse[1] < mse[0]:
        raise AssertionError(f"depth_target: depth MSE {mse[0]} -> {mse[1]} did not fall")

    # teleport, with k-means' centres caught on their way out
    centres = []
    plain_kmeans = teleport.kmeans

    def caught_kmeans(*args, **kwargs):
        out = plain_kmeans(*args, **kwargs)
        centres.append(out[0])
        return out

    style_scene = make_scene(torus_scene(style_n), device)
    teleport.kmeans = caught_kmeans
    try:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        tele, labels = teleport.cluster_teleport(scene, style_scene, num_clusters=k)
        torch.cuda.synchronize()
        teleport_s = time.perf_counter() - t1
    finally:
        teleport.kmeans = plain_kmeans
    cnt_c, stl_c = (c.astype(np.float64) for c in centres)
    before_xyz = style_scene.xyz.cpu().numpy().astype(np.float64)
    after_xyz = tele.xyz.cpu().numpy().astype(np.float64)
    shift_err, mean_err, clusters = 0.0, 0.0, 0
    for i in range(k):
        members = labels == i
        if not members.any():
            continue
        clusters += 1
        gap = after_xyz[members].mean(0) - cnt_c[i]
        shift_err = max(shift_err, float(np.abs(gap - (before_xyz[members].mean(0)
                                                       - stl_c[i])).max()))
        mean_err = max(mean_err, float(np.linalg.norm(gap)))
    if shift_err > TELEPORT_SHIFT_TOL or mean_err > TELEPORT_MEAN_TOL:
        raise AssertionError(f"teleport: cluster mean - content centre off its shift by "
                             f"{shift_err} (limit {TELEPORT_SHIFT_TOL}), from the centre by "
                             f"{mean_err} (limit {TELEPORT_MEAN_TOL})")
    t1 = time.perf_counter()
    dists = get_intracluster_stats(tele, labels, ("xyz",), num_clusters=k)["xyz"]
    torch.cuda.synchronize()
    stats_s = time.perf_counter() - t1
    big = int(np.bincount(labels, minlength=k).argmax())
    pts = after_xyz[labels == big]
    ref = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    m = len(pts)
    got = dists[big, :m, :m].double().cpu().numpy() ** 2
    stats_err = float(np.abs(got - ref).max())
    padding_zero = bool((dists[big, m:] == 0).all()) and bool((dists[big, :, m:] == 0).all())
    # matrix-product distances: float32 rounding of |a|^2 + |b|^2 - 2 a.b is
    # ~1e-6 in d^2 at |x| < 2.5
    if not (bool(torch.isfinite(dists).all()) and stats_err <= 1e-5 and padding_zero):
        raise AssertionError(f"intracluster stats: squared distances off float64 by "
                             f"{stats_err}, padding zero {padding_zero}")
    emit("refine_entry_point", t0, views=REFINE_VIEWS, width=res, height=res, steps=steps,
         launches=launches, modes=modes, teleport_k=k, teleport_s=teleport_s,
         teleport_clusters=clusters, teleport_shift_err=shift_err, teleport_mean_err=mean_err,
         intracluster_shape=list(dists.shape), intracluster_s=stats_s,
         intracluster_sq_err_largest_cluster=stats_err, setup_s=t_setup)
    return launches


# ---- stylization: K4 / K5 against their plain versions ------------------------

def k45_case(mp, balls, m, seed, density=0.02):
    """Seeded K4/K5 inputs: m real points of mp (the rest padded rows, which
    coincide and carry no code), two coincident real pairs with nonzero
    code, and a random code with every value of {0, 1, 2, 3}."""
    rng = np.random.default_rng(seed)
    tp = np.zeros((mp, 3), np.float32)
    tp[:m] = rng.normal(size=(m, 3)) * 0.5
    x = np.zeros((balls, mp, 3), np.float32)
    x[:, :m] = tp[:m] * 1.3 + rng.normal(size=(balls, m, 3)) * 0.05
    x[:, m:] = rng.normal(size=(balls, 1, 3))
    x[:, 5], x[:, 17] = x[:, 9], x[:, 40]
    code = np.zeros((mp, mp), np.uint8)
    code[:m, :m] = np.where(rng.random((m, m)) < density, rng.integers(1, 4, (m, m)), 0)
    code[5, 9], code[9, 5], code[17, 40] = 3, 1, 2
    return x, tp, code, 0.7, 1.9


def compare_k45(x, tp, code, pairs, cg, cl):
    """K4 and K5 (both on the pair list of `code`) twice each and their
    plain versions on the same inputs, K4 also against the dense plain
    version on the code; raises past tolerance or if two runs differ in any
    bit. Returns (loss relative error, gradient error over the plain max
    |g|, K4 and K5 max absolute errors, K4's relative error against the
    dense plain version)."""
    from wast3d_tpu_torch.stylize import desc_kernel as dk

    loss, loss2 = dk.desc_loss(x, tp, pairs, cg, cl), dk.desc_loss(x, tp, pairs, cg, cl)
    grad, grad2 = dk.desc_grad(x, tp, pairs, cg, cl), dk.desc_grad(x, tp, pairs, cg, cl)
    ref_loss = dk.pair_loss_list_reference(x, tp, pairs, cg, cl)
    dense_loss = dk.pair_loss_reference(x, tp, code, cg, cl)
    ref_grad = dk.pair_grad_list_reference(x, tp, pairs, cg, cl)
    torch.cuda.synchronize()
    if not (torch.equal(loss, loss2) and torch.equal(grad, grad2)):
        raise AssertionError("K4/K5: two runs on the same inputs differ")
    if not (torch.isfinite(loss).all() and torch.isfinite(grad).all()):
        raise AssertionError("K4/K5: non-finite values")
    loss_err = float(((loss - ref_loss).abs() / ref_loss.abs()).max())
    dense_err = float(((loss - dense_loss).abs() / dense_loss.abs()).max())
    gmax = float(ref_grad.abs().max())
    grad_err = float((grad - ref_grad).abs().max()) / gmax
    if loss_err > K45_LOSS_RTOL or dense_err > K45_LOSS_RTOL:
        raise AssertionError(f"K4 vs plain: relative error {loss_err} on the list, {dense_err} "
                             f"against the dense version (limit {K45_LOSS_RTOL})")
    if grad_err > K45_GRAD_ATOL_REL:
        raise AssertionError(f"K5 vs plain: {grad_err} of max |g| (limit {K45_GRAD_ATOL_REL})")
    return (loss_err, grad_err, float((loss - ref_loss).abs().max()),
            float((grad - ref_grad).abs().max()), dense_err)


def phase_k45_cases(device):
    from wast3d_tpu_torch.stylize.desc_kernel import build_pair_list, desc_grad

    t0 = time.perf_counter()
    out = {}
    for mp in (1024, 2048, 4096):
        for balls in (1, 3, 9):  # 9: two passes of 8 balls over a row
            m = mp - 100 + balls
            x, tp, code, cg, cl = k45_case(mp, balls, m=m, seed=mp + balls)
            xt, tpt, ct = (torch.from_numpy(a).to(device) for a in (x, tp, code))
            pairs = build_pair_list(ct)
            asymmetric = int((code != code.T).sum())
            if asymmetric == 0:
                raise AssertionError("the K4/K5 case's code is symmetric")
            loss_err, grad_err, _, _, dense_err = compare_k45(xt, tpt, ct, pairs, cg, cl)
            pad_grad = float(desc_grad(xt, tpt, pairs, cg, cl)[:, m:].abs().max())
            if pad_grad != 0.0:
                raise AssertionError(f"K5: padded rows got gradient {pad_grad}")
            out[f"mp{mp}_b{balls}"] = {"nonzero_pairs": int((code != 0).sum()),
                                       "asymmetric_pairs": asymmetric,
                                       "loss_rel_err": loss_err,
                                       "loss_rel_err_vs_dense": dense_err,
                                       "grad_err_of_max": grad_err}
    emit("k4k5_cases", t0, cases=out, loss_rtol=K45_LOSS_RTOL,
         grad_atol_of_max=K45_GRAD_ATOL_REL, runs_bitwise_equal=True,
         padded_rows_grad_zero=True)


def crystal_points(m, device, seed=1, edge_scale=None):
    """`tools/stylize_gate.py::make_style_patch`'s points: a jittered cubic
    crystal with vacancies, scaled so its median 1-NN edge is edge_scale."""
    rng = np.random.default_rng(seed)
    side = int(np.ceil(m ** (1 / 3)))
    i, j, k = np.meshgrid(*[np.arange(side)] * 3, indexing="ij")
    lat = np.stack([i, j, k], -1).reshape(-1, 3).astype(np.float32)
    lat = lat[rng.permutation(len(lat))[:m]]
    pts = lat + rng.normal(size=lat.shape).astype(np.float32) * 0.08
    if edge_scale is not None:
        med = np.median(edge_lengths(pts, device, k=1))
        pts *= float(edge_scale / max(med, 1e-12))
    return pts.astype(np.float32), rng


def crystal_patch(m, device, seed=1, edge_scale=None):
    """`make_style_patch`: the crystal with its attribute arrays."""
    from wast3d_tpu_torch.stylize.cluster import StylePatch

    pts, rng = crystal_points(m, device, seed, edge_scale)
    return StylePatch({
        "_xyz": pts,
        "_features_dc": rng.uniform(0.2, 0.8, (m, 1, 3)).astype(np.float32),
        "_features_rest": np.zeros((m, 15, 3), np.float32),
        "_rotation": np.tile([[1, 0, 0, 0]], (m, 1)).astype(np.float32),
        "_scaling": np.full((m, 3), -5.0, np.float32),
        "_opacity": np.full((m, 1), 2.0, np.float32),
    })


def edge_lengths(points, device, k=5):
    """k-NN edge lengths (self excluded), absolute units."""
    from wast3d_tpu_torch.ops.knn import knn_sq_dists

    p = torch.as_tensor(np.asarray(points, np.float32), device=device)
    d, _ = knn_sq_dists(p, p, k=k, exclude_self=True)
    return np.sqrt(np.maximum(d.cpu().numpy(), 0.0)).ravel()


def w1(a, b, q=256):
    """Wasserstein-1 between 1-D samples by quantile matching."""
    qs = np.linspace(0, 1, q)
    return float(np.mean(np.abs(np.quantile(a, qs) - np.quantile(b, qs))))


def cuda_times_ms(fn, warmup, reps):
    """Per-launch CUDA-event times of `reps` calls after `warmup`."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return times


def k45_bounds(code, balls, mp):
    """(K4 bytes ms, K4 ops ms, K5 bytes ms, K5 ops ms, K4's pairs, K5's
    pairs) for these inputs: each input byte read once and each output byte
    written once (both read the pair list's row_ptr and row_order; K4 the 4
    bytes of each entry with j > i, and writes its [B, Mp] partials and the
    loss; K5 every entry, and writes dx); operations on the pairs each
    kernel evaluates (K4 the pairs j > i, K5 every entry)."""
    both = (code != 0) | (code != 0).T
    pairs_k4 = int(np.triu(both, 1).sum())
    pairs_k5 = int(both.sum())
    points_bytes = 12 * mp * balls + 12 * mp
    list_bytes = 8 * mp + 4
    k4_bytes = list_bytes + 4 * pairs_k4 + points_bytes + 4 * balls * mp + 4 * balls
    k5_bytes = list_bytes + 4 * pairs_k5 + points_bytes + 12 * mp * balls
    k4_ops = pairs_k4 * (K4_OPS_PER_PAIR + K4_OPS_PER_PAIR_BALL * balls)
    k5_ops = pairs_k5 * (K5_OPS_PER_PAIR + K5_OPS_PER_PAIR_BALL * balls)
    ms = lambda v, rate: v / rate * 1e3  # noqa: E731
    return (ms(k4_bytes, HBM_BYTES_PER_S), ms(k4_ops, F32_OPS_PER_S),
            ms(k5_bytes, HBM_BYTES_PER_S), ms(k5_ops, F32_OPS_PER_S), pairs_k4, pairs_k5)


def stretched_balls(pts, balls, rng, device):
    """Balls as the fit sees them: the patch stretched by 0.8-1.6 per axis
    (point spacing near the style's, as from the init placement on), moved,
    and jittered by ~6% of the 0.085 edge. Returns [balls, M, 3] on `device`
    and the per-ball scales [balls, 1, 3]."""
    scale = rng.uniform(0.8, 1.6, (balls, 1, 3)).astype(np.float32)
    x = pts[None] * scale + rng.normal(size=(balls, 1, 3)).astype(np.float32) \
        + rng.normal(size=(balls, len(pts), 3)).astype(np.float32) * 0.005
    return torch.from_numpy(x.astype(np.float32)).to(device), scale


def phase_k45_full_width(device, mp=STYLE_MP, balls=STYLE_BATCH):
    """K4 and K5 alone at the production shape: a real pair code from the
    port's `compute_target_descriptors` of a 16384-point crystal patch,
    8 balls of perturbed, rescaled copies. Returns their kernels-line entries."""
    from wast3d_tpu_torch.config import StylizeConfig
    from wast3d_tpu_torch.stylize import desc_kernel as dk
    from wast3d_tpu_torch.stylize.fit import compute_target_descriptors, packbits

    t0 = time.perf_counter()
    pts, _ = crystal_points(mp, device, edge_scale=0.085)
    b0 = time.perf_counter()
    td = compute_target_descriptors(pts, StylizeConfig(), device=device)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - b0
    if td.pair_code is None or tuple(td.pair_code.shape) != (mp, mp):
        raise AssertionError(f"no [{mp}, {mp}] pair code on the kernel path")
    if not (torch.equal(packbits(td.pair_code & 1), td.bits_global)
            and torch.equal(packbits(td.pair_code >> 1), td.bits_local)):
        raise AssertionError("pair code: bit 0 is not the global mask or bit 1 the local one")
    # The pair list, once per fit: its build again, alone (host clock; it syncs).
    list_s = []
    for _ in range(4):
        torch.cuda.synchronize()
        b0 = time.perf_counter()
        pairs = dk.build_pair_list(td.pair_code)
        torch.cuda.synchronize()
        list_s.append(time.perf_counter() - b0)
    if not all(torch.equal(a, b) for a, b in zip(pairs, td.pair_list)):
        raise AssertionError("the pair list differs from one build to the next")
    row_len = (pairs.row_ptr[1:] - pairs.row_ptr[:-1]).cpu().numpy()
    x, _ = stretched_balls(pts, balls, np.random.default_rng(11), device)
    coefs = (td.coef_global, td.coef_local)
    dense_args = (x, td.points, td.pair_code) + coefs
    list_args = (x, td.points, pairs) + coefs
    k4 = cuda_times_ms(lambda: dk.desc_loss(*list_args), 3, 20)
    k5 = cuda_times_ms(lambda: dk.desc_grad(*list_args), 3, 20)
    k4_again = cuda_times_ms(lambda: dk.desc_loss(*list_args), 3, 20)
    k5_again = cuda_times_ms(lambda: dk.desc_grad(*list_args), 3, 20)
    k4_device, _ = device_ms(lambda: dk.desc_loss(*list_args))
    k5_device, _ = device_ms(lambda: dk.desc_grad(*list_args))
    k4_plain = cuda_times_ms(lambda: dk.pair_loss_list_reference(*list_args), 0, 1)[0]
    k4_dense_plain = cuda_times_ms(lambda: dk.pair_loss_reference(*dense_args), 0, 1)[0]
    k5_plain = cuda_times_ms(lambda: dk.pair_grad_list_reference(*list_args), 0, 1)[0]
    k5_dense_plain = cuda_times_ms(lambda: dk.pair_grad_reference(*dense_args), 0, 1)[0]
    loss_err, grad_err, k4_abs, k5_abs, k4_dense_err = compare_k45(
        x, td.points, td.pair_code, pairs, *coefs)
    dense = dk.pair_grad_reference(*dense_args)
    listed = dk.pair_grad_list_reference(*list_args)
    plain_vs_dense = float((listed - dense).abs().max() / dense.abs().max())
    if plain_vs_dense > K45_GRAD_ATOL_REL:
        raise AssertionError(f"K5's plain version on the list vs on the dense code: "
                             f"{plain_vs_dense} of max |g|")
    code_np = td.pair_code.cpu().numpy()
    k4_b, k4_o, k5_b, k5_o, pairs_k4, pairs_k5 = k45_bounds(code_np, balls, mp)
    if pairs_k5 != int(pairs.row_ptr[-1]):
        raise AssertionError(f"the pair list holds {int(pairs.row_ptr[-1])} entries, the code "
                             f"{pairs_k5} pairs")
    k4_ms, k5_ms = statistics.median(k4), statistics.median(k5)
    emit("k4k5_full_width", t0, mp=mp, balls=balls, descriptor_build_s=build_s,
         pair_list_build_ms=[v * 1e3 for v in list_s],
         pair_list_row_len={"min": int(row_len.min()), "median": float(np.median(row_len)),
                            "max": int(row_len.max())},
         code_values={int(v): int((code_np == v).sum()) for v in range(4)},
         upper_pairs_k4=pairs_k4, symmetric_pairs_k5=pairs_k5,
         k4_ms_median=k4_ms, k4_ms_min=min(k4), k4_ms_max=max(k4), k4_plain_ms=k4_plain,
         k4_again_ms_median=statistics.median(k4_again), k4_device_ms_by_kernel=k4_device,
         k4_dense_plain_ms=k4_dense_plain, k4_loss_rel_err_vs_dense=k4_dense_err,
         k5_ms_median=k5_ms, k5_ms_min=min(k5), k5_ms_max=max(k5), k5_plain_ms=k5_plain,
         k5_again_ms_median=statistics.median(k5_again), k5_device_ms_by_kernel=k5_device,
         k5_dense_plain_ms=k5_dense_plain, k5_plain_list_vs_dense_of_max=plain_vs_dense,
         k4_bound_bytes_ms=k4_b, k4_bound_ops_ms=k4_o, k5_bound_bytes_ms=k5_b,
         k5_bound_ops_ms=k5_o, k4_loss_rel_err=loss_err, k5_grad_err_of_max=grad_err,
         warmup=3, reps=20)

    def entry(name, src, replaces, ms, plain, err, b, o):
        return {"name": name, "route": "cuda", "source": src, "replaces": replaces,
                "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain,
                "bound_ms": max(b, o), "bound_by": "bytes" if b >= o else "operations",
                "library_ms": None}

    return (entry("desc_loss", "wast3d_tpu_torch/csrc/desc_loss.cu",
                  "wast3d_tpu/stylize/desc_kernel.py:65", k4_ms, k4_plain, k4_abs, k4_b, k4_o),
            entry("desc_grad", "wast3d_tpu_torch/csrc/desc_grad.cu",
                  "wast3d_tpu/stylize/desc_kernel.py:88", k5_ms, k5_plain, k5_abs, k5_b, k5_o))


def phase_k45_near_coincident(device, mp=STYLE_MP, balls=STYLE_BATCH, dup_frac=0.01):
    """K4 and K5 where points nearly coincide, as near-duplicate Gaussians of
    a trained scene do: 1% of the 16384-point crystal replaced by copies of
    other points moved by 1e-6 to 1e-2 of the 0.085 edge (log-uniform), so
    the pair code joins each copy to its original; the balls stretch the
    patch and keep each copy beside its original at the ball's scale, as the
    fit's initial placement does. Both kernels and both plain versions are
    held to a float64 evaluation of the same formula on the same inputs."""
    from wast3d_tpu_torch.config import StylizeConfig
    from wast3d_tpu_torch.stylize import desc_kernel as dk
    from wast3d_tpu_torch.stylize.fit import compute_target_descriptors

    t0 = time.perf_counter()
    pts, _ = crystal_points(mp, device, edge_scale=0.085)
    rng = np.random.default_rng(13)
    ndup = int(mp * dup_frac)
    dup = rng.choice(mp, ndup, replace=False)
    src = rng.choice(np.setdiff1d(np.arange(mp), dup), ndup, replace=False)
    unit = rng.normal(size=(ndup, 3))
    unit /= np.linalg.norm(unit, axis=1, keepdims=True)
    sep = 0.085 * 10.0 ** rng.uniform(-6, -2, ndup)
    pts[dup] = pts[src] + (unit * sep[:, None]).astype(np.float32)
    td = compute_target_descriptors(pts, StylizeConfig(), device=device)
    x, scale = stretched_balls(pts, balls, rng, device)
    x[:, dup] = x[:, src] + torch.from_numpy((pts[dup] - pts[src])[None] * scale).to(device)
    code, pairs = td.pair_code, td.pair_list
    joined = int(((code[dup, src] | code[src, dup]) != 0).sum())
    coefs = (td.coef_global, td.coef_local)
    args = (x, td.points, pairs) + coefs
    args64 = (x.double(), td.points.double(), code) + coefs
    loss, grad = dk.desc_loss(*args), dk.desc_grad(*args)
    loss_p = dk.pair_loss_list_reference(*args)
    grad_p = dk.pair_grad_list_reference(*args)
    loss64, grad64 = dk.pair_loss_reference(*args64), dk.pair_grad_reference(*args64)
    gmax = float(grad64.abs().max())
    k5_err = float((grad.double() - grad64).abs().max()) / gmax
    plain_grad_err = float((grad_p.double() - grad64).abs().max()) / gmax
    k4_err = float(((loss.double() - loss64).abs() / loss64.abs()).max())
    plain_loss_err = float(((loss_p.double() - loss64).abs() / loss64.abs()).max())
    emit("k4k5_near_coincident", t0, mp=mp, balls=balls, near_pairs=ndup,
         near_pairs_with_code=joined, separation_min=float(sep.min()),
         separation_max=float(sep.max()), grad64_max=gmax,
         k5_err_of_max=k5_err, plain_grad_err_of_max=plain_grad_err,
         k4_loss_rel_err=k4_err, plain_loss_rel_err=plain_loss_err,
         grad_limit_of_max=K45_GRAD_ATOL_REL, grad_slack_of_max=NEAR_SLACK_REL,
         loss_rtol=K45_LOSS_RTOL)
    if joined == 0:
        raise AssertionError("no near-coincident pair carries a pair code")
    if not (torch.isfinite(grad).all() and torch.isfinite(loss).all()):
        raise AssertionError("K4/K5: non-finite values on near-coincident points")
    if k5_err > K45_GRAD_ATOL_REL or k5_err > plain_grad_err + NEAR_SLACK_REL:
        raise AssertionError(f"K5 vs float64: {k5_err} of max |g| (plain version "
                             f"{plain_grad_err}; limit {K45_GRAD_ATOL_REL}, and no more "
                             f"than the plain version's + {NEAR_SLACK_REL})")
    if k4_err > K45_LOSS_RTOL or k4_err > plain_loss_err + NEAR_SLACK_REL:
        raise AssertionError(f"K4 vs float64: relative error {k4_err} (plain version "
                             f"{plain_loss_err}; limit {K45_LOSS_RTOL})")


# ---- stylization gate and entry point -------------------------------------------

def content_domain(device, n=FULL_N):
    """The 200k shell's content points and the prepared domain (as
    `stylize_scene` prepares it), with the domain's median 1-NN spacing."""
    from wast3d_tpu_torch.config import StylizeConfig
    from wast3d_tpu_torch.stylize import prepare

    cfg = StylizeConfig()
    xyz = bench_scene(n)["xyz"]
    domain = xyz[prepare.prepare_scene(xyz, num_clusters=cfg.num_content_clusters,
                                       q=cfg.outlier_quantile, kth_neighbor=cfg.outlier_knn,
                                       seed=0, device=device)]
    dsub = domain[np.random.default_rng(3).choice(len(domain), min(10_000, len(domain)),
                                                  replace=False)]
    return domain, float(np.median(edge_lengths(dsub, device, k=1)))


def style_metrics(cpatch, domain, circles, fitted, r_ball, cfg, device):
    """`tools/stylize_gate.py`'s metrics: each ball's descriptor loss and
    edge-length W1 at the reference init placement and after the fit (at
    most 48 balls), and the share of the domain within r_ball of a fitted
    point. The descriptor loss goes through `descriptor_loss` (K4 on the
    kernel path)."""
    from wast3d_tpu_torch.ops.knn import knn_sq_dists
    from wast3d_tpu_torch.stylize.fit import compute_target_descriptors, descriptor_loss

    td = compute_target_descriptors(cpatch.xyz, cfg, device=device)
    m, mp = len(cpatch.xyz), td.points.shape[0]
    rng = np.random.default_rng(0)
    tp = np.asarray(cpatch.xyz)
    sel = range(len(circles))
    if len(circles) > 48:
        sel = sorted(rng.choice(len(circles), 48, replace=False).tolist())
    init = [tp * domain[circles[i]].std(0) * 5.0 + domain[circles[i]].mean(0) for i in sel]
    final = [fitted[i] for i in sel]

    def losses(point_sets):
        x = torch.zeros((len(point_sets), mp, 3), device=device)
        x[:, :m] = torch.as_tensor(np.stack(point_sets).astype(np.float32), device=device)
        with torch.no_grad():
            return descriptor_loss(x, td, cfg.desc_block).cpu().numpy()

    style_edges = edge_lengths(tp, device)
    w1_init = [w1(style_edges, edge_lengths(p, device)) for p in init]
    w1_final = [w1(style_edges, edge_lengths(p, device)) for p in final]
    l_init, l_final = losses(init), losses(final)
    dsub = domain[rng.choice(len(domain), min(20_000, len(domain)), replace=False)]
    dmin, _ = knn_sq_dists(torch.as_tensor(dsub, device=device),
                           torch.as_tensor(np.concatenate(fitted).astype(np.float32),
                                           device=device), k=1)
    covered = float(np.mean(np.sqrt(np.maximum(dmin[:, 0].cpu().numpy(), 0)) < r_ball))
    return {
        "desc_loss_init": float(np.mean(l_init)), "desc_loss_final": float(np.mean(l_final)),
        "desc_loss_reduction_x": float(np.mean(l_init) / max(np.mean(l_final), 1e-12)),
        "edge_w1_init": float(np.mean(w1_init)), "edge_w1_final": float(np.mean(w1_final)),
        "edge_w1_reduction_x": float(np.mean(w1_init) / max(np.mean(w1_final), 1e-12)),
        "domain_coverage_frac": covered, "metric_balls": len(init),
    }


def phase_stylize_gate(device, domain, spacing, patch_m=2048, edge_ratio=1.5,
                       fit_steps=STYLE_FIT_STEPS, n=FULL_N):
    """`tools/stylize_gate.py` at the JAX record's configuration (200k
    shell, 2048-point crystal at edge ratio 1.5, 1000 fit steps,
    w_coverage 1.0, batch 8), port only. Its cleaned patch pads below 2048,
    so the fit takes the single-block descriptor path, as the record did."""
    from wast3d_tpu_torch.config import StylizeConfig
    from wast3d_tpu_torch.stylize import coverage, fit
    from wast3d_tpu_torch.stylize.pipeline import clean_style_patch

    t0 = time.perf_counter()
    cfg = StylizeConfig(fit_steps=fit_steps, w_coverage=1.0)
    cpatch = clean_style_patch(crystal_patch(patch_m, device, edge_scale=edge_ratio * spacing),
                               device=device)
    _, d_outer = coverage.cluster_radius(cpatch.xyz, device=device)
    r_ball = d_outer * cfg.ball_radius_factor
    circles = coverage.filter_circles(
        coverage.sample_circles(domain, r=r_ball, min_points_per_cluster=cfg.min_ball_points,
                                device=device),
        min_points=max(1, cfg.min_ball_points // 2))
    t_cover = time.perf_counter() - t0
    reset_kernel_counts()
    f0 = time.perf_counter()
    fitted = fit.fit_all_balls(cpatch.xyz, domain, circles, cfg=cfg, batch_size=STYLE_BATCH,
                               device=device)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - f0
    launches = kernel_counts()
    mp = fit.padded_patch_size(len(cpatch.xyz), cfg.desc_block)
    metrics = style_metrics(cpatch, domain, circles, fitted, r_ball, cfg, device)
    for key, low in GATE_MIN.items():
        if not metrics[key] >= low:
            raise AssertionError(f"stylize gate: {key} {metrics[key]} below {low}")
    if not all(np.isfinite(f).all() for f in fitted):
        raise AssertionError("stylize gate: non-finite fitted points")
    emit("stylize_gate", t0, content_n=n, patch_m=len(cpatch.xyz), padded_mp=mp,
         balls=len(circles), fit_steps=fit_steps, batch_size=STYLE_BATCH, w_coverage=1.0,
         edge_ratio=edge_ratio, domain_n=len(domain), domain_spacing_median=spacing,
         r_ball=r_ball, cover_s=t_cover, fit_s=fit_s, launches_in_fit=launches,
         **metrics, limits=GATE_MIN, jax_tpu_record=JAX_GATE)


def phase_stylize_entry_point(device, domain, spacing, fit_steps=STYLE_FIT_STEPS,
                              style_m=ENTRY_STYLE_M, max_style_points=STYLE_MP, n=FULL_N):
    """`cli.stylize` on the 200k shell (a PLY saved by the port) and an
    18,000-point crystal (npz) at edge ratio 1.5: cleaning keeps ~16.6k
    points and `--max_style_points 16384` subsamples them, so Mp = 16384
    and K4/K5 carry the fit. Every kernel's count is set to 0 just before
    the CLI and read just after. Returns {kernel name: launches}."""
    from wast3d_tpu_torch.cli import stylize as cli
    from wast3d_tpu_torch.config import StylizeConfig
    from wast3d_tpu_torch.scene.ply import load_ply, save_ply
    from wast3d_tpu_torch.stylize import coverage, fit, prepare
    from wast3d_tpu_torch.stylize.cluster import NPZ_KEYS
    from wast3d_tpu_torch.stylize.pipeline import clean_style_patch

    t0 = time.perf_counter()
    cfg = StylizeConfig(fit_steps=fit_steps, w_coverage=1.0)
    patch = crystal_patch(style_m, device, edge_scale=1.5 * spacing)
    with tempfile.TemporaryDirectory(prefix="w3d_chip_smoke_stylize_") as tmp:
        content_ply, style_npz = os.path.join(tmp, "content.ply"), os.path.join(tmp, "style.npz")
        out_ply = os.path.join(tmp, "stylized.ply")
        save_ply(make_scene(bench_scene(n), device), content_ply)
        np.savez(style_npz, **{k: getattr(patch, k[1:]) for k in NPZ_KEYS})
        t_setup = time.perf_counter() - t0

        reset_kernel_counts()
        t1 = time.perf_counter()
        cli.main(["--content", content_ply, "--style_cluster", style_npz, "--output", out_ply,
                  "--fit_steps", str(fit_steps), "--w_coverage", "1.0",
                  "--max_style_points", str(max_style_points), "--device", device.type])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t1
        launches = kernel_counts()
        out = load_ply(out_ply, device=device)
        finite = bool(torch.isfinite(out.xyz).all())
        merged_n = out.capacity

    # What the CLI saw, rebuilt from the same seeds, for the checks below.
    cpatch = clean_style_patch(patch, device=device)
    if len(cpatch) > max_style_points:
        cpatch = cpatch.select(np.random.default_rng(0).choice(len(cpatch),
                                                               size=max_style_points,
                                                               replace=False))
    _, d_outer = coverage.cluster_radius(cpatch.xyz, device=device)
    circles = coverage.filter_circles(
        coverage.sample_circles(domain, r=d_outer * cfg.ball_radius_factor,
                                min_points_per_cluster=cfg.min_ball_points, device=device),
        min_points=max(1, cfg.min_ball_points // 2))
    batches = -(-len(circles) // STYLE_BATCH)
    mp = fit.padded_patch_size(len(cpatch.xyz), cfg.desc_block)
    want = only(desc_loss=fit_steps * batches, desc_grad=fit_steps * batches)
    if mp != max_style_points or launches != want or launches["desc_loss"] == 0:
        raise AssertionError(f"launches {launches} at Mp {mp}, want {want} (K4 and K5 once "
                             f"per Adam step of each of {batches} batches)")
    if not finite or merged_n == 0:
        raise AssertionError(f"stylized PLY: {merged_n} Gaussians, finite {finite}")
    # The fitted balls again, for the loss reduction through K4 (not counted above).
    f0 = time.perf_counter()
    fitted = fit.fit_all_balls(cpatch.xyz, domain, circles, cfg=cfg, batch_size=STYLE_BATCH,
                               device=device)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - f0
    step_ms = fit_step_split(cpatch, domain, circles[:STYLE_BATCH], cfg, device)
    metrics = style_metrics(cpatch, domain, circles, fitted, d_outer * cfg.ball_radius_factor,
                            cfg, device)
    if not metrics["desc_loss_final"] < metrics["desc_loss_init"]:
        raise AssertionError(f"entry point: descriptor loss did not fall: {metrics}")
    emit("stylize_entry_point", t0, content_n=n, style_m=style_m,
         patch_m=len(cpatch.xyz), padded_mp=mp, balls=len(circles), batches=batches,
         fit_steps=fit_steps, w_coverage=1.0, launches=launches, merged_n=merged_n,
         setup_s=t_setup, cli_s=cli_s, fit_all_balls_s=fit_s, fit_step_ms_median=step_ms,
         **metrics)
    return launches


def fit_step_split(cpatch, domain, circles, cfg, device, reps=5):
    """CUDA-event medians (ms) of the parts of one Adam step of `fit_balls`
    on this batch of balls: each loss forward and backward, and the Adam
    update."""
    from wast3d_tpu_torch.stylize import fit

    td = fit.compute_target_descriptors(cpatch.xyz, cfg, device=device)
    m, mp = len(cpatch.xyz), td.points.shape[0]
    cap = min(cfg.ball_capacity, max(len(c) for c in circles))
    balls, mask = fit.pad_balls(np.asarray(domain, np.float32), circles, cap)
    dom, mask = torch.as_tensor(balls, device=device), torch.as_tensor(mask, device=device)
    x = torch.zeros((len(circles), mp, 3), device=device)
    x[:, :m] = torch.as_tensor(cpatch.xyz, device=device) * 2.0 + dom[:, :1]
    x.requires_grad_(True)

    def fwd_bwd(loss_fn):
        return lambda: torch.autograd.grad(loss_fn().sum(), [x])

    parts = {
        "descriptor_k4_k5": fwd_bwd(lambda: fit.descriptor_loss(x, td, cfg.desc_block)),
        "domain_adaptation": fwd_bwd(lambda: fit.domain_adaptation_loss(
            x, dom, mask, cfg.domain_knn, x_rows=m)),
        "domain_coverage": fwd_bwd(lambda: fit.domain_coverage_loss(x, dom, mask, x_rows=m)),
    }
    out = {k: statistics.median(cuda_times_ms(fn, 1, reps)) for k, fn in parts.items()}
    g = torch.randn_like(x)
    mu, nu = torch.zeros_like(x), torch.zeros_like(x)

    def adam():
        a = 0.9 * mu + 0.1 * g
        b = 0.999 * nu + 0.001 * g * g
        return x.detach() - cfg.fit_lr * (a / 0.5) / (torch.sqrt(b / 0.5) + 1e-8)

    out["adam"] = statistics.median(cuda_times_ms(adam, 1, reps))
    out["balls"] = len(circles)
    return out


# ---- geometry transfer and the style sweep -----------------------------------

GEOM_N = 4096  # above cli.pipeline's ~3,500-point style cluster 0
GEOM_K = 100  # compute_targets' default k
GEOM_STEPS = 200  # cut from optimize_cluster_geometry's default 1000
GEOM_PERTURB = 0.05  # of the cluster's extent
GEOM_EVAL_DRAWS = 16  # v1: fixed draws its loss is compared on, start against end
SWEEP_EDGE_RATIOS = (1.0, 1.5, 2.0, 2.5)  # x the domain's spacing; seeds 1-4
SWEEP_FIT_STEPS = 200  # cut from StylizeConfig's default 1000


def random_unit_quaternions(n, rng):
    q = rng.normal(size=(n, 4))
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


def phase_geom_transfer(device, n=GEOM_N, k=GEOM_K, steps=GEOM_STEPS):
    """`optimize_cluster_geometry` in its three variants (v0, v1, v4) at the
    default lr on a seeded crystal cluster of n points (centred, with random
    unit quaternions and scales), its xyz perturbed by GEOM_PERTURB of its
    extent, against the unperturbed cluster's targets (k = 100) and n shape
    points on a unit sphere (v1 scales them by the cluster's mean radius).
    Each variant's loss must be finite and fall: v0 and v4 end below their
    start. v1's OT term draws 100 new points of each cloud every step, and
    that draw moves its loss by more than 200 steps at the default lr
    lower it, so v1 is held on fixed draws: its mean loss over
    GEOM_EVAL_DRAWS draws, the same at the start and at the end, must
    fall; the mean of its last 10 steps against its first 10 is reported.
    Times each step by CUDA events around the whole run."""
    from wast3d_tpu_torch.stylize import geom_transfer as gt

    t0 = time.perf_counter()
    pts, rng = crystal_points(n, device)
    pts = pts - pts.mean(0)
    extent = float(np.ptp(pts, axis=0).max())
    xyz = torch.as_tensor(pts, device=device)
    rot = torch.as_tensor(random_unit_quaternions(n, rng), device=device)
    scal = torch.as_tensor(rng.uniform(0.05, 0.5, (n, 3)).astype(np.float32), device=device)
    shape = rng.normal(size=(n, 3))
    shape = torch.as_tensor((shape / np.linalg.norm(shape, axis=1, keepdims=True))
                            .astype(np.float32), device=device)
    x0 = xyz + torch.as_tensor(rng.normal(size=(n, 3)).astype(np.float32),
                               device=device) * (GEOM_PERTURB * extent)
    targets = gt.compute_targets(xyz, rot, scal, k=k)
    radius = torch.linalg.norm(xyz, dim=1).mean()
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    eval_gen = torch.Generator(device=device).manual_seed(1)
    draws = [gt.sample_indices(eval_gen, n, n, 100) for _ in range(GEOM_EVAL_DRAWS)]

    def v1_on_draws(x):
        with torch.no_grad():
            return float(torch.stack([gt.loss_v1(x, rot, scal, targets, shape,
                                                 target_mean_radius=radius, indices=d)
                                      for d in draws]).mean())

    out = {}
    for variant in ("v0", "v1", "v4"):
        losses = []
        gen = torch.Generator(device=device).manual_seed(0)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        x = gt.optimize_cluster_geometry(x0, rot, scal, targets, shape, gen, variant=variant,
                                         steps=steps, target_mean_radius=radius,
                                         losses=losses)
        end.record()
        torch.cuda.synchronize()
        curve = torch.stack(losses).cpu().numpy().astype(np.float64)
        row = {"loss_first": float(curve[0]), "loss_last": float(curve[-1]),
               "loss_first10_mean": float(curve[:10].mean()),
               "loss_last10_mean": float(curve[-10:].mean()),
               "ms_per_step": start.elapsed_time(end) / steps,
               "moved_max": float((x - x0).abs().max())}
        if variant == "v1":
            row.update(fixed_draws_start=v1_on_draws(x0), fixed_draws_end=v1_on_draws(x))
            falls = row["fixed_draws_end"] < row["fixed_draws_start"]
        else:
            falls = curve[-1] < curve[0]
        if not (np.isfinite(curve).all() and bool(torch.isfinite(x).all()) and falls):
            raise AssertionError(f"geom_transfer {variant}: {row}")
        out[variant] = row
    emit("geom_transfer", t0, n_points=n, k=k, steps=steps, lr=1.6e-4, extent=extent,
         perturbation=GEOM_PERTURB * extent, v1_eval_draws=GEOM_EVAL_DRAWS, variants=out,
         setup_s=t_setup)


def descriptor_loss_fall(patch_xyz, ball_points, fitted, cfg, device, max_balls=8):
    """Mean descriptor loss (through K4 on the kernel path) of the first
    `max_balls` balls at the fit's initial placement (the patch scaled by
    5 x each ball's per-axis standard deviation, at its mean) and after the
    fit. `ball_points`: each ball's domain points."""
    from wast3d_tpu_torch.stylize.fit import compute_target_descriptors, descriptor_loss

    td = compute_target_descriptors(patch_xyz, cfg, device=device)
    m, mp = len(patch_xyz), td.points.shape[0]
    sel = range(min(max_balls, len(ball_points)))
    init = [patch_xyz * ball_points[i].std(0, ddof=1) * 5.0 + ball_points[i].mean(0)
            for i in sel]
    final = [fitted[i] for i in sel]

    def mean_loss(point_sets):
        x = torch.zeros((len(point_sets), mp, 3), device=device)
        x[:, :m] = torch.as_tensor(np.stack(point_sets).astype(np.float32), device=device)
        with torch.no_grad():
            return float(descriptor_loss(x, td, cfg.desc_block).mean())

    return mean_loss(init), mean_loss(final)


def phase_sweep_entry_point(device, spacing, fit_steps=SWEEP_FIT_STEPS,
                            style_m=ENTRY_STYLE_M, max_style_points=STYLE_MP, n=FULL_N):
    """`cli.sweep` on the 200k shell (a PLY saved by the port) and four
    18,000-point crystals (npz; seeds 1-4 at edge ratios 1.0, 1.5, 2.0 and
    2.5 x the domain's spacing) at `--max_style_points 16384`: cleaning
    keeps ~16.6k points of each and the sweep subsamples all four to one
    count, so Mp = 16384 and K4/K5 carry every style's fit. The counts are
    set to 0 just before the CLI and read just after: K4 = K5 = the sum over
    styles of fit_steps x ceil(balls / 8). A spy on
    `sweep.fit_balls_sweep` keeps the fit's inputs and outputs: each
    style's descriptor loss must fall, and style 0's first batch must equal
    `fit.fit_balls` run again on the same inputs bit for bit (after the
    counts are read). Returns {kernel name: launches}."""
    from wast3d_tpu_torch.cli import sweep as cli
    from wast3d_tpu_torch.config import StylizeConfig
    from wast3d_tpu_torch.scene.ply import load_ply, save_ply
    from wast3d_tpu_torch.stylize import fit, sweep
    from wast3d_tpu_torch.stylize.cluster import NPZ_KEYS

    t0 = time.perf_counter()
    cfg = StylizeConfig(fit_steps=fit_steps)
    seen = {}
    real = sweep.fit_balls_sweep

    def spy(targets, descs, balls, mask, cfg, batch_size=8, mesh=None):
        out = real(targets, descs, balls, mask, cfg, batch_size, mesh)
        seen.update(targets=targets, descs=descs, balls=balls, mask=mask, out=out,
                    batch_size=batch_size)
        return out

    with tempfile.TemporaryDirectory(prefix="w3d_chip_smoke_sweep_") as tmp:
        content_ply = os.path.join(tmp, "content.ply")
        save_ply(make_scene(bench_scene(n), device), content_ply)
        npzs = []
        for i, ratio in enumerate(SWEEP_EDGE_RATIOS):
            patch = crystal_patch(style_m, device, seed=i + 1, edge_scale=ratio * spacing)
            npzs.append(os.path.join(tmp, f"crystal{i + 1}.npz"))
            np.savez(npzs[-1], **{key: getattr(patch, key[1:]) for key in NPZ_KEYS})
        out_dir = os.path.join(tmp, "out")
        t_setup = time.perf_counter() - t0

        sweep.fit_balls_sweep = spy
        try:
            reset_kernel_counts()
            t1 = time.perf_counter()
            cli.main(["--content", content_ply, "--style_clusters", *npzs,
                      "--output_dir", out_dir, "--fit_steps", str(fit_steps),
                      "--max_style_points", str(max_style_points), "--device", device.type])
            torch.cuda.synchronize()
            cli_s = time.perf_counter() - t1
            launches = kernel_counts()
        finally:
            sweep.fit_balls_sweep = real
        plys = []
        for i in range(len(SWEEP_EDGE_RATIOS)):
            scene = load_ply(os.path.join(out_dir, f"stylized_crystal{i + 1}.ply"),
                             device=device)
            plys.append((scene.capacity, bool(torch.isfinite(scene.xyz).all())))

    balls = [int(b.shape[0]) for b in seen["balls"]]
    batches = sum(-(-b // STYLE_BATCH) for b in balls)
    m = int(seen["targets"].shape[1])
    mp = int(seen["descs"][0].points.shape[0])
    want = only(desc_loss=fit_steps * batches, desc_grad=fit_steps * batches)
    if mp != max_style_points or launches != want or launches["desc_loss"] == 0:
        raise AssertionError(f"launches {launches} at Mp {mp}, want {want} (K4 and K5 once "
                             f"per Adam step of each of {batches} batches over {balls} balls)")
    if not all(cap > 0 and finite for cap, finite in plys):
        raise AssertionError(f"stylized PLYs (Gaussians, finite): {plys}")
    # What the sweep fitted, again, outside the counted run.
    b = seen["batch_size"]
    direct = fit.fit_balls(seen["targets"][0], seen["descs"][0], seen["balls"][0][:b],
                           seen["mask"][0][:b], cfg)
    style0_bit_equal = torch.equal(direct, seen["out"][0][:b])
    if not style0_bit_equal:
        raise AssertionError("style 0: the sweep's fit differs from fit.fit_balls on the "
                             f"same inputs by {float((direct - seen['out'][0][:b]).abs().max())}")
    falls = []
    for s in range(len(balls)):
        pts, keep = seen["balls"][s].cpu().numpy(), seen["mask"][s].cpu().numpy()
        l_init, l_final = descriptor_loss_fall(
            seen["targets"][s].cpu().numpy(), [pts[i][keep[i]] for i in range(balls[s])],
            seen["out"][s].cpu().numpy(), cfg, device)
        if not l_final < l_init:
            raise AssertionError(f"style {s}: descriptor loss {l_init} -> {l_final}")
        falls.append({"desc_loss_init": l_init, "desc_loss_final": l_final})
    emit("sweep_entry_point", t0, content_n=n, style_m=style_m, styles=len(balls),
         edge_ratios=list(SWEEP_EDGE_RATIOS), patch_m=m, padded_mp=mp, balls=balls,
         batches=batches, ball_capacity=int(seen["balls"][0].shape[1]), fit_steps=fit_steps,
         launches=launches, plys=plys, style0_fit_bit_equal=style0_bit_equal,
         descriptor_loss=falls, setup_s=t_setup, cli_s=cli_s)
    return launches


# ---- parallel/: two ranks sharing the card ---------------------------------------
#
# The ranks are spawned processes (`parallel.multihost.spawn`) that import this
# file again; their functions (`_rank_*`) run on cuda:0 in a gloo group named
# here, the one backend that lets two ranks share a card (NCCL refuses two ranks
# on one GPU). Times in these phases are two ranks sharing one H100, gloo staging
# through the host: none is a scaling figure.

PAR_RANKS = 2
PAR_REPS = 20  # timed frames / steps / routings, after PAR_WARMUP
PAR_WARMUP = 3
PAR_TRAIN_ITERS = 100  # ShardedTrainer: densify at 50 and 100
PAR_FIT_STEPS = 200  # the ball fit and the sweep, cut from 1000
RING_RTOL, RING_ATOL = 1e-4, 1e-6  # tests/test_parallel.py:49
SHARDED_LOSS_RTOL = 1e-5  # tests/test_parallel.py:376
# The ball fit over ranks against one device: each ball's fit is its own,
# but a rank fits 4 of each batch's 8 balls, and kernels of another batch
# size may round otherwise (Adam then moves a coordinate with a near-zero
# gradient by up to its rate a step). Held to the bound that
# tests/test_torch_stylize.py sets for one fit under two roundings.
FIT_PARITY_RTOL, FIT_PARITY_ATOL = 1e-4, 1e-5


def _median_host_ms(fn, reps=PAR_REPS, warmup=PAR_WARMUP):
    """Median of `reps` host-clock times of fn() + synchronize, after `warmup`."""
    times = []
    for i in range(warmup + reps):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        if i >= warmup:
            times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def _gloo_cuda_probe(device):
    """Which collectives gloo takes CUDA tensors for, with the right values,
    on a group of its own with a short timeout: 'ok', 'wrong values' or the
    error. Point-to-point is left out: a gloo send of a CUDA tensor aborts
    the process (its transport writes from the device address: "writev ...
    Bad address", an exception in gloo's own thread)."""
    import datetime

    import torch.distributed as dist

    group = dist.new_group(backend="gloo", timeout=datetime.timedelta(seconds=60))
    rank, world = dist.get_rank(), dist.get_world_size()

    def x(r=rank):
        return torch.arange(4, dtype=torch.float32, device=device) + 10 * r

    def broadcast():
        t = x()
        dist.broadcast(t, 0, group=group)
        return t, x(0)

    def all_reduce():
        t = x()
        dist.all_reduce(t, group=group)
        return t, sum(x(r) for r in range(world))

    def all_gather():
        parts = [torch.empty_like(x()) for _ in range(world)]
        dist.all_gather(parts, x(), group=group)
        return torch.cat(parts), torch.cat([x(r) for r in range(world)])

    def all_to_all_single():
        t = torch.empty_like(x())
        dist.all_to_all_single(t, x(), group=group)
        chunk = 4 // world
        return t, torch.cat([x(r)[rank * chunk:(rank + 1) * chunk] for r in range(world)])

    out = {}
    for op in (broadcast, all_reduce, all_gather, all_to_all_single):
        try:
            got, want = op()
            torch.cuda.synchronize()
            out[op.__name__] = "ok" if torch.equal(got, want) else "wrong values"
        except (RuntimeError, ValueError) as e:
            out[op.__name__] = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
    dist.destroy_process_group(group)
    return out


def _on(device):
    """This rank's device (the card the ranks share)."""
    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return device


def _rank_parallel_cases(device, n, res, gt, target):
    """`parallel_cases` on one gloo rank on `device`: the f32 and bf16 strips,
    the tile-sharded gradients and 23 steps, the ring 3-NN, the sharded loss."""
    import torch.distributed as dist

    from wast3d_tpu_torch.config import OptimizationConfig
    from wast3d_tpu_torch.ops.rasterizer import api, render_path
    from wast3d_tpu_torch.parallel import make_mesh, scene_sharding, shard_train_state
    from wast3d_tpu_torch.parallel.losses import photometric_loss_sharded
    from wast3d_tpu_torch.parallel.render_sharded import padded_grid, render_tile_sharded, route_rows
    from wast3d_tpu_torch.parallel.ring import ring_mean_sq_dist_to_3nn
    from wast3d_tpu_torch.parallel.train_sharded import make_tile_sharded_train_step
    from wast3d_tpu_torch.train.reconstruct import init_train_state

    device = _on(device)
    out = {"gloo_cuda": _gloo_cuda_probe(device)}
    mesh = make_mesh(data=1)
    rows = scene_sharding(mesh, n)
    arrays = {k: v[rows] for k, v in bench_scene(n).items()}
    scene = make_scene(arrays, device)
    cam = view_camera(res, res, device)
    bg = torch.zeros(3, device=device)
    gt = torch.from_numpy(gt).to(device)
    settings = api.RasterizeSettings()

    reset_kernel_counts()
    frame = render_tile_sharded(cam, scene, bg, mesh, settings)
    torch.cuda.synchronize()
    out["frame_launches"] = kernel_counts()
    out["frame"] = {k: frame[k].cpu().numpy() for k in ("render", "depth", "final_T")}
    out["height_pad"] = frame["height_pad"]
    fast = render_tile_sharded(cam, scene, bg, mesh, settings._replace(fast_chain=True))
    out["frame_fast"] = fast["render"].cpu().numpy()
    dist.barrier()
    out["frame_ms"] = _median_host_ms(lambda: render_tile_sharded(cam, scene, bg, mesh, settings))
    out["frame_fast_ms"] = _median_host_ms(
        lambda: render_tile_sharded(cam, scene, bg, mesh, settings._replace(fast_chain=True)))
    # The duplicate routing alone, on this frame's sorted rows.
    grid_x, grid_y_pad = padded_grid(res, res, PAR_RANKS)
    prep = api.preprocess_scene(cam, scene)
    binning, sorted_rows = render_path.bin_and_pack(prep, res, grid_y_pad * 16)
    group = mesh.get_group("model")
    tiles_per_shard = grid_x * grid_y_pad // PAR_RANKS
    got, _ = route_rows(sorted_rows, binning.tile_of_dup, tiles_per_shard, group)
    out["a2a_sent_rows"] = int(sorted_rows.shape[0])
    out["a2a_received_rows"] = int(got.shape[0])
    out["a2a_bytes_sent"] = int(sorted_rows.shape[0]) * (sorted_rows.shape[1] * 4 + 8)
    dist.barrier()
    out["a2a_ms"] = _median_host_ms(
        lambda: route_rows(sorted_rows, binning.tile_of_dup, tiles_per_shard, group))

    # (b) the tile-sharded step's gradients, then 23 steps
    params = {k: v.detach().requires_grad_(True) for k, v in scene.params().items()}
    reset_kernel_counts()
    live = render_tile_sharded(cam, scene.with_params(params), bg, mesh, settings)
    loss = photometric_loss_sharded(live["render"], gt, mesh, res)
    grads = torch.autograd.grad(loss, list(params.values()))
    torch.cuda.synchronize()
    out["grad_launches"] = kernel_counts()
    out["grads"] = {k: g.cpu().numpy() for k, g in zip(params, grads)}
    out["grad_loss"] = float(loss.detach())
    full = make_scene(bench_scene(n), device)
    state = shard_train_state(init_train_state(full, OptimizationConfig(), 1.0), mesh)
    del full
    step = make_tile_sharded_train_step(mesh, OptimizationConfig(), settings)
    holder = {"state": state, "losses": []}

    def one_step():
        holder["state"], aux = step(holder["state"], cam, gt, bg)
        holder["losses"].append(float(aux["loss"]))

    dist.barrier()
    reset_kernel_counts()
    out["step_ms"] = _median_host_ms(one_step)
    out["step_launches"] = kernel_counts()
    out["step_losses"] = holder["losses"]

    # (c) the ring 3-NN at n
    dist.barrier()
    t = time.perf_counter()
    ring = ring_mean_sq_dist_to_3nn(scene.xyz, mesh)
    torch.cuda.synchronize()
    out["ring_s"] = time.perf_counter() - t
    out["ring"] = ring.cpu().numpy()
    # (d) the halo-exchange loss of the f32 strips against a random image
    out["sharded_loss"] = float(photometric_loss_sharded(
        frame["render"], torch.from_numpy(target).to(device), mesh, res))
    return out


def _rank_nccl_frame(device, n, res, target):
    """The f32 frame through `render_tile_sharded`, and its sharded loss,
    on a one-rank nccl group (every collective runs, on one rank)."""
    from wast3d_tpu_torch.ops.rasterizer import api
    from wast3d_tpu_torch.parallel import make_mesh
    from wast3d_tpu_torch.parallel.losses import photometric_loss_sharded
    from wast3d_tpu_torch.parallel.render_sharded import render_tile_sharded

    device = _on(device)
    mesh = make_mesh(data=1)
    scene = make_scene(bench_scene(n), device)
    reset_kernel_counts()
    frame = render_tile_sharded(view_camera(res, res, device), scene,
                                torch.zeros(3, device=device), mesh, api.RasterizeSettings())
    torch.cuda.synchronize()
    loss = photometric_loss_sharded(frame["render"], torch.from_numpy(target).to(device),
                                    mesh, res)
    return {"frame": frame["render"].cpu().numpy(), "launches": kernel_counts(),
            "mesh_device": str(mesh.device_type), "loss": float(loss),
            "backend": torch.distributed.get_backend()}


def _frame_diff(a, b):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return float(d.max()), float(d.mean())


def phase_parallel_cases(device, n=FULL_N, res=FULL_RES):
    """`parallel/` on two gloo ranks sharing cuda:0, on the 200k / 800x800
    shell (jitter off): (a) `render_tile_sharded`'s stitched strips against
    `api.render` within K1's limits, bit equality reported, in the f32 tier
    and (bf16) against the K1f frame; (b) one tile-sharded step's gradients
    of every parameter, gathered, against the single-device step's within
    K2's bound (1e-3 of each column's max), and 23 steps; (c)
    `ring_mean_sq_dist_to_3nn` at 200k against `ops.knn.mean_sq_dist_to_3nn`
    (rtol 1e-4, atol 1e-6); (d) `photometric_loss_sharded` of the strips
    against `photometric_loss` of the frame, on a uniform random target as
    JAX's test takes (rtol 1e-5); (e) the f32 frame on a one-rank nccl
    group. K1, K2 and K3 must launch on each rank. Times are two ranks
    sharing one H100 through gloo's host staging, not scaling figures."""
    from wast3d_tpu_torch.ops.image_losses import photometric_loss
    from wast3d_tpu_torch.ops.knn import mean_sq_dist_to_3nn
    from wast3d_tpu_torch.ops.rasterizer import api
    from wast3d_tpu_torch.parallel import multihost

    t0 = time.perf_counter()
    arrays = bench_scene(n)
    scene = make_scene(arrays, device)
    cam = view_camera(res, res, device)
    bg = torch.zeros(3, device=device)
    settings = api.RasterizeSettings()
    single = api.render(cam, scene, bg, settings=settings, device=device)
    single_fast = api.render(cam, scene, bg, settings=settings._replace(fast_chain=True),
                             device=device)
    gt = api.render(cam, make_scene(perturbed(arrays), device), bg, settings=settings,
                    device=device)["render"].detach()
    params = {k: v.detach().requires_grad_(True) for k, v in scene.params().items()}
    out = api.render(cam, scene.with_params(params), bg, settings=settings, device=device)
    loss = photometric_loss(out["render"], gt)
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    single_ms = _median_host_ms(lambda: api.render(cam, scene, bg, settings=settings,
                                                   device=device))
    ring_ref = mean_sq_dist_to_3nn(scene.xyz).cpu().numpy()
    # JAX's test_parallel.py holds its sharded loss on uniform images: there
    # the loss is ~0.3, and rtol 1e-5 measures the sums, not a cancellation
    target = np.random.default_rng(4).uniform(0, 1, (res, res, 3)).astype(np.float32)
    loss_ref = float(photometric_loss(single["render"], torch.from_numpy(target).to(device)))
    t_ref = time.perf_counter() - t0

    t1 = time.perf_counter()
    ranks = multihost.spawn(_rank_parallel_cases, PAR_RANKS,
                            (str(device), n, res, gt.cpu().numpy(), target), backend="gloo")
    ranks_s = time.perf_counter() - t1

    h = res
    frame = {k: np.concatenate([r["frame"][k] for r in ranks])[:h]
             for k in ("render", "depth", "final_T")}
    want = {"render": single["render"], "depth": single["depth"], "final_T": single["final_T"]}
    want = {k: v.detach().cpu().numpy() for k, v in want.items()}
    color_max, color_mean = _frame_diff(frame["render"], want["render"])
    t_max, t_mean = _frame_diff(frame["final_T"], want["final_T"])
    depth_max, _ = _frame_diff(frame["depth"], want["depth"])
    frame_bits = all(np.array_equal(frame[k], want[k]) for k in frame)
    if not (color_max <= TOL_MAX and t_max <= TOL_MAX and color_mean <= TOL_MEAN
            and depth_max <= TOL_DEPTH):
        raise AssertionError(f"tile-sharded frame vs api.render: colour {color_max} / "
                             f"{color_mean}, final_T {t_max}, depth {depth_max}")
    fast = np.concatenate([r["frame_fast"] for r in ranks])[:h]
    fast_want = single_fast["render"].cpu().numpy()
    fast_max, fast_mean = _frame_diff(fast, fast_want)
    fast_bits = bool(np.array_equal(fast, fast_want))
    if not (fast_max <= TOL_MAX and fast_mean <= TOL_MEAN):
        raise AssertionError(f"tile-sharded bf16 frame vs the K1f frame: {fast_max} / {fast_mean}")

    grad_err = {}
    for k, g in grads.items():
        got = np.concatenate([r["grads"][k] for r in ranks]).reshape(g.shape[0], -1)
        ref = g.cpu().numpy().reshape(g.shape[0], -1)
        scale = np.maximum(np.abs(ref).max(0), 1e-30)
        grad_err[k] = float((np.abs(got - ref).max(0) / scale).max())
    if max(grad_err.values()) > K2_TOL:
        raise AssertionError(f"tile-sharded gradients vs one device (of each column's max): "
                             f"{grad_err}")
    ring = np.concatenate([r["ring"] for r in ranks])
    ring_ok = np.allclose(ring, ring_ref, rtol=RING_RTOL, atol=RING_ATOL)
    ring_err = float(np.max(np.abs(ring - ring_ref) / (RING_ATOL + RING_RTOL * np.abs(ring_ref))))
    if not ring_ok:
        raise AssertionError(f"ring 3-NN vs ops.knn: {ring_err} of the bound")
    loss_err = max(abs(r["sharded_loss"] - loss_ref) / abs(loss_ref) for r in ranks)
    if loss_err > SHARDED_LOSS_RTOL:
        raise AssertionError(f"sharded loss {[r['sharded_loss'] for r in ranks]} vs {loss_ref}")
    steps = PAR_WARMUP + PAR_REPS
    for r in ranks:
        if r["frame_launches"] != only(blend_fwd=1):
            raise AssertionError(f"a strip render launched {r['frame_launches']}, want K1 once")
        if r["grad_launches"] != only(blend_fwd=1, blend_bwd=1, segment_sum=1):
            raise AssertionError(f"a step's gradients launched {r['grad_launches']}, "
                                 "want K1, K2, K3 once each")
        if r["step_launches"] != only(blend_fwd=steps, blend_bwd=steps, segment_sum=steps):
            raise AssertionError(f"{steps} steps launched {r['step_launches']}")
    if not ranks[0]["step_losses"][-1] < ranks[0]["step_losses"][0]:
        raise AssertionError(f"tile-sharded steps: loss {ranks[0]['step_losses']}")

    t2 = time.perf_counter()
    nccl = multihost.spawn(_rank_nccl_frame, 1, (str(device), n, res, target),
                           backend="nccl")[0]
    nccl_s = time.perf_counter() - t2
    nccl_max, nccl_mean = _frame_diff(nccl["frame"][:h], want["render"])
    nccl_bits = bool(np.array_equal(nccl["frame"][:h], want["render"]))
    nccl_loss_rel = abs(nccl["loss"] - loss_ref) / abs(loss_ref)
    if (not (nccl_max <= TOL_MAX and nccl_mean <= TOL_MEAN) or nccl_loss_rel > SHARDED_LOSS_RTOL
            or nccl["launches"] != only(blend_fwd=1)):
        raise AssertionError(f"nccl frame vs api.render: {nccl_max} / {nccl_mean}, loss "
                             f"{nccl_loss_rel}, launches {nccl['launches']}")
    emit("parallel_cases", t0, ranks=PAR_RANKS, backend="gloo (CUDA tensors staged through the "
         "host)", n=n, width=res, height=res, height_pad=ranks[0]["height_pad"],
         frame_bit_equal=frame_bits, frame_color_max=color_max, frame_color_mean=color_mean,
         frame_final_t_max=t_max, frame_depth_max=depth_max,
         frame_fast_bit_equal=fast_bits, frame_fast_max=fast_max,
         grad_max_rel_of_column_max=grad_err,
         ring_max_of_bound=ring_err, ring_bit_equal=bool(np.array_equal(ring, ring_ref)),
         sharded_loss=[r["sharded_loss"] for r in ranks], loss_ref=loss_ref,
         sharded_loss_rel=loss_err, nccl_frame_bit_equal=nccl_bits, nccl_frame_max=nccl_max,
         nccl_loss_rel=nccl_loss_rel, nccl_backend=nccl["backend"],
         nccl_mesh_device=nccl["mesh_device"], nccl_s=nccl_s,
         launches_per_rank={"frame": ranks[0]["frame_launches"],
                            "gradients": ranks[0]["grad_launches"],
                            f"{steps}_steps": ranks[0]["step_launches"]},
         gloo_cuda=ranks[0]["gloo_cuda"],
         timing_note="host clock, median of 20; 2 ranks sharing one H100, gloo staging through "
                     "the host; not a scaling figure",
         frame_ms_per_rank=[r["frame_ms"] for r in ranks],
         frame_fast_ms_per_rank=[r["frame_fast_ms"] for r in ranks],
         single_device_frame_ms=single_ms,
         step_ms_per_rank=[r["step_ms"] for r in ranks],
         step_losses_first_last=[ranks[0]["step_losses"][0], ranks[0]["step_losses"][-1]],
         a2a_rows_sent_per_rank=[r["a2a_sent_rows"] for r in ranks],
         a2a_rows_received_per_rank=[r["a2a_received_rows"] for r in ranks],
         a2a_bytes_sent_per_rank=[r["a2a_bytes_sent"] for r in ranks],
         a2a_ms_per_rank=[r["a2a_ms"] for r in ranks],
         ring_s_per_rank=[r["ring_s"] for r in ranks], references_s=t_ref, ranks_s=ranks_s)


def _rank_parallel_entry_point(device, src, iters, fit_args, sweep_args):
    """`parallel_entry_point` on one gloo rank on `device`: `ShardedTrainer`
    (data = 2), `fit_all_balls(mesh)` and `stylize_sweep(mesh)`, each with the
    counts set to 0 just before and read just after."""
    from wast3d_tpu_torch.config import OptimizationConfig, StylizeConfig
    from wast3d_tpu_torch.parallel import make_mesh
    from wast3d_tpu_torch.parallel.train_sharded import ShardedTrainer, init_sharded
    from wast3d_tpu_torch.scene import datasets
    from wast3d_tpu_torch.scene.gaussians import from_point_cloud
    from wast3d_tpu_torch.stylize import fit
    from wast3d_tpu_torch.stylize.sweep import stylize_sweep

    device = _on(device)
    mesh = make_mesh(data=PAR_RANKS)
    out = {}

    info = datasets.load_scene_info(src)
    extent = info.nerf_normalization["radius"]
    cams = datasets.build_cameras(info.train_cameras, device=device)
    scene = from_point_cloud(np.asarray(info.point_cloud.points, np.float32),
                             np.asarray(info.point_cloud.colors, np.float32), device=device)
    cfg = OptimizationConfig(iterations=iters, densify_from_iter=iters // 4,
                             densification_interval=iters // 2)
    tr = ShardedTrainer(init_sharded(scene, cfg, mesh, extent), cams, mesh, opt_cfg=cfg,
                        spatial_lr_scale=extent, cameras_extent=extent, seed=0, device=device)
    n_init = tr.total_rows()
    reset_kernel_counts()
    t = time.perf_counter()
    tr.run(iters, log_every=max(1, iters // 10))
    torch.cuda.synchronize()
    out["train_s"] = time.perf_counter() - t
    out["train_launches"] = kernel_counts()
    out["train_history"] = tr.history
    out["train_n"] = (n_init, tr.total_rows())
    out["views"] = len(cams)
    del tr, scene

    patch_xyz, domain, circles, fit_steps = fit_args
    cfg = StylizeConfig(fit_steps=fit_steps, w_coverage=1.0)
    reset_kernel_counts()
    t = time.perf_counter()
    fitted = fit.fit_all_balls(patch_xyz, domain, circles, cfg=cfg, batch_size=STYLE_BATCH,
                               device=device, mesh=mesh)
    torch.cuda.synchronize()
    out["fit_s"] = time.perf_counter() - t
    out["fit_launches"] = kernel_counts()
    rank = torch.distributed.get_rank()
    out["fitted"] = np.stack(fitted) if rank == 0 else None

    content_arrays, patches, fit_steps, max_style_points = sweep_args
    reset_kernel_counts()
    t = time.perf_counter()
    scenes = stylize_sweep(make_scene(content_arrays, device), patches,
                           StylizeConfig(fit_steps=fit_steps), device=device, mesh=mesh,
                           max_style_points=max_style_points)
    torch.cuda.synchronize()
    out["sweep_s"] = time.perf_counter() - t
    out["sweep_launches"] = kernel_counts()
    out["sweep"] = None if scenes is None else [
        {f: getattr(s, f).cpu().numpy() for f in ("xyz", "features_dc", "features_rest",
                                                 "scaling", "rotation", "opacity")}
        for s in scenes]
    return out


def phase_parallel_entry_point(device, domain, spacing, n=FULL_N, res=FULL_RES,
                               iters=PAR_TRAIN_ITERS, fit_steps=PAR_FIT_STEPS,
                               style_m=ENTRY_STYLE_M, max_style_points=STYLE_MP,
                               n_init=N_INIT):
    """Two gloo ranks sharing cuda:0: `ShardedTrainer` with data = 2,
    model = 1 on `train_entry_point`'s 6-view 800x800 dataset (100k random
    init, `iters` iterations, densify at iters / 2 and iters): the loss falls,
    N changes and K1 = K2 = K3 = iters on each rank; `fit_all_balls(mesh)` at
    Mp = 16384 (`stylize_entry_point`'s patch, `fit_steps` steps) against
    one-device `fit_all_balls` on the same inputs (bit equality reported;
    `FIT_PARITY_RTOL` / `FIT_PARITY_ATOL`), K4 and K5 on both ranks; `stylize_sweep(mesh)` on `sweep_entry_point`'s
    four styles: each style's scene equals the one-device sweep's. The
    one-device references run here first. Times are two ranks sharing one
    H100, not scaling figures."""
    from wast3d_tpu_torch.config import StylizeConfig
    from wast3d_tpu_torch.core.sh import sh_to_rgb
    from wast3d_tpu_torch.parallel import multihost
    from wast3d_tpu_torch.scene.datasets import store_ply_points
    from wast3d_tpu_torch.stylize import coverage, fit
    from wast3d_tpu_torch.stylize.pipeline import clean_style_patch
    from wast3d_tpu_torch.stylize.sweep import stylize_sweep

    t0 = time.perf_counter()
    cfg = StylizeConfig(fit_steps=fit_steps, w_coverage=1.0)
    cpatch = clean_style_patch(crystal_patch(style_m, device, edge_scale=1.5 * spacing),
                               device=device)
    cpatch = cpatch.select(np.random.default_rng(0).choice(len(cpatch), size=max_style_points,
                                                           replace=False))
    _, d_outer = coverage.cluster_radius(cpatch.xyz, device=device)
    circles = coverage.filter_circles(
        coverage.sample_circles(domain, r=d_outer * cfg.ball_radius_factor,
                                min_points_per_cluster=cfg.min_ball_points, device=device),
        min_points=max(1, cfg.min_ball_points // 2))
    t = time.perf_counter()
    single_fit = fit.fit_all_balls(cpatch.xyz, domain, circles, cfg=cfg,
                                   batch_size=STYLE_BATCH, device=device)
    torch.cuda.synchronize()
    single_fit_s = time.perf_counter() - t
    # One device again, each rank's slab of the first batch alone: what a
    # rank's batch size does to the bits by itself.
    slab = STYLE_BATCH // PAR_RANKS
    balls, mask = fit.pad_balls(domain, circles,
                                min(cfg.ball_capacity, max(len(c) for c in circles)))
    desc = fit.compute_target_descriptors(cpatch.xyz, cfg, device=device)
    batch_effect = []
    for lo in range(0, min(STYLE_BATCH, len(circles)), slab):
        hi = min(lo + slab, len(circles))
        alone = fit.fit_balls(torch.as_tensor(cpatch.xyz, device=device), desc,
                              torch.as_tensor(balls[lo:hi], device=device),
                              torch.as_tensor(mask[lo:hi], device=device), cfg).cpu().numpy()
        batch_effect.append({"balls": [lo, hi], "max_abs": float(
            np.abs(alone - np.stack(single_fit[lo:hi])).max())})
    content = bench_scene(n)
    patches = [crystal_patch(style_m, device, seed=i + 1, edge_scale=ratio * spacing)
               for i, ratio in enumerate(SWEEP_EDGE_RATIOS)]
    t = time.perf_counter()
    single_sweep = stylize_sweep(make_scene(content, device), patches,
                                 StylizeConfig(fit_steps=fit_steps), device=device,
                                 max_style_points=max_style_points)
    torch.cuda.synchronize()
    single_sweep_s = time.perf_counter() - t

    with tempfile.TemporaryDirectory(prefix="w3d_chip_smoke_parallel_") as tmp:
        src = os.path.join(tmp, "scene")
        views = write_blender_dataset(src, make_scene(content, device), device, res)
        rng = np.random.default_rng(2)
        store_ply_points(os.path.join(src, "points3d.ply"), rng.random((n_init, 3)) * 2.6 - 1.3,
                         sh_to_rgb(rng.random((n_init, 3)) / 255.0) * 255)
        t_setup = time.perf_counter() - t0
        t = time.perf_counter()
        ranks = multihost.spawn(
            _rank_parallel_entry_point, PAR_RANKS,
            (str(device), src, iters, (cpatch.xyz, domain, circles, fit_steps),
             (content, patches, fit_steps, max_style_points)), backend="gloo")
        ranks_s = time.perf_counter() - t

    losses = [(e["iter"], e["loss"]) for e in ranks[0]["train_history"] if "loss" in e]
    densify = [(e["iter"], e["n"]) for e in ranks[0]["train_history"]
               if e.get("event") == "densify"]
    n_init, n_final = ranks[0]["train_n"]
    if [it for it, _ in densify] != [iters // 2, iters]:
        raise AssertionError(f"densify fired at {densify}, want {iters // 2} and {iters}")
    if not (losses[-1][1] < losses[0][1]) or n_final == n_init:
        raise AssertionError(f"ShardedTrainer: losses {losses}, N {n_init} -> {n_final}")
    for r in ranks:
        want = only(blend_fwd=iters, blend_bwd=iters, segment_sum=iters)
        if r["train_launches"] != want:
            raise AssertionError(f"ShardedTrainer launched {r['train_launches']}, want {want}")
        for key in ("fit_launches", "sweep_launches"):
            if r[key]["desc_loss"] == 0 or r[key]["desc_grad"] == 0:
                raise AssertionError(f"{key}: {r[key]}: K4/K5 idle on a rank")
    fitted = ranks[0]["fitted"]
    fit_max = float(np.abs(fitted - np.stack(single_fit)).max())
    fit_bits = bool(np.array_equal(fitted, np.stack(single_fit)))
    if not np.allclose(fitted, np.stack(single_fit), rtol=FIT_PARITY_RTOL, atol=FIT_PARITY_ATOL):
        raise AssertionError(f"fit_all_balls over ranks vs one device: {fit_max}")
    sweep = ranks[0]["sweep"]
    sweep_bits = []
    for s, one in zip(sweep, single_sweep):
        sweep_bits.append(all(np.array_equal(s[f], getattr(one, f).cpu().numpy()) for f in s))
    if ranks[1]["sweep"] is not None or not all(sweep_bits):
        raise AssertionError(f"sweep over the data axis vs one device, per style: {sweep_bits}")
    emit("parallel_entry_point", t0, ranks=PAR_RANKS, backend="gloo (CUDA tensors staged "
         "through the host)", views=ranks[0]["views"], width=res, height=res,
         iterations=iters, losses=losses, densify_n=densify, n_init=n_init, n_final=n_final,
         train_launches_per_rank=[r["train_launches"] for r in ranks],
         fit_balls=len(circles), fit_steps=fit_steps, patch_m=max_style_points,
         fit_bit_equal=fit_bits, fit_max_abs=fit_max,
         one_device_slab_alone_vs_batch=batch_effect,
         fit_launches_per_rank=[r["fit_launches"] for r in ranks],
         sweep_styles=len(sweep), sweep_bit_equal=sweep_bits,
         sweep_launches_per_rank=[r["sweep_launches"] for r in ranks],
         timing_note="host clock; 2 ranks sharing one H100, gloo staging through the host; "
                     "not a scaling figure",
         train_s_per_rank=[r["train_s"] for r in ranks],
         train_iters_per_s=[iters / r["train_s"] for r in ranks],
         fit_s_per_rank=[r["fit_s"] for r in ranks], single_fit_s=single_fit_s,
         sweep_s_per_rank=[r["sweep_s"] for r in ranks], single_sweep_s=single_sweep_s,
         setup_s=t_setup, ranks_s=ranks_s, dataset_views=views)


# ---- profile (python3 chip_smoke.py --profile) --------------------------------

def device_events(prof):
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def busy_us(spans):
    """Length of the union of sorted (start, end) spans."""
    busy, cur_s, cur_e = 0.0, None, None
    for a, b in spans:
        if cur_e is None or a > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def device_ms(fn, reps=20):
    """`fn` on the device, by `torch.profiler`, per call: ({kernel name: ms},
    device busy ms). CUDA events around a call of small kernels measure the
    host's launch rate as well; this is the device's own time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a session now and then records nothing: take another
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = device_events(prof)
        PROFILER_SESSIONS["profiler_sessions"] += 1
        if events:
            break
        PROFILER_SESSIONS["profiler_empty_sessions"] += 1
    else:
        raise AssertionError("the profiler recorded no device activity in 3 sessions")
    by_name = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    return ({k[:80]: v / reps / 1e3 for k, v in by_name.items()},
            busy_us(spans) / reps / 1e3)


def kernel_device_ms(fn, name, reps=20):
    """The device time per call of the kernels of `fn` whose name holds `name`."""
    by_name, _ = device_ms(fn, reps)
    hits = [v for k, v in by_name.items() if name in k]
    if not hits:
        raise AssertionError(f"no kernel named like {name!r} ran: {sorted(by_name)}")
    return sum(hits)

def kernel_group(name: str) -> str:
    for key, group in (("blend_fwd_kernel", "K1 blend_fwd"), ("blend_bwd_kernel", "K2 blend_bwd"),
                       ("segsum_kernel", "K3 segsum"), ("radix", "sort"), ("Sort", "sort"),
                       ("index", "gather/scatter/index"), ("gather", "gather/scatter/index"),
                       ("scatter", "gather/scatter/index"), ("reduce", "reductions"),
                       ("cumsum", "scan"), ("scan", "scan"), ("Scan", "scan"),
                       ("elementwise", "elementwise"), ("Memset", "memset/memcpy"),
                       ("Memcpy", "memset/memcpy"), ("memcpy", "memset/memcpy")):
        if key in name:
            return group
    return "other"


def phase_profile_train(device, n=FULL_N, res=FULL_RES, warmup=5, steps=10):
    """`torch.profiler` over `steps` train steps at 200k / 800x800 (jitter
    off): device busy and idle share of the window, kernels per step, and
    device time by kernel group and by kernel."""
    from torch.profiler import ProfilerActivity, profile

    from wast3d_tpu_torch.config import OptimizationConfig
    from wast3d_tpu_torch.ops.rasterizer import api
    from wast3d_tpu_torch.train import reconstruct as R

    t0 = time.perf_counter()
    scene = make_scene(bench_scene(n), device)
    cam = view_camera(res, res, device, eye=(0, 0, -3), fov=0.9)
    bg = torch.zeros(3, device=device)
    settings = api.RasterizeSettings(renderer="cuda")
    opt_cfg = OptimizationConfig()
    with torch.no_grad():
        gt = api.render(cam, make_scene(perturbed(bench_scene(n)), device), bg,
                        settings=settings, device=device)["render"]
    state = R.init_train_state(scene, opt_cfg, 1.0)

    def step(st):
        return R.train_step(st, cam, gt, bg, None, opt_cfg=opt_cfg, settings=settings,
                            width=res, height=res, jitter=False)[0]

    for _ in range(warmup):
        state = step(state)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        w0 = time.perf_counter()
        for _ in range(steps):
            state = step(state)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - w0) * 1e6
    kernels = device_events(prof)
    if not kernels:
        raise AssertionError("the profiler recorded no device activity")
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy = busy_us(spans)
    window = max(b for _, b in spans) - min(a for a, _ in spans)
    by_group, by_name = {}, {}
    for e in kernels:
        d = e.time_range.end - e.time_range.start
        g = kernel_group(e.name)
        by_group[g] = by_group.get(g, 0.0) + d
        by_name[e.name] = by_name.get(e.name, 0.0) + d
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    emit("profile_train", t0, n_gaussians=n, width=res, height=res, steps=steps,
         wall_ms_per_step=wall_us / steps / 1e3,
         device_busy_ms_per_step=busy / steps / 1e3,
         device_idle_share_of_wall=1.0 - busy / wall_us,
         device_idle_share_of_kernel_window=1.0 - busy / window,
         kernels_per_step=len(kernels) / steps,
         group_ms_per_step={g: v / steps / 1e3 for g, v in
                            sorted(by_group.items(), key=lambda kv: -kv[1])},
         top_kernels_ms_per_step=[[k[:90], v / steps / 1e3] for k, v in top])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one CUDA card",
              file=sys.stderr)
        return 1
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    sys.path.insert(0, ROOT)
    from wast3d_tpu_torch import _build

    t_start = time.perf_counter()
    # Plain versions use einsum (matmul): keep it in full f32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)

    t0 = time.perf_counter()
    smi = nvidia_smi_line()
    print(smi, flush=True)
    emit("device", t0, nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0])

    t0 = time.perf_counter()
    # The host library (one g++) builds beside the kernels (nvcc).
    with ThreadPoolExecutor(1) as pool:
        native_future = pool.submit(_build.build_native)
        built = _build.build()
        native_built = native_future.result()
    _build.load_library()
    emit("build", t0, nvcc_s=built.seconds, library=os.path.relpath(built.path, ROOT),
         gxx_s=native_built.seconds, native_library=os.path.relpath(native_built.path, ROOT),
         ptxas=[ln.strip() for ln in built.log.splitlines() if "ptxas" in ln])

    if "--profile" in sys.argv[1:]:
        phase_profile_train(device)
        faulthandler.cancel_dump_traceback_later()
        return 0
    if "--only" in sys.argv[1:]:
        names = sys.argv[sys.argv.index("--only") + 1].split(",")
        domain = spacing = None
        for name in names:
            if (name in ("stylize_gate", "stylize_entry_point", "sweep_entry_point",
                         "parallel_entry_point") and domain is None):
                domain, spacing = content_domain(device)
            {"k1_cases": lambda: phase_k1_cases(device),
             "k1_fast_cases": lambda: phase_k1_cases(device, fast=True),
             "k2_cases": lambda: phase_k2_cases(device),
             "k2_fast_cases": lambda: phase_k2_cases(device, fast=True),
             "k3_cases": lambda: phase_k3_cases(device),
             "full_width": lambda: phase_full_width(device),
             "full_width_fast": lambda: phase_full_width_fast(device),
             "entry_point": lambda: phase_entry_point(device),
             "train_full_width": lambda: phase_train_full_width(device),
             "train_full_width_fast": lambda: phase_train_full_width_fast(device),
             "train_entry_point": lambda: phase_train_entry_point(device),
             "pipeline_entry_point": lambda: phase_pipeline_entry_point(device),
             "k4k5_cases": lambda: phase_k45_cases(device),
             "k4k5_full_width": lambda: phase_k45_full_width(device),
             "k4k5_near_coincident": lambda: phase_k45_near_coincident(device),
             "stylize_gate": lambda: phase_stylize_gate(device, domain, spacing),
             "stylize_entry_point": lambda: phase_stylize_entry_point(device, domain, spacing),
             "oracle_cases": lambda: phase_oracle_cases(device),
             "api_options": lambda: phase_api_options(device),
             "geom_transfer": lambda: phase_geom_transfer(device),
             "sweep_entry_point": lambda: phase_sweep_entry_point(device, spacing),
             "eval_entry_point": lambda: phase_eval_entry_point(device),
             "refine_entry_point": lambda: phase_refine_entry_point(device),
             "parallel_cases": lambda: phase_parallel_cases(device),
             "parallel_entry_point": lambda: phase_parallel_entry_point(device, domain, spacing),
             "io": lambda: phase_io(device),
             "pack_gather": lambda: phase_pack_gather(device),
             "viewer_entry_point": lambda: phase_viewer_entry_point(device),
             }[name]()
        print(json.dumps({"partial_run": names,
                          "total_seconds": time.perf_counter() - t_start}), flush=True)
        faulthandler.cancel_dump_traceback_later()
        return 0

    phase_io(device)
    phase_k1_cases(device)
    phase_k1_cases(device, fast=True)
    phase_k2_cases(device)
    phase_k2_cases(device, fast=True)
    phase_k3_cases(device)
    phase_golden(device)
    phase_oracle_cases(device)
    k1 = phase_full_width(device)
    k1f = phase_full_width_fast(device)
    kg = phase_pack_gather(device)
    serve_fast, serve = phase_entry_point(device)
    if serve_fast["blend_fwd_fast"] == 0 or serve["blend_fwd"] == 0:
        raise AssertionError(f"K1f or K1 was never launched on the serving path: "
                             f"{serve_fast}, {serve}")
    phase_api_options(device)
    k2, k3 = phase_train_full_width(device)
    k2f = phase_train_full_width_fast(device)
    train = phase_train_entry_point(device)
    if any(train[k] == 0 for k in TRAIN_KERNELS):
        raise AssertionError(f"a kernel of the training path was never launched: {train}")
    viewer = phase_viewer_entry_point(device)
    if any(viewer[k] == 0 for k in TRAIN_KERNELS):
        raise AssertionError(f"a kernel of the viewer's training path was never launched: "
                             f"{viewer}")
    phase_k45_cases(device)
    k4, k5 = phase_k45_full_width(device)
    phase_k45_near_coincident(device)
    t0 = time.perf_counter()
    domain, spacing = content_domain(device)
    emit("content_domain", t0, content_n=FULL_N, domain_n=len(domain),
         domain_spacing_median=spacing)
    phase_stylize_gate(device, domain, spacing)
    style = phase_stylize_entry_point(device, domain, spacing)
    if style["desc_loss"] == 0 or style["desc_grad"] == 0:
        raise AssertionError(f"K4/K5 were never launched on the stylization path: {style}")
    phase_geom_transfer(device)
    phase_sweep_entry_point(device, spacing)
    phase_pipeline_entry_point(device)
    phase_eval_entry_point(device)
    phase_refine_entry_point(device)
    phase_parallel_cases(device)
    phase_parallel_entry_point(device, domain, spacing)
    kernels = [k1, k1f, k2, k2f, k3, k4, k5, kg]
    k1f["launches"] = serve_fast["blend_fwd_fast"]  # K2f's: from its train steps
    for k in (k1, k2, k3, k4, k5):
        k["launches"] = (style if k["name"] in ("desc_loss", "desc_grad") else train)[k["name"]]

    print(json.dumps({"total_seconds": time.perf_counter() - t_start}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    sys.exit(main())
