#!/usr/bin/env python3
"""Drive the port's serving, training and stylization paths on one CUDA card
and check them.

    python3 chip_smoke.py             # the checks below
    python3 chip_smoke.py --profile   # build, then only a torch.profiler
                                      # trace of the 200k / 800x800 train step
    python3 chip_smoke.py --only k3_cases,k4k5_full_width
                                      # build, then only the named phases
                                      # (no result line)

Builds the port's CUDA kernels from `wast3d_tpu_torch/csrc/` with one
`nvcc` call and holds each kernel against its plain PyTorch version on the
card: K1 (blend forward), K2 (blend backward) and K3 (per-Gaussian gradient
segment sum), each on small seeded cases, K2 and K3 also run twice for
bitwise equality (K3 also on the render path's route, from the binning's
own segments, against the bare-rank route: the same bits). Then the serving path: the golden scene through the
kernel, the 200k-Gaussian / 800x800 scene of `bench.py` timed, and the
user's render entry point (`wast3d_tpu_torch.cli.render`). Then the
training path: 20 timed train steps on the same scene with a stage split,
K2 and K3 against their plain versions at that size, and the user's train
entry point (`wast3d_tpu_torch.cli.train`, ~300 iterations with densify) on
a Blender-format dataset. Then the stylization path: K4 (pair-descriptor
loss) and K5 (its gradient), both on the fit's pair list, against their
plain versions on seeded cases (K4 also against the dense one),
twice each for bitwise equality, alone at the production shape
(Mp = 16384, 8 balls), and against float64 where points nearly coincide; a port-only mirror of `tools/stylize_gate.py` at the
JAX record's configuration; and the user's stylize entry point
(`wast3d_tpu_torch.cli.stylize`) at Mp = 16384, where K4/K5 carry the fit.
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

import faulthandler
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
WATCHDOG_S = 1100  # dump every thread's stack and exit rather than hang

# NVIDIA H100 SXM data sheet: HBM rate and f32 (non-tensor-core) peak.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# K1 per evaluated (pixel, entry) pair: ~25 f32 operations plus one expf,
# counted as one more (csrc/blend_fwd.cu).
K1_OPS_PER_PAIR = 26
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


def emit(phase: str, t0: float, **numbers) -> None:
    numbers["seconds"] = time.perf_counter() - t0
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

def kernel_inputs(scene, cam, offsets=None):
    """The exact inputs the main path hands K1 for this view."""
    from wast3d_tpu_torch.ops.rasterizer import api, render_path

    prep = api.preprocess_scene(cam, scene)
    binning, rows = render_path.bin_and_pack(prep, cam.width, cam.height,
                                             jittered=offsets is not None)
    return rows, binning.tile_start, binning.tile_end, cam.width, cam.height, offsets


def compare_k1(inputs, bg):
    """Kernel and plain version on the same inputs; raises past tolerance.
    Returns ({field: (max, mean)} absolute errors, the kernel's output)."""
    from wast3d_tpu_torch.ops.rasterizer.blend import blend_fwd, blend_fwd_reference

    rows, starts, ends, w, h, offsets = inputs
    k = blend_fwd(rows, starts, ends, w, h, bg, offsets)
    p = blend_fwd_reference(rows, starts, ends, w, h, bg, offsets)
    torch.cuda.synchronize()
    errs = {}
    for name, a, b in zip(("color", "depth", "final_T"), k, p):
        if not torch.isfinite(a).all():
            raise AssertionError(f"K1 {name}: non-finite values")
        d = (a - b).abs()
        errs[name] = (float(d.max()) if d.numel() else 0.0, float(d.mean()) if d.numel() else 0.0)
    for name in ("color", "final_T"):
        mx, mean = errs[name]
        if mx > TOL_MAX or mean > TOL_MEAN:
            raise AssertionError(f"K1 {name} vs plain: max {mx} mean {mean} "
                                 f"(limits {TOL_MAX}, {TOL_MEAN})")
    if errs["depth"][0] > TOL_DEPTH:
        raise AssertionError(f"K1 depth vs plain: max {errs['depth'][0]} (limit {TOL_DEPTH})")
    return errs, k


def k1_cases(device):
    bg = torch.tensor([0.2, 0.5, 0.9], device=device)
    cases = {}
    cases["random_64"] = kernel_inputs(make_scene(random_scene(), device), view_camera(64, 64, device))
    cases["nonmultiple_50x34"] = kernel_inputs(make_scene(random_scene(seed=1), device),
                                               view_camera(50, 34, device))
    cases["saturating_32"] = kernel_inputs(make_scene(saturating_scene(), device),
                                           view_camera(32, 32, device))
    off = -np.random.default_rng(7).uniform(0, 1, (48, 64, 2)).astype(np.float32)
    cases["jitter_64x48"] = kernel_inputs(make_scene(random_scene(seed=2), device),
                                          view_camera(64, 48, device),
                                          torch.from_numpy(off).to(device))
    cases["empty_tiles_96"] = kernel_inputs(make_scene(corner_scene(), device),
                                            view_camera(96, 96, device))
    behind = random_scene(seed=3)
    behind["xyz"][:, 2] = -9.0  # everything behind the camera: no rows at all
    cases["no_rows_64"] = kernel_inputs(make_scene(behind, device), view_camera(64, 64, device))
    return bg, cases


def phase_k1_cases(device):
    t0 = time.perf_counter()
    bg, cases = k1_cases(device)
    out = {}
    for name, inputs in cases.items():
        rows, starts, ends = inputs[:3]
        errs, k = compare_k1(inputs, bg)
        out[name] = {"K": int(rows.shape[0]),
                     "empty_tiles": int((ends == starts).sum()),
                     "final_T_min": float(k.final_T.min()),
                     **{f"{f}_max": e[0] for f, e in errs.items()},
                     **{f"{f}_mean": e[1] for f, e in errs.items()}}
    if out["empty_tiles_96"]["empty_tiles"] == 0:
        raise AssertionError("the empty-tiles case has no empty tile")
    if out["saturating_32"]["final_T_min"] >= 1e-3:
        raise AssertionError("the saturating case never reached the early stop")
    emit("k1_vs_plain", t0, cases=out, tolerance={"color_final_T_max": TOL_MAX,
                                                   "mean": TOL_MEAN, "depth_max": TOL_DEPTH})


# ---- K2 and K3 against their plain versions -------------------------------

def k2_cotangents(h, w, device, seed):
    """Seeded cotangents of colour, depth and final_T."""
    from wast3d_tpu_torch.ops.rasterizer.blend import BlendOutput

    rng = np.random.default_rng(seed)
    arrays = (rng.normal(size=(h, w, 3)), rng.normal(size=(h, w)) * 0.1,
              rng.normal(size=(h, w)))
    return BlendOutput(*(torch.from_numpy(a.astype(np.float32)).to(device) for a in arrays))


def compare_k2(inputs, bg, grads):
    """K2 twice and its plain version on the same inputs (K1's output as
    the forward); raises past K2_TOL or if the two kernel runs differ in any
    bit. Returns (max error over columns, relative to each column's max;
    the kernel's output)."""
    from wast3d_tpu_torch.ops.rasterizer.blend import (
        blend_bwd, blend_bwd_reference, blend_fwd)

    rows, starts, ends, w, h, offsets = inputs
    out = blend_fwd(rows, starts, ends, w, h, bg, offsets)
    k = blend_bwd(rows, starts, ends, w, h, bg, offsets, out, grads)
    k_again = blend_bwd(rows, starts, ends, w, h, bg, offsets, out, grads)
    p = blend_bwd_reference(rows, starts, ends, w, h, bg, offsets, out, grads)
    torch.cuda.synchronize()
    if not torch.isfinite(k).all():
        raise AssertionError("K2: non-finite values")
    if not torch.equal(k, k_again):
        raise AssertionError("K2: two runs on the same inputs differ")
    if k.numel() and (k[:, GRAD_COLS:] != 0).any():
        raise AssertionError("K2: padding columns not zero")
    rel = 0.0
    for col in range(GRAD_COLS):
        scale = float(p[:, col].abs().max()) if p.numel() else 0.0
        err = float((k[:, col] - p[:, col]).abs().max()) if p.numel() else 0.0
        rel = max(rel, err / scale if scale > 0 else err)
    if rel > K2_TOL:
        raise AssertionError(f"K2 vs plain: {rel} of the column max (limit {K2_TOL})")
    return rel, k


def phase_k2_cases(device):
    t0 = time.perf_counter()
    _, cases = k1_cases(device)
    out = {}
    for bg_value in (0.0, 1.0):
        bg = torch.full((3,), bg_value, device=device)
        for i, (name, inputs) in enumerate(cases.items()):
            rows, _, _, w, h, _ = inputs
            rel, k = compare_k2(inputs, bg, k2_cotangents(h, w, device, seed=i))
            out[f"{name}_bg{int(bg_value)}"] = {
                "K": int(rows.shape[0]), "max_rel_err": rel,
                "max_abs_grad": float(k.abs().max()) if k.numel() else 0.0}
    emit("k2_vs_plain", t0, cases=out, tolerance_rel_to_column_max=K2_TOL,
         runs_bitwise_equal=True)


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
        blend_fwd, blend_fwd_reference, evaluated_pairs)

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
    plain_ms = cuda_time_ms(lambda: blend_fwd_reference(*inputs), 3)
    errs, _ = compare_k1(inputs[:5] + (None,), bg)
    pairs = evaluated_pairs(*inputs[:5])
    K, tiles = int(rows.shape[0]), int(binning.tile_start.shape[0])
    bytes_moved = 48 * K + 8 * tiles + 12 + 20 * res * res
    ops = K1_OPS_PER_PAIR * pairs
    bytes_ms, ops_ms = bytes_moved / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    median = statistics.median(frame_ms)
    emit("full_width", t0, n_gaussians=n, visible=visible, width=res, height=res,
         sh_degree=3, duplicates_K=K, tiles=tiles, setup_s=t_setup,
         frame_ms_median=median, frame_ms_min=min(frame_ms), frame_ms_max=max(frame_ms),
         frames=frames, warmup=warmup, mpix_per_s=res * res / (median * 1e-3) / 1e6,
         stage_ms_median={k: statistics.median(v) for k, v in stage.items()},
         k1_ms=k1_ms, plain_ms=plain_ms, k1_bound_ms=bound_ms,
         k1_bound_bytes_ms=bytes_ms, k1_bound_ops_ms=ops_ms, evaluated_pairs=pairs,
         k1_launches_in_frames=launched,
         **{f"k1_{f}_max_err": e[0] for f, e in errs.items()})
    return {"name": "blend_fwd", "route": "cuda", "source": "wast3d_tpu_torch/csrc/blend_fwd.cu",
            "replaces": "wast3d_tpu/ops/rasterizer/pallas_blend.py:402",
            "launches": None, "max_abs_err": max(e[0] for e in errs.values()),
            "ms": k1_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
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


def phase_entry_point(device, n=FULL_N, res=FULL_RES):
    """The user's render entry point, with every kernel's count set to 0
    just before and read just after. Returns {kernel name: launches}."""
    from wast3d_tpu_torch.cli import render as cli
    from wast3d_tpu_torch.scene.ply import save_ply
    from wast3d_tpu_torch.utils.png import read_png

    t0 = time.perf_counter()
    scene = make_scene(bench_scene(n), device)
    with tempfile.TemporaryDirectory(prefix="w3d_chip_smoke_") as tmp:
        src, model = os.path.join(tmp, "scene"), os.path.join(tmp, "model")
        views = write_blender_dataset(src, scene, device, res)
        save_ply(scene, os.path.join(model, "point_cloud", "iteration_1", "point_cloud.ply"))
        t_setup = time.perf_counter() - t0

        reset_kernel_counts()
        t1 = time.perf_counter()
        cli.main(["-m", model, "-s", src, "--device", device.type])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t1
        launches = kernel_counts()

        worst_diff, psnrs, written = 0, [], {}
        for split, count in (("train", views - 2), ("test", 2)):
            base = os.path.join(model, split, "ours_1")
            ren = sorted(os.listdir(os.path.join(base, "renders")))
            gt = sorted(os.listdir(os.path.join(base, "gt")))
            written[split] = (len(ren), len(gt))
            if len(ren) != count or ren != gt:
                raise AssertionError(f"{split}: renders {ren} gt {gt} (want {count} each)")
            for f in ren:
                a = read_png(os.path.join(base, "renders", f)).astype(np.int32)
                b = read_png(os.path.join(base, "gt", f)).astype(np.int32)
                if a.shape != (res, res, 3):
                    raise AssertionError(f"{split}/{f}: shape {a.shape}")
                worst_diff = max(worst_diff, int(np.abs(a - b).max()))
                if (a != b).any():
                    psnrs.append(psnr(a / 255.0, b / 255.0))
    if launches != {"blend_fwd": views, "blend_bwd": 0, "segment_sum": 0, "desc_loss": 0,
                    "desc_grad": 0}:
        raise AssertionError(f"launches {launches} for {views} views (want K1 once each)")
    if worst_diff > 2:
        raise AssertionError(f"entry point renders differ from the plain renders by {worst_diff}/255")
    emit("entry_point", t0, views=views, width=res, height=res, launches=launches,
         written=written, max_png_diff_vs_plain=worst_diff,
         min_psnr_vs_plain=min(psnrs) if psnrs else None,  # None: all identical
         setup_s=t_setup, cli_s=cli_s)
    return launches


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


TRAIN_KERNELS = ("blend_fwd", "blend_bwd", "segment_sum")


def _counted():
    from wast3d_tpu_torch.ops.rasterizer.blend import blend_bwd, blend_fwd
    from wast3d_tpu_torch.ops.rasterizer.grad_reduce import segment_sum
    from wast3d_tpu_torch.stylize.desc_kernel import desc_grad, desc_loss

    return {"blend_fwd": blend_fwd, "blend_bwd": blend_bwd, "segment_sum": segment_sum,
            "desc_loss": desc_loss, "desc_grad": desc_grad}


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
    want = {"blend_fwd": iters + report_renders, "blend_bwd": iters, "segment_sum": iters,
            "desc_loss": 0, "desc_grad": 0}
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
    want = {"blend_fwd": 0, "blend_bwd": 0, "segment_sum": 0,
            "desc_loss": fit_steps * batches, "desc_grad": fit_steps * batches}
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
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = device_events(prof)
    if not events:
        raise AssertionError("the profiler recorded no device activity")
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
    built = _build.build()
    _build.load_library()
    emit("build", t0, nvcc_s=built.seconds, library=os.path.relpath(built.path, ROOT),
         ptxas=[ln.strip() for ln in built.log.splitlines() if "ptxas" in ln])

    if "--profile" in sys.argv[1:]:
        phase_profile_train(device)
        faulthandler.cancel_dump_traceback_later()
        return 0
    if "--only" in sys.argv[1:]:
        only = sys.argv[sys.argv.index("--only") + 1].split(",")
        domain = spacing = None
        for name in only:
            if name in ("stylize_gate", "stylize_entry_point") and domain is None:
                domain, spacing = content_domain(device)
            {"k1_cases": lambda: phase_k1_cases(device),
             "k2_cases": lambda: phase_k2_cases(device),
             "k3_cases": lambda: phase_k3_cases(device),
             "full_width": lambda: phase_full_width(device),
             "train_full_width": lambda: phase_train_full_width(device),
             "train_entry_point": lambda: phase_train_entry_point(device),
             "k4k5_cases": lambda: phase_k45_cases(device),
             "k4k5_full_width": lambda: phase_k45_full_width(device),
             "k4k5_near_coincident": lambda: phase_k45_near_coincident(device),
             "stylize_gate": lambda: phase_stylize_gate(device, domain, spacing),
             "stylize_entry_point": lambda: phase_stylize_entry_point(device, domain, spacing),
             }[name]()
        print(json.dumps({"partial_run": only,
                          "total_seconds": time.perf_counter() - t_start}), flush=True)
        faulthandler.cancel_dump_traceback_later()
        return 0

    phase_k1_cases(device)
    phase_k2_cases(device)
    phase_k3_cases(device)
    phase_golden(device)
    k1 = phase_full_width(device)
    serve = phase_entry_point(device)
    if serve["blend_fwd"] == 0:
        raise AssertionError(f"K1 was never launched on the serving path: {serve}")
    k2, k3 = phase_train_full_width(device)
    train = phase_train_entry_point(device)
    if any(train[k] == 0 for k in TRAIN_KERNELS):
        raise AssertionError(f"a kernel of the training path was never launched: {train}")
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
    kernels = [k1, k2, k3, k4, k5]
    for k in kernels:
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
