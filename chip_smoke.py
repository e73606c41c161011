#!/usr/bin/env python3
"""Drive the port's serving and training paths on one CUDA card and check them.

    python3 chip_smoke.py             # the checks below
    python3 chip_smoke.py --profile   # build, then only a torch.profiler
                                      # trace of the 200k / 800x800 train step

Builds the port's CUDA kernels from `wast3d_tpu_torch/csrc/` with one
`nvcc` call and holds each kernel against its plain PyTorch version on the
card: K1 (blend forward), K2 (blend backward) and K3 (per-Gaussian gradient
segment sum), each on small seeded cases, K2 and K3 also run twice for
bitwise equality. Then the serving path: the golden scene through the
kernel, the 200k-Gaussian / 800x800 scene of `bench.py` timed, and the
user's render entry point (`wast3d_tpu_torch.cli.render`). Then the
training path: 20 timed train steps on the same scene with a stage split,
K2 and K3 against their plain versions at that size, and the user's train
entry point (`wast3d_tpu_torch.cli.train`, ~300 iterations with densify) on
a Blender-format dataset. Each entry point runs with the kernels' launch
counts set to 0 just before it and read just after. Every phase prints one
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


def compare_k3(d, rank, n1, mode):
    """One rank-major wrapper twice against float64 `index_add_`; raises
    if the two runs differ in any bit or if a row's error exceeds the
    worst-case bound of summing its segment in float32 in some order,
    gamma_(n-1) sum |values| with gamma_m = m u / (1 - m u), u = 2^-24 and
    n the segment's length (times K3_BOUND_SLACK). The bf16
    wrapper is held to the float64 sum of the bf16-rounded values. Returns
    the largest error as a fraction of that bound."""
    from wast3d_tpu_torch.ops.rasterizer import grad_reduce

    fn = grad_reduce.REDUCERS[mode]
    a = fn(d, rank, n1)
    b = fn(d, rank, n1)
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
    # The render path's layout: 10 of 12 columns (row stride 12) through the sort's perm.
    rng = np.random.default_rng(1)
    full = torch.from_numpy(rng.normal(size=(3000, 12)).astype(np.float32)).to(device)
    rank = torch.from_numpy(rng.integers(0, 700, 3000)).to(device)
    sorted_ranks, perm = grad_reduce.sort_ranks(rank)
    a = grad_reduce.segment_sum(full[:, :GRAD_COLS], sorted_ranks, 700, perm=perm)
    b = grad_reduce.segment_sum_reference(full[:, :GRAD_COLS], sorted_ranks, 700, perm=perm)
    strided_err = float((a - b).abs().max())
    if strided_err > 1e-4:
        raise AssertionError(f"K3 on strided rows: {strided_err}")
    emit("k3_vs_index_add_f64", t0, cases=out, strided_perm_max_abs_err=strided_err,
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
    if launches != {"blend_fwd": views, "blend_bwd": 0, "segment_sum": 0}:
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
    launched = {k: v - counts[k] for k, v in kernel_counts().items()}
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
    k2_plain_ms = cuda_time_ms(lambda: blend_bwd_reference(*k2_args), 2)
    k2_err, drows = compare_k2((rows, starts, ends, res, res, None), bg, grads)
    pairs = evaluated_pairs(rows, starts, ends, res, res)
    K, tiles = int(rows.shape[0]), int(starts.shape[0])
    k2_bytes = 48 * K * 2 + 40 * res * res + 8 * tiles + 12
    k2_bytes_ms = k2_bytes / HBM_BYTES_PER_S * 1e3
    k2_ops_ms = K2_OPS_PER_PAIR * pairs / F32_OPS_PER_S * 1e3

    d = drows[:, :GRAD_COLS]
    rank = binning.rank
    n1 = int(state.scene.capacity)
    sorted_ranks, perm = grad_reduce.sort_ranks(rank)
    k3_ms = cuda_time_ms(lambda: grad_reduce.segment_sum(d, sorted_ranks, n1, perm=perm), 50)
    k3_plain_ms = cuda_time_ms(
        lambda: grad_reduce.segment_sum_reference(d, sorted_ranks, n1, perm=perm), 5)
    sort_ms = cuda_time_ms(lambda: grad_reduce.sort_ranks(rank), 20)
    wrapper_ms = cuda_time_ms(
        lambda: grad_reduce.segment_reduce_by_rank_sortpayload(d, rank, n1), 20)
    index_add_ms = cuda_time_ms(lambda: torch.zeros((n1, GRAD_COLS), device=device)
                                .index_add_(0, rank, d), 20)
    k3_contiguous_ms = cuda_time_ms(  # K3a / K3c read gathered, contiguous rows
        lambda rm=d[perm].contiguous(): grad_reduce.segment_sum(rm, sorted_ranks, n1), 50)
    reduce_ms = {mode: cuda_time_ms(lambda m=mode: grad_reduce.reduce(d, rank, n1, m), 20)
                 for mode in grad_reduce.GRAD_REDUCES}
    k3_err = compare_k3(d.contiguous(), rank, n1, "segsum_sortpayload")
    k3_bytes = K * (4 * GRAD_COLS + 4 + 8) + 4 * GRAD_COLS * n1
    k3_bytes_ms = k3_bytes / HBM_BYTES_PER_S * 1e3
    k3_ops_ms = K * GRAD_COLS / F32_OPS_PER_S * 1e3
    median = statistics.median(step_ms)
    emit("train_full_width", t0, n_gaussians=n, width=res, height=res, sh_degree=3,
         jitter=False, grad_reduce=settings.grad_reduce, setup_s=t_setup, warmup=warmup,
         steps=steps, step_ms_median=median, step_ms_min=min(step_ms),
         step_ms_max=max(step_ms), steps_per_s=1e3 / median, loss_first=losses[0],
         loss_last=losses[-1], launches_in_steps=launched,
         stage_ms_median=stage_ms, duplicates_K=K, evaluated_pairs=pairs,
         k2_ms=k2_ms, k2_plain_ms=k2_plain_ms, k2_bound_bytes_ms=k2_bytes_ms,
         k2_bound_ops_ms=k2_ops_ms, k2_max_rel_err=k2_err,
         k3_ms=k3_ms, k3_plain_ms=k3_plain_ms, k3_sort_ms=sort_ms,
         k3_wrapper_sort_plus_kernel_ms=wrapper_ms, index_add_ms=index_add_ms,
         k3_contiguous_rows_ms=k3_contiguous_ms, reduce_ms_by_mode=reduce_ms,
         k3_bound_bytes_ms=k3_bytes_ms, k3_bound_ops_ms=k3_ops_ms, k3_err_fraction_of_f32_bound=k3_err)
    k2 = {"name": "blend_bwd", "route": "cuda", "source": "wast3d_tpu_torch/csrc/blend_bwd.cu",
          "replaces": "wast3d_tpu/ops/rasterizer/pallas_blend.py:543", "launches": None,
          "max_abs_err": float((drows - blend_bwd_reference(*k2_args)).abs().max()),
          "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": max(k2_bytes_ms, k2_ops_ms),
          "bound_by": "bytes" if k2_bytes_ms >= k2_ops_ms else "operations",
          "library_ms": None}
    k3_out = grad_reduce.segment_sum(d, sorted_ranks, n1, perm=perm)
    k3_ref = torch.zeros((n1, GRAD_COLS), dtype=torch.float64, device=device).index_add_(
        0, rank, d.to(torch.float64))
    k3 = {"name": "segment_sum", "route": "cuda", "source": "wast3d_tpu_torch/csrc/segsum.cu",
          "replaces": "wast3d_tpu/ops/rasterizer/grad_reduce.py:65", "launches": None,
          "max_abs_err": float((k3_out.to(torch.float64) - k3_ref).abs().max()),
          "ms": k3_ms, "plain_ms": k3_plain_ms, "bound_ms": max(k3_bytes_ms, k3_ops_ms),
          "bound_by": "bytes" if k3_bytes_ms >= k3_ops_ms else "operations",
          "library_ms": index_add_ms}
    return k2, k3


def kernel_counts():
    from wast3d_tpu_torch.ops.rasterizer.blend import blend_bwd, blend_fwd
    from wast3d_tpu_torch.ops.rasterizer.grad_reduce import segment_sum

    return {"blend_fwd": blend_fwd.launches, "blend_bwd": blend_bwd.launches,
            "segment_sum": segment_sum.launches}


def reset_kernel_counts():
    from wast3d_tpu_torch.ops.rasterizer.blend import blend_bwd, blend_fwd
    from wast3d_tpu_torch.ops.rasterizer.grad_reduce import segment_sum

    blend_fwd.launches = blend_bwd.launches = segment_sum.launches = 0


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
    report_renders = min(5, views)  # report(): PSNR over train_cams[:5] (no test split)
    if [it for it, _ in densify] != [200, 300]:
        raise AssertionError(f"densify fired at {densify}, want iterations 200 and 300")
    if not (len(losses) >= 2 and losses[-1][1] < losses[0][1]):
        raise AssertionError(f"train loss did not fall: {losses}")
    if n_final == N_INIT or not finite:
        raise AssertionError(f"N {N_INIT} -> {n_final}, finite {finite}")
    want = {"blend_fwd": iters + report_renders, "blend_bwd": iters, "segment_sum": iters}
    if launches != want:
        raise AssertionError(f"launches {launches}, want {want} (one K1, K2, K3 per step, "
                             f"plus K1 for {report_renders} report renders)")
    emit("train_entry_point", t0, views=views, width=res, height=res, iterations=iters,
         launches=launches, launches_per_step={k: (v - (report_renders if k == "blend_fwd"
                                                       else 0)) / iters
                                               for k, v in launches.items()},
         losses=losses, densify_n=densify, n_init=N_INIT, n_final=n_final,
         psnr_train=report[-1]["psnr_train"] if report else None,
         setup_s=t_setup, cli_s=cli_s, iters_per_s=iters / cli_s)
    return launches


# ---- profile (python3 chip_smoke.py --profile) --------------------------------

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
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
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
    if not kernels:
        raise AssertionError("the profiler recorded no device activity")
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
    if any(v == 0 for v in train.values()):
        raise AssertionError(f"a kernel of the training path was never launched: {train}")
    kernels = [k1, k2, k3]
    for k in kernels:
        k["launches"] = train[k["name"]]

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
