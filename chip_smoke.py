#!/usr/bin/env python3
"""Drive the port's serving path on one CUDA card and check it.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `wast3d_tpu_torch/csrc/` with `nvcc`,
holds each kernel against its plain PyTorch version on the card, renders
the golden scene through the kernel, renders the 200k-Gaussian / 800x800
scene of `bench.py` and times it, and finally runs the user's entry point
(`wast3d_tpu_torch.cli.render`) on a small Blender-format dataset with the
kernels' launch counts reset just before and read just after. Every phase
prints one JSON line with its numbers and seconds; any failure raises and
the script exits non-zero. The last lines are the card's name and power
limit as nvidia-smi prints them, one `{"kernels": [...]}` line, and
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
    """The user's entry point, with every kernel's count set to 0 just
    before and read just after. Returns {kernel name: launches}."""
    from wast3d_tpu_torch.cli import render as cli
    from wast3d_tpu_torch.ops.rasterizer.blend import blend_fwd
    from wast3d_tpu_torch.scene.ply import save_ply
    from wast3d_tpu_torch.utils.png import read_png

    t0 = time.perf_counter()
    scene = make_scene(bench_scene(n), device)
    with tempfile.TemporaryDirectory(prefix="w3d_chip_smoke_") as tmp:
        src, model = os.path.join(tmp, "scene"), os.path.join(tmp, "model")
        views = write_blender_dataset(src, scene, device, res)
        save_ply(scene, os.path.join(model, "point_cloud", "iteration_1", "point_cloud.ply"))
        t_setup = time.perf_counter() - t0

        blend_fwd.launches = 0
        t1 = time.perf_counter()
        cli.main(["-m", model, "-s", src, "--device", device.type])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t1
        launches = {"blend_fwd": blend_fwd.launches}

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
    if launches["blend_fwd"] != views:
        raise AssertionError(f"K1 launched {launches['blend_fwd']} times for {views} views")
    if worst_diff > 2:
        raise AssertionError(f"entry point renders differ from the plain renders by {worst_diff}/255")
    emit("entry_point", t0, views=views, width=res, height=res, launches=launches,
         written=written, max_png_diff_vs_plain=worst_diff,
         min_psnr_vs_plain=min(psnrs) if psnrs else None,  # None: all identical
         setup_s=t_setup, cli_s=cli_s)
    return launches


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

    phase_k1_cases(device)
    phase_golden(device)
    k1 = phase_full_width(device)
    launches = phase_entry_point(device)
    k1["launches"] = launches[k1["name"]]
    if any(v == 0 for v in launches.values()):
        raise AssertionError(f"a kernel of the path was never launched: {launches}")

    print(json.dumps({"total_seconds": time.perf_counter() - t_start}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"kernels": [k1]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    sys.exit(main())
