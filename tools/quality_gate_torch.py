#!/usr/bin/env python3
"""Reconstruction quality gate for the PyTorch port, on one CUDA card.

The port-only counterpart of `tools/quality_gate.py` (no JAX): the same
procedural ground-truth scene (60 coloured blobs of 150 splats on and inside
a sphere shell) rendered into a Blender-format dataset (40 train views, 5
held-out test views, 400 x 400), then reconstructed from the Blender
loader's random 100k-point init through the evaluation chain of
`wast3d_tpu_torch.eval.full_eval`: `run_training` (`train_scene` with the
eval split, 7000 iterations, the xyz schedule and densification cut to the
run as the JAX gate cuts them), `render_sets`, then `evaluate`.

It reports the held-out and train PSNR computed in memory from the trained
scene (as the JAX gate does: float renders against the float ground truth,
test views and the first 5 train views), the PNG-based PSNR / SSIM /
LPIPS_PROXY of `results.json`, the Gaussian count and each stage's seconds,
next to the JAX record and its bar (1 dB below the record's held-out PSNR).

    python3 tools/quality_gate_torch.py [--iters 7000] [--out runs/qgate_torch]

Writes <out>/quality_gate_torch.json and prints it as the last line; exits
1 if the held-out PSNR misses the bar.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# The JAX gate's record (tools/quality_gate.py, 7000 iterations at 400^2;
# runs/qgate/quality_gate.json): quality only, its times are a TPU's.
JAX_RECORD = {"psnr_test": 40.386, "psnr_train": 40.842, "n_gaussians": 26904}
BAR_DB = 1.0


def gt_arrays(n_blobs=60, pts_per_blob=150, seed=3):
    """The JAX gate's ground-truth splats (`tools/quality_gate.py:_gt_arrays`,
    detail off): xyz, rgb, log scale."""
    rng = np.random.default_rng(seed)
    xyz, rgb, scal = [], [], []
    for _ in range(n_blobs):
        c = rng.normal(size=3)
        c = c / np.linalg.norm(c) * rng.uniform(0.5, 1.0)
        color = rng.uniform(0.1, 0.95, 3)
        sigma = rng.uniform(0.02, 0.08)
        xyz.append(c + rng.normal(size=(pts_per_blob, 3)) * sigma)
        rgb.append(np.tile(color, (pts_per_blob, 1))
                   * rng.uniform(0.7, 1.3, (pts_per_blob, 1)).clip(0, 1))
        scal.append(np.full((pts_per_blob, 3), sigma * 0.6))
    xyz = np.concatenate(xyz).astype(np.float32)
    rgb = np.clip(np.concatenate(rgb), 0, 1).astype(np.float32)
    return xyz, rgb, np.log(np.concatenate(scal)).astype(np.float32)


def make_gt_scene(device):
    from wast3d_tpu_torch.core.sh import rgb_to_sh
    from wast3d_tpu_torch.scene.gaussians import from_arrays

    xyz, rgb, scal = gt_arrays()
    n = len(xyz)
    opacity = np.float32(np.log(0.92 / 0.08))  # inverse sigmoid of 0.92
    return from_arrays(
        xyz=xyz, features_dc=rgb_to_sh(rgb)[:, None, :],
        features_rest=np.zeros((n, 15, 3), np.float32), scaling=scal,
        rotation=np.tile(np.array([[1, 0, 0, 0]], np.float32), (n, 1)),
        opacity=np.full((n, 1), opacity, np.float32), device=device)


def pose(i, total, phase):
    """The JAX gate's orbit: c2w with -z toward the origin, y up."""
    th = 2 * np.pi * i / total + phase
    el = 0.35 * np.sin(3 * th + phase)
    eye = 4.0 * np.array([np.cos(th) * np.cos(el), np.sin(el), np.sin(th) * np.cos(el)])
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(fwd, [0, 1, 0])
    right /= np.linalg.norm(right)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, np.cross(right, fwd), -fwd, eye
    return c2w


def make_dataset(root, device, res=400, n_train=40, n_test=5, fovx=0.8):
    """Render the ground truth into a Blender-format dataset (RGBA PNGs,
    alpha 1), as the JAX gate does, through the port's K1."""
    from wast3d_tpu_torch.core.camera import make_camera
    from wast3d_tpu_torch.ops.rasterizer import api
    from wast3d_tpu_torch.utils.png import write_png

    scene = make_gt_scene(device)
    os.makedirs(root, exist_ok=True)
    for name, count, phase in (("train", n_train, 0.0), ("test", n_test, 0.123)):
        frames = []
        for i in range(count):
            c2w = pose(i, count, phase)
            c2w_cv = c2w.copy()
            c2w_cv[:3, 1:3] *= -1  # Blender -> COLMAP, as the loader does
            w2c = np.linalg.inv(c2w_cv)
            cam = make_camera(w2c[:3, :3].T, w2c[:3, 3], fovx=fovx, fovy=fovx, width=res,
                              height=res, device=device)
            with torch.no_grad():
                img = api.render(cam, scene, torch.zeros(3), device=device)["render"]
            rgba = np.concatenate([np.clip(img.cpu().numpy(), 0, 1),
                                   np.ones((res, res, 1), np.float32)], -1)
            write_png(os.path.join(root, f"{name}_{i}.png"), (rgba * 255).astype(np.uint8))
            frames.append({"file_path": f"./{name}_{i}", "transform_matrix": c2w.tolist()})
        with open(os.path.join(root, f"transforms_{name}.json"), "w") as f:
            json.dump({"camera_angle_x": fovx, "frames": frames}, f)


def held_out_psnr(trainer, data, device):
    """Mean PSNR of float renders against the float ground truth: the test
    views and the first 5 train views (the JAX gate's measure)."""
    from wast3d_tpu_torch.ops.image_losses import psnr
    from wast3d_tpu_torch.ops.rasterizer import api
    from wast3d_tpu_torch.scene.datasets import build_cameras, load_scene_info

    info = load_scene_info(data, eval_split=True)
    res = {}
    for split, infos in (("test", info.test_cameras), ("train", info.train_cameras[:5])):
        vals = []
        for cam, gt in build_cameras(infos, device=device):
            with torch.no_grad():
                out = api.render(cam, trainer.state.scene, torch.zeros(3, device=device),
                                 settings=trainer.settings, device=device)
            vals.append(float(psnr(out["render"], torch.from_numpy(gt).to(device))))
        res[f"psnr_{split}"] = float(np.mean(vals))
    return res


def nvidia_smi_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=7000)
    ap.add_argument("--res", type=int, default=400)
    ap.add_argument("--views", type=int, default=40, help="training views")
    ap.add_argument("--out", default="runs/qgate_torch")
    ap.add_argument("--workdir", default=None,
                    help="dataset and model directory (default: a temporary one)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    from wast3d_tpu_torch.config import OptimizationConfig
    from wast3d_tpu_torch.device import resolve_device
    from wast3d_tpu_torch.eval.full_eval import run_training
    from wast3d_tpu_torch.eval.metrics import evaluate
    from wast3d_tpu_torch.eval.render_sets import render_sets

    device = resolve_device(args.device)
    with tempfile.TemporaryDirectory(prefix="w3d_qgate_") as tmp:
        work = args.workdir or tmp
        data, model = os.path.join(work, "data"), os.path.join(work, "model")
        seconds = {}
        t0 = time.perf_counter()
        make_dataset(data, device, res=args.res, n_train=args.views)
        seconds["dataset"] = time.perf_counter() - t0

        opt = OptimizationConfig(iterations=args.iters, position_lr_max_steps=args.iters,
                                 densify_until_iter=args.iters // 2)
        t0 = time.perf_counter()
        trainer = run_training(data, model, iterations=args.iters, device=device,
                               opt_cfg=opt, log_every=500)
        if device.type == "cuda":
            torch.cuda.synchronize()
        seconds["train"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        res = held_out_psnr(trainer, data, device)
        seconds["psnr_in_memory"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        render_sets(model, data, iteration=args.iters, device=device)
        seconds["render_sets"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        metrics = evaluate([model], device=device)[model][f"ours_{args.iters}"]
        seconds["metrics"] = time.perf_counter() - t0
        events = [e for e in trainer.history if "event" in e]

    bar = JAX_RECORD["psnr_test"] - BAR_DB
    report = {
        **res, "results_json": metrics, "n_gaussians": int(trainer.state.scene.num_active),
        "iters": args.iters, "res": args.res, "views": args.views,
        "steps_per_s": args.iters / seconds["train"], "seconds": seconds,
        "device": nvidia_smi_line() if device.type == "cuda" else "cpu",
        "jax_record": JAX_RECORD, "bar_psnr_test": bar,
        "meets_bar": res["psnr_test"] >= bar, "densify_events": len(events),
    }
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "quality_gate_torch.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report), flush=True)
    return 0 if report["meets_bar"] else 1


if __name__ == "__main__":
    sys.exit(main())
