"""SSIM / PSNR / LPIPS evaluation over render directories.

Port of `wast3d_tpu/eval/metrics.py` (the reference `metrics.py:36-103`):
walks `<model_path>/<split>/ours_<iter>/{renders,gt}`, computes per-view and
mean metrics and writes `results.json` + `per_view.json` in the same schema
and keys. LPIPS is exact only with pretrained weights (`ops/lpips.py`);
otherwise its key is `LPIPS_PROXY`. Images are read by the port's own reader
(`utils/image_io.read_image`: PNG, JPEG, BMP, TIFF, WebP or GIF by the
file's signature, PIL's arrays without PIL); each image is `[..., :3] / 255`
in float32, as in JAX.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from wast3d_tpu_torch.device import DeviceLike, resolve_device
from wast3d_tpu_torch.ops.image_losses import psnr as psnr_fn
from wast3d_tpu_torch.ops.image_losses import ssim as ssim_fn
from wast3d_tpu_torch.ops.lpips import LPIPS
from wast3d_tpu_torch.utils.image_io import read_image


def _read_image(path: str) -> np.ndarray:
    return np.asarray(read_image(path), dtype=np.float32)[..., :3] / 255.0


def _read_images(renders_dir: str, gt_dir: str):
    names = sorted(os.listdir(renders_dir))
    renders = [_read_image(os.path.join(renders_dir, f)) for f in names]
    gts = [_read_image(os.path.join(gt_dir, f)) for f in names]
    return renders, gts, names


def evaluate_dir(method_dir: str, lpips_model: Optional[LPIPS] = None,
                 device: DeviceLike = None) -> Dict:
    """Evaluate one `ours_<iteration>` directory on `device` (None means
    CUDA; an `lpips_model` computes on its own device). Returns
    {"mean": {...}, "per_view": {...}}."""
    dev = resolve_device(device)
    renders, gts, names = _read_images(
        os.path.join(method_dir, "renders"), os.path.join(method_dir, "gt"))
    if lpips_model is None:
        lpips_model = LPIPS(device=dev)
    key = lpips_model.metric_name.upper()
    per_view = {"SSIM": {}, "PSNR": {}, key: {}}
    with torch.no_grad():
        for r, g, name in zip(renders, gts, names):
            rt, gt = torch.from_numpy(r).to(dev), torch.from_numpy(g).to(dev)
            per_view["SSIM"][name] = float(ssim_fn(rt, gt))
            per_view["PSNR"][name] = float(psnr_fn(rt, gt))
            per_view[key][name] = float(lpips_model(rt, gt))
    return {"mean": {k: float(np.mean(list(v.values()))) for k, v in per_view.items()},
            "per_view": per_view}


def evaluate(model_paths: List[str], split: str = "test",
             device: DeviceLike = None) -> Dict:
    """Per model dir, evaluate every `ours_*` method under `<model>/<split>`
    and write results.json and per_view.json (the reference's `evaluate`)."""
    dev = resolve_device(device)
    lpips_model = LPIPS(device=dev)
    all_results = {}
    for model_path in model_paths:
        results, per_views = {}, {}
        split_dir = os.path.join(model_path, split)
        if not os.path.isdir(split_dir):
            continue
        for method in sorted(os.listdir(split_dir)):
            mdir = os.path.join(split_dir, method)
            if not os.path.isdir(os.path.join(mdir, "renders")):
                continue
            res = evaluate_dir(mdir, lpips_model, device=dev)
            results[method] = res["mean"]
            per_views[method] = res["per_view"]
        with open(os.path.join(model_path, "results.json"), "w") as f:
            json.dump(results, f, indent=True)
        with open(os.path.join(model_path, "per_view.json"), "w") as f:
            json.dump(per_views, f, indent=True)
        all_results[model_path] = results
    return all_results
