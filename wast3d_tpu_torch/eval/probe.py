"""Render probe: dump RGB / depth / normals artifacts for N views.

Port of `wast3d_tpu/eval/probe.py` (the reference `test_depth.py:66-143`):
render a handful of views of a trained scene and save RGB, min-max
normalised depth and depth-derived normals as PNGs, plus the raw arrays in
`probe.npz`, the reference's human-inspectable QA artifact.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch

from wast3d_tpu_torch.device import DeviceLike, resolve_device
from wast3d_tpu_torch.eval.render_sets import save_image
from wast3d_tpu_torch.ops.depth import depth_to_normals
from wast3d_tpu_torch.ops.rasterizer import api


def probe_views(
    scene,
    cameras: List,
    out_dir: str,
    bg_color=None,
    settings: Optional[api.RasterizeSettings] = None,
    max_views: int = 10,
    *,
    device: DeviceLike = None,
) -> dict:
    """Render up to `max_views` cameras (or (camera, gt) pairs) on `device`
    (None means CUDA); returns {"rgb", "depth", "normals"} lists of numpy
    arrays."""
    dev = resolve_device(device)
    bg = torch.zeros(3) if bg_color is None else bg_color
    settings = settings or api.RasterizeSettings()
    os.makedirs(out_dir, exist_ok=True)
    dump = {"rgb": [], "depth": [], "normals": []}
    for i, cam in enumerate(cameras[:max_views]):
        if isinstance(cam, tuple):
            cam = cam[0]
        with torch.no_grad():
            out = api.render(cam, scene, bg, settings=settings, device=dev)
            fx = cam.width / (2.0 * cam.tan_fovx)
            fy = cam.height / (2.0 * cam.tan_fovy)
            normals = depth_to_normals(out["depth"], fx, fy).cpu().numpy()
        rgb = out["render"].cpu().numpy()
        depth = out["depth"].cpu().numpy()
        save_image(os.path.join(out_dir, f"rgb_{i:03d}.png"), rgb)
        dn = (depth - depth.min()) / (np.ptp(depth) + 1e-9)
        save_image(os.path.join(out_dir, f"depth_{i:03d}.png"), np.stack([dn] * 3, -1))
        save_image(os.path.join(out_dir, f"normals_{i:03d}.png"), (normals + 1) / 2)
        dump["rgb"].append(rgb)
        dump["depth"].append(depth)
        dump["normals"].append(normals)
    np.savez(os.path.join(out_dir, "probe.npz"),
             **{k: np.stack(v) for k, v in dump.items() if v})
    return dump
