"""Render facade: camera + GaussianScene -> image dict.

Port of `wast3d_tpu/ops/rasterizer/api.py::render` for serving: the same
output keys and shapes ([H, W, C] images), random per-pixel sampling
offsets in (-1, 0], and two renderers: "cuda" runs K1 (the hand-written
blend kernel; on CPU tensors its wrapper takes the plain version) and
"torch" runs the plain PyTorch blend everywhere. The training taps
(`means2d_offset`, `view_depth_offset`) and the precomputed-colour /
precomputed-covariance options belong to a later slice.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from wast3d_tpu_torch.core.camera import Camera
from wast3d_tpu_torch.device import DeviceLike, resolve_device
from wast3d_tpu_torch.ops.rasterizer import preprocess as prep_mod
from wast3d_tpu_torch.ops.rasterizer.render_path import render_sorted
from wast3d_tpu_torch.scene.gaussians import GaussianScene

RENDERERS = ("cuda", "torch")


class RasterizeSettings(NamedTuple):
    """renderer: "cuda" (K1) or "torch" (the plain blend).
    tile_cull: drop duplicates whose alpha stays below 1/255 over the whole
    tile at emission (exact; the blend skips them anyway). Binning has no
    static capacities here, so the JAX package's capacity knobs have no
    counterpart."""

    renderer: str = "cuda"
    tile_cull: bool = True


def random_sampling_offsets(generator: torch.Generator, height: int,
                            width: int) -> torch.Tensor:
    """[H, W, 2] uniform in (-1, 0], on the generator's device."""
    return -torch.rand((height, width, 2), generator=generator,
                       device=generator.device, dtype=torch.float32)


def preprocess_scene(camera: Camera, scene: GaussianScene,
                     scaling_modifier: float = 1.0) -> prep_mod.Preprocessed:
    """Project `scene` into `camera` (both on one device)."""
    return prep_mod.preprocess(
        means3d=scene.get_xyz,
        opacities=scene.get_opacity,
        view_transform=camera.view_transform,
        full_proj_transform=camera.full_proj_transform,
        camera_center=camera.camera_center,
        tan_fovx=camera.tan_fovx,
        tan_fovy=camera.tan_fovy,
        width=camera.width,
        height=camera.height,
        sh_degree=scene.active_sh_degree,
        shs=scene.get_features,
        scales=scene.get_scaling,
        rotations=scene.get_rotation,
        scaling_modifier=scaling_modifier,
        mask=scene.mask,
    )


def render(
    camera: Camera,
    scene: GaussianScene,
    bg_color,
    settings: RasterizeSettings = RasterizeSettings(),
    sampling_offsets: Optional[torch.Tensor] = None,
    scaling_modifier: float = 1.0,
    device: DeviceLike = None,
) -> dict:
    """Render `scene` from `camera` on `device` (None means CUDA). Returns
    render [H,W,3], depth [H,W], final_T [H,W], radii [N] int32,
    visibility_filter [N] bool, and overflow / overflow_emit / overflow_rect
    (always False: binning has no capacities to overflow)."""
    if settings.renderer not in RENDERERS:
        raise ValueError(f"renderer must be one of {RENDERERS}, got "
                         f"{settings.renderer!r}")
    dev = resolve_device(device)
    camera = camera.to(dev)
    scene = scene.to(dev)
    bg = torch.as_tensor(bg_color, dtype=torch.float32).to(dev).contiguous()
    if sampling_offsets is not None:
        sampling_offsets = sampling_offsets.to(dev, torch.float32).contiguous()

    prep = preprocess_scene(camera, scene, scaling_modifier)
    out = render_sorted(prep, camera.width, camera.height, bg,
                        sampling_offsets, tile_cull=settings.tile_cull,
                        use_kernel=settings.renderer == "cuda")
    b = out.binning
    return {
        "render": out.color,
        "depth": out.depth,
        "final_T": out.final_T,
        "radii": prep.radii,
        "visibility_filter": prep.radii > 0,
        "overflow": b.overflow,
        "overflow_emit": b.overflow_emit,
        "overflow_rect": b.overflow_rect,
    }
