"""Render facade: camera + GaussianScene -> image dict.

Port of `wast3d_tpu/ops/rasterizer/api.py::render`: the same output keys
and shapes ([H, W, C] images), random per-pixel sampling offsets in (-1, 0],
and two renderers: "cuda" runs the hand-written kernels (K1 forward, K2
blend backward, K3 gradient reduction; on CPU tensors each wrapper takes its
plain version) and "torch" runs the plain PyTorch versions everywhere.

The output is differentiable with respect to the scene's tensors. Two
gradient taps, as in the JAX package: `means2d_offset` ([N, 2] zeros added
to the projected means; its gradient is the view-space positional gradient
that densification accumulates) and `view_depth_offset` ([N] zeros added to
the view depths; its gradient is the per-Gaussian expected-depth gradient).
Depth gradients reach the means through the view matrix by autograd. The
precomputed-colour / precomputed-covariance options are not ported
(`override_color` raises).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from wast3d_tpu_torch.core.camera import Camera
from wast3d_tpu_torch.device import DeviceLike, resolve_device
from wast3d_tpu_torch.ops.rasterizer import preprocess as prep_mod
from wast3d_tpu_torch.ops.rasterizer import grad_reduce as reduce_mod
from wast3d_tpu_torch.ops.rasterizer.render_path import render_sorted
from wast3d_tpu_torch.scene.gaussians import GaussianScene

RENDERERS = ("cuda", "torch")


class RasterizeSettings(NamedTuple):
    """renderer: "cuda" (K1, K2, K3) or "torch" (their plain versions).
    tile_cull: drop duplicates whose alpha stays below 1/255 over the whole
    tile at emission (exact; the blend skips them anyway).
    grad_reduce: how the duplicates' gradients are summed per Gaussian, one
    of `grad_reduce.GRAD_REDUCES`: "segsum_sortpayload" (default, exact
    f32), "segsum", "segsum_sortpacked" (bf16-rounded values), or "scatter"
    (plain `index_add_`, for tests and checks).
    Binning has no static capacities here, so the JAX package's capacity
    knobs have no counterpart."""

    renderer: str = "cuda"
    tile_cull: bool = True
    grad_reduce: str = reduce_mod.DEFAULT


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
    scaling_modifier: float = 1.0,
    override_color: Optional[torch.Tensor] = None,
    settings: RasterizeSettings = RasterizeSettings(),
    sampling_offsets: Optional[torch.Tensor] = None,
    means2d_offset: Optional[torch.Tensor] = None,
    view_depth_offset: Optional[torch.Tensor] = None,
    *,
    device: DeviceLike = None,
) -> dict:
    """Render `scene` from `camera` on `device` (None means CUDA). Returns
    render [H,W,3], depth [H,W], final_T [H,W], radii [N] int32,
    visibility_filter [N] bool, and overflow / overflow_emit / overflow_rect
    (always False: binning has no capacities to overflow). The gradient
    taps are described in the module docstring.

    The positional order is the JAX package's; `device` is the port's own
    and keyword-only. `override_color` (precomputed colours) is not ported
    yet: any value but None raises."""
    if override_color is not None:
        raise NotImplementedError(
            "render(override_color=...) is not ported yet (ROADMAP queue 1 item 8, "
            "rasterizer API completeness)")
    if settings.renderer not in RENDERERS:
        raise ValueError(f"renderer must be one of {RENDERERS}, got "
                         f"{settings.renderer!r}")
    if settings.grad_reduce not in reduce_mod.GRAD_REDUCES:
        raise ValueError(f"grad_reduce must be one of {reduce_mod.GRAD_REDUCES}, got "
                         f"{settings.grad_reduce!r}")
    dev = resolve_device(device)
    camera = camera.to(dev)
    scene = scene.to(dev)
    bg = torch.as_tensor(bg_color, dtype=torch.float32).to(dev).contiguous()
    if sampling_offsets is not None:
        sampling_offsets = sampling_offsets.to(dev, torch.float32).contiguous()

    prep = preprocess_scene(camera, scene, scaling_modifier)
    if means2d_offset is not None:
        prep = prep._replace(means2d=prep.means2d + means2d_offset)
    if view_depth_offset is not None:
        prep = prep._replace(depths=prep.depths + view_depth_offset.reshape(-1))
    out = render_sorted(prep, camera.width, camera.height, bg,
                        sampling_offsets, tile_cull=settings.tile_cull,
                        use_kernel=settings.renderer == "cuda",
                        grad_reduce=settings.grad_reduce)
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
