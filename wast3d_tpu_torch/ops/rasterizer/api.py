"""Render facade: camera + GaussianScene -> image dict.

Port of `wast3d_tpu/ops/rasterizer/api.py::render`: the same output keys
and shapes ([H, W, C] images), random per-pixel sampling offsets in (-1, 0],
and the JAX package's renderer names: "pallas" runs the hand-written kernels
(K1 forward, K2 blend backward, K3 gradient reduction; on CPU tensors each
wrapper takes its plain version) and "tiled", which JAX documents as the
reference implementation for its kernel, runs their plain PyTorch versions
everywhere; "oracle" runs the per-pixel oracle (`oracle.py`, plain PyTorch,
O(N·H·W), for tests). "cuda" and "torch" are the port's older names for the
first two.

The output is differentiable with respect to the scene's tensors. Two
gradient taps, as in the JAX package: `means2d_offset` ([N, 2] zeros added
to the projected means; its gradient is the view-space positional gradient
that densification accumulates) and `view_depth_offset` ([N] zeros added to
the view depths; its gradient is the per-Gaussian expected-depth gradient).
Depth gradients reach the means through the view matrix by autograd.

As in JAX, `override_color` ([N, 3], taken as given: no +0.5, no clamp)
replaces the SH colours; `convert_shs_python` evaluates the SH colours
outside preprocess (normalised view directions) and hands them in as
precomputed colours; `compute_cov3d_python` hands in the scene's packed
covariance instead of its scales and rotations. Gradients reach each of
them through the same blend backward.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from wast3d_tpu_torch.core.camera import Camera
from wast3d_tpu_torch.core.sh import eval_sh_color
from wast3d_tpu_torch.device import DeviceLike, resolve_device
from wast3d_tpu_torch.ops.rasterizer import grad_reduce as reduce_mod
from wast3d_tpu_torch.ops.rasterizer import oracle as oracle_mod
from wast3d_tpu_torch.ops.rasterizer import preprocess as prep_mod
from wast3d_tpu_torch.ops.rasterizer.render_path import render_sorted
from wast3d_tpu_torch.scene.gaussians import GaussianScene

# renderer name -> whether it runs the kernels (JAX's names, then the
# port's older aliases); the oracle is plain PyTorch of its own
RENDERERS = {"pallas": True, "tiled": False, "oracle": False, "cuda": True,
             "torch": False}


class RasterizeSettings(NamedTuple):
    """The JAX package's fields, in its order.

    renderer: "pallas" (K1, K2, K3; the default), "tiled" (their plain
    versions) or "oracle" (the per-pixel oracle, for tests); "cuda" and
    "torch" are aliases of the first two. JAX's default is "tiled": the
    port's is the kernels, so that a plain version is never on a path where
    a card is present.
    dup_capacity, max_per_tile, chunk, max_tiles_per_gaussian,
    pallas_interpret, phase_a_tiles, big_budget_divisor, floor_band_budget,
    phase_plan, route_capacity: the JAX package's static capacities and
    TPU knobs, accepted with its defaults and read by nothing: binning has
    no static capacities here, so nothing overflows.
    tile_cull: drop duplicates whose alpha stays below 1/255 over the whole
    tile at emission (exact; the blend skips them anyway).
    fast_chain: the bf16 tier of the blend, K1f forward and K2f backward
    (`blend.py`); off by default, as in the JAX package, where the serving
    CLIs turn it on.
    quad_power: the quad route of the blend's power (`blend.py`): JAX's
    matrix-unit form, split-bf16 coefficients times each pixel's monomials
    (a triple split in the f32 tier, K1q; a double split in the bf16 tier,
    K1fq), then JAX's clamp and skip allowance. Taken, as JAX takes it, by
    renders through the kernels ("pallas", "cuda") without jitter; on by
    default, as in JAX. The direct form (K1, K1f) serves jittered renders,
    `quad_power=False` and "tiled"; the backward recomputes the direct form
    on either route.
    pack_gather: the bf16 tier's serving gather, Kg (`pack_gather.py`):
    24-byte split-bf16 rows gathered by rank and recentred with JAX's
    roundings (`pallas_path.py:150-190`); forward only (it raises under
    autograd) and, as in JAX, it raises without `fast_chain`.
    grad_reduce: how the duplicates' gradients are summed per Gaussian, one
    of `grad_reduce.GRAD_REDUCES`: "segsum_sortpayload" (default, exact
    f32), "segsum", "segsum_sortpacked" (bf16-rounded values), or "scatter"
    (plain `index_add_`, for tests and checks)."""

    renderer: str = "pallas"
    dup_capacity: int = 1 << 18
    max_per_tile: int = 1024
    chunk: int = 32
    max_tiles_per_gaussian: int = 512
    pallas_interpret: bool = False
    phase_a_tiles: int = 6
    big_budget_divisor: int = 16
    floor_band_budget: int = 256
    phase_plan: tuple = ()
    route_capacity: int = 0
    tile_cull: bool = True
    fast_chain: bool = False
    quad_power: bool = True
    pack_gather: bool = False
    grad_reduce: str = reduce_mod.DEFAULT


def use_kernels(renderer: str) -> bool:
    """Whether `renderer` runs the kernels (True) or plain PyTorch."""
    if renderer not in RENDERERS:
        raise ValueError(f"renderer must be one of {sorted(RENDERERS)}, got {renderer!r}")
    return RENDERERS[renderer]


def random_sampling_offsets(generator: torch.Generator, height: int,
                            width: int) -> torch.Tensor:
    """[H, W, 2] uniform in (-1, 0], on the generator's device."""
    return -torch.rand((height, width, 2), generator=generator,
                       device=generator.device, dtype=torch.float32)


def preprocess_scene(camera: Camera, scene: GaussianScene,
                     scaling_modifier: float = 1.0,
                     override_color: Optional[torch.Tensor] = None,
                     convert_shs_python: bool = False,
                     compute_cov3d_python: bool = False) -> prep_mod.Preprocessed:
    """Project `scene` into `camera` (both on one device), with `render`'s
    colour and covariance options."""
    colors_precomp = shs = None
    if override_color is not None:
        colors_precomp = override_color
    elif convert_shs_python:
        dirs = scene.get_xyz - camera.camera_center[None, :]
        dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
        colors_precomp = eval_sh_color(scene.active_sh_degree,
                                       scene.get_features.transpose(1, 2), dirs)
    else:
        shs = scene.get_features
    scales = rotations = cov3d_precomp = None
    if compute_cov3d_python:
        cov3d_precomp = scene.get_covariance(scaling_modifier)
    else:
        scales, rotations = scene.get_scaling, scene.get_rotation
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
        shs=shs,
        colors_precomp=colors_precomp,
        scales=scales,
        rotations=rotations,
        cov3d_precomp=cov3d_precomp,
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
    convert_shs_python: bool = False,
    compute_cov3d_python: bool = False,
    *,
    device: DeviceLike = None,
) -> dict:
    """Render `scene` from `camera` on `device` (None means CUDA). Returns
    render [H,W,3], depth [H,W], final_T [H,W], radii [N] int32,
    visibility_filter [N] bool, and overflow / overflow_emit / overflow_rect
    (always False: binning has no capacities to overflow, and the oracle
    none either). The gradient taps and the colour and covariance options
    are described in the module docstring.

    The positional order is the JAX package's; `device` is the port's own
    and keyword-only."""
    use_kernel = use_kernels(settings.renderer)
    if settings.grad_reduce not in reduce_mod.GRAD_REDUCES:
        raise ValueError(f"grad_reduce must be one of {reduce_mod.GRAD_REDUCES}, got "
                         f"{settings.grad_reduce!r}")
    if settings.pack_gather and not settings.fast_chain:
        raise ValueError("pack_gather requires fast_chain (bf16 tier)")
    dev = resolve_device(device)
    camera = camera.to(dev)
    scene = scene.to(dev)
    bg = torch.as_tensor(bg_color, dtype=torch.float32).to(dev).contiguous()
    if sampling_offsets is not None:
        sampling_offsets = sampling_offsets.to(dev, torch.float32).contiguous()

    if override_color is not None:
        override_color = override_color.to(dev)
    prep = preprocess_scene(camera, scene, scaling_modifier, override_color,
                            convert_shs_python, compute_cov3d_python)
    if means2d_offset is not None:
        prep = prep._replace(means2d=prep.means2d + means2d_offset)
    if view_depth_offset is not None:
        prep = prep._replace(depths=prep.depths + view_depth_offset.reshape(-1))
    if settings.renderer == "oracle":
        color, depth, final_t = oracle_mod.render_oracle(
            prep, camera.width, camera.height, bg, sampling_offsets)
        false = torch.zeros((), dtype=torch.bool, device=dev)
        overflow = overflow_emit = overflow_rect = false
    else:
        out = render_sorted(prep, camera.width, camera.height, bg,
                            sampling_offsets, tile_cull=settings.tile_cull,
                            use_kernel=use_kernel,
                            grad_reduce=settings.grad_reduce,
                            fast_chain=settings.fast_chain,
                            pack_gather=settings.pack_gather,
                            quad_power=settings.quad_power)
        color, depth, final_t = out.color, out.depth, out.final_T
        b = out.binning
        overflow, overflow_emit, overflow_rect = b.overflow, b.overflow_emit, b.overflow_rect
    return {
        "render": color,
        "depth": depth,
        "final_T": final_t,
        "radii": prep.radii,
        "visibility_filter": prep.radii > 0,
        "overflow": overflow,
        "overflow_emit": overflow_emit,
        "overflow_rect": overflow_rect,
    }
