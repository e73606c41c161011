"""Image-space refinement: VGG content / style / TV and depth / normal losses.

Port of `wast3d_tpu/refine/drivers.py`: one driver for the reference's
family of `train_st*` scripts, each a `RefineMode` with its script's loss
wiring and weights:

- IMAGE_STYLE (`train_st.py:283-323`): VGG content on layers [2, 3] against
  the ground-truth image (x1e1), Gram style on layers [0, 1] against a
  style image (x1e-3), TV (x1e3).
- CONTENT_ONLY (`train_cont_loss.py:107-110`): VGG content (x1e-3) + TV.
- NORMALS_STYLE (`train_st_normals.py:112-152`): photometric L1 / D-SSIM +
  VGG content on layers [1, 2, 3] + TV (x1e2) + Gram style of the min-max
  normalised depth -> normals image, layers [0, 1] (x1e-3).
- DEPTH_TARGET (`train_st_depth_hotdog.py:218-247`): MSE of the rendered
  depth to a blurred target depth (x0.1) + photometric.
- RELIEF (`train_st_normals_sphere3.py:192-216`): photometric + depth-target
  MSE + TV on the image and on the inverted depth.

`refine_step` renders through `api.render` (with the default settings: K1
forward, K2 backward, K3 per-Gaussian reduction) and backpropagates colour
and, in the depth modes, the expected-depth channel into every Gaussian
parameter; Adam is `train/optim.py` at spatial scale 1, as in JAX.
"""

from __future__ import annotations

import enum
from typing import NamedTuple, Optional

import numpy as np
import torch

from wast3d_tpu_torch.config import OptimizationConfig
from wast3d_tpu_torch.core.camera import Camera
from wast3d_tpu_torch.ops import vgg as vgg_mod
from wast3d_tpu_torch.ops.depth import depth_to_normals
from wast3d_tpu_torch.ops.image_losses import photometric_loss, tv_loss
from wast3d_tpu_torch.ops.rasterizer import api as raster_api
from wast3d_tpu_torch.train.optim import make_optimizer
from wast3d_tpu_torch.train.reconstruct import TrainState


class RefineMode(str, enum.Enum):
    IMAGE_STYLE = "image_style"
    CONTENT_ONLY = "content_only"
    NORMALS_STYLE = "normals_style"
    DEPTH_TARGET = "depth_target"
    RELIEF = "relief"


class RefineWeights(NamedTuple):
    content: float = 0.0
    style: float = 0.0
    tv: float = 0.0
    photometric: float = 0.0
    depth: float = 0.0
    content_layers: tuple = (2, 3)
    style_layers: tuple = (0, 1)


MODE_WEIGHTS = {
    RefineMode.IMAGE_STYLE: RefineWeights(content=1e1, style=1e-3, tv=1e3),
    RefineMode.CONTENT_ONLY: RefineWeights(content=1e-3, tv=1e0),
    RefineMode.NORMALS_STYLE: RefineWeights(
        content=1e0, style=1e-3, tv=1e2, photometric=1.0,
        content_layers=(1, 2, 3),
    ),
    RefineMode.DEPTH_TARGET: RefineWeights(photometric=1.0, depth=0.1),
    RefineMode.RELIEF: RefineWeights(photometric=1.0, depth=1.0, tv=1e0),
}


def _loss(out: dict, camera: Camera, gt_image, style_image, target_depth, vgg_params,
          mode: RefineMode, opt_cfg: OptimizationConfig, width: int, height: int):
    w = MODE_WEIGHTS[mode]
    img = out["render"]
    loss = torch.zeros((), dtype=torch.float32, device=img.device)
    if w.photometric:
        loss = loss + w.photometric * photometric_loss(img, gt_image, opt_cfg.lambda_dssim)
    if w.content or (w.style and mode != RefineMode.NORMALS_STYLE):
        feats = vgg_mod.get_features(vgg_params, img)
    if w.content:
        gt_feats = vgg_mod.get_features(vgg_params, gt_image)
        loss = loss + w.content * vgg_mod.content_loss(gt_feats, feats, w.content_layers)
    if w.style and mode == RefineMode.NORMALS_STYLE:
        # style on the normal map, min-max normalised to [0, 1]; amin / amax
        # share a tie's gradient as jnp.min / jnp.max do
        fx = width / (2.0 * camera.tan_fovx)
        fy = height / (2.0 * camera.tan_fovy)
        normals = depth_to_normals(out["depth"], fx, fy)
        nmin, nmax = torch.amin(normals), torch.amax(normals)
        normals01 = (normals - nmin) / (nmax - nmin + 1e-6)
        n_feats = vgg_mod.get_features(vgg_params, normals01)
        s_feats = vgg_mod.get_features(vgg_params, style_image)
        loss = loss + w.style * vgg_mod.style_loss(s_feats, n_feats, w.style_layers)
    elif w.style:
        s_feats = vgg_mod.get_features(vgg_params, style_image)
        loss = loss + w.style * vgg_mod.style_loss(s_feats, feats, w.style_layers)
    if w.tv:
        loss = loss + w.tv * tv_loss(img)
        if mode == RefineMode.RELIEF:
            d = out["depth"]  # TV on the inverted depth too
            loss = loss + w.tv * tv_loss(torch.amax(d) - d)
    if w.depth and target_depth is not None:
        loss = loss + w.depth * torch.mean((out["depth"] - target_depth) ** 2)
    return loss


def refine_step(
    state: TrainState,
    camera: Camera,
    gt_image: torch.Tensor,
    style_image: Optional[torch.Tensor],
    target_depth: Optional[torch.Tensor],
    vgg_params: dict,
    bg_color: torch.Tensor,
    mode: RefineMode,
    settings: raster_api.RasterizeSettings,
    opt_cfg: OptimizationConfig,
    width: int,
    height: int,
):
    """One refinement step on the scene's device; every tensor argument is
    on it (`vgg_params` as `vgg.to_device` gives it). style_image /
    target_depth may be None where the mode does not read them. Returns
    (new_state, loss as a 0-d tensor, not synchronised)."""
    mode = RefineMode(mode)
    opt = make_optimizer(opt_cfg, 1.0)
    scene = state.scene
    params = {k: v.detach().requires_grad_(True) for k, v in scene.params().items()}
    out = raster_api.render(camera, scene.with_params(params), bg_color, settings=settings,
                            device=scene.device)
    loss = _loss(out, camera, gt_image, style_image, target_depth, vgg_params, mode,
                 opt_cfg, width, height)
    leaves = list(params.values())
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = {k: torch.zeros_like(x) if g is None else g
             for (k, x), g in zip(params.items(), grads)}
    step = state.step + 1
    new_params, new_opt = opt.update(grads, state.opt_state, scene.params(), step)
    return TrainState(scene.with_params(new_params), new_opt, state.stats, step), loss.detach()


def refine(
    state: TrainState,
    cameras,
    mode: RefineMode,
    iterations: int,
    style_image: Optional[np.ndarray] = None,
    target_depths: Optional[list] = None,
    opt_cfg: OptimizationConfig = OptimizationConfig(),
    settings: raster_api.RasterizeSettings = raster_api.RasterizeSettings(),
    bg_color=None,
    vgg_weights_path: Optional[str] = None,
    seed: int = 0,
):
    """Host loop over random cameras (the `train_st*` skeleton) on the
    scene's device. `cameras` is a list of (Camera, ground truth [H, W, 3]);
    the order is JAX's: `np.random.default_rng(seed).permutation`, popped
    from the end. Returns (state, losses as floats)."""
    dev = state.scene.device
    vgg_params = vgg_mod.to_device(vgg_mod.load_weights(vgg_weights_path), dev)
    bg = (torch.zeros(3, device=dev) if bg_color is None
          else torch.as_tensor(bg_color, dtype=torch.float32, device=dev))

    def on_dev(a):
        return None if a is None else torch.as_tensor(a, dtype=torch.float32, device=dev)

    views = [(cam.to(dev), on_dev(gt)) for cam, gt in cameras]
    depths = None if target_depths is None else [on_dev(d) for d in target_depths]
    style_t = on_dev(style_image)
    rng = np.random.default_rng(seed)
    order, losses = [], []
    for _ in range(iterations):
        if not order:
            order = list(rng.permutation(len(views)))
        ci = order.pop()
        cam, gt = views[ci]
        state, loss = refine_step(
            state, cam, gt, style_t, None if depths is None else depths[ci], vgg_params, bg,
            mode=RefineMode(mode), settings=settings, opt_cfg=opt_cfg,
            width=cam.width, height=cam.height)
        losses.append(float(loss))
    return state, losses
