"""Photometric 3DGS reconstruction: the train step and its host driver.

Port of `wast3d_tpu/train/reconstruct.py` (the reference `train.py:31-156`):
per iteration a random camera (without replacement), render, (1 - lambda)
L1 + lambda (1 - SSIM) (plus the sphere regularisers of `train/spheres.py`
when a `SphereConfig` is given, for style scenes), backward, densification
statistics, Adam with the xyz learning-rate schedule; densify / prune /
opacity reset and the SH warm-up run on the reference's schedule
(`train/schedule.py`).

`train_step` runs eagerly: preprocess, binning and the sorted gather, K1
forward, the loss, then backward through K2 (blend), K3 (per-Gaussian
gradient reduction) and autograd for preprocess, then Adam and the
statistics. It returns a new state and leaves the old one as it was, as the
JAX step does. Binning synchronises with the host twice
(`ops/rasterizer/binning.py`): `repeat_interleave` sizes its output from
the per-Gaussian tile counts, and the tile-cull's boolean `keep` mask sizes
the kept entries; nothing else in the step does.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from wast3d_tpu_torch.config import OptimizationConfig, SphereConfig
from wast3d_tpu_torch.core.camera import Camera
from wast3d_tpu_torch.device import DeviceLike, resolve_device
from wast3d_tpu_torch.ops.image_losses import photometric_loss
from wast3d_tpu_torch.ops.rasterizer import api as raster_api
from wast3d_tpu_torch.scene.gaussians import GaussianScene
from wast3d_tpu_torch.train import densify as densify_mod
from wast3d_tpu_torch.train.optim import AdamState, make_optimizer
from wast3d_tpu_torch.train.spheres import sphere_regularizer


class TrainState(NamedTuple):
    scene: GaussianScene
    opt_state: AdamState
    stats: densify_mod.DensifyStats
    step: int


def init_train_state(scene: GaussianScene, opt_cfg: OptimizationConfig,
                     spatial_lr_scale: float) -> TrainState:
    opt = make_optimizer(opt_cfg, spatial_lr_scale)
    return TrainState(scene=scene, opt_state=opt.init(scene.params()),
                      stats=densify_mod.init_stats(scene.capacity, scene.device),
                      step=0)


def train_step(
    state: TrainState,
    camera: Camera,
    gt_image: torch.Tensor,
    bg_color: torch.Tensor,
    generator: Optional[torch.Generator],
    opt_cfg: OptimizationConfig,
    settings: raster_api.RasterizeSettings,
    width: int,
    height: int,
    spatial_lr_scale: float = 1.0,
    sphere_cfg: Optional[SphereConfig] = None,
    jitter: bool = True,
) -> Tuple[TrainState, dict]:
    """One reconstruction step on the scene's device. `generator` draws the
    sampling offsets when `jitter` is on; `sphere_cfg` adds the sphere
    regularisers to the loss. Returns (new_state, aux) with the loss (a 0-d
    tensor, not synchronised), radii, visibility and num_active."""
    opt = make_optimizer(opt_cfg, spatial_lr_scale)
    scene = state.scene
    dev = scene.device
    params = {k: v.detach().requires_grad_(True) for k, v in scene.params().items()}
    m2d = torch.zeros((scene.capacity, 2), dtype=torch.float32, device=dev,
                      requires_grad=True)
    offsets = (raster_api.random_sampling_offsets(generator, height, width)
               if jitter else None)
    live = scene.with_params(params)
    out = raster_api.render(camera, live, bg_color, settings=settings,
                            sampling_offsets=offsets, device=dev, means2d_offset=m2d)
    loss = photometric_loss(out["render"], gt_image, opt_cfg.lambda_dssim)
    if sphere_cfg is not None:
        loss = loss + sphere_regularizer(live, sphere_cfg)
    leaves = list(params.values()) + [m2d]
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]
    g_params = dict(zip(params, grads[:-1]))

    step = state.step + 1
    new_params, new_opt = opt.update(g_params, state.opt_state, scene.params(), step)
    new_stats = densify_mod.add_stats(state.stats, grads[-1], out["radii"],
                                      out["visibility_filter"], width, height)
    aux = {
        "loss": loss.detach(),
        "radii": out["radii"],
        "visibility": out["visibility_filter"],
        "num_active": scene.num_active,
    }
    return TrainState(scene.with_params(new_params), new_opt, new_stats, step), aux


class Trainer:
    """Host-side driver of the reference's schedule (`train/schedule.py`).

    `cameras` is a list of (Camera, ground-truth [H, W, 3] float image or
    None). Ground truth is kept on the training device unless
    `data_device == "cpu"`. The camera order comes from
    `np.random.default_rng(seed)`, as in the JAX package, so both visit the
    same cameras; jitter and split noise come from a `torch.Generator`
    seeded with `seed` (JAX's `jax.random` numbers are not reproduced)."""

    def __init__(
        self,
        state: TrainState,
        cameras,
        opt_cfg: OptimizationConfig = OptimizationConfig(),
        settings: raster_api.RasterizeSettings = raster_api.RasterizeSettings(),
        bg_color=None,
        spatial_lr_scale: float = 1.0,
        cameras_extent: float = 1.0,
        sphere_cfg: Optional[SphereConfig] = None,
        seed: int = 0,
        white_background: bool = False,
        jitter: bool = True,
        data_device: str = "tpu",
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.state = state
        keep_on_host = data_device == "cpu"

        def gt_tensor(gt):
            if gt is None:
                return None
            t = torch.as_tensor(np.asarray(gt, np.float32))
            return t if keep_on_host else t.to(self.device)

        self.cameras = [(cam.to(self.device), gt_tensor(gt)) for cam, gt in cameras]
        self.opt_cfg = opt_cfg
        self.settings = settings
        if bg_color is None:
            bg_color = [1.0, 1.0, 1.0] if white_background else [0.0, 0.0, 0.0]
        self.bg_color = torch.as_tensor(bg_color, dtype=torch.float32).to(self.device)
        self.spatial_lr_scale = spatial_lr_scale
        self.cameras_extent = cameras_extent
        self.sphere_cfg = sphere_cfg
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.rng = np.random.default_rng(seed)
        self.jitter = jitter
        self._camera_order = []
        self.history = []
        self.history_sink = None
        self._it = int(state.step)
        self._white_bg = bool((self.bg_color == 1.0).all())

    def _next_camera(self):
        """Random camera without replacement (the reference pops from a
        shuffled copy)."""
        if not self._camera_order:
            self._camera_order = list(self.rng.permutation(len(self.cameras)))
        return self.cameras[self._camera_order.pop()]

    def _do_step(self, it: int):
        cam, gt = self._next_camera()
        self.state, aux = train_step(
            self.state, cam, gt.to(self.device), self.bg_color, self.generator,
            opt_cfg=self.opt_cfg, settings=self.settings, width=cam.width,
            height=cam.height, spatial_lr_scale=self.spatial_lr_scale,
            sphere_cfg=self.sphere_cfg, jitter=self.jitter)
        return aux

    def total_rows(self) -> int:
        """The scene's Gaussians (the schedule logs it after densifying)."""
        return int(self.state.scene.capacity)

    def run(self, iterations: int, log_every: int = 0) -> TrainState:
        from wast3d_tpu_torch.train.schedule import run_schedule

        return run_schedule(self, iterations, log_every)
