"""Sharded reconstruction training: cameras over "data" x Gaussians over "model".

Port of `wast3d_tpu/parallel/train_sharded.py`. Every rank holds its model
slice of the scene's rows, their Adam moments and their densification
statistics (`mesh.shard_train_state`); ranks of one model group hold the
same camera, ranks of one data group the same rows.

- `make_sharded_train_step`: the model group all-gathers the scene rows
  (the backward reduce-scatters their gradients), each data rank renders
  its own camera with `api.render` (K1, then K2 and K3 in the backward),
  the gradients are averaged over the data group and Adam runs on each
  rank's rows; `densify.add_stats_batch` takes every view's statistics.
- `make_tile_sharded_train_step`: one camera, the scene's rows and the
  image's tile strips both over "model" (`render_sharded`), the loss by
  halo exchange (`losses`) or, with `sharded_loss=False`, on the gathered
  image.
A loss term that every rank of the model group computes alike from
gathered rows (the data-parallel step's, the gathered-image loss, the
sphere regulariser) enters the backward divided by the group's size,
because the reduce-scatter sums the group's identical gradients.

`ShardedTrainer` runs `train/schedule.run_schedule` on a sharded state with
`Trainer`'s hooks. The port's densify appends and removes rows, so each
rank densifies its own rows and the slices grow unevenly; JAX's fixed
capacity, `_grow` and `gaussians.grow_capacity` have no counterpart.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from wast3d_tpu_torch.config import OptimizationConfig, SphereConfig
from wast3d_tpu_torch.device import DeviceLike, resolve_device
from wast3d_tpu_torch.ops.image_losses import photometric_loss
from wast3d_tpu_torch.ops.rasterizer import api as raster_api
from wast3d_tpu_torch.parallel import collectives as C
from wast3d_tpu_torch.parallel.losses import photometric_loss_sharded
from wast3d_tpu_torch.parallel.mesh import (axis_group, axis_index, axis_size,
                                            shard_train_state)
from wast3d_tpu_torch.parallel.render_sharded import render_tile_sharded
from wast3d_tpu_torch.train import densify as densify_mod
from wast3d_tpu_torch.train import reconstruct as R
from wast3d_tpu_torch.train.optim import make_optimizer
from wast3d_tpu_torch.train.spheres import sphere_loss


def shard_camera_batch(mesh, cameras, gt_images):
    """This rank's (camera, ground truth) of a batch with one view per rank
    of the data axis (JAX stacks the batch and shards it over "data")."""
    d = axis_index(mesh, "data")
    return cameras[d], gt_images[d]


def _gather_rows(fields: dict, mask: torch.Tensor, group, sizes):
    """The model group's rows of several [n, ...] tensors and the mask, in
    one differentiable all-gather of their concatenated columns."""
    n = mask.shape[0]
    flat = torch.cat([v.reshape(n, -1) for v in fields.values()]
                     + [mask.to(torch.float32)[:, None]], 1)
    full = C.all_gather_rows(flat, group, sizes)
    out, col = {}, 0
    for k, v in fields.items():
        width = int(np.prod(v.shape[1:]))
        # contiguous, as the rows were: CPU kernels of strided tensors can round
        # differently (sigmoid, exp)
        out[k] = full[:, col:col + width].reshape((-1,) + tuple(v.shape[1:])).contiguous()
        col += width
    return out, full[:, col] > 0.5


def _grads(objective, leaves):
    grads = torch.autograd.grad(objective, leaves, allow_unused=True)
    return [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]


def make_sharded_train_step(mesh, opt_cfg: OptimizationConfig,
                            settings: raster_api.RasterizeSettings,
                            spatial_lr_scale: float = 1.0,
                            sphere_cfg: Optional[SphereConfig] = None,
                            jitter: bool = True):
    """Returns train_step(state, camera, gt, bg, generator) -> (state, aux)
    for this rank: `state` holds its rows (`init_sharded`), camera and gt
    its view of the batch (`shard_camera_batch`). With jitter, `generator`
    (the same seed on every rank) draws one offset field per data rank and
    each rank takes its own. aux holds the batch's mean loss and the
    scene's active Gaussians over every slice."""
    opt = make_optimizer(opt_cfg, spatial_lr_scale)
    model_g, data_g = axis_group(mesh, "model"), axis_group(mesh, "data")
    n_model, n_data = axis_size(mesh, "model"), axis_size(mesh, "data")
    m_idx, d_idx = axis_index(mesh, "model"), axis_index(mesh, "data")

    def train_step(state: R.TrainState, camera, gt, bg_color, generator=None):
        scene = state.scene
        dev = scene.device
        h, w = gt.shape[0], gt.shape[1]
        params = {k: v.detach().requires_grad_(True) for k, v in scene.params().items()}
        sizes = C.gather_sizes(scene.capacity, model_g)
        mine = slice(sum(sizes[:m_idx]), sum(sizes[:m_idx + 1]))
        full, mask = _gather_rows(params, scene.mask, model_g, sizes)
        live = scene.with_params(full).replace(mask=mask)
        m2d = torch.zeros((live.capacity, 2), dtype=torch.float32, device=dev,
                          requires_grad=True)
        offsets = None
        if jitter:
            offsets = [raster_api.random_sampling_offsets(generator, h, w)
                       for _ in range(n_data)][d_idx]
        out = raster_api.render(camera, live, bg_color, settings=settings,
                                sampling_offsets=offsets, means2d_offset=m2d, device=dev)
        loss = photometric_loss(out["render"], gt.to(dev), opt_cfg.lambda_dssim)
        if sphere_cfg is not None:
            loss = loss + sphere_loss(live.scaling, live.mask, sphere_cfg)
        leaves = list(params.values()) + [m2d]
        grads = _grads(loss / n_model, leaves)
        g_params = {k: C.all_reduce_sum(g, data_g) / n_data for k, g in zip(params, grads)}
        # Each view's own-loss gradient of this rank's rows, over the batch.
        g_view = C.all_gather_rows((grads[-1][mine] * n_model)[None], data_g)
        radii = C.all_gather_rows(out["radii"][mine][None], data_g)
        step = state.step + 1
        new_params, new_opt = opt.update(g_params, state.opt_state, scene.params(), step)
        new_stats = densify_mod.add_stats_batch(state.stats, g_view / n_data, radii,
                                                radii > 0, w, h)
        false = torch.zeros((), dtype=torch.bool, device=dev)
        aux = {
            "loss": C.all_reduce_sum(loss.detach(), data_g) / n_data,
            "overflow": false, "overflow_emit": false, "overflow_rect": false,
            "num_active": C.all_reduce_sum(scene.num_active, model_g),
        }
        return R.TrainState(scene.with_params(new_params), new_opt, new_stats, step), aux

    return train_step


def make_tile_sharded_train_step(mesh, opt_cfg: OptimizationConfig,
                                 settings: raster_api.RasterizeSettings,
                                 spatial_lr_scale: float = 1.0,
                                 sphere_cfg: Optional[SphereConfig] = None,
                                 sharded_loss: bool = True):
    """Returns train_step(state, camera, gt, bg) -> (state, aux): one camera,
    the scene's rows and the image strips over "model"
    (`render_tile_sharded`); the loss by halo exchange
    (`photometric_loss_sharded`), or with `sharded_loss=False` on the
    gathered image. Gradients, Adam and the densification statistics stay
    with each rank's rows. Pixel jitter is not threaded through the strip
    path, as in JAX."""
    opt = make_optimizer(opt_cfg, spatial_lr_scale)
    model_g = axis_group(mesh, "model")
    n_model = axis_size(mesh, "model")

    def train_step(state: R.TrainState, camera, gt, bg_color):
        scene = state.scene
        dev = scene.device
        h, w = gt.shape[0], gt.shape[1]
        gt = gt.to(dev)
        params = {k: v.detach().requires_grad_(True) for k, v in scene.params().items()}
        m2d = torch.zeros((scene.capacity, 2), dtype=torch.float32, device=dev,
                          requires_grad=True)
        live = scene.with_params(params)
        out = render_tile_sharded(camera, live, bg_color, mesh, settings, means2d_offset=m2d)
        if sharded_loss:
            loss = photometric_loss_sharded(out["render"], gt, mesh, h, opt_cfg.lambda_dssim)
            objective = loss
        else:
            image = C.all_gather_rows(out["render"], model_g)
            loss = photometric_loss(image[:h], gt, opt_cfg.lambda_dssim)
            objective = loss / n_model
        if sphere_cfg is not None:
            full, mask = _gather_rows({"scaling": params["scaling"]}, scene.mask, model_g, None)
            reg = sphere_loss(full["scaling"], mask, sphere_cfg)
            loss, objective = loss + reg, objective + reg / n_model
        leaves = list(params.values()) + [m2d]
        grads = _grads(objective, leaves)
        step = state.step + 1
        new_params, new_opt = opt.update(dict(zip(params, grads)), state.opt_state,
                                         scene.params(), step)
        new_stats = densify_mod.add_stats(state.stats, grads[-1], out["radii"],
                                          out["visibility_filter"], w, h)
        aux = {
            "loss": loss.detach(),
            "overflow": out["overflow"], "overflow_emit": out["overflow_emit"],
            "overflow_rect": out["overflow_rect"], "overflow_route": out["overflow_route"],
            "num_active": C.all_reduce_sum(scene.num_active, model_g),
        }
        return R.TrainState(scene.with_params(new_params), new_opt, new_stats, step), aux

    return train_step


def init_sharded(scene, opt_cfg: OptimizationConfig, mesh,
                 spatial_lr_scale: float = 1.0) -> R.TrainState:
    """This rank's rows of a fresh training state for `scene`."""
    return shard_train_state(R.init_train_state(scene, opt_cfg, spatial_lr_scale), mesh)


class ShardedTrainer(R.Trainer):
    """`Trainer` on a sharded state: one iteration takes one camera per
    rank of the data axis (all ranks draw the camera order from one seed),
    runs `make_sharded_train_step`, and the schedule densifies each rank's
    rows. With data = model = 1 and jitter off it is `Trainer` step for
    step (densify included). Jitter offsets come from a generator seeded
    `seed` on every rank, the split noise from one seeded `seed` plus the
    rank's model index (one noise per slice; the data group's replicas draw
    alike). Only rank 0 should write (`multihost.is_coordinator`)."""

    def __init__(self, state: R.TrainState, cameras, mesh,
                 opt_cfg: OptimizationConfig = OptimizationConfig(),
                 settings: raster_api.RasterizeSettings = raster_api.RasterizeSettings(),
                 bg_color=None, spatial_lr_scale: float = 1.0, cameras_extent: float = 1.0,
                 sphere_cfg: Optional[SphereConfig] = None, seed: int = 0,
                 white_background: bool = False, jitter: bool = True,
                 data_device: str = "tpu", device: DeviceLike = None):
        dev = resolve_device(device if device is not None else state.scene.device)
        super().__init__(state, cameras, opt_cfg=opt_cfg, settings=settings,
                         bg_color=bg_color, spatial_lr_scale=spatial_lr_scale,
                         cameras_extent=cameras_extent, sphere_cfg=sphere_cfg, seed=seed,
                         white_background=white_background, jitter=jitter,
                         data_device=data_device, device=dev)
        self.mesh = mesh
        self.batch = axis_size(mesh, "data")
        self.jitter_generator = torch.Generator(device=dev).manual_seed(seed)
        self.generator = torch.Generator(device=dev).manual_seed(
            seed + axis_index(mesh, "model"))
        self._step_fn = make_sharded_train_step(mesh, opt_cfg, settings, spatial_lr_scale,
                                                sphere_cfg, jitter)

    def _do_step(self, it: int):
        views = [self._next_camera() for _ in range(self.batch)]
        cam, gt = shard_camera_batch(self.mesh, [c for c, _ in views], [g for _, g in views])
        self.state, aux = self._step_fn(self.state, cam, gt.to(self.device), self.bg_color,
                                        self.jitter_generator)
        return aux

    def total_rows(self) -> int:
        rows = torch.tensor(self.state.scene.capacity, device=self.device)
        return int(C.all_reduce_sum(rows, axis_group(self.mesh, "model")))
