"""The rank side of `test_torch_parallel.py`, `test_torch_train_sharded.py`
and `test_torch_blend_quad.py`.

Those files spawn two gloo ranks (`parallel.multihost.spawn`) that import
the function they run by name. This module holds those functions and what
they share with the tests; it imports torch, numpy and the port only, so a
rank starts without importing JAX. It holds no tests.
"""

import functools
import os

import numpy as np
import torch

from wast3d_tpu_torch import config as tcfg
from wast3d_tpu_torch.core.camera import look_at_camera
from wast3d_tpu_torch.ops.rasterizer.api import RasterizeSettings
from wast3d_tpu_torch.scene.gaussians import from_arrays
from wast3d_tpu_torch.train import reconstruct as TR

RANKS = 2
W, H = 64, 48  # the tile-sharded render's image (strips of 32 rows)
TALL_H = 96  # the tall quad strips' image height (strips of 48 rows)
EYE = (0.2, -0.1, -5)
RES = 32  # the train steps' and trainers' images (strips of 16 rows)
LR_SCALE = 2.0
PLAIN = RasterizeSettings(renderer="tiled")
SCHEDULE = dict(densify_from_iter=2, densify_until_iter=30, densification_interval=5,
                opacity_reset_interval=1000, densify_grad_threshold=1e-5)
TRAINER_ITERS = 6  # densify at 5, then one step on the densified slices
FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity")


def camera(w, h, eye=(0, 0, -5), fov=0.8):
    """`tests.test_rasterizer._cam` on the port's side."""
    return look_at_camera(eye=list(eye), target=[0, 0, 0], up=[0, -1, 0], fovx=fov, fovy=fov,
                          width=w, height=h, device="cpu")


def trainer_views():
    rng = np.random.default_rng(7)
    return [((0.4 * i - 0.4, 0.2, -5), rng.uniform(0, 1, (RES, RES, 3)).astype(np.float32))
            for i in range(3)]


def port_trainer(state, cfg, lr_scale, cls=TR.Trainer, *args):
    """A (Sharded)Trainer of the cases' shape: the views of `trainer_views`,
    jitter off, the plain renderer."""
    cams = [(camera(RES, RES, eye), g) for eye, g in trainer_views()]
    return cls(state, cams, *args, opt_cfg=cfg, settings=PLAIN, spatial_lr_scale=lr_scale,
               cameras_extent=4.0, seed=0, jitter=False, device="cpu")


def state_for(arrays):
    scene = from_arrays(**arrays, device="cpu")
    return TR.init_train_state(scene, tcfg.OptimizationConfig(), LR_SCALE)


def state_numpy(st):
    return dict(params={k: v.detach().numpy() for k, v in st.scene.params().items()},
                mu={k: v.numpy() for k, v in st.opt_state.mu.items()},
                nu={k: v.numpy() for k, v in st.opt_state.nu.items()},
                stats=[a.numpy() for a in st.stats])


# The tile-sharded render's settings whose routes `strip_routes` records.
STRIP_ROUTE_SETTINGS = {
    "pallas": RasterizeSettings(renderer="pallas"),
    "cuda": RasterizeSettings(renderer="cuda"),
    "pallas_fast": RasterizeSettings(renderer="pallas", fast_chain=True),
    "pallas_quad_power_off": RasterizeSettings(renderer="pallas", quad_power=False),
    "tiled": PLAIN,
}


def strip_routes(inp):
    """`render_tile_sharded` of `inp["scene"]` on a one-rank gloo group,
    once with each of STRIP_ROUTE_SETTINGS: {name: [(fast, quad) of each
    plain blend walk it ran]} (on the CPU every blend takes a plain version,
    `blend._walk`)."""
    from wast3d_tpu_torch.ops.rasterizer import blend
    from wast3d_tpu_torch.parallel import make_mesh
    from wast3d_tpu_torch.parallel.render_sharded import render_tile_sharded

    torch.set_num_threads(1)
    mesh = make_mesh(data=1)
    scene = from_arrays(**inp["scene"], device="cpu")
    walks, plain_walk = [], blend._walk

    def spy(*args, **kwargs):
        walks.append((kwargs.get("fast", False), kwargs.get("quad", False)))
        return plain_walk(*args, **kwargs)

    out = {}
    blend._walk = spy
    try:
        for name, settings in STRIP_ROUTE_SETTINGS.items():
            walks.clear()
            render_tile_sharded(camera(W, H, EYE), scene, torch.zeros(3), mesh, settings)
            out[name] = list(walks)
    finally:
        blend._walk = plain_walk
    return out


def parallel_cases(inp):
    """`test_torch_parallel.py`'s cases on one rank of a 2-rank gloo group;
    numpy results."""
    from wast3d_tpu_torch.ops.knn import _BIG
    from wast3d_tpu_torch.parallel import multihost
    from wast3d_tpu_torch.parallel import make_mesh, scene_sharding
    from wast3d_tpu_torch.parallel.losses import photometric_loss_sharded
    from wast3d_tpu_torch.parallel.mesh import axis_index, replicated, row_range
    from wast3d_tpu_torch.parallel.render_sharded import render_tile_sharded
    from wast3d_tpu_torch.parallel.ring import ring_knn_sq_dists, ring_mean_sq_dist_to_3nn

    torch.set_num_threads(1)  # two ranks and the test's process share the host
    out = {}
    mesh = make_mesh(data=1)
    mesh_d = multihost.global_mesh(data=2)
    me = axis_index(mesh, "model")
    out["mesh"] = dict(shape=tuple(mesh.shape), names=tuple(mesh.mesh_dim_names),
                       model_index=me, data_shape=tuple(mesh_d.shape),
                       data_index=axis_index(mesh_d, "data"),
                       rows=scene_sharding(mesh, 201), all_rows=replicated(mesh, 201),
                       init=multihost.init_distributed(), coordinator=multihost.is_coordinator())

    def t(name):
        return torch.from_numpy(inp[name])

    def mine(x):
        return x[scene_sharding(mesh, x.shape[0])]

    pts = t("ring_pts")
    out["ring"] = [a.numpy() for a in ring_knn_sq_dists(mine(pts), mine(pts), 4, mesh,
                                                         exclude_self=True)]
    out["ring_data_axis"] = ring_knn_sq_dists(pts, pts, 3, mesh_d, exclude_self=True)[0].numpy()
    un = t("ring_uneven")
    out["ring_uneven"] = [a.numpy() for a in ring_knn_sq_dists(mine(un), mine(un), 3, mesh,
                                                                exclude_self=True, block=32)]
    out["ring_qd"] = ring_knn_sq_dists(mine(t("ring_q")), mine(t("ring_data")), 1, mesh)[1].numpy()
    valid = torch.arange(64) < 32
    q = t("ring_q")
    out["ring_valid"] = ring_knn_sq_dists(mine(q), mine(q), 2, mesh,
                                          data_valid=mine(valid))[1].numpy()
    out["ring_query_valid"] = ring_knn_sq_dists(mine(q), mine(q), 2, mesh,
                                                query_valid=mine(valid))[0].numpy()
    out["big"] = _BIG
    out["ring_mean"] = ring_mean_sq_dist_to_3nn(mine(t("ring_mean")), mesh).numpy()

    strip = t("loss_strip")[row_range(64, RANKS, me)].clone().requires_grad_(True)
    loss = photometric_loss_sharded(strip, t("loss_gt"), mesh, H, 0.2)
    (g,) = torch.autograd.grad(loss, [strip])
    out["loss"], out["loss_grad"] = float(loss.detach()), g.numpy()
    full = t("full_strip")[row_range(64, RANKS, me)]
    out["loss_full"] = float(photometric_loss_sharded(full, t("full_gt"), mesh, 64, 0.2))
    try:
        photometric_loss_sharded(t("loss_strip")[:4], t("loss_gt"), mesh, 8, 0.2)
    except ValueError as e:
        out["short_strip"] = str(e)

    arrays = {k: v[scene_sharding(mesh, 201)] for k, v in inp["scene"].items()}
    scene = from_arrays(**arrays, device="cpu")
    cam = camera(W, H, EYE)
    params = {k: v.clone().requires_grad_(True) for k, v in scene.params().items()}
    res = render_tile_sharded(cam, scene.with_params(params), torch.from_numpy(inp["bg"]), mesh,
                              RasterizeSettings(renderer="pallas"))
    h = res["render"].shape[0]
    target = torch.nn.functional.pad(t("target"), (0, 0, 0, 0, 0, res["height_pad"] - H))
    strip_loss = torch.sum(((res["render"] - target[me * h:(me + 1) * h]) ** 2)
                           * ((me * h + torch.arange(h)) < H)[:, None, None])
    grads = torch.autograd.grad(strip_loss, list(params.values()))
    out["render"] = {k: res[k].detach().numpy() for k in ("render", "depth", "final_T")}
    out["render"].update(radii=res["radii"].numpy(), height_pad=res["height_pad"],
                         overflow=bool(res["overflow"]), route=bool(res["overflow_route"]))
    out["render_grads"] = {k: g.numpy() for k, g in zip(params, grads)}
    fast = render_tile_sharded(cam, scene, torch.from_numpy(inp["bg"]), mesh,
                               RasterizeSettings(renderer="pallas", fast_chain=True))
    out["render_fast"] = fast["render"].numpy()
    tall = inp["tall_scene"]
    tall = from_arrays(**{k: v[scene_sharding(mesh, len(v))] for k, v in tall.items()},
                       device="cpu")
    res = render_tile_sharded(camera(W, TALL_H, EYE), tall, torch.from_numpy(inp["bg"]), mesh,
                              RasterizeSettings(renderer="pallas"))
    out["render_tall"] = {k: res[k].numpy() for k in ("render", "depth", "final_T")}
    return out


def train_sharded_cases(inp):
    """`test_torch_train_sharded.py`'s cases on one rank of a 2-rank gloo
    group; numpy results."""
    from wast3d_tpu_torch.cli import pipeline as pipe_cli
    from wast3d_tpu_torch.cli import sweep as sweep_cli
    from wast3d_tpu_torch.parallel import make_mesh, shard_train_state
    from wast3d_tpu_torch.parallel import train_sharded as S
    from wast3d_tpu_torch.stylize import fit, sweep
    from wast3d_tpu_torch.stylize import pipeline as tpipe

    torch.set_num_threads(1)  # two ranks and the test's process share the host
    out = {}
    rank = torch.distributed.get_rank()
    model_mesh, data_mesh = make_mesh(data=1), make_mesh(data=RANKS)
    cam = camera(RES, RES)
    gt, bg = torch.from_numpy(inp["gt"]), torch.zeros(3)

    def two_steps(step, state, *args):
        losses = []
        for _ in range(2):
            state, aux = step(state, *args)
            losses.append(float(aux["loss"]))
        return losses, state_numpy(state)

    state = shard_train_state(state_for(inp["scene"]), model_mesh)
    dp = S.make_sharded_train_step(model_mesh, tcfg.OptimizationConfig(), PLAIN, LR_SCALE,
                                   jitter=False)
    out["dp"] = two_steps(dp, state, cam, gt, bg)
    for name, sharded in (("tile", True), ("tile_gathered", False)):
        step = S.make_tile_sharded_train_step(model_mesh, tcfg.OptimizationConfig(), PLAIN,
                                              LR_SCALE, sharded_loss=sharded)
        out[name] = two_steps(step, state, cam, gt, bg)

    # (2, 1): one view per rank
    views = [(cam, gt), (camera(RES, RES, (0.3, 0.0, -5)),
                         torch.from_numpy(inp["gt2"]))]
    mine = S.shard_camera_batch(data_mesh, [v[0] for v in views], [v[1] for v in views])
    step = S.make_sharded_train_step(data_mesh, tcfg.OptimizationConfig(), PLAIN, LR_SCALE,
                                     jitter=False)
    s1, aux = step(state_for(inp["scene"]), *mine, bg)
    out["batch"] = float(aux["loss"]), state_numpy(s1)

    for name, arrays, cfg, lr_scale, iters in (
            ("trainer", inp["scene"], tcfg.OptimizationConfig(), LR_SCALE, 4),
            ("trainer_densify", inp["trainer_scene"], tcfg.OptimizationConfig(**SCHEDULE),
             1.0, TRAINER_ITERS)):
        state = S.init_sharded(from_arrays(**arrays, device="cpu"), cfg, model_mesh, lr_scale)
        tr = port_trainer(state, cfg, lr_scale, S.ShardedTrainer, model_mesh)
        tr.run(iters, log_every=1)
        out[name] = tr.history

    patch, domain, circles = inp["fit"]
    out["fit"] = fit.fit_all_balls(patch, domain, circles, cfg=tcfg.StylizeConfig(**inp["fit_cfg"]),
                                   batch_size=4, device="cpu", mesh=data_mesh)

    scenes = sweep.stylize_sweep(inp["content"], inp["patches"],
                                 tcfg.StylizeConfig(**inp["sweep_kw"]), seed=0, device="cpu",
                                 mesh=data_mesh)
    out["sweep"] = None if scenes is None else [
        {f: getattr(s, f).numpy() for f in FIELDS} for s in scenes]

    # the CLIs as under torchrun: this process is a rank of the group
    os.environ.update(WORLD_SIZE=str(RANKS), RANK=str(rank))
    sweep_cli.main(["--content", inp["content_ply"], "--style_clusters", *inp["npzs"],
                    "--output_dir", inp["sweep_out"], "--data_axis", str(RANKS),
                    *[f"--{k}={v}" for k, v in inp["sweep_kw"].items()], "--device", "cpu"])
    tpipe.stylize_scene = functools.partial(tpipe.stylize_scene,
                                            cfg=tcfg.StylizeConfig(**inp["pipe_kw"]))
    out["pipeline"] = pipe_cli.main(inp["pipeline_argv"] + ["--devices", str(RANKS)])
    return out
