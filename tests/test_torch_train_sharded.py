"""Port parity on the CPU: the sharded training steps, `ShardedTrainer`,
the ball-sharded fit, the sweep over the data axis and the three CLIs'
rank flags.

Two gloo ranks are spawned once (`cases`, through `parallel.multihost.spawn`)
and run every case (`test_torch_parallel_ranks.train_sharded_cases`); the
tests hold what they
hand back to JAX's single-device functions and to the port's
single-device path, in this process.

- Train steps (200 Gaussians, 32 x 32, jitter off, two steps): the
  data-parallel step on a (1, 2) mesh (the scene's rows over two ranks,
  all-gathered) and the tile-sharded step (strips of 16 rows, the loss by
  halo exchange, and with `sharded_loss=False` on the gathered image)
  against JAX `train_step` (`renderer="tiled"`, `grad_reduce="scatter"`)
  at `test_torch_train.py::test_train_steps_match_jax`'s bounds, and
  against the port's single-device `train_step`: the data-parallel step
  bit for bit (the gather and the halved-then-summed gradients are exact),
  the tile-sharded step at 1e-4 of each parameter group's learning rate
  plus two units in the last place of its largest value (its loss sums
  strips in another order, which moves the gradients by rounding, and Adam
  divides a rounding of a small gradient by its own size). On a (2, 1) mesh with one camera per rank, the step's
  parameters, moments and statistics equal those of a step on the two
  views' averaged gradients and `add_stats_batch`, at 1e-6 relative.
- `ShardedTrainer` on a (1, 2) mesh: four iterations over three 32 x 32
  views of the train-step scene against JAX's `Trainer` at rtol 1e-4
  (`test_torch_train.py`'s bound before a densify) and the port's
  `Trainer` bit for bit; and on JAX `test_parallel.py`'s schedule (40
  Gaussians, densify every 5 from iteration 2) against the port's
  `Trainer`: the same losses until the densify and the same N after it
  (each rank then appends its own clones and split children, with its own
  split noise, so later steps differ).
- `fit_all_balls(mesh)` over the two ranks (11 balls in batches of 4,
  JAX `test_parallel.py`'s case) equals the port's single-device fit bit
  for bit (each ball's fit is its own), and JAX's `fit_all_balls(mesh=None)`
  within `test_torch_stylize.py`'s fit bounds (rtol 1e-4, atol 1e-5), each
  package from its own descriptors (the patches are small and their
  neighbour distances have no ties).
- `stylize_sweep(mesh)` with the two styles over the data axis: rank 0's
  scenes equal the port's one-device sweep bit for bit, which
  `test_torch_sweep.py` holds to JAX's `stylize_sweep(mesh=None)` (from
  JAX's descriptors: the grid patches' neighbour distances tie).
- The CLIs: `cli.stylize --devices 2 --device cpu` from this process
  (two new ranks), and `cli.sweep --data_axis 2` and `cli.pipeline
  --devices 2 --skip_recon` on the spawned ranks as under torchrun, each
  writes what its one-device run writes, bit for bit (those runs are held
  to JAX by `test_torch_stylize.py`, `test_torch_sweep.py` and
  `test_torch_pipeline.py`)."""

import os
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_rasterizer import _cam, _random_scene
from tests.test_torch_parallel_ranks import (FIELDS, LR_SCALE, PLAIN, RANKS, RES, SCHEDULE,
                                             TRAINER_ITERS, camera, port_trainer, state_for,
                                             state_numpy, train_sharded_cases, trainer_views)
from tests.test_torch_stylize import FIT_ATOL, FIT_RTOL, PIPE_KW, _cfgs
from tests.test_torch_sweep import _patches
from tests.test_train import _mini_scene
from wast3d_tpu import config as jcfg
from wast3d_tpu.ops.rasterizer import api as japi
from wast3d_tpu.stylize import fit as jfit
from wast3d_tpu.train import reconstruct as JR
from wast3d_tpu_torch import config as tcfg
from wast3d_tpu_torch.ops.rasterizer import api as tapi
from wast3d_tpu_torch.parallel import multihost
from wast3d_tpu_torch.scene.gaussians import from_arrays
from wast3d_tpu_torch.train import reconstruct as TR
from wast3d_tpu_torch.train.optim import PARAM_KEYS

LRS = {"xyz": 1.6e-4 * LR_SCALE, "f_dc": 2.5e-3, "f_rest": 1.25e-4, "opacity": 0.05,
       "scaling": 5e-3, "rotation": 1e-3}
TILED = japi.RasterizeSettings(renderer="tiled", dup_capacity=1 << 14, max_per_tile=512,
                               chunk=16, grad_reduce="scatter")
FIT_CFG = dict(global_knn=8, global_stride=3, local_knn=5, fit_steps=12, domain_knn=4,
               ball_capacity=64)
SMALL_KW = {**PIPE_KW, "fit_steps": 10}  # the sweep's, the CLIs' and the pipeline's fits


def _scene_arrays(jscene, n):
    return {f: np.asarray(getattr(jscene, f))[:n] for f in FIELDS}


def _fit_case():
    rng = np.random.default_rng(7)
    patch = rng.normal(size=(30, 3)).astype(np.float32) * 0.2
    domain = rng.normal(size=(400, 3)).astype(np.float32)
    domain /= np.maximum(np.linalg.norm(domain, axis=1, keepdims=True), 1e-6)
    circles = [rng.choice(400, size=rng.integers(20, 60), replace=False) for _ in range(11)]
    return patch, domain, circles


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The cases' inputs (files in a temporary directory)."""
    from tests.test_torch_pipeline import content_scene, style_scene
    from wast3d_tpu.scene.ply import save_ply as jax_save_ply
    from wast3d_tpu_torch.scene.ply import save_ply
    from wast3d_tpu_torch.stylize.cluster import NPZ_KEYS

    tmp = tmp_path_factory.mktemp("sharded")
    rng = np.random.default_rng(0)
    patch, domain, circles = _fit_case()
    _, tcontent, _, tpatches = _patches()
    content_ply = str(tmp / "content.ply")
    save_ply(tcontent, content_ply)
    npzs = []
    for i, p in enumerate(tpatches):
        npzs.append(str(tmp / f"style{i}.npz"))
        np.savez(npzs[-1], **{k: getattr(p, k[1:]) for k in NPZ_KEYS})
    iters = 7
    pipe = {k: str(tmp / k) for k in ("pipe_one", "pipe_ranks")}
    for w in pipe.values():
        for name, scene in (("content", content_scene()), ("style", style_scene())):
            jax_save_ply(scene, os.path.join(w, name, "point_cloud", f"iteration_{iters}",
                                             "point_cloud.ply"))
    pipe_argv = ["--content_data", "none", "--style_data", "none", "--iterations", str(iters),
                 "--num_clusters", "3", "--style_cluster_index", "1", "--skip_recon",
                 "--turntable_frames", "1", "--device", "cpu"]
    inp = dict(
        scene=_scene_arrays(_random_scene(n=200, seed=3), 200),
        gt=rng.uniform(0, 1, (RES, RES, 3)).astype(np.float32),
        gt2=rng.uniform(0, 1, (RES, RES, 3)).astype(np.float32),
        trainer_scene=_scene_arrays(_mini_scene(n=40, cap=64), 40),
        fit=(patch, domain, circles), content=tcontent, patches=tpatches,
        fit_cfg=FIT_CFG, sweep_kw=SMALL_KW, pipe_kw=SMALL_KW,
        content_ply=content_ply, npzs=npzs, sweep_out=str(tmp / "sweep_ranks"),
        pipeline_argv=[*pipe_argv, "--workdir", pipe["pipe_ranks"]],
    )
    return dict(inp=inp, tmp=tmp, pipe=pipe, pipe_argv=pipe_argv)


@pytest.fixture(scope="module")
def spawned(inputs):
    """The ranks at work, in a thread: this process computes the references
    meanwhile (the fixtures that `cases` takes)."""
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(multihost.spawn, train_sharded_cases, RANKS, (inputs["inp"],), "gloo")


@pytest.fixture(scope="module")
def cases(inputs, spawned, jax_steps, port_steps, fit_refs):
    """The inputs and the ranks' results."""
    return dict(inputs, results=spawned.result())


# ---- the train steps -------------------------------------------------------------

def _jax_trainer(views):
    """JAX's `Trainer` on the train steps' scene and config (its steps share
    one compilation of `train_step`)."""
    cams = [(_cam(w=RES, h=RES, eye=eye), jnp.asarray(g)) for eye, g in views]
    return JR.Trainer(JR.init_train_state(_random_scene(n=200, seed=3),
                                          jcfg.OptimizationConfig(), LR_SCALE),
                      cams, opt_cfg=jcfg.OptimizationConfig(), settings=TILED,
                      spatial_lr_scale=LR_SCALE, cameras_extent=4.0, seed=0, jitter=False)


@pytest.fixture(scope="module")
def jax_steps(inputs, spawned):
    """JAX's single-device `train_step`, twice, on the cases' state (a
    `Trainer` of one view: two of its iterations are two steps)."""
    jt = _jax_trainer([((0, 0, -5), inputs["inp"]["gt"])])
    jt.run(2, log_every=1)
    jst = jt.state
    losses = [h["loss"] for h in jt.history if "loss" in h]
    return losses, dict(params={k: np.asarray(v)[:200] for k, v in jst.scene.params().items()},
                        mu={k: np.asarray(v)[:200] for k, v in jst.opt_state.mu.items()},
                        nu={k: np.asarray(v)[:200] for k, v in jst.opt_state.nu.items()},
                        stats=[np.asarray(a)[:200] for a in jst.stats])


@pytest.fixture(scope="module")
def port_steps(inputs, spawned):
    """The port's single-device `train_step`, twice."""
    st, losses = state_for(inputs["inp"]["scene"]), []
    for _ in range(2):
        st, aux = TR.train_step(st, camera(RES, RES), torch.from_numpy(inputs["inp"]["gt"]),
                                torch.zeros(3), None, opt_cfg=tcfg.OptimizationConfig(),
                                settings=PLAIN, width=RES, height=RES,
                                spatial_lr_scale=LR_SCALE, jitter=False)
        losses.append(float(aux["loss"]))
    return losses, state_numpy(st)


def _stitched(results, name):
    """The two ranks' row slices of a step's state, concatenated."""
    parts = [r[name][1] for r in results]
    return dict(params={k: np.concatenate([p["params"][k] for p in parts]) for k in PARAM_KEYS},
                mu={k: np.concatenate([p["mu"][k] for p in parts]) for k in PARAM_KEYS},
                nu={k: np.concatenate([p["nu"][k] for p in parts]) for k in PARAM_KEYS},
                stats=[np.concatenate([p["stats"][i] for p in parts]) for i in range(3)])


def _assert_close_to_jax(got, losses, want, want_losses):
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    for k in PARAM_KEYS:
        v = want["params"][k]
        np.testing.assert_allclose(got["params"][k], v, rtol=0,
                                   atol=1e-3 * LRS[k] * 2 + 1e-6 * np.abs(v).max(), err_msg=k)
        for group in ("mu", "nu"):
            w = want[group][k]
            np.testing.assert_allclose(got[group][k], w, rtol=0,
                                       atol=1e-4 * np.abs(w).max() + 1e-30, err_msg=group + k)
    for a, b in zip(got["stats"], want["stats"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * np.abs(b).max())


@pytest.mark.parametrize("name", ["dp", "tile", "tile_gathered"])
def test_sharded_steps_match_jax(cases, jax_steps, name):
    res = cases["results"]
    assert res[0][name][0] == res[1][name][0]  # one loss on every rank
    _assert_close_to_jax(_stitched(res, name), res[0][name][0], jax_steps[1], jax_steps[0])


def test_data_parallel_step_equals_single_device_bit_for_bit(cases, port_steps):
    got = _stitched(cases["results"], "dp")
    assert cases["results"][0]["dp"][0] == port_steps[0]
    for group in ("params", "mu", "nu"):
        for k in PARAM_KEYS:
            np.testing.assert_array_equal(got[group][k], port_steps[1][group][k],
                                          err_msg=group + k)
    for a, b in zip(got["stats"], port_steps[1]["stats"]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["tile", "tile_gathered"])
def test_tile_sharded_step_tracks_single_device(cases, port_steps, name):
    got = _stitched(cases["results"], name)
    np.testing.assert_allclose(cases["results"][0][name][0], port_steps[0], rtol=1e-6)
    for k in PARAM_KEYS:
        v = port_steps[1]["params"][k]
        np.testing.assert_allclose(got["params"][k], v, rtol=0,
                                   atol=1e-4 * LRS[k] + 2.0 ** -22 * np.abs(v).max(), err_msg=k)
    np.testing.assert_array_equal(got["stats"][1], port_steps[1]["stats"][1])  # denom


def test_data_axis_step_averages_the_views(cases):
    """(2, 1): the step equals Adam on the mean of the two views'
    single-device gradients, and `add_stats_batch` of their statistics."""
    from wast3d_tpu_torch.ops.image_losses import photometric_loss
    from wast3d_tpu_torch.train import densify
    from wast3d_tpu_torch.train.optim import make_optimizer

    inp, res = cases["inp"], cases["results"]
    st = state_for(inp["scene"])
    views = [(camera(RES, RES), inp["gt"]),
             (camera(RES, RES, (0.3, 0.0, -5)), inp["gt2"])]
    grads, losses, m2d, radii = [], [], [], []
    for cam, gt in views:
        params = {k: v.clone().requires_grad_(True) for k, v in st.scene.params().items()}
        off = torch.zeros((200, 2), requires_grad=True)
        out = tapi.render(cam, st.scene.with_params(params), torch.zeros(3), settings=PLAIN,
                          means2d_offset=off, device="cpu")
        loss = photometric_loss(out["render"], torch.from_numpy(gt), 0.2)
        g = torch.autograd.grad(loss, list(params.values()) + [off])
        grads.append(dict(zip(params, g[:-1])))
        m2d.append(g[-1] / 2)
        losses.append(float(loss.detach()))
        radii.append(out["radii"])
    opt = make_optimizer(tcfg.OptimizationConfig(), LR_SCALE)
    new, new_opt = opt.update({k: (grads[0][k] + grads[1][k]) / 2 for k in PARAM_KEYS},
                              st.opt_state, st.scene.params(), 1)
    radii = torch.stack(radii)
    stats = densify.add_stats_batch(st.stats, torch.stack(m2d), radii, radii > 0, RES, RES)
    for r in res:
        loss, got = r["batch"]
        np.testing.assert_allclose(loss, np.mean(losses), rtol=1e-6)
        for k in PARAM_KEYS:
            np.testing.assert_allclose(got["params"][k], new[k].numpy(), rtol=1e-6, atol=1e-9,
                                       err_msg=k)
            np.testing.assert_allclose(got["mu"][k], new_opt.mu[k].numpy(), rtol=1e-6,
                                       atol=1e-12, err_msg=k)
        for a, b in zip(got["stats"], stats):
            np.testing.assert_allclose(a, b.numpy(), rtol=1e-6, atol=1e-9)


# ---- ShardedTrainer ----------------------------------------------------------------

def _losses(history):
    return [(h["iter"], h["loss"], h["n"]) for h in history if "loss" in h]


def test_sharded_trainer_tracks_jax_and_theport_trainer(cases, jax_steps):
    """Four iterations on the train steps' scene (JAX's `Trainer` reuses
    `jax_steps`'s compilation)."""
    inp = cases["inp"]
    cfg = tcfg.OptimizationConfig()
    single = port_trainer(TR.init_train_state(from_arrays(**inp["scene"], device="cpu"), cfg,
                                               LR_SCALE), cfg, LR_SCALE)
    single.run(4, log_every=1)
    got = [_losses(r["trainer"]) for r in cases["results"]]
    assert got[0] == got[1] == _losses(single.history) and len(got[0]) == 4
    jt = _jax_trainer(trainer_views())
    jt.run(4, log_every=1)
    jl = [h["loss"] for h in jt.history if "loss" in h]
    np.testing.assert_allclose([loss for _, loss, _ in got[0]], jl, rtol=1e-4)


def test_sharded_trainer_densifies_each_slice(cases):
    cfg = tcfg.OptimizationConfig(**SCHEDULE)
    single = port_trainer(TR.init_train_state(
        from_arrays(**cases["inp"]["trainer_scene"], device="cpu"), cfg, 1.0), cfg, 1.0)
    single.run(TRAINER_ITERS, log_every=1)
    got = [_losses(r["trainer_densify"]) for r in cases["results"]]
    want = _losses(single.history)
    assert got[0] == got[1] and got[0][:5] == want[:5] and len(got[0]) == TRAINER_ITERS
    assert got[0][5][2] == want[5][2] and np.isfinite(got[0][5][1])
    densify = [h for h in cases["results"][0]["trainer_densify"] if h.get("event") == "densify"]
    assert [h["iter"] for h in densify] == [5] and densify[0]["n"] > 40
    assert densify == [h for h in single.history if h.get("event") == "densify"]


# ---- stylization ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def fit_refs(inputs, spawned):
    """The port's single-device `fit_all_balls` and JAX's (`mesh=None`)."""
    from wast3d_tpu_torch.stylize import fit as tfit

    patch, domain, circles = inputs["inp"]["fit"]
    jc, tc = _cfgs(**FIT_CFG)
    return (tfit.fit_all_balls(patch, domain, circles, cfg=tc, batch_size=4, device="cpu"),
            jfit.fit_all_balls(patch, domain, circles, cfg=jc, batch_size=4))


def test_fit_all_balls_over_ranks_equals_single_device_and_jax(cases, fit_refs):
    got = cases["results"][0]["fit"]
    assert len(got) == 11
    for r in cases["results"][1:]:
        for a, b in zip(r["fit"], got):
            np.testing.assert_array_equal(a, b)
    single, jax_fit = fit_refs
    for a, b in zip(got, single):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got, jax_fit):
        np.testing.assert_allclose(a, b, rtol=FIT_RTOL, atol=FIT_ATOL)


def test_sweep_over_the_data_axis_equals_one_device(cases):
    from wast3d_tpu_torch.stylize import sweep as tsweep

    got = cases["results"][0]["sweep"]
    assert cases["results"][1]["sweep"] is None and len(got) == 2
    _, tc = _cfgs(**SMALL_KW)
    one = tsweep.stylize_sweep(cases["inp"]["content"], cases["inp"]["patches"], tc, seed=0,
                               device="cpu")
    for g, s in zip(got, one):
        assert g["xyz"].shape[0] > 40
        for f in FIELDS:
            np.testing.assert_array_equal(g[f], getattr(s, f).numpy(), err_msg=f)


# ---- the CLIs ----------------------------------------------------------------------

def _ply_fields(path):
    from wast3d_tpu_torch.scene.ply import load_ply

    s = load_ply(path, device="cpu")
    return {f: getattr(s, f).numpy() for f in FIELDS}


def _assert_same_ply(a, b):
    fa, fb = _ply_fields(a), _ply_fields(b)
    for f in FIELDS:
        np.testing.assert_array_equal(fa[f], fb[f], err_msg=f)


def test_cli_stylize_devices_two_writes_the_one_device_ply(cases):
    from wast3d_tpu_torch.cli import stylize

    inp, tmp = cases["inp"], cases["tmp"]
    argv = ["--content", inp["content_ply"], "--style_cluster", inp["npzs"][0],
            "--batch_size", "4", *[f"--{k}={v}" for k, v in SMALL_KW.items()], "--device", "cpu"]
    stylize.main([*argv, "--output", str(tmp / "one.ply")])
    stylize.main([*argv, "--output", str(tmp / "ranks.ply"), "--devices", str(RANKS)])
    _assert_same_ply(str(tmp / "ranks.ply"), str(tmp / "one.ply"))


def test_cli_sweep_data_axis_two_writes_the_one_device_plys(cases):
    from wast3d_tpu_torch.cli import sweep

    inp, tmp = cases["inp"], cases["tmp"]
    sweep.main(["--content", inp["content_ply"], "--style_clusters", *inp["npzs"],
                "--output_dir", str(tmp / "sweep_one"), "--data_axis", "1",
                *[f"--{k}={v}" for k, v in SMALL_KW.items()], "--device", "cpu"])
    for i in range(2):
        name = f"stylized_style{i}.ply"
        _assert_same_ply(os.path.join(inp["sweep_out"], name), str(tmp / "sweep_one" / name))


def test_cli_pipeline_devices_two_writes_the_one_device_files(cases, monkeypatch):
    from tests.test_torch_pipeline import small_stylize
    from wast3d_tpu_torch.cli import pipeline as pipe_cli
    from wast3d_tpu_torch.stylize import pipeline as tpipe
    from wast3d_tpu_torch.utils.png import read_png

    small_stylize(monkeypatch, tpipe, tcfg.StylizeConfig(**SMALL_KW))
    one = pipe_cli.main([*cases["pipe_argv"], "--workdir", cases["pipe"]["pipe_one"]])
    ranks = cases["results"][0]["pipeline"]
    assert cases["results"][1]["pipeline"] is None
    for k in ("content_n", "patch_n", "stylized_n", "style_n", "frames"):
        assert ranks[k] == one[k], k
    work = cases["pipe"]
    _assert_same_ply(os.path.join(work["pipe_ranks"], "stylized.ply"),
                     os.path.join(work["pipe_one"], "stylized.ply"))
    frame = os.path.join("turntable", "00000.png")
    np.testing.assert_array_equal(read_png(os.path.join(work["pipe_ranks"], frame)),
                                  read_png(os.path.join(work["pipe_one"], frame)))
