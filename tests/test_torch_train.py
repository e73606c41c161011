"""Port parity: the training path against the JAX package, on the CPU.

Both packages start from the same state (`scene.convert.train_state_from_numpy`
on the JAX `TrainState`) and get the same inputs as numpy arrays; the
split noise is drawn with `jax.random.normal(key, (2, C, 3))`, as JAX's
`densify.py` draws it, and handed to the port as `eps`. The port renders
with renderer="torch" (the plain versions of K1, K2, K3), JAX with
renderer="tiled", grad_reduce="scatter".

Tolerances, with their reasons:
- Adam over 3 steps: the same f32 formula, 1e-6 relative on the moments
  and 1e-6 of the group's learning rate on the parameters.
- densify / prune / reset: exact decisions; rows compared as sets (JAX fills
  free slots of a fixed table, the port appends and removes), values to
  1e-6 absolute.
- train steps: gradients agree to ~1e-6 relative (test_torch_blend_bwd.py),
  but Adam divides by sqrt(v), so a parameter whose gradient is tiny moves
  by up to its learning rate on noise; parameters are held to 1e-3 of the
  group's learning rate per step, moments to 1e-4 of their largest value.
- `train_scene` on the Blender fixture of `tests/test_driver.py` with
  jitter off: until the first densify the two runs see the same state, so
  the losses agree to 1e-4 relative and N exactly; after it the split
  children differ (the port's noise is not JAX's), so later losses are
  held to 2% and N to 3%."""

import argparse
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_datasets_eval import _make_blender_fixture
from tests.test_rasterizer import _cam, _random_scene
from tests.test_torch_scene import port_cam
from wast3d_tpu import config as jcfg
from wast3d_tpu.ops.rasterizer import api as japi
from wast3d_tpu.train import densify as jdens
from wast3d_tpu.train import reconstruct as JR
from wast3d_tpu.train.optim import make_optimizer as j_make_optimizer
from wast3d_tpu_torch import config as tcfg
from wast3d_tpu_torch.cli import train as tcli
from wast3d_tpu_torch.ops.rasterizer import api as tapi
from wast3d_tpu_torch.scene.convert import train_state_from_numpy
from wast3d_tpu_torch.train import checkpoint as tckpt
from wast3d_tpu_torch.train import densify as tdens
from wast3d_tpu_torch.train import reconstruct as TR
from wast3d_tpu_torch.train.optim import PARAM_KEYS, AdamState
from wast3d_tpu_torch.train.optim import make_optimizer as t_make_optimizer

TILED = japi.RasterizeSettings(renderer="tiled", dup_capacity=1 << 14, max_per_tile=512,
                               chunk=16, grad_reduce="scatter")
PLAIN = tapi.RasterizeSettings(renderer="torch")
LRS = {"xyz": 1.6e-4, "f_dc": 2.5e-3, "f_rest": 1.25e-4, "opacity": 0.05,
       "scaling": 5e-3, "rotation": 1e-3}


def state_to_numpy(st):
    return dict(params={k: np.asarray(v) for k, v in st.scene.params().items()},
                mu={k: np.asarray(v) for k, v in st.opt_state.mu.items()},
                nu={k: np.asarray(v) for k, v in st.opt_state.nu.items()},
                count=int(st.opt_state.count), stats=[np.asarray(a) for a in st.stats],
                step=int(st.step), mask=np.asarray(st.scene.mask),
                active_sh_degree=st.scene.active_sh_degree,
                max_sh_degree=st.scene.max_sh_degree)


def port_state(jst):
    return train_state_from_numpy(**state_to_numpy(jst), device="cpu")


def random_grads(params, seed):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=np.shape(v)).astype(np.float32) * 1e-3 for k, v in params.items()}


# ---- optimizer ----------------------------------------------------------------

def test_optim_update_three_steps_matches_jax():
    js = _random_scene(n=100, seed=1)
    jp = {k: np.asarray(v) for k, v in js.params().items()}
    cfg_j, cfg_t = jcfg.OptimizationConfig(), tcfg.OptimizationConfig()
    jo, to = j_make_optimizer(cfg_j, 2.5), t_make_optimizer(cfg_t, 2.5)
    jstate, tstate = jo.init({k: jnp.asarray(v) for k, v in jp.items()}), to.init(
        {k: torch.from_numpy(v.copy()) for k, v in jp.items()})
    jpar = {k: jnp.asarray(v) for k, v in jp.items()}
    tpar = {k: torch.from_numpy(v.copy()) for k, v in jp.items()}
    for step in range(1, 4):
        g = random_grads(jp, step)
        jpar, jstate = jo.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jpar, step)
        tpar, tstate = to.update({k: torch.from_numpy(v) for k, v in g.items()}, tstate, tpar,
                                 step)
    assert tstate.count == int(jstate.count) == 3
    for k in PARAM_KEYS:
        np.testing.assert_allclose(tstate.mu[k].numpy(), np.asarray(jstate.mu[k]), rtol=1e-6,
                                   atol=1e-12, err_msg=k)
        np.testing.assert_allclose(tstate.nu[k].numpy(), np.asarray(jstate.nu[k]), rtol=1e-6,
                                   atol=1e-15, err_msg=k)
        lr = LRS[k] * (2.5 if k == "xyz" else 1.0)
        np.testing.assert_allclose(tpar[k].numpy(), np.asarray(jpar[k]), rtol=0,
                                   atol=1e-6 * lr + 1e-6 * np.abs(jp[k]).max(), err_msg=k)
    for k, fn in to.lr_fns.items():
        np.testing.assert_allclose(fn(3), float(jo.lr_fns[k](3)), rtol=1e-6, err_msg=k)


def test_from_point_cloud_and_compact_match_jax():
    """Scale init through the 3-NN distances (1e-5 relative, as in
    test_torch_losses.py), the rest exactly; `compact` keeps the mask's
    rows in order."""
    from wast3d_tpu.scene.gaussians import from_point_cloud as j_from_pc
    from wast3d_tpu_torch.scene.gaussians import compact, from_point_cloud

    rng = np.random.default_rng(4)
    pts = rng.uniform(-1.3, 1.3, (300, 3)).astype(np.float32)
    rgb = rng.uniform(0, 1, (300, 3)).astype(np.float32)
    js = j_from_pc(pts, rgb, max_sh_degree=3)
    ts = from_point_cloud(pts, rgb, max_sh_degree=3, device="cpu")
    assert ts.capacity == 300 and bool(ts.mask.all()) and ts.active_sh_degree == 0
    for k, v in ts.params().items():
        np.testing.assert_allclose(v.numpy(), np.asarray(js.params()[k])[:300], rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    keep = torch.from_numpy(rng.uniform(size=300) < 0.7)
    small = compact(ts.replace(mask=keep))
    assert small.capacity == int(keep.sum()) and bool(small.mask.all())
    torch.testing.assert_close(small.xyz, ts.xyz[keep], rtol=0, atol=0)
    assert compact(ts) is ts


# ---- densification statistics, densify / prune, opacity reset ---------------

def test_add_stats_matches_jax():
    rng = np.random.default_rng(0)
    n = 300
    g = rng.normal(size=(n, 2)).astype(np.float32) * 1e-4
    radii = rng.integers(0, 30, n).astype(np.int32)
    vis = radii > 0
    j = jdens.init_stats(n)
    t = tdens.init_stats(n)
    for _ in range(2):
        j = jdens.add_stats(j, jnp.asarray(g), jnp.asarray(radii), jnp.asarray(vis), 64, 48)
        t = tdens.add_stats(t, torch.from_numpy(g), torch.from_numpy(radii),
                            torch.from_numpy(vis), 64, 48)
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-12)


def densify_case(seed=0):
    """A JAX state with room to grow (capacity 1024 for 300 Gaussians),
    high gradients on a third of them, scales on both sides of the
    clone/split line, and a few transparent ones to prune."""
    rng = np.random.default_rng(seed)
    js = _random_scene(n=300, seed=seed, cap=1024)
    op = np.asarray(js.opacity).copy()
    op[:10] = -7.0  # sigmoid ~ 9e-4 < min_opacity 0.005
    js = js.replace(opacity=jnp.asarray(op))
    jst = JR.init_train_state(js, jcfg.OptimizationConfig(), 1.0)
    mu = {k: jnp.asarray(rng.normal(size=v.shape).astype(np.float32) * 1e-3)
          for k, v in jst.opt_state.mu.items()}
    nu = {k: jnp.asarray(rng.uniform(0, 1e-6, size=v.shape).astype(np.float32))
          for k, v in jst.opt_state.nu.items()}
    c = js.capacity
    accum = np.where(rng.uniform(size=c) < 0.35, 5e-3, 1e-5).astype(np.float32)
    denom = np.where(np.asarray(js.mask), 10.0, 0.0).astype(np.float32)  # dead: 0/0
    radii = rng.uniform(0, 40, c).astype(np.float32)
    stats = jdens.DensifyStats(jnp.asarray(accum * denom), jnp.asarray(denom),
                               jnp.asarray(radii))
    return jst._replace(opt_state=jst.opt_state._replace(mu=mu, nu=nu), stats=stats)


def active_rows(scene_params, mask, mu, nu):
    """[n_active, D] params + moments of the active rows, sorted
    lexicographically (row order differs by design)."""
    cols = []
    for src in (scene_params, mu, nu):
        for k in PARAM_KEYS:
            a = np.asarray(src[k])
            cols.append(a.reshape(a.shape[0], -1))
    rows = np.concatenate(cols, 1)[np.asarray(mask)]
    return rows[np.lexsort(rows.T[::-1])]


@pytest.mark.parametrize("max_screen,big_screen", [(0.0, False), (20.0, False), (20.0, True)])
def test_densify_and_prune_matches_jax_as_sets(max_screen, big_screen):
    jst = densify_case()
    key = jax.random.PRNGKey(3)
    c = jst.scene.capacity
    kw = dict(max_grad=2e-4, min_opacity=0.005, extent=0.8, max_screen_size=max_screen,
              percent_dense=0.1, prune_big_screen=big_screen)
    jscene, jopt, jstats, dropped = jdens.densify_and_prune(
        jst.scene, jst.opt_state, jst.stats, key, **kw)
    assert int(dropped) == 0
    eps = np.array(jax.random.normal(key, (2, c, 3), jnp.float32))
    tst = port_state(jst)
    tscene, topt, tstats, tdropped = tdens.densify_and_prune(
        tst.scene, tst.opt_state, tst.stats, eps=torch.from_numpy(eps), **kw)
    assert tdropped == 0
    n_act = int(np.asarray(jscene.mask).sum())
    assert tscene.capacity == n_act and bool(tscene.mask.all())
    assert n_act != int(np.asarray(jst.scene.mask).sum())  # something happened
    want = active_rows(jscene.params(), jscene.mask, jopt.mu, jopt.nu)
    got = active_rows({k: v.numpy() for k, v in tscene.params().items()}, tscene.mask.numpy(),
                      {k: v.numpy() for k, v in topt.mu.items()},
                      {k: v.numpy() for k, v in topt.nu.items()})
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert topt.count == int(jopt.count)
    for s in tstats:
        assert s.shape == (n_act,) and not bool(s.any())


def test_reset_opacity_matches_jax():
    jst = densify_case(seed=1)
    js, jo = jdens.reset_opacity(jst.scene, jst.opt_state)
    tst = port_state(jst)
    ts, to = tdens.reset_opacity(tst.scene, tst.opt_state)
    np.testing.assert_allclose(ts.opacity.numpy(), np.asarray(js.opacity), rtol=1e-6)
    assert not bool(to.mu["opacity"].any()) and not bool(to.nu["opacity"].any())
    torch.testing.assert_close(to.mu["xyz"], tst.opt_state.mu["xyz"])


# ---- train step ---------------------------------------------------------------

@pytest.mark.parametrize("steps", [1, 3])
def test_train_steps_match_jax(steps):
    w = h = 64
    js = _random_scene(n=200, seed=3)
    gt = np.random.default_rng(0).uniform(0, 1, (h, w, 3)).astype(np.float32)
    bg = np.array([0.0, 0.0, 0.0], np.float32)
    jst = JR.init_train_state(js, jcfg.OptimizationConfig(), spatial_lr_scale=2.0)
    tst = port_state(jst)
    for _ in range(steps):
        jst, jaux = JR.train_step(jst, _cam(w=w, h=h), jnp.asarray(gt), jnp.asarray(bg),
                                  jax.random.PRNGKey(0), opt_cfg=jcfg.OptimizationConfig(),
                                  settings=TILED, width=w, height=h, spatial_lr_scale=2.0,
                                  jitter=False)
        tst, taux = TR.train_step(tst, port_cam(w=w, h=h), torch.from_numpy(gt),
                                  torch.from_numpy(bg), None,
                                  opt_cfg=tcfg.OptimizationConfig(), settings=PLAIN, width=w,
                                  height=h, spatial_lr_scale=2.0, jitter=False)
        np.testing.assert_allclose(float(taux["loss"]), float(jaux["loss"]), rtol=1e-5)
        np.testing.assert_array_equal(taux["radii"].numpy(), np.asarray(jaux["radii"]))
    assert tst.step == int(jst.step) == steps
    want = state_to_numpy(jst)
    for k, v in want["params"].items():
        lr = LRS[k] * (2.0 if k == "xyz" else 1.0)
        np.testing.assert_allclose(tst.scene.params()[k].numpy(), v, rtol=0,
                                   atol=1e-3 * lr * steps + 1e-6 * np.abs(v[:200]).max(),
                                   err_msg=k)
    for group in ("mu", "nu"):
        for k, v in want[group].items():
            got = getattr(tst.opt_state, group)[k].numpy()
            np.testing.assert_allclose(got, v, rtol=0, atol=1e-4 * np.abs(v).max() + 1e-30,
                                       err_msg=f"{group} {k}")
    for a, b, name in zip(tst.stats, want["stats"], tdens.DensifyStats._fields):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-5 * np.abs(b).max(),
                                   err_msg=name)


# ---- the driver and the CLI -----------------------------------------------------

def blender_scene(root):
    """The Blender fixture of `tests/test_driver.py` with its 200-point
    cloud moved in front of the cameras (they sit near z = -4 and look down
    -z), so every step renders and densification has gradients to read."""
    from wast3d_tpu.scene.datasets import store_ply_points

    _make_blender_fixture(root)
    rng = np.random.default_rng(0)
    xyz = rng.uniform(-1, 1, (200, 3)) * [1.0, 1.0, 0.5] + [0.0, 0.0, -6.0]
    store_ply_points(os.path.join(root, "points3d.ply"), xyz, rng.uniform(0, 255, (200, 3)))


def test_train_scene_tracks_jax(tmp_path):
    """30 iterations with densify at 20 and 30; jitter off on both sides."""
    from wast3d_tpu.train.driver import train_scene as j_train_scene
    from wast3d_tpu_torch.train.driver import train_scene as t_train_scene

    src = str(tmp_path / "scene")
    blender_scene(src)
    opt = dict(iterations=30, densify_from_iter=10, densification_interval=10)
    jt = j_train_scene(source_path=src, model_path=str(tmp_path / "jax"), iterations=30,
                       save_iterations=[30], opt_cfg=jcfg.OptimizationConfig(**opt),
                       settings=TILED, quiet=True, log_every=1, jitter=False)
    tt = t_train_scene(source_path=src, model_path=str(tmp_path / "port"), iterations=30,
                       save_iterations=[30], opt_cfg=tcfg.OptimizationConfig(**opt),
                       settings=PLAIN, quiet=True, log_every=1, jitter=False, device="cpu")
    jl = [e for e in jt.history if "loss" in e]
    tl = [e for e in tt.history if "loss" in e]
    assert [e["iter"] for e in tl] == [e["iter"] for e in jl] == list(range(1, 31))
    densified = [e for e in tt.history if e.get("event") == "densify"]
    assert [e["iter"] for e in densified] == [20, 30]
    for a, b in zip(tl, jl):
        if a["iter"] <= 20:
            assert a["n"] == b["n"] == 200
            np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-4, err_msg=str(a["iter"]))
        else:
            np.testing.assert_allclose(a["loss"], b["loss"], rtol=2e-2, err_msg=str(a["iter"]))
            np.testing.assert_allclose(a["n"], b["n"], rtol=3e-2, err_msg=str(a["iter"]))
    n_final_j = int(np.asarray(jt.state.scene.mask).sum())
    assert tt.state.scene.capacity != 200  # densify changed N
    np.testing.assert_allclose(tt.state.scene.capacity, n_final_j, rtol=3e-2)
    ply = os.path.join(tmp_path, "port", "point_cloud", "iteration_30", "point_cloud.ply")
    from wast3d_tpu_torch.scene.ply import load_ply

    assert load_ply(ply, device="cpu").capacity == tt.state.scene.capacity
    log = [json.loads(line) for line in open(tmp_path / "port" / "log.jsonl")]
    assert any("psnr_train" in e for e in log)


def jax_cli_parser():
    """The parser `wast3d_tpu.cli.train.main` builds, caught at parse time."""
    from wast3d_tpu.cli import train as jcli

    caught = {}

    class Caught(Exception):
        pass

    def parse(self, *a, **k):
        caught["parser"] = self
        raise Caught

    orig = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = parse
    try:
        with pytest.raises(Caught):
            jcli.main()
    finally:
        argparse.ArgumentParser.parse_args = orig
    return caught["parser"]


def test_cli_train_flags_match_jax():
    def flags(p):
        return {opt: (a.default, a.nargs) for a in p._actions for opt in a.option_strings
                if opt not in ("-h", "--help")}

    j, t = flags(jax_cli_parser()), flags(tcli.build_parser())
    assert set(t) - set(j) == {"--device"}
    for opt, val in j.items():
        if opt != "--renderer":  # "pallas" there, "cuda" here
            assert t[opt] == val, opt
    ns = tcli.build_parser().parse_args(["-s", "x", "-m", "y"])
    assert ns.renderer == "cuda" and ns.device == "cuda" and ns.data_device == "tpu"


def test_cli_train_sphere_mode_is_not_ported():
    with pytest.raises(NotImplementedError, match="queue 1 item 12"):
        tcli.main(["-s", "x", "-m", "y", "--sphere_mode", "isotropic", "--device", "cpu"])


def test_cli_train_on_cpu_with_checkpoint(tmp_path):
    src = str(tmp_path / "scene")
    blender_scene(src)
    model = str(tmp_path / "model")
    tcli.main(["-s", src, "-m", model, "--iterations", "6", "--save_iterations", "6",
               "--checkpoint_iterations", "4", "--renderer", "torch", "--quiet",
               "--device", "cpu", "--densify_from_iter", "2",
               "--densification_interval", "3", "--port", "1"])
    assert os.path.exists(os.path.join(model, "point_cloud", "iteration_6", "point_cloud.ply"))
    assert tcfg.load_cfg_args(model).source_path == os.path.abspath(src)
    st, slr = tckpt.load_checkpoint(os.path.join(model, "chkpnt4"), device="cpu")
    assert st.step == 4 and st.opt_state.count == 4 and slr > 0
    assert st.stats.denom.shape == (st.scene.capacity,)
    resumed = str(tmp_path / "resumed")
    tcli.main(["-s", src, "-m", resumed, "--iterations", "6", "--save_iterations", "6",
               "--start_checkpoint", os.path.join(model, "chkpnt4"), "--renderer", "torch",
               "--quiet", "--device", "cpu"])
    assert os.path.exists(os.path.join(resumed, "point_cloud", "iteration_6",
                                       "point_cloud.ply"))


def test_checkpoint_roundtrip(tmp_path):
    tst = port_state(densify_case(seed=2))
    path = str(tmp_path / "ck")
    tckpt.save_checkpoint(path, tst, 1.5)
    back, slr = tckpt.load_checkpoint(path, device="cpu")
    assert slr == 1.5 and back.step == tst.step
    for f in ("xyz", "features_rest", "opacity", "mask"):
        torch.testing.assert_close(getattr(back.scene, f), getattr(tst.scene, f))
    for k in PARAM_KEYS:
        torch.testing.assert_close(back.opt_state.nu[k], tst.opt_state.nu[k])
    for a, b in zip(back.stats, tst.stats):
        torch.testing.assert_close(a, b)
    assert isinstance(back.opt_state, AdamState)
