"""Port parity: image-space refinement (`refine/`) and the auxiliary models
(`models/`) against the JAX package, on the CPU.

Inputs are made from numpy seeds and go through both packages. The port
renders with renderer="tiled" (the plain versions of K1, K2, K3), JAX with
renderer="tiled", grad_reduce="scatter". Tolerances, with their reasons:
- k-means / teleport: the same numpy seeding and the same Lloyd updates, so
  the same labels; positions to 1e-5 (float32 centre sums in another order).
- intracluster distances: the same matrix-product form |a|^2 + |b|^2 - 2a.b,
  whose float32 rounding on unit-scale points is ~1e-6 in d^2; so squared
  distances are held to 1e-5 absolute (a distance near 0, the diagonal,
  is the root of that rounding, up to ~1e-3); the loss 1e-5 relative, its
  gradient 1e-4 of its max.
- refine losses: rtol 1e-4 (render and VGG agree to ~1e-6 relative).
- refine parameters after one step: Adam's first step moves every
  parameter with a nonzero gradient by about its learning rate times the
  gradient's sign, however small the gradient. So the test first holds the
  first moments (0.1 g) to 1e-4 of each group's largest; where |mu| is above
  that bound the two gradients have the same sign, the steps are the same
  and the parameters are held to 1e-6 of the learning rate; elsewhere float
  noise may flip the sign, and the step is only held to at most lr.
- encodings 1e-6 (linear bands: one ulp, see its test); the sphere
  projector 1e-5. (Style transfer is in `tests/test_torch_eval.py`.)
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_rasterizer import _cam
from tests.test_torch_scene import port_cam, port_scene
from tests.test_torch_train import port_state
from tests.test_train import _mini_scene
from wast3d_tpu.config import OptimizationConfig as JOpt
from wast3d_tpu.ops.rasterizer import api as japi
from wast3d_tpu.refine import drivers as JD
from wast3d_tpu.refine import intracluster as JI
from wast3d_tpu.refine.teleport import cluster_teleport as j_teleport
from wast3d_tpu.train.reconstruct import init_train_state
from wast3d_tpu_torch.config import OptimizationConfig as TOpt
from wast3d_tpu_torch.ops.rasterizer import api as tapi
from wast3d_tpu_torch.refine import drivers as TD
from wast3d_tpu_torch.refine import intracluster as TI
from wast3d_tpu_torch.refine.teleport import cluster_teleport as t_teleport
from wast3d_tpu_torch.train.optim import PARAM_KEYS

JSET = japi.RasterizeSettings(renderer="tiled", dup_capacity=1 << 12, max_per_tile=128,
                              chunk=16, grad_reduce="scatter")
TSET = tapi.RasterizeSettings(renderer="tiled")
LRS = {"xyz": 1.6e-4, "f_dc": 2.5e-3, "f_rest": 1.25e-4, "opacity": 0.05,
       "scaling": 5e-3, "rotation": 1e-3}


# ---- teleport ------------------------------------------------------------------

def test_cluster_teleport_matches_jax():
    content = _mini_scene(n=40, seed=0, cap=64)
    content = content.replace(xyz=content.xyz + 10.0)
    style = _mini_scene(n=40, seed=1, cap=64)
    jt, jl = j_teleport(content, style, num_clusters=4)
    tt, tl = t_teleport(port_scene(content), port_scene(style), num_clusters=4)
    np.testing.assert_array_equal(tl, np.asarray(jl))
    np.testing.assert_allclose(tt.xyz.numpy(), np.asarray(jt.xyz), atol=1e-5)
    # dead slots untouched, as in JAX
    np.testing.assert_array_equal(tt.xyz.numpy()[40:], np.asarray(style.xyz)[40:])


# ---- intracluster --------------------------------------------------------------

def _ids_and_values(n, k, seed, d=3):
    rng = np.random.default_rng(seed)
    return rng.integers(0, k, size=n), rng.normal(size=(n, d)).astype(np.float32)


@pytest.mark.parametrize("cap", [None, 16])
def test_pack_clusters_matches_jax(cap):
    ids, _ = _ids_and_values(200, 7, 0)
    jp = JI.pack_clusters(ids, 7, cap)
    tp = TI.pack_clusters(ids, 7, cap, device="cpu")
    for a, b in zip(tp, jp):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_intracluster_dists_loss_and_gradient_match_jax():
    ids, vals = _ids_and_values(200, 7, 1)
    jp, tp = JI.pack_clusters(ids, 7), TI.pack_clusters(ids, 7, device="cpu")
    jd = np.asarray(JI.intracluster_pairwise_dists(jnp.asarray(vals), jp))
    td = TI.intracluster_pairwise_dists(torch.from_numpy(vals), tp).numpy()
    np.testing.assert_allclose(td ** 2, jd ** 2, atol=1e-5)
    np.testing.assert_array_equal(td == 0, jd == 0)
    moved = vals + 0.1 * np.random.default_rng(2).normal(size=vals.shape).astype(np.float32)
    jl, jg = jax.value_and_grad(lambda v: JI.intracluster_stats_loss(v, jnp.asarray(jd), jp))(
        jnp.asarray(moved))
    x = torch.from_numpy(moved).requires_grad_(True)
    tl = TI.intracluster_stats_loss(x, torch.from_numpy(jd), tp)
    (tg,) = torch.autograd.grad(tl, [x])
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    jg = np.asarray(jg)
    assert np.abs(tg.numpy() - jg).max() <= 1e-4 * np.abs(jg).max()
    assert float(TI.intracluster_stats_loss(torch.from_numpy(vals), torch.from_numpy(td),
                                            tp)) < 1e-10


def test_get_intracluster_stats_matches_jax():
    from tests.test_rasterizer import _random_scene

    scene = _random_scene(n=50, seed=3)
    ids = np.random.default_rng(0).integers(0, 5, size=scene.capacity)
    j = JI.get_intracluster_stats(scene, ids, attrbs=("xyz", "features_dc"))
    t = TI.get_intracluster_stats(port_scene(scene), ids, attrbs=("xyz", "features_dc"))
    for attr in ("xyz", "features_dc"):
        np.testing.assert_allclose(t[attr].numpy() ** 2, np.asarray(j[attr]) ** 2, atol=1e-5)


# ---- refine --------------------------------------------------------------------

def _refine_setup():
    """`tests/test_refine.py`'s setup: 30 Gaussians (capacity 64), one 32^2
    view. Its ground truth is the scene's own render moved by 0.01-0.05 per
    value, so that the L1 term's sign is the same in both packages (at a
    difference of exactly 0 in JAX, the port's ~1e-7 render noise would
    give the sign another value)."""
    scene = _mini_scene(n=30, seed=2, cap=64)
    cam = _cam(w=32, h=32)
    out = japi.render(cam, scene, jnp.zeros(3), settings=JSET)
    rng = np.random.default_rng(0)
    move = rng.uniform(0.01, 0.05, (32, 32, 3)) * rng.choice([-1.0, 1.0], (32, 32, 3))
    gt = (np.asarray(out["render"]) + move).astype(np.float32)
    cfg = JOpt(densify_from_iter=10**9)
    style = rng.uniform(size=(32, 32, 3)).astype(np.float32)
    depth = [np.asarray(out["depth"]) * 0.9]
    return init_train_state(scene, cfg, 1.0), (cam, gt), cfg, style, depth


def _opt_arrays(state, port):
    conv = (lambda t: t.detach().numpy()) if port else np.asarray
    return ({k: conv(v) for k, v in state.scene.params().items()},
            {k: conv(v) for k, v in state.opt_state.mu.items()})


@pytest.mark.parametrize("mode", list(JD.RefineMode), ids=lambda m: m.value)
def test_refine_matches_jax(mode):
    jst, (cam, gt), cfg, style, depth = _refine_setup()
    tst = port_state(jst)
    tcfg = TOpt(densify_from_iter=10**9)
    jcams, tcams = [(cam, jnp.asarray(gt))], [(port_cam(w=32, h=32), gt)]
    kw = dict(style_image=style, target_depths=depth)
    j1, jl1 = JD.refine(jst, jcams, mode, 1, opt_cfg=cfg, settings=JSET, **kw)
    t1, tl1 = TD.refine(tst, tcams, TD.RefineMode(mode.value), 1, opt_cfg=tcfg,
                        settings=TSET, **kw)
    jp, jmu = _opt_arrays(j1, port=False)
    tp, tmu = _opt_arrays(t1, port=True)
    p0 = {k: np.asarray(v) for k, v in jst.scene.params().items()}
    for k in PARAM_KEYS:
        bound = 1e-4 * np.abs(jmu[k]).max()
        np.testing.assert_allclose(tmu[k], jmu[k], rtol=0, atol=bound + 1e-12, err_msg=k)
        sure = np.abs(jmu[k]) > bound
        np.testing.assert_allclose(tp[k][sure], jp[k][sure], rtol=0, atol=1e-6 * LRS[k],
                                   err_msg=k)
        assert np.abs(tp[k] - p0[k]).max() <= LRS[k] * (1 + 1e-3), k
    j3, jl3 = JD.refine(j1, jcams, mode, 2, opt_cfg=cfg, settings=JSET, **kw)
    t3, tl3 = TD.refine(t1, tcams, TD.RefineMode(mode.value), 2, opt_cfg=tcfg,
                        settings=TSET, **kw)
    assert int(t3.step) == int(j3.step) == 3
    np.testing.assert_allclose(tl1 + tl3, jl1 + jl3, rtol=1e-4)
    assert np.isfinite(tl1 + tl3).all()


def test_refine_visits_jaxs_camera_order(monkeypatch):
    """Both drivers pop the same cameras: each step's camera, recorded by a
    stand-in step, over three passes of five views."""
    seen = {"jax": [], "port": []}

    def recorder(name):
        def step(state, camera, *args, **kwargs):
            seen[name].append(camera)
            return state, 0.0
        return step

    monkeypatch.setattr(JD, "refine_step", recorder("jax"))
    monkeypatch.setattr(TD, "refine_step", recorder("port"))
    monkeypatch.setattr(TD.vgg_mod, "load_weights", lambda path: {})
    jst = _refine_setup()[0]
    gt = np.zeros((8, 8, 3), np.float32)
    jcams = [(_cam(w=8, h=8, eye=(0.1 * i, 0, -5)), gt) for i in range(5)]
    tcams = [(port_cam(w=8, h=8, eye=(0.1 * i, 0, -5)), gt) for i in range(5)]
    JD.refine(jst, jcams, JD.RefineMode.CONTENT_ONLY, 15, seed=3)
    TD.refine(port_state(jst), tcams, TD.RefineMode.CONTENT_ONLY, 15, seed=3)
    j_idx = [next(i for i, (c, _) in enumerate(jcams) if c is cam) for cam in seen["jax"]]
    t_idx = [[c.view_transform.tolist() for c, _ in tcams].index(cam.view_transform.tolist())
             for cam in seen["port"]]
    assert t_idx == j_idx and sorted(j_idx[:5]) == list(range(5))


# ---- models --------------------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, {"include_input": False, "num_freqs": 4,
                                     "max_freq_log2": 3}], ids=["default", "no_input"])
def test_embedder_matches_jax(kw):
    from wast3d_tpu.models.encodings import Embedder as JE
    from wast3d_tpu_torch.models import Embedder as TE

    x = np.random.default_rng(0).uniform(-1, 1, (50, 3)).astype(np.float32)
    je, te = JE(**kw), TE(**kw)
    assert te.out_dim == je.out_dim
    np.testing.assert_array_equal(te.freq_bands.numpy(), np.asarray(je.freq_bands))
    np.testing.assert_allclose(te.embed(torch.from_numpy(x)).numpy(),
                               np.asarray(je.embed(jnp.asarray(x))), atol=1e-6)


def test_embedder_linear_bands_within_an_ulp_of_jax():
    """Linear sampling (bands from 1 to 1024): each band within one float32
    ulp of JAX's, so the embedding within |x| * band * 2^-23 (1.3e-4 here)."""
    from wast3d_tpu.models.encodings import Embedder as JE
    from wast3d_tpu_torch.models import Embedder as TE

    je, te = JE(log_sampling=False), TE(log_sampling=False)
    jb = np.asarray(je.freq_bands)
    np.testing.assert_allclose(te.freq_bands.numpy(), jb, rtol=2 ** -23)
    x = np.random.default_rng(1).uniform(-1, 1, (50, 3)).astype(np.float32)
    np.testing.assert_allclose(te.embed(torch.from_numpy(x)).numpy(),
                               np.asarray(je.embed(jnp.asarray(x))), atol=1.3e-4)


@pytest.mark.parametrize("max_freq_log2,num_freqs", [(10.0, 6), (2.0, 2), (10, 10)])
def test_nerf_positional_encoding_matches_jax(max_freq_log2, num_freqs):
    from wast3d_tpu.models.encodings import nerf_positional_encoding as jenc
    from wast3d_tpu_torch.models import nerf_positional_encoding as tenc

    x = np.random.default_rng(2).uniform(-1, 1, (4, 7, 3)).astype(np.float32)
    np.testing.assert_allclose(tenc(torch.from_numpy(x), max_freq_log2, num_freqs).numpy(),
                               np.asarray(jenc(jnp.asarray(x), max_freq_log2, num_freqs)),
                               atol=1e-6)


def test_sphere_projection_model_carries_flax_params():
    from wast3d_tpu.models.sphere_projection import SphereProjectionModel as JM
    from wast3d_tpu_torch.models import SphereProjectionModel as TM
    from wast3d_tpu_torch.models.sphere_projection import state_dict_from_flax

    pts = np.random.default_rng(3).normal(size=(40, 3)).astype(np.float32)
    jm = JM(hidden_dim=32)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(pts))
    jout, jrot = jm.apply(variables, jnp.asarray(pts))
    tm = TM(hidden_dim=32)
    tm.load_state_dict(state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(variables))))
    with torch.no_grad():
        tout, trot = tm(torch.from_numpy(pts))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=1e-5)
    np.testing.assert_allclose(trot.numpy(), np.asarray(jrot), atol=1e-5)
