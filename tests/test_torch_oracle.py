"""Port parity on the CPU: the per-pixel oracle (`ops/rasterizer/oracle.py`),
`render`'s colour and covariance options, preprocess's precomputed inputs,
the transforms helpers and `render_batch`, against the JAX package.

Tolerances, with their reasons:
- the oracle against JAX's oracle on one shared `Preprocessed` (80x48,
  n = 150): colour and final_T 1e-5, depth 1e-4 (the same float32 formulas;
  the colour and depth sums are matrix products that sum N terms in another
  order). A pixel whose stop at T = 1e-4 flips would differ by a whole
  Gaussian's share; the test counts such pixels and allows none;
- the oracle's xyz gradient against JAX's: 1e-4 of max |g| (autograd of
  the same masks, summed in another order);
- the port's "tiled" against the port's oracle at JAX's own limits
  (`tests/test_rasterizer.py`: 2e-3 colour and final_T, 2e-2 depth, xyz
  gradient 5e-5 absolute);
- the golden gate through renderer="oracle" (PSNR > 45 dB, depth < 2e-2);
- renders with `override_color`, `convert_shs_python` and
  `compute_cov3d_python` against JAX "tiled" at `test_torch_render.py`'s
  limits (3e-3 colour / final_T, 3e-2 depth) and against the port's
  default render, where each option computes the same values, within 1e-5
  (depth 1e-4: the python covariance is a matrix product, the default
  path's is written out term by term); `override_color` set to the
  default path's colours renders the default image bit for bit;
  their gradients against JAX's within 1e-4 of max |g| per field. The SH
  scenes' colours sit away from 0, where the python path's clamp and the
  default path's clamp have the same gradient;
- preprocess with precomputed colours / covariances: as
  `test_torch_preprocess.py` (1e-5 of each field's scale);
- the transforms helpers 1e-6.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_rasterizer import _cam, _random_scene
from tests.test_torch_preprocess import rotated_sh_scene
from tests.test_torch_scene import port_cam, port_scene
from wast3d_tpu.core import transforms as jtr
from wast3d_tpu.ops.rasterizer import api as japi
from wast3d_tpu.ops.rasterizer import oracle as joracle
from wast3d_tpu.ops.rasterizer import preprocess as jprep
from wast3d_tpu_torch.core import transforms as ttr
from wast3d_tpu_torch.core.camera import make_camera
from wast3d_tpu_torch.eval import render_sets as trs
from wast3d_tpu_torch.ops.rasterizer import api as tapi
from wast3d_tpu_torch.ops.rasterizer import oracle as toracle
from wast3d_tpu_torch.ops.rasterizer import preprocess as tprep
from wast3d_tpu_torch.scene.ply import load_ply

GOLD = os.path.join(os.path.dirname(__file__), "golden")
CPU = "cpu"
ORACLE = tapi.RasterizeSettings(renderer="oracle")
J_ORACLE = japi.RasterizeSettings(renderer="oracle")
J_TILED = japi.RasterizeSettings(renderer="tiled", dup_capacity=1 << 14, max_per_tile=512,
                                 chunk=16)
T_TILED = tapi.RasterizeSettings(renderer="tiled")


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_prep(js, jcam):
    return jprep.preprocess(
        means3d=js.get_xyz, opacities=js.get_opacity, view_transform=jcam.view_transform,
        full_proj_transform=jcam.full_proj_transform, camera_center=jcam.camera_center,
        tan_fovx=jcam.tan_fovx, tan_fovy=jcam.tan_fovy, width=jcam.width,
        height=jcam.height, sh_degree=js.active_sh_degree, shs=js.get_features,
        scales=js.get_scaling, rotations=js.get_rotation, mask=js.mask)


def _offsets(w, h, seed):
    return -np.random.default_rng(seed).uniform(0, 1, (h, w, 2)).astype(np.float32)


# ---- the oracle ------------------------------------------------------------------

@pytest.mark.parametrize("jitter", [False, True])
@pytest.mark.parametrize("tile_cull", [True, False])
def test_oracle_matches_jax_oracle(jitter, tile_cull):
    """JAX's oracle with tile_cull=False composites nothing (its `~in_rect`
    inverts the Python bool True into -2, which skips every Gaussian), so
    the port's tile_cull=False, which composites every Gaussian at every
    pixel as documented, is held to JAX's tile_cull=True on radii so large
    that every tile lies in every rect: the same footprint."""
    w, h = 80, 48
    js = _random_scene(n=150, seed=int(jitter) + 2 * int(tile_cull))
    jp = _jax_prep(js, _cam(w=w, h=h))
    off = _offsets(w, h, 7) if jitter else None
    bg = np.array([0.3, 0.6, 0.9], np.float32)
    jref = jp if tile_cull else jp._replace(radii=jnp.where(jp.radii > 0, 1 << 14, 0))
    jc, jd, jt = joracle.render_oracle(jref, w, h, jnp.asarray(bg),
                                       None if off is None else jnp.asarray(off))
    tp = tprep.Preprocessed(*(_t(x) for x in jp))
    tc, td, tt = toracle.render_oracle(tp, w, h, _t(bg), None if off is None else _t(off),
                                       tile_cull=tile_cull)
    jc, jd, jt = np.asarray(jc), np.asarray(jd), np.asarray(jt)
    flips = int(np.count_nonzero(np.abs(tt.numpy() - jt) > 1e-3))
    assert flips == 0, f"{flips} pixels whose stop at T = 1e-4 flipped"
    np.testing.assert_allclose(tc.numpy(), jc, atol=1e-5, rtol=0)
    np.testing.assert_allclose(tt.numpy(), jt, atol=1e-5, rtol=0)
    np.testing.assert_allclose(td.numpy(), jd, atol=1e-4, rtol=0)
    assert float(jt.min()) < 0.5  # the scene covers pixels


def test_oracle_row_block_does_not_change_the_image():
    w, h = 50, 34
    tp = tapi.preprocess_scene(port_cam(w=w, h=h), port_scene(_random_scene(n=80, seed=3)))
    a = toracle.render_oracle(tp, w, h, torch.ones(3))
    b = toracle.render_oracle(tp, w, h, torch.ones(3), row_block=5)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=1e-6)


def _xyz_grad_port(scene, cam, settings, bg, target):
    xyz = scene.xyz.clone().requires_grad_(True)
    out = tapi.render(cam, scene.replace(xyz=xyz), bg, settings=settings, device=CPU)
    (g,) = torch.autograd.grad(torch.mean((out["render"] - target) ** 2), [xyz])
    return g


def test_oracle_xyz_gradient_matches_jax():
    w, h = 48, 40
    js = _random_scene(n=100, seed=6)
    jcam = _cam(w=w, h=h)
    target = np.random.default_rng(0).uniform(size=(h, w, 3)).astype(np.float32)

    def jloss(xyz):
        out = japi.render(jcam, js.replace(xyz=xyz), jnp.zeros(3), settings=J_ORACLE)
        return jnp.mean((out["render"] - jnp.asarray(target)) ** 2)

    jg = np.asarray(jax.grad(jloss)(js.xyz))
    tg = _xyz_grad_port(port_scene(js), port_cam(w=w, h=h), ORACLE, torch.zeros(3),
                        _t(target))
    np.testing.assert_allclose(tg.numpy(), jg, atol=1e-4 * np.abs(jg).max(), rtol=0)
    assert np.abs(jg).max() > 0


@pytest.mark.parametrize("seed", [0, 1])
def test_tiled_matches_oracle(seed):
    """`tests/test_rasterizer.py::TestTiledParity::test_matches_oracle` on
    the port's two renderers."""
    scene, cam = port_scene(_random_scene(n=150, seed=seed)), port_cam(w=80, h=48)
    o = tapi.render(cam, scene, torch.ones(3), settings=ORACLE, device=CPU)
    t = tapi.render(cam, scene, torch.ones(3), settings=T_TILED, device=CPU)
    assert not bool(o["overflow"]) and not bool(o["overflow_emit"])
    np.testing.assert_allclose(t["render"].numpy(), o["render"].numpy(), atol=2e-3)
    np.testing.assert_allclose(t["depth"].numpy(), o["depth"].numpy(), atol=2e-2)
    np.testing.assert_allclose(t["final_T"].numpy(), o["final_T"].numpy(), atol=2e-3)


def test_tiled_matches_oracle_with_jitter():
    scene, cam = port_scene(_random_scene(n=60, seed=2)), port_cam(w=32, h=32)
    off = _t(_offsets(32, 32, 0))
    o = tapi.render(cam, scene, torch.zeros(3), settings=ORACLE, sampling_offsets=off,
                    device=CPU)
    t = tapi.render(cam, scene, torch.zeros(3), settings=T_TILED, sampling_offsets=off,
                    device=CPU)
    np.testing.assert_allclose(t["render"].numpy(), o["render"].numpy(), atol=2e-3)


def test_tiled_gradient_matches_oracle_gradient():
    """`tests/test_rasterizer.py::TestGradients::test_tiled_grad_matches_oracle_grad`."""
    scene, cam = port_scene(_random_scene(n=40, seed=4)), port_cam(w=32, h=32)
    target = torch.zeros((32, 32, 3))
    g_o = _xyz_grad_port(scene, cam, ORACLE, torch.zeros(3), target)
    g_t = _xyz_grad_port(scene, cam, T_TILED, torch.zeros(3), target)
    np.testing.assert_allclose(g_t.numpy(), g_o.numpy(), atol=5e-5)


def test_golden_gate_through_the_oracle():
    data = np.load(os.path.join(GOLD, "render.npz"))
    scene = load_ply(os.path.join(GOLD, "scene.ply"), device=CPU).replace(active_sh_degree=3)
    cam = make_camera(data["R"], data["t"], fovx=float(data["fov"][0]),
                      fovy=float(data["fov"][1]), width=int(data["wh"][0]),
                      height=int(data["wh"][1]), device=CPU)
    out = tapi.render(cam, scene, torch.zeros(3), settings=ORACLE, device=CPU)
    mse = float(np.mean((out["render"].numpy() - data["color"]) ** 2))
    assert 20 * np.log10(1.0 / np.sqrt(mse)) > 45.0
    assert float(np.abs(out["depth"].numpy() - data["depth"]).max()) < 2e-2


def test_near_cull_renders_nothing():
    from tests.test_rasterizer import _scene_from

    s = port_scene(_scene_from([[0, 0, -10]], [[1, 0, 0]], [[0.3] * 3], [[0.9]]))
    out = tapi.render(port_cam(), s, torch.zeros(3), settings=ORACLE, device=CPU)
    assert float(out["render"].abs().max()) == 0.0
    assert not bool(out["visibility_filter"].any())


# ---- render's colour and covariance options -------------------------------------

OPTIONS = ["override_color", "convert_shs_python", "compute_cov3d_python"]


def _sh_scene():
    js = rotated_sh_scene(n=200, seed=21, deg=3)
    return js, port_scene(js)


def _override(js):
    """Colours away from 0, some above 1 and one below 0: taken as given."""
    c = np.random.default_rng(4).uniform(0.05, 1.2, size=(js.xyz.shape[0], 3))
    c[0] = [-0.2, 0.5, 1.3]
    return c.astype(np.float32)


def _jax_render(js, option, color=None, xyz=None, bg=None):
    scene = js if xyz is None else js.replace(xyz=xyz)
    bg = jnp.asarray([0.1, 0.2, 0.3]) if bg is None else bg
    kw = {"override_color": color} if option == "override_color" else {option: True}
    return japi.render(_cam(w=64, h=48, fov=0.9), scene, bg, 0.9, settings=J_TILED, **kw)


@pytest.mark.parametrize("option", OPTIONS)
def test_render_options_match_jax_and_the_default_render(option):
    js, ts = _sh_scene()
    color = _override(js)
    j = _jax_render(js, option, jnp.asarray(color) if option == "override_color" else None)
    kw = {"override_color": _t(color)} if option == "override_color" else {option: True}
    cam, bg = port_cam(w=64, h=48, fov=0.9), torch.tensor([0.1, 0.2, 0.3])
    t = tapi.render(cam, ts, bg, 0.9, settings=T_TILED, device=CPU, **kw)
    np.testing.assert_allclose(t["render"].numpy(), np.asarray(j["render"]), atol=3e-3)
    np.testing.assert_allclose(t["final_T"].numpy(), np.asarray(j["final_T"]), atol=3e-3)
    np.testing.assert_allclose(t["depth"].numpy(), np.asarray(j["depth"]), atol=3e-2)
    if option != "override_color":
        d = tapi.render(cam, ts, bg, 0.9, settings=T_TILED, device=CPU)
        for key, tol in (("render", 1e-5), ("depth", 1e-4), ("final_T", 1e-5)):
            np.testing.assert_allclose(t[key].numpy(), d[key].numpy(), atol=tol, rtol=0)
        torch.testing.assert_close(t["radii"], d["radii"], rtol=0, atol=0)
    else:
        own = tapi.preprocess_scene(cam, ts, 0.9).colors
        o = tapi.render(cam, ts, bg, 0.9, own, settings=T_TILED, device=CPU)
        d = tapi.render(cam, ts, bg, 0.9, settings=T_TILED, device=CPU)
        for key in ("render", "depth", "final_T", "radii"):
            torch.testing.assert_close(o[key], d[key], rtol=0, atol=0)


def test_override_color_is_taken_as_given():
    """A negative colour reaches the blend negative (no +0.5, no clamp): a
    lone splat of colour (-0.2, 0.5, 1.3) draws below the background in red
    and above 1 in blue."""
    from tests.test_rasterizer import _scene_from

    s = port_scene(_scene_from([[0, 0, 0]], [[0.5, 0.5, 0.5]], [[0.3] * 3], [[0.9]]))
    color = torch.tensor([[-0.2, 0.5, 1.3]]).expand(s.capacity, 3)
    out = tapi.render(port_cam(), s, torch.full((3,), 0.5), 1.0, color, settings=ORACLE,
                      device=CPU)
    center = out["render"][31:33, 31:33].mean((0, 1))
    assert float(center[0]) < 0.0 and float(center[2]) > 1.0


@pytest.mark.parametrize("option", OPTIONS)
def test_render_option_gradients_match_jax(option):
    """Gradients of one loss with respect to the option's own input (the
    override colours, the SH features, the scale and rotation) and to xyz,
    through the blend backward and the gradient reduction."""
    js, ts = _sh_scene()
    color = _override(js)
    target = np.random.default_rng(9).uniform(size=(48, 64, 3)).astype(np.float32)
    names = {"override_color": ["override_color", "xyz"],
             "convert_shs_python": ["features_dc", "features_rest", "xyz"],
             "compute_cov3d_python": ["scaling", "rotation", "xyz"]}[option]

    def jloss(leaves):
        fields = {k: v for k, v in leaves.items() if k != "override_color"}
        scene = js.replace(**fields)
        kw = ({"override_color": leaves["override_color"]} if option == "override_color"
              else {option: True})
        out = japi.render(_cam(w=64, h=48, fov=0.9), scene, jnp.zeros(3), 0.9,
                          settings=J_TILED, **kw)
        return jnp.mean((out["render"] - jnp.asarray(target)) ** 2 + 0.1 * out["depth"][..., None])

    jleaves = {k: (jnp.asarray(color) if k == "override_color" else getattr(js, k))
               for k in names}
    jg = jax.grad(jloss)(jleaves)

    leaves = {k: (_t(color) if k == "override_color" else getattr(ts, k).clone())
              .requires_grad_(True) for k in names}
    fields = {k: v for k, v in leaves.items() if k != "override_color"}
    kw = ({"override_color": leaves["override_color"]} if option == "override_color"
          else {option: True})
    out = tapi.render(port_cam(w=64, h=48, fov=0.9), ts.replace(**fields), torch.zeros(3),
                      0.9, settings=tapi.RasterizeSettings(renderer="pallas"), device=CPU,
                      **kw)
    loss = torch.mean((out["render"] - _t(target)) ** 2 + 0.1 * out["depth"][..., None])
    grads = torch.autograd.grad(loss, list(leaves.values()))
    for name, g in zip(leaves, grads):
        ref = np.asarray(jg[name])
        n = min(ref.shape[0], g.shape[0])
        scale = np.abs(ref).max()
        assert scale > 0, name
        np.testing.assert_allclose(g.numpy()[:n], ref[:n], atol=1e-4 * scale, rtol=0,
                                   err_msg=name)


# ---- preprocess with precomputed inputs ----------------------------------------

FLOAT_FIELDS = ("means2d", "depths", "conics", "colors", "opacities")


@pytest.mark.parametrize("precomp", ["colors", "cov3d", "both"])
def test_preprocess_precomputed_inputs_match_jax(precomp):
    js, ts = _sh_scene()
    jcam, tcam = _cam(w=80, h=48, fov=0.9), port_cam(w=80, h=48, fov=0.9)
    color = _override(js)
    cov = np.asarray(js.get_covariance(0.8))
    common = lambda s, c: dict(  # noqa: E731
        means3d=s.get_xyz, opacities=s.get_opacity, view_transform=c.view_transform,
        full_proj_transform=c.full_proj_transform, camera_center=c.camera_center,
        tan_fovx=c.tan_fovx, tan_fovy=c.tan_fovy, width=c.width, height=c.height,
        sh_degree=s.active_sh_degree, scaling_modifier=0.8, mask=s.mask)

    def extra(s, arr):
        kw = {}
        if precomp in ("colors", "both"):
            kw["colors_precomp"] = arr(color)
        else:
            kw["shs"] = s.get_features
        if precomp in ("cov3d", "both"):
            kw["cov3d_precomp"] = arr(cov)
        else:
            kw.update(scales=s.get_scaling, rotations=s.get_rotation)
        return kw

    j = jprep.preprocess(**common(js, jcam), **extra(js, jnp.asarray))
    t = tprep.preprocess(**common(ts, tcam), **extra(ts, _t))
    valid = np.asarray(j.valid)
    np.testing.assert_array_equal(t.valid.numpy(), valid)
    for f in FLOAT_FIELDS:
        ref = np.asarray(getattr(j, f))[valid]
        scale = max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(getattr(t, f).numpy()[valid], ref, atol=1e-5 * scale,
                                   rtol=0, err_msg=f)
    if precomp != "cov3d":
        np.testing.assert_array_equal(t.colors.numpy(), color)
    for f in ("radii", "extent_x", "extent_y"):
        diff = np.abs(getattr(t, f).numpy().astype(np.int64) - np.asarray(getattr(j, f)))
        assert diff.max(initial=0) <= 1 and np.count_nonzero(diff) <= 0.005 * diff.size, f


def test_preprocess_takes_exactly_one_of_each_pair():
    _, ts = _sh_scene()
    cam = port_cam()
    kw = dict(means3d=ts.get_xyz, opacities=ts.get_opacity, view_transform=cam.view_transform,
              full_proj_transform=cam.full_proj_transform, camera_center=cam.camera_center,
              tan_fovx=cam.tan_fovx, tan_fovy=cam.tan_fovy, width=64, height=64)
    with pytest.raises(ValueError, match="shs"):
        tprep.preprocess(**kw, scales=ts.get_scaling, rotations=ts.get_rotation)
    with pytest.raises(ValueError, match="cov3d"):
        tprep.preprocess(**kw, shs=ts.get_features)
    with pytest.raises(ValueError, match="cov3d"):
        tprep.preprocess(**kw, shs=ts.get_features, scales=ts.get_scaling,
                         rotations=ts.get_rotation, cov3d_precomp=ts.get_covariance())


# ---- transforms helpers ---------------------------------------------------------

def test_transforms_helpers_match_jax():
    rng = np.random.default_rng(8)
    s = rng.uniform(0.01, 0.5, (50, 3)).astype(np.float32)
    q = rng.normal(size=(50, 4)).astype(np.float32)
    jl = np.asarray(jtr.build_scaling_rotation(jnp.asarray(s), jnp.asarray(q)))
    tl = ttr.build_scaling_rotation(_t(s), _t(q))
    np.testing.assert_allclose(tl.numpy(), jl, atol=1e-6, rtol=0)
    cov = tl @ tl.transpose(-1, -2)
    jp = np.asarray(jtr.strip_symmetric(jnp.asarray(cov.numpy())))
    tp = ttr.strip_symmetric(cov)
    np.testing.assert_array_equal(tp.numpy(), jp)
    np.testing.assert_array_equal(ttr.unpack_symmetric(tp).numpy(),
                                  np.asarray(jtr.unpack_symmetric(jnp.asarray(jp))))
    torch.testing.assert_close(ttr.unpack_symmetric(tp), cov, rtol=0, atol=0)
    np.testing.assert_allclose(ttr.covariance_from_scaling_rotation(_t(s), 0.7, _t(q)).numpy(),
                               np.asarray(jtr.covariance_from_scaling_rotation(
                                   jnp.asarray(s), 0.7, jnp.asarray(q))), atol=1e-6, rtol=0)


# ---- render_batch --------------------------------------------------------------

@pytest.mark.parametrize("mode", ["map", "vmap"])
def test_render_batch_stacks_each_views_render(mode):
    scene = port_scene(_random_scene(n=200, seed=5))
    cams = [port_cam(w=64, h=48, eye=(x, 0.3, -5)) for x in (0.0, 0.8, -0.6)]
    out = trs.render_batch(cams, scene, torch.ones(3), T_TILED, mode, device=CPU)
    for i, cam in enumerate(cams):
        one = tapi.render(cam, scene, torch.ones(3), settings=T_TILED, device=CPU)
        for key, val in one.items():
            assert out[key].shape == (3, *val.shape), key
            torch.testing.assert_close(out[key][i], val, rtol=0, atol=0)
    with pytest.raises(ValueError, match="mode"):
        trs.render_batch(cams, scene, torch.ones(3), T_TILED, "scan", device=CPU)


def test_render_set_in_groups_writes_the_same_pngs(tmp_path):
    """`render_set(batch=3)` (what `cli.render --batch 3` calls) writes the
    PNGs of `batch=1` byte for byte, depth PNGs included, for 5 views (a
    short last group)."""
    scene = port_scene(_random_scene(n=200, seed=5))
    views = [(port_cam(w=48, h=32, eye=(x, 0.2, -5)), None) for x in (0.0, 0.5, -0.5, 1.0, -1.0)]
    dirs = {b: trs.render_set(str(tmp_path / f"b{b}"), "test", 1, views, scene, torch.ones(3),
                              T_TILED, save_depth=True, batch=b, device=CPU) for b in (1, 3)}
    for sub in ("renders", "depth"):
        names = sorted(os.listdir(os.path.join(dirs[1], sub)))
        assert names == sorted(os.listdir(os.path.join(dirs[3], sub))) and len(names) == 5
        for f in names:
            with open(os.path.join(dirs[1], sub, f), "rb") as a, \
                    open(os.path.join(dirs[3], sub, f), "rb") as b:
                assert a.read() == b.read(), (sub, f)
