"""The port's serving slice as a whole, on CPU, against the JAX package.

- the golden gate of `tests/test_golden_render.py` (PSNR > 45, depth error
  < 2e-2) through the port's `api.render`;
- a seeded random scene against JAX `api.render(renderer="tiled")`, with
  the tolerances the JAX kernel is held to (`tests/test_pallas_blend.py`):
  3e-3 on colour and final_T, 3e-2 on depth; radii as in
  `test_torch_preprocess.py` (exact but for ceil() ties);
- `render`'s positional order is JAX's (`render(cam, scene, bg, 0.5)`);
- `render_sets` through the port's CLI (`--no-fast`, the f32 tier) writes
  the same file tree as JAX
  `render_sets`, with images within 2/255 (a float difference can move an
  8-bit truncation across one step)."""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tests.test_datasets_eval import _make_blender_fixture
from tests.test_rasterizer import _cam, _random_scene, _scene_from
from tests.test_torch_scene import port_cam, port_scene
from wast3d_tpu.ops.rasterizer import api as japi
from wast3d_tpu.scene import datasets as jds
from wast3d_tpu.scene.ply import save_ply as jax_save_ply
from wast3d_tpu_torch.cli import render as tcli
from wast3d_tpu_torch.core.camera import make_camera
from wast3d_tpu_torch.ops.rasterizer import api as tapi
from wast3d_tpu_torch.scene.ply import load_ply

GOLD = os.path.join(os.path.dirname(__file__), "golden")
TILED = japi.RasterizeSettings(renderer="tiled", dup_capacity=1 << 14,
                               max_per_tile=512, chunk=16)


def psnr(a, b):
    return float(20.0 * np.log10(1.0 / np.sqrt(np.mean((a - b) ** 2))))


@pytest.mark.parametrize("renderer", ["torch", "cuda"])
def test_golden_gate(renderer):
    """renderer="cuda" on CPU tensors runs K1's plain version (its wrapper
    takes it for CPU tensors), so both settings must meet the gate."""
    data = np.load(os.path.join(GOLD, "render.npz"))
    scene = load_ply(os.path.join(GOLD, "scene.ply"), device="cpu").replace(active_sh_degree=3)
    cam = make_camera(data["R"], data["t"], fovx=float(data["fov"][0]),
                      fovy=float(data["fov"][1]), width=int(data["wh"][0]),
                      height=int(data["wh"][1]), device="cpu")
    out = tapi.render(cam, scene, torch.zeros(3),
                      settings=tapi.RasterizeSettings(renderer=renderer), device="cpu")
    assert not bool(out["overflow"])
    p = psnr(out["render"].numpy(), data["color"])
    assert p > 45.0, p
    d_err = float(np.abs(out["depth"].numpy() - data["depth"]).max())
    assert d_err < 2e-2, d_err


@pytest.mark.parametrize("seed,jitter,size", [(0, False, (64, 64)), (1, False, (50, 34)),
                                              (2, True, (64, 48))])
def test_random_scene_matches_jax_tiled(seed, jitter, size):
    w, h = size
    js = _random_scene(n=200, seed=seed)
    bg = np.array([1.0, 1.0, 1.0], np.float32)
    offsets = (-np.random.default_rng(seed).uniform(0, 1, (h, w, 2)).astype(np.float32)
               if jitter else None)
    j = japi.render(_cam(w=w, h=h), js, jnp.asarray(bg), settings=TILED,
                    sampling_offsets=None if offsets is None else jnp.asarray(offsets))
    t = tapi.render(port_cam(w=w, h=h), port_scene(js), torch.from_numpy(bg),
                    settings=tapi.RasterizeSettings(renderer="torch"),
                    sampling_offsets=None if offsets is None else torch.from_numpy(offsets),
                    device="cpu")
    assert not bool(j["overflow"])
    assert t["render"].shape == (h, w, 3)
    np.testing.assert_allclose(t["render"].numpy(), np.asarray(j["render"]), atol=3e-3)
    np.testing.assert_allclose(t["final_T"].numpy(), np.asarray(j["final_T"]), atol=3e-3)
    np.testing.assert_allclose(t["depth"].numpy(), np.asarray(j["depth"]), atol=3e-2)
    dr = np.abs(t["radii"].numpy().astype(np.int64) - np.asarray(j["radii"]))
    assert dr.max() <= 1 and np.count_nonzero(dr) <= 0.005 * dr.size
    np.testing.assert_array_equal(t["visibility_filter"].numpy(),
                                  np.asarray(j["visibility_filter"]))


def test_positional_order_is_jaxs():
    """`render(cam, scene, bg, 0.5)` scales the splats by 0.5, as JAX's
    positional call does: the same image as the keyword call, and JAX's
    within the tolerances of `test_random_scene_matches_jax_tiled`."""
    w, h = 64, 48
    js = _random_scene(n=200, seed=3)
    bg = np.array([0.2, 0.4, 0.6], np.float32)
    cam, scene = port_cam(w=w, h=h), port_scene(js)
    pos = tapi.render(cam, scene, torch.from_numpy(bg), 0.5, None,
                      tapi.RasterizeSettings(renderer="torch"), device="cpu")
    kw = tapi.render(cam, scene, torch.from_numpy(bg), scaling_modifier=0.5,
                     settings=tapi.RasterizeSettings(renderer="torch"), device="cpu")
    full = tapi.render(cam, scene, torch.from_numpy(bg), device="cpu",
                       settings=tapi.RasterizeSettings(renderer="torch"))
    j = japi.render(_cam(w=w, h=h), js, jnp.asarray(bg), 0.5, None, TILED)
    for key in ("render", "depth", "final_T", "radii"):
        torch.testing.assert_close(pos[key], kw[key], rtol=0, atol=0)
    assert not torch.equal(pos["render"], full["render"])
    assert int(pos["radii"].sum()) < int(full["radii"].sum())
    np.testing.assert_allclose(pos["render"].numpy(), np.asarray(j["render"]), atol=3e-3)
    np.testing.assert_allclose(pos["final_T"].numpy(), np.asarray(j["final_T"]), atol=3e-3)
    np.testing.assert_allclose(pos["depth"].numpy(), np.asarray(j["depth"]), atol=3e-2)


def test_override_color_matches_jax():
    """Precomputed colours in the positional slot after the scaling
    modifier, as in JAX: taken as given (one row negative, some above 1),
    within the tolerances of `test_random_scene_matches_jax_tiled`."""
    js = _random_scene(n=200, seed=4)
    n = int(js.xyz.shape[0])
    color = np.random.default_rng(4).uniform(-0.2, 1.3, (n, 3)).astype(np.float32)
    bg = np.array([0.2, 0.4, 0.6], np.float32)
    j = japi.render(_cam(w=64, h=48), js, jnp.asarray(bg), 1.0, jnp.asarray(color), TILED)
    t = tapi.render(port_cam(w=64, h=48), port_scene(js), torch.from_numpy(bg), 1.0,
                    torch.from_numpy(color), tapi.RasterizeSettings(renderer="torch"),
                    device="cpu")
    np.testing.assert_allclose(t["render"].numpy(), np.asarray(j["render"]), atol=3e-3)
    np.testing.assert_allclose(t["final_T"].numpy(), np.asarray(j["final_T"]), atol=3e-3)
    np.testing.assert_allclose(t["depth"].numpy(), np.asarray(j["depth"]), atol=3e-2)
    assert float(t["render"].min()) < 0.0


def test_random_sampling_offsets_range():
    g = torch.Generator().manual_seed(0)
    off = tapi.random_sampling_offsets(g, 30, 20)
    assert off.shape == (30, 20, 2) and off.dtype == torch.float32
    assert float(off.max()) <= 0.0 and float(off.min()) > -1.0


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def test_render_sets_tree_matches_jax(tmp_path):
    src = str(tmp_path / "scene")
    _make_blender_fixture(src)
    rng = np.random.default_rng(0)
    jds.store_ply_points(os.path.join(src, "points3d.ply"),
                         rng.uniform(-1, 1, (200, 3)), rng.uniform(0, 255, (200, 3)))
    # In front of the fixture's cameras (at z ~ -4, looking down -z).
    n = 150
    scene = _scene_from(
        xyz=rng.normal(size=(n, 3)) * [0.8, 0.8, 0.3] + [0, 0, -7],
        rgb=rng.uniform(0.1, 0.9, (n, 3)), scale=rng.uniform(0.05, 0.2, (n, 3)),
        opacity=rng.uniform(0.3, 0.95, (n, 1)))
    jmodel, tmodel = str(tmp_path / "jax_model"), str(tmp_path / "port_model")
    jax_save_ply(scene, os.path.join(jmodel, "point_cloud", "iteration_7", "point_cloud.ply"))
    shutil.copytree(jmodel, tmodel)

    from wast3d_tpu.eval.render_sets import render_sets as jax_render_sets

    jax_render_sets(jmodel, src, settings=TILED, autoplan=False)
    tcli.main(["-m", tmodel, "-s", src, "--no-fast", "--device", "cpu"])  # the f32 tier
    files = _tree(jmodel)
    assert files == _tree(tmodel)
    pngs = [f for f in files if f.endswith(".png")]
    assert len(pngs) == 6  # 3 renders + 3 gt of the train split
    for f in pngs:
        a = np.asarray(Image.open(os.path.join(jmodel, f)), np.int32)
        b = np.asarray(Image.open(os.path.join(tmodel, f)), np.int32)
        assert np.abs(a - b).max() <= 2, f
    ren = np.asarray(Image.open(os.path.join(tmodel, "train/ours_7/renders/00000.png")))
    assert ren.max() > 50  # the splats are in view, not an empty frame
