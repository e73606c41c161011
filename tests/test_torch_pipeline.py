"""The WaSt-3D pipeline on the port (`cli.pipeline` and what it adds:
`train/spheres.py`, `config.SphereConfig`, the `sphere_cfg` hook of the
train step, `eval/camera_path.py`) against the JAX package, on the CPU.

Tolerances, with their reasons:
- sphere losses and their gradients rtol 1e-5 (the same float32 formulas,
  summed in another order);
- train steps with a sphere config as `test_torch_train.py` holds them
  without one (Adam amplifies last-bit gradient differences);
- cameras: view and projection matrices within 1e-6 (float32 products of
  the same float64 matrices);
- frames within 2/255 (a float difference can move an 8-bit truncation one
  step, as in `test_torch_render.py`);
- `cli.pipeline --skip_recon`: the cluster files as
  `test_torch_stylize_ops.py` holds `export_clusters`, the stylized PLY as
  `test_torch_stylize.py` holds `stylize_scene` (from one descriptor state,
  with that test's small `StylizeConfig`: the CLI's stylization takes the
  default one, whose 1000 fit steps over 80 content clusters are for a
  card), the turntable frames within 2/255."""

import dataclasses
import functools
import json
import math
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tests.test_rasterizer import _cam, _random_scene, _scene_from
from tests.test_torch_stylize import PIPE_KW, _converted
from tests.test_torch_train import LRS, PLAIN, TILED, blender_scene, port_state, state_to_numpy
from wast3d_tpu import config as jcfg
from wast3d_tpu.eval import camera_path as jcp
from wast3d_tpu.scene.ply import save_ply as jax_save_ply
from wast3d_tpu.train import reconstruct as JR
from wast3d_tpu.train import spheres as jsph
from wast3d_tpu_torch import config as tcfg
from wast3d_tpu_torch.cli import pipeline as tpipe_cli
from wast3d_tpu_torch.cli import train as tcli
from wast3d_tpu_torch.eval import camera_path as tcp
from wast3d_tpu_torch.scene.ply import load_ply
from wast3d_tpu_torch.train import reconstruct as TR
from wast3d_tpu_torch.train import spheres as tsph
from wast3d_tpu_torch.utils.png import read_png

MODES = ["isotropic", "anisotropic", "anisotropic_simple"]
RTOL = 1e-5
CAM_ATOL = 1e-6
FRAME_TOL = 2  # of 255


def jax_sphere_cfg(mode):
    """The SphereConfig `wast3d_tpu.cli.train` builds for a mode."""
    if mode == "isotropic":
        return jcfg.SphereConfig()
    return jcfg.SphereConfig(anisotropic=True, anisotropy_ratio=1.3, lambda_anisotropy=0.1,
                             lambda_min_scale=0.5 if mode == "anisotropic" else 0.0)


def test_sphere_config_matches_jax():
    assert [f.name for f in dataclasses.fields(tcfg.SphereConfig)] == \
        [f.name for f in dataclasses.fields(jcfg.SphereConfig)]
    assert dataclasses.asdict(tcfg.SphereConfig()) == dataclasses.asdict(jcfg.SphereConfig())
    assert set(tcfg._GROUPS) == set(jcfg._GROUPS)
    assert all(tcfg._GROUPS[k].__name__ == v.__name__ for k, v in jcfg._GROUPS.items())
    for mode in MODES:
        assert dataclasses.asdict(tcli.sphere_config(mode)) == \
            dataclasses.asdict(jax_sphere_cfg(mode))
    assert tcli.sphere_config("none") is None


def log_scales(seed=0, n=64, dead=9):
    """Seeded log-scales of mixed anisotropy and a mask with `dead` slots."""
    rng = np.random.default_rng(seed)
    s = (rng.normal(size=(n, 3)) * 0.8 - 3.0).astype(np.float32)
    s[: n // 4] = s[: n // 4, :1]  # some isotropic rows
    mask = np.ones(n, bool)
    mask[-dead:] = False
    return s, mask


LOSSES = {
    "isotropy": lambda mod, s, m: mod.scaling_isotropy_loss(s, m),
    "uniformity": lambda mod, s, m: mod.scaling_uniformity_loss(s, m),
    "anisotropy_1.3": lambda mod, s, m: mod.scaling_anisotropy_loss(s, m, 1.3),
    "anisotropy_2.0": lambda mod, s, m: mod.scaling_anisotropy_loss(s, m, 2.0),
    "min_val": lambda mod, s, m: mod.scaling_min_val_loss(s, m),
}


def check_loss_and_grad(jax_fn, port_fn, s, mask):
    jl, jg = jax.value_and_grad(lambda x: jax_fn(x, jnp.asarray(mask)))(jnp.asarray(s))
    t = torch.from_numpy(s).requires_grad_(True)
    tl = port_fn(t, torch.from_numpy(mask))
    (tg,) = torch.autograd.grad(tl, [t])
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=RTOL)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=RTOL,
                               atol=RTOL * float(np.abs(jg).max()))
    assert not tg[~torch.from_numpy(mask)].any()  # dead slots take no part
    return float(tl.detach())


@pytest.mark.parametrize("name", sorted(LOSSES))
@pytest.mark.parametrize("seed", [0, 1])
def test_sphere_losses_match_jax(name, seed):
    s, mask = log_scales(seed)
    value = check_loss_and_grad(functools.partial(LOSSES[name], jsph),
                                functools.partial(LOSSES[name], tsph), s, mask)
    assert value > 0.0


@pytest.mark.parametrize("mode", MODES)
def test_sphere_regularizer_matches_jax(mode):
    s, mask = log_scales(2)

    def jax_fn(x, m):
        return jsph.sphere_regularizer(types.SimpleNamespace(scaling=x, mask=m),
                                       jax_sphere_cfg(mode))

    def port_fn(x, m):
        return tsph.sphere_regularizer(types.SimpleNamespace(scaling=x, mask=m),
                                       tcli.sphere_config(mode))

    check_loss_and_grad(jax_fn, port_fn, s, mask)
    # the plain means of an all-active scene are the masked means
    full = np.ones_like(mask)
    a = port_fn(torch.from_numpy(s[mask]), torch.from_numpy(full[mask]))
    b = jax_fn(jnp.asarray(s), jnp.asarray(mask))
    np.testing.assert_allclose(float(a), float(b), rtol=RTOL)


@pytest.mark.parametrize("mode", MODES)
def test_train_steps_with_spheres_match_jax(mode):
    """Three train steps with each sphere config, as
    `test_torch_train.py::test_train_steps_match_jax` runs them without."""
    w = h = 64
    steps = 3
    js = _random_scene(n=200, seed=3)
    gt = np.random.default_rng(0).uniform(0, 1, (h, w, 3)).astype(np.float32)
    bg = np.zeros(3, np.float32)
    jst = JR.init_train_state(js, jcfg.OptimizationConfig(), spatial_lr_scale=2.0)
    tst = port_state(jst)
    jsc, tsc = jax_sphere_cfg(mode), tcli.sphere_config(mode)
    for _ in range(steps):
        jst, jaux = JR.train_step(jst, _cam(w=w, h=h), jnp.asarray(gt), jnp.asarray(bg),
                                  jax.random.PRNGKey(0), opt_cfg=jcfg.OptimizationConfig(),
                                  settings=TILED, width=w, height=h, spatial_lr_scale=2.0,
                                  sphere_cfg=jsc, jitter=False)
        tst, taux = TR.train_step(tst, port_cam_64(), torch.from_numpy(gt),
                                  torch.from_numpy(bg), None, opt_cfg=tcfg.OptimizationConfig(),
                                  settings=PLAIN, width=w, height=h, spatial_lr_scale=2.0,
                                  sphere_cfg=tsc, jitter=False)
        np.testing.assert_allclose(float(taux["loss"]), float(jaux["loss"]), rtol=1e-5)
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
    # the regulariser moved the log-scales: its gradient reached Adam
    no_sphere = port_state(JR.init_train_state(js, jcfg.OptimizationConfig(), 2.0))
    for _ in range(steps):
        no_sphere, _ = TR.train_step(no_sphere, port_cam_64(), torch.from_numpy(gt),
                                     torch.from_numpy(bg), None,
                                     opt_cfg=tcfg.OptimizationConfig(), settings=PLAIN,
                                     width=w, height=h, spatial_lr_scale=2.0, jitter=False)
    assert not torch.equal(no_sphere.opt_state.mu["scaling"], tst.opt_state.mu["scaling"])


def port_cam_64():
    from tests.test_torch_scene import port_cam

    return port_cam(w=64, h=64)


def captured_train_scene_kwargs(monkeypatch, argv):
    """The keyword arguments each package's `cli.train` hands `train_scene`
    for the same command line."""
    from wast3d_tpu.cli import train as jcli
    from wast3d_tpu.train import driver as jdriver
    from wast3d_tpu.viewer import network_gui
    from wast3d_tpu_torch.train import driver as tdriver

    got = {}
    monkeypatch.setattr(jdriver, "train_scene", lambda **k: got.setdefault("jax", k))
    monkeypatch.setattr(tdriver, "train_scene", lambda **k: got.setdefault("port", k))
    monkeypatch.setattr(network_gui, "maybe_start", lambda *a: None)
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    jcli.main()
    tcli.main(argv + ["--device", "cpu"])
    return got["jax"], got["port"]


@pytest.mark.parametrize("mode", ["none"] + MODES)
def test_cli_train_sphere_mode_builds_jaxs_config(monkeypatch, mode):
    j, t = captured_train_scene_kwargs(monkeypatch, ["-s", "src", "-m", "out", "--iterations",
                                                     "10", "--sphere_mode", mode])
    if mode == "none":
        assert j["sphere_cfg"] is None and t["sphere_cfg"] is None
    else:
        assert dataclasses.asdict(t["sphere_cfg"]) == dataclasses.asdict(j["sphere_cfg"])
    assert dataclasses.asdict(t["opt_cfg"]) == dataclasses.asdict(j["opt_cfg"])
    assert t["iterations"] == j["iterations"] == 10


def test_cli_train_sphere_mode_trains(tmp_path):
    src, model = str(tmp_path / "scene"), str(tmp_path / "model")
    blender_scene(src)
    tcli.main(["-s", src, "-m", model, "--iterations", "4", "--save_iterations", "4",
               "--sphere_mode", "anisotropic", "--renderer", "torch", "--quiet",
               "--device", "cpu"])
    log = [json.loads(line) for line in open(os.path.join(model, "log.jsonl"))]
    report = [e for e in log if "psnr_train" in e]
    assert report[-1]["iter"] == 4 and math.isfinite(report[-1]["psnr_train"])
    assert os.path.exists(os.path.join(model, "point_cloud", "iteration_4", "point_cloud.ply"))


# ---- camera paths ------------------------------------------------------------------

def assert_cameras_match(tcams, jcams):
    assert len(tcams) == len(jcams) > 0
    for a, b in zip(tcams, jcams):
        for f in ("view_transform", "full_proj_transform", "camera_center"):
            np.testing.assert_allclose(getattr(a, f).numpy(), np.asarray(getattr(b, f)),
                                       rtol=0, atol=CAM_ATOL, err_msg=f)
        assert (a.width, a.height) == (b.width, b.height)
        np.testing.assert_allclose([a.fovx, a.fovy], [float(b.fovx), float(b.fovy)], rtol=1e-7)


def test_spiral_path_matches_jax():
    center = np.array([0.1, -0.2, 0.3])
    kw = dict(num_frames=7, fov=0.9, width=64, height=48, revolutions=1.5)
    assert_cameras_match(tcp.spiral_path(center, 3.0, 0.6, device="cpu", **kw),
                         jcp.spiral_path(center, 3.0, 0.6, **kw))


def keyframe_file(path):
    """A nerfstudio-style keyframe path: three camera-to-world matrices
    (column-major, as JSON strings) around the origin, with their fovs."""
    keyframes = []
    for i, (ang, fov) in enumerate([(0.0, 50.0), (0.7, 40.0), (1.6, 60.0)]):
        eye = np.array([4 * math.sin(ang), 0.5 * i, 4 * math.cos(ang)])
        z = eye / np.linalg.norm(eye)  # OpenGL: the camera looks down -z
        x = np.cross([0.0, 1.0, 0.0], z)
        x /= np.linalg.norm(x)
        c2w = np.eye(4)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x, np.cross(z, x), z, eye
        keyframes.append({"matrix": json.dumps(c2w.T.reshape(-1).tolist()), "fov": fov})
    with open(path, "w") as f:
        json.dump({"keyframes": keyframes}, f)


def test_load_camera_path_matches_jax(tmp_path):
    path = str(tmp_path / "path.json")
    keyframe_file(path)
    t = tcp.load_camera_path(path, width=64, height=48, frames_per_segment=5, device="cpu")
    j = jcp.load_camera_path(path, width=64, height=48, frames_per_segment=5)
    assert len(t) == 2 * 5 + 1
    assert_cameras_match(t, j)


def frame_scene(seed=0, n=150):
    rng = np.random.default_rng(seed)
    return _scene_from(xyz=rng.normal(size=(n, 3)) * 0.6,
                       rgb=rng.uniform(0.1, 0.9, (n, 3)), scale=rng.uniform(0.03, 0.15, (n, 3)),
                       opacity=rng.uniform(0.3, 0.95, (n, 1)))


def assert_frames_match(tpaths, jpaths):
    assert [os.path.basename(p) for p in tpaths] == [os.path.basename(p) for p in jpaths]
    for a, b in zip(tpaths, jpaths):
        x = read_png(a).astype(np.int32)
        y = np.asarray(Image.open(b).convert("RGB"), np.int32)
        assert x.shape == y.shape and np.abs(x - y).max() <= FRAME_TOL, a
    assert max(read_png(p).max() for p in tpaths) > 50  # the scene is in view


def test_render_path_matches_jax(tmp_path):
    from tests.test_torch_scene import port_scene

    js = frame_scene()
    kw = dict(num_frames=3, width=64, height=48)
    jpaths = jcp.render_path(js, jcp.spiral_path(np.zeros(3), 4.0, 0.8, **kw),
                             str(tmp_path / "jax"), save_depth=True)
    tpaths = tcp.render_path(port_scene(js), tcp.spiral_path(np.zeros(3), 4.0, 0.8,
                                                              device="cpu", **kw),
                             str(tmp_path / "port"), save_depth=True, device="cpu")
    assert_frames_match(tpaths, jpaths)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))


# ---- the pipeline CLI ---------------------------------------------------------------

def style_scene(seed=1):
    """Three 7 x 7 grids far apart: k-means finds each grid, in both packages."""
    rng = np.random.default_rng(seed)
    g = np.stack(np.meshgrid(np.linspace(-1, 1, 7), np.linspace(-1, 1, 7)), -1).reshape(-1, 2)
    grid = np.concatenate([g, np.zeros((49, 1))], 1) * 0.3
    xyz = np.concatenate([grid + off for off in ([0, 0, 0], [5, 0, 0], [0, 5, 0])])
    return _scene_from(xyz=xyz, rgb=rng.uniform(0.2, 0.9, (147, 3)),
                       scale=np.full((147, 3), 0.02), opacity=np.full((147, 1), 0.9))


def content_scene(seed=0, n=300):
    """A 300-point unit sphere, the content of `test_torch_stylize.py`."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3))
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    return _scene_from(xyz=pts, rgb=rng.uniform(0.2, 0.9, (n, 3)),
                       scale=np.full((n, 3), 0.05), opacity=np.full((n, 1), 0.8))


def small_stylize(monkeypatch, module, cfg):
    """The pipeline CLI's `stylize_scene` (imported at call time) with the
    small config of `test_torch_stylize.py`."""
    monkeypatch.setattr(module, "stylize_scene",
                        functools.partial(module.stylize_scene, cfg=cfg))


def test_cli_pipeline_skip_recon_matches_jax(tmp_path, monkeypatch):
    from wast3d_tpu.cli import pipeline as jpipe_cli
    from wast3d_tpu.config import StylizeConfig as JCfg
    from wast3d_tpu.stylize import fit as jfit
    from wast3d_tpu.stylize import pipeline as jpipe
    from wast3d_tpu.stylize.cluster import load_cluster as j_load_cluster
    from wast3d_tpu_torch.config import StylizeConfig as TCfg
    from wast3d_tpu_torch.stylize import fit as tfit
    from wast3d_tpu_torch.stylize import pipeline as tpipe

    iters, frames = 7, 2
    work = {k: str(tmp_path / k) for k in ("jax", "port")}
    for w in work.values():
        for name, scene in (("content", content_scene()), ("style", style_scene())):
            jax_save_ply(scene, os.path.join(w, name, "point_cloud", f"iteration_{iters}",
                                             "point_cloud.ply"))
    argv = ["--content_data", "none", "--style_data", "none", "--iterations", str(iters),
            "--num_clusters", "3", "--style_cluster_index", "1", "--skip_recon",
            "--turntable_frames", str(frames)]
    monkeypatch.setenv("WAST3D_NO_CACHE", "1")
    small_stylize(monkeypatch, jpipe, JCfg(**PIPE_KW))
    small_stylize(monkeypatch, tpipe, TCfg(**PIPE_KW))

    monkeypatch.setattr(sys, "argv", ["pipeline", *argv, "--workdir", work["jax"]])
    jpipe_cli.main()
    # the port's fit starts from the JAX descriptor state of the same patch
    jpatch = jpipe.clean_style_patch(j_load_cluster(
        os.path.join(work["jax"], "style_clusters", "cluster_1.npz")))
    jtd = jfit.compute_target_descriptors(jpatch.xyz, JCfg(**PIPE_KW))
    monkeypatch.setattr(tfit, "compute_target_descriptors", lambda *a, **k: _converted(jtd))
    report = tpipe_cli.main([*argv, "--workdir", work["port"], "--device", "cpu"])

    for i in range(3):
        with np.load(os.path.join(work["jax"], "style_clusters", f"cluster_{i}.npz")) as a, \
                np.load(os.path.join(work["port"], "style_clusters", f"cluster_{i}.npz")) as b:
            assert set(a.files) == set(b.files)
            for k in a.files:
                np.testing.assert_allclose(b[k], a[k], atol=1e-6, err_msg=k)
    from wast3d_tpu.scene.ply import load_ply as jax_load_ply

    j = jax_load_ply(os.path.join(work["jax"], "stylized.ply"))
    t = load_ply(os.path.join(work["port"], "stylized.ply"), device="cpu")
    n = int(np.asarray(j.mask).sum())
    assert t.capacity == n == report["stylized_n"] > 40
    np.testing.assert_allclose(t.xyz.numpy(), np.asarray(j.xyz)[:n], rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(t.scaling.numpy(), np.asarray(j.scaling)[:n])
    turn = {k: sorted(os.path.join(w, "turntable", f)
                      for f in os.listdir(os.path.join(w, "turntable")))
            for k, w in work.items()}
    assert len(turn["port"]) == report["frames"] == frames
    assert_frames_match(turn["port"], turn["jax"])
    assert set(report["stage_s"]) == {"content", "style", "clusters", "stylize", "turntable"}


def write_dataset(root, scene, res=64, views=3):
    """A Blender-format dataset of `scene` (a JAX scene) at res x res: views
    on a circle at distance 4, images from the port's plain renderer, and a
    points3d.ply of the scene's own points."""
    from tests.test_torch_scene import port_scene
    from wast3d_tpu_torch.eval.render_sets import save_image
    from wast3d_tpu_torch.ops.rasterizer import api
    from wast3d_tpu_torch.scene import datasets

    os.makedirs(root, exist_ok=True)
    frames = []
    for i in range(views):
        a = 2 * math.pi * i / views
        eye = np.array([4 * math.sin(a), 0.4, -4 * math.cos(a)])
        z = eye / np.linalg.norm(eye)
        x = np.cross([0.0, 1.0, 0.0], z)
        x /= np.linalg.norm(x)
        c2w = np.eye(4)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x, np.cross(z, x), z, eye
        save_image(os.path.join(root, f"r_{i}.png"), np.zeros((res, res, 3)))
        frames.append({"file_path": f"./r_{i}", "transform_matrix": c2w.tolist()})
    with open(os.path.join(root, "transforms_train.json"), "w") as f:
        json.dump({"camera_angle_x": 0.9, "frames": frames}, f)
    xyz = np.asarray(scene.xyz)[np.asarray(scene.mask)]
    datasets.store_ply_points(os.path.join(root, "points3d.ply"), xyz,
                              np.full(xyz.shape, 128.0))
    info = datasets.load_scene_info(root)
    ts = port_scene(scene)
    for ci, (cam, _) in zip(info.train_cameras,
                            datasets.build_cameras(info.train_cameras, device="cpu")):
        out = api.render(cam, ts, torch.zeros(3), device="cpu",
                         settings=api.RasterizeSettings(renderer="torch"))
        save_image(os.path.join(root, ci.image_name + ".png"), out["render"].numpy())


def test_cli_pipeline_runs_on_cpu(tmp_path, monkeypatch):
    """All five stages through the port alone, from two datasets at 64 x 64:
    a few iterations each, two turntable frames."""
    from wast3d_tpu_torch.config import StylizeConfig as TCfg
    from wast3d_tpu_torch.stylize import pipeline as tpipe

    content, style, work = (str(tmp_path / k) for k in ("content", "style", "work"))
    write_dataset(content, content_scene())
    write_dataset(style, style_scene())
    small_stylize(monkeypatch, tpipe, TCfg(**PIPE_KW))
    report = tpipe_cli.main(["--content_data", content, "--style_data", style,
                             "--workdir", work, "--iterations", "3", "--num_clusters", "3",
                             "--sphere_mode", "anisotropic_simple", "--turntable_frames", "2",
                             "--device", "cpu"])
    for name, n in (("content", 300), ("style", 147)):
        ply = os.path.join(work, name, "point_cloud", "iteration_3", "point_cloud.ply")
        assert load_ply(ply, device="cpu").capacity == n  # no densify in 3 iterations
    assert sorted(os.listdir(os.path.join(work, "style_clusters"))) == \
        [f"cluster_{i}.npz" for i in range(3)]
    out = load_ply(os.path.join(work, "stylized.ply"), device="cpu")
    assert out.capacity == report["stylized_n"] > 0 and bool(torch.isfinite(out.xyz).all())
    frames = sorted(os.listdir(os.path.join(work, "turntable")))
    assert frames == ["00000.png", "00001.png"] and report["frames"] == 2
    assert read_png(os.path.join(work, "turntable", frames[0])).shape == (800, 800, 3)


def test_cli_pipeline_flags_match_jax(monkeypatch):
    from tests.test_torch_stylize import _flags, _jax_parser
    from wast3d_tpu.cli import pipeline as jpipe_cli

    j, t = _flags(_jax_parser(jpipe_cli)), _flags(tpipe_cli.build_parser())
    assert set(t) - set(j) == {"--device"} and set(j) <= set(t)
    for opt, val in j.items():
        assert t[opt] == val, opt
    # more CUDA ranks than cards raise before any stage runs
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="2 CUDA ranks need 2 cards"):
        tpipe_cli.main(["--content_data", "a", "--style_data", "b", "--workdir", "c",
                        "--devices", "2", "--device", "cuda"])
