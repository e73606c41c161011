"""Port parity: evaluation (VGG, LPIPS, depth ops, TV, metrics, render_set
depth PNGs, probe, the metrics and full_eval CLIs) and neural style
transfer, against the JAX package, on the CPU.

Inputs are made from numpy seeds. Tolerances, with their reasons:
- VGG19 features: each captured layer within 1e-4 of its largest |value|
  (the same float32 convolutions summed in another order; measured ~3e-6);
  content, style and Gram rtol 1e-4, their image gradients 1e-4 of the
  largest;
- LPIPS: 1e-5 absolute (a sum of channel-normalised squared differences);
- depth -> normals and blur: values and gradients 1e-5 (a few float32
  roundings on unit-scale maps);
- TV: rtol 1e-6;
- metrics from the same PNGs: PSNR 1e-4 dB, SSIM 1e-5, LPIPS_PROXY 1e-5;
- depth PNGs: at most 1/255 (one truncation step of the 8-bit write);
- probe arrays: rgb and depth 1e-5 (the plain render agrees with JAX
  `tiled` to ~1e-6); normals 1e-4: a normal is the direction of depth
  differences, so where depth fades to 0 at a silhouette's fringe a
  ~1e-7 depth difference turns it by its relative size (measured 2.8e-5);
- style transfer: losses and image rtol 1e-4 (two Adam steps on the VGG
  gradient).
"""

import importlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_rasterizer import _cam, _random_scene
from tests.test_torch_scene import port_cam, port_scene
from tests.test_torch_stylize import _flags, _jax_parser
from wast3d_tpu.ops import depth as jdepth
from wast3d_tpu.ops import image_losses as jloss
from wast3d_tpu.ops import lpips as jlpips
from wast3d_tpu.ops import vgg as jvgg
from wast3d_tpu.ops.rasterizer import api as japi
from wast3d_tpu_torch.ops import depth as tdepth
from wast3d_tpu_torch.ops import image_losses as tloss
from wast3d_tpu_torch.ops import lpips as tlpips
from wast3d_tpu_torch.ops import vgg as tvgg
from wast3d_tpu_torch.ops.rasterizer import api as tapi
from wast3d_tpu_torch.utils.png import write_png

JSET = japi.RasterizeSettings(renderer="tiled", dup_capacity=1 << 12, max_per_tile=128,
                              chunk=16, grad_reduce="scatter")
TSET = tapi.RasterizeSettings(renderer="tiled")


def _image(shape, seed):
    return np.random.default_rng(seed).uniform(size=shape).astype(np.float32)


def _assert_layers_close(got, want, rel=1e-4):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        g = g.detach().numpy()
        assert g.shape == w.shape, (i, g.shape, w.shape)
        assert np.abs(g - w).max() <= rel * np.abs(w).max(), i


# ---- VGG -----------------------------------------------------------------------

def test_random_weights_are_jaxs():
    j, t = jvgg.init_random_params(3), tvgg.init_random_params(3)
    assert list(t) == list(j)
    for k in j:
        np.testing.assert_array_equal(t[k], j[k])


@pytest.mark.parametrize("source", ["random", "npz", "pth"])
def test_vgg_features_match_jax(source, tmp_path):
    """vgg_features on a 32^2 image, from the random weights and from a
    torchvision-keyed state dict written as .npz and as .pth."""
    if source == "random":
        path = None
    else:
        rng = np.random.default_rng(1)
        sd = {k: (rng.normal(0, 0.05, v.shape)).astype(np.float32)
              for k, v in jvgg.init_random_params(0).items()}
        path = str(tmp_path / f"vgg19.{source}")
        if source == "npz":
            np.savez(path, **sd)
        else:
            torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    jp, tp = jvgg.load_weights(path), tvgg.load_weights(path)
    img = _image((32, 32, 3), 2)
    _assert_layers_close(tvgg.vgg_features(tp, torch.from_numpy(img)),
                         jvgg.vgg_features(jp, jnp.asarray(img)))


def test_load_weights_reads_the_environment_variable(tmp_path, monkeypatch):
    sd = {k: v + 1.0 for k, v in jvgg.init_random_params(0).items()}
    np.savez(tmp_path / "w.npz", **sd)
    monkeypatch.setenv("WAST3D_VGG19_WEIGHTS", str(tmp_path / "w.npz"))
    got = tvgg.load_weights()
    for k in sd:
        np.testing.assert_array_equal(got[k], sd[k])


@pytest.mark.parametrize("size", [37, 800])
def test_get_features_resizes_as_jax(size):
    """The 112^2 nearest resize is torch's "nearest-exact": from 800^2,
    "nearest" would pick another source column for every output column."""
    p = jvgg.init_random_params(0)
    img = _image((size, size, 3), size)
    _assert_layers_close(tvgg.get_features(tvgg.to_device(p, "cpu"), torch.from_numpy(img)),
                         jvgg.get_features(p, jnp.asarray(img)))


def test_content_style_gram_and_their_gradients_match_jax():
    p = jvgg.init_random_params(0)
    tp = tvgg.to_device(p, "cpu")
    a, b = _image((32, 32, 3), 4), _image((32, 32, 3), 5)

    @jax.jit
    def jloss_fn(x):
        fx, fb = jvgg.get_features(p, x), jvgg.get_features(p, jnp.asarray(b))
        return (jvgg.content_loss(fb, fx, [2, 3]), jvgg.style_loss(fb, fx, [0, 1]),
                jvgg.gram(fx[1]))

    jc, js, jg = jloss_fn(jnp.asarray(a))
    x = torch.from_numpy(a).requires_grad_(True)
    fx, fb = tvgg.get_features(tp, x), tvgg.get_features(tp, torch.from_numpy(b))
    tc, ts = tvgg.content_loss(fb, fx, [2, 3]), tvgg.style_loss(fb, fx, [0, 1])
    tg = tvgg.gram(fx[1])
    np.testing.assert_allclose(float(tc), float(jc), rtol=1e-4)
    np.testing.assert_allclose(float(ts), float(js), rtol=1e-4)
    np.testing.assert_allclose(tg.detach().numpy(), np.asarray(jg), rtol=1e-4,
                               atol=1e-4 * float(jnp.abs(jg).max()))
    for t_loss, idx in ((tc, 0), (ts, 1)):
        want = np.asarray(jax.grad(lambda v: jloss_fn(v)[idx])(jnp.asarray(a)))
        (got,) = torch.autograd.grad(t_loss, [x], retain_graph=True)
        assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max(), idx


def test_full_f32_restores_the_callers_flags():
    cudnn = torch.backends.cudnn
    knob, attr = ((cudnn.conv, "fp32_precision") if hasattr(getattr(cudnn, "conv", None),
                                                           "fp32_precision")
                  else (cudnn, "allow_tf32"))
    before = getattr(knob, attr)
    with tvgg.full_f32():
        assert getattr(knob, attr) in ("ieee", False)
    assert getattr(knob, attr) == before


# ---- LPIPS ---------------------------------------------------------------------

def test_lpips_proxy_matches_jax():
    j, t = jlpips.LPIPS(), tlpips.LPIPS(device="cpu")
    assert (t.metric_name, t.is_calibrated()) == (j.metric_name, j.is_calibrated()) == (
        "lpips_proxy", False)
    a, b = _image((40, 40, 3), 6), _image((40, 40, 3), 7)
    for x, y in ((a, b), (a, a)):
        np.testing.assert_allclose(float(t(x, y)), float(j(x, y)), atol=1e-5)


@pytest.mark.parametrize("spelling", ["lin{i}.model.1.weight", "{i}.1.weight", "{i}.weight"])
def test_lpips_calibrated_from_npz_matches_jax(spelling, tmp_path):
    rng = np.random.default_rng(8)
    backbone = {k: rng.normal(0, np.sqrt(2.0 / (v.shape[1] * 9)) if v.ndim == 4 else 0.01,
                              v.shape).astype(np.float32)
                for k, v in tvgg.he_init(tlpips._VGG16_LAYERS, 0).items()}
    lins = {spelling.format(i=i): rng.uniform(0, 1, (1, c, 1, 1)).astype(np.float32)
            for i, c in enumerate(tlpips._CHANNELS)}
    np.savez(tmp_path / "vgg16.npz", **backbone)
    np.savez(tmp_path / "lin.npz", **lins)
    paths = (str(tmp_path / "vgg16.npz"), str(tmp_path / "lin.npz"))
    j, t = jlpips.LPIPS(*paths), tlpips.LPIPS(*paths, device="cpu")
    assert t.metric_name == j.metric_name == "lpips" and t.is_calibrated()
    a, b = _image((36, 36, 3), 9), _image((36, 36, 3), 10)
    np.testing.assert_allclose(float(t(a, b)), float(j(a, b)), atol=1e-5)


# ---- depth ops and TV ------------------------------------------------------------

def _depth_map(kind):
    if kind == "flat":
        return np.full((20, 24), 2.0, np.float32)
    return np.random.default_rng(11).uniform(1.0, 2.0, (20, 24)).astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "flat"])
def test_depth_to_normals_and_its_gradient_match_jax(kind):
    """Values and gradients to 1e-5; on a flat map n is 0 off the border
    and the gradient must stay finite (the epsilon inside the root)."""
    d = _depth_map(kind)
    w = _image((20, 24, 3), 12) - 0.5

    def jf(x):
        return jnp.sum(jdepth.depth_to_normals(x, 30.0, 31.0, 11.0, 9.5) * w)

    want_v = np.asarray(jdepth.depth_to_normals(jnp.asarray(d), 30.0, 31.0, 11.0, 9.5))
    want_g = np.asarray(jax.grad(jf)(jnp.asarray(d)))
    x = torch.from_numpy(d).requires_grad_(True)
    got_v = tdepth.depth_to_normals(x, 30.0, 31.0, 11.0, 9.5)
    (got_g,) = torch.autograd.grad(torch.sum(got_v * torch.from_numpy(w)), [x])
    np.testing.assert_allclose(got_v.detach().numpy(), want_v, atol=1e-5)
    assert np.isfinite(got_g.numpy()).all()
    np.testing.assert_allclose(got_g.numpy(), want_g, atol=1e-5 * max(1.0, np.abs(want_g).max()))
    np.testing.assert_allclose(tdepth.depth_to_3d(torch.from_numpy(d), 30.0, 31.0, 11.0,
                                                  9.5).numpy(),
                               np.asarray(jdepth.depth_to_3d(jnp.asarray(d), 30.0, 31.0, 11.0,
                                                             9.5)), atol=1e-6)


@pytest.mark.parametrize("sigma,radius", [(1.7, None), (0.4, None), (2.0, 3)])
def test_gaussian_blur_and_its_gradient_match_jax(sigma, radius):
    d = _depth_map("random")
    w = _image((20, 24), 13)
    want_v = np.asarray(jdepth.gaussian_blur(jnp.asarray(d), sigma, radius))
    want_g = np.asarray(jax.grad(lambda x: jnp.sum(jdepth.gaussian_blur(x, sigma, radius) * w))(
        jnp.asarray(d)))
    x = torch.from_numpy(d).requires_grad_(True)
    got = tdepth.gaussian_blur(x, sigma, radius)
    (g,) = torch.autograd.grad(torch.sum(got * torch.from_numpy(w)), [x])
    np.testing.assert_allclose(got.detach().numpy(), want_v, atol=1e-5)
    np.testing.assert_allclose(g.numpy(), want_g, atol=1e-5)


@pytest.mark.parametrize("shape", [(17, 23), (17, 23, 3)])
def test_tv_losses_match_jax(shape):
    img = _image(shape, 14)
    for jf, tf in ((jloss.tv_loss, tloss.tv_loss), (jloss.tv_loss_sq, tloss.tv_loss_sq)):
        np.testing.assert_allclose(float(tf(torch.from_numpy(img))),
                                   float(jf(jnp.asarray(img))), rtol=1e-6)


# ---- metrics, render_set, probe ----------------------------------------------------

def _write_method(model, method, names, seed):
    rng = np.random.default_rng(seed)
    for sub in ("renders", "gt"):
        os.makedirs(os.path.join(model, "test", method, sub), exist_ok=True)
    for name in names:
        gt = rng.integers(0, 256, (24, 28, 3)).astype(np.uint8)
        noisy = np.clip(gt.astype(int) + rng.integers(-20, 21, gt.shape), 0, 255)
        write_png(os.path.join(model, "test", method, "gt", name), gt)
        write_png(os.path.join(model, "test", method, "renders", name), noisy.astype(np.uint8))


def test_evaluate_matches_jax(tmp_path):
    """A model with two methods (two views and one) written once and copied,
    then each package's `evaluate` on its copy: the same keys in the same
    order, the same values."""
    import shutil

    from wast3d_tpu.eval.metrics import evaluate as jeval
    from wast3d_tpu_torch.eval.metrics import evaluate as teval

    names = ["00000.png", "00001.png"]
    _write_method(str(tmp_path / "j" / "m"), "ours_7", names, seed=1)
    _write_method(str(tmp_path / "j" / "m"), "ours_30", names[:1], seed=2)
    shutil.copytree(tmp_path / "j", tmp_path / "t")
    jeval([str(tmp_path / "j" / "m")])
    tr = teval([str(tmp_path / "t" / "m"), str(tmp_path / "t" / "absent")], device="cpu")
    assert list(tr) == [str(tmp_path / "t" / "m")]
    tol = {"PSNR": 1e-4, "SSIM": 1e-5, "LPIPS_PROXY": 1e-5}
    jres, tres, jpv, tpv = (json.load(open(tmp_path / pkg / "m" / name))
                            for pkg, name in (("j", "results.json"), ("t", "results.json"),
                                              ("j", "per_view.json"), ("t", "per_view.json")))
    assert tres == tr[str(tmp_path / "t" / "m")]
    assert list(tres) == list(jres) == list(tpv) == list(jpv) == ["ours_30", "ours_7"]
    for method in jres:
        assert list(tres[method]) == list(jres[method]) == ["SSIM", "PSNR", "LPIPS_PROXY"]
        for key, t in tol.items():
            assert abs(tres[method][key] - jres[method][key]) <= t, (method, key)
            assert list(tpv[method][key]) == list(jpv[method][key])
            for view, v in jpv[method][key].items():
                assert abs(tpv[method][key][view] - v) <= t, (method, key, view)


def test_render_set_depth_pngs_match_jax(tmp_path):
    from wast3d_tpu.eval.render_sets import render_set as jrs
    from wast3d_tpu_torch.eval.render_sets import render_set as trs
    from wast3d_tpu_torch.utils.png import read_png

    scene = _random_scene(n=50, seed=0)
    jcams = [(_cam(w=32, h=32, eye=(0.3 * i, 0, -5)), None) for i in range(2)]
    tcams = [(port_cam(w=32, h=32, eye=(0.3 * i, 0, -5)), None) for i in range(2)]
    jbase = jrs(str(tmp_path / "j"), "test", 5, jcams, scene, jnp.zeros(3), JSET,
                save_depth=True, batch=2)
    tbase = trs(str(tmp_path / "t"), "test", 5, tcams, port_scene(scene), torch.zeros(3),
                TSET, save_depth=True, device="cpu")
    assert sorted(os.listdir(os.path.join(tbase, "depth"))) == ["00000.png", "00001.png"]
    for sub in ("depth", "renders"):
        for f in sorted(os.listdir(os.path.join(jbase, sub))):
            a = read_png(os.path.join(tbase, sub, f)).astype(int)
            b = read_png(os.path.join(jbase, sub, f)).astype(int)
            assert a.shape == b.shape == (32, 32, 3)
            assert np.abs(a - b).max() <= 1, (sub, f)


def test_probe_views_match_jax(tmp_path):
    from wast3d_tpu.eval.probe import probe_views as jprobe
    from wast3d_tpu_torch.eval.probe import probe_views as tprobe

    scene = _random_scene(n=60, seed=1)
    jcams = [_cam(w=32, h=32, eye=(0.4 * i, 0.1, -5)) for i in range(3)]
    tcams = [(port_cam(w=32, h=32, eye=(0.4 * i, 0.1, -5)), None) for i in range(3)]
    j = jprobe(scene, jcams, str(tmp_path / "j"), settings=JSET, max_views=2)
    t = tprobe(port_scene(scene), tcams, str(tmp_path / "t"), settings=TSET, max_views=2,
               device="cpu")
    for k in ("rgb", "depth", "normals"):
        assert len(t[k]) == len(j[k]) == 2
        for a, b in zip(t[k], j[k]):
            np.testing.assert_allclose(a, np.asarray(b), atol=1e-4 if k == "normals" else 1e-5,
                                       err_msg=k)
    tz, jz = np.load(tmp_path / "t" / "probe.npz"), np.load(tmp_path / "j" / "probe.npz")
    assert sorted(tz.files) == sorted(jz.files) == ["depth", "normals", "rgb"]
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j"))


# ---- CLIs and full_eval ---------------------------------------------------------------

@pytest.mark.parametrize("name", ["metrics", "full_eval"])
def test_cli_flags_match_jax(name):
    j = _flags(_jax_parser(importlib.import_module(f"wast3d_tpu.cli.{name}")))
    t = _flags(importlib.import_module(f"wast3d_tpu_torch.cli.{name}").build_parser())
    assert set(t) - set(j) == {"--device"}
    for opt, val in j.items():
        assert t[opt] == val, opt


def test_cli_metrics_on_cpu(tmp_path, capsys):
    from wast3d_tpu_torch.cli import metrics as cli

    _write_method(str(tmp_path / "m"), "ours_1", ["00000.png"], seed=1)
    res = cli.main(["-m", str(tmp_path / "m"), "--device", "cpu"])
    assert list(res[str(tmp_path / "m")]["ours_1"]) == ["SSIM", "PSNR", "LPIPS_PROXY"]
    assert json.loads(capsys.readouterr().out) == res


@pytest.mark.parametrize("scenes", [None, ["garden", "truck", "playroom", "nowhere"]])
def test_full_eval_jobs_match_jax(scenes, monkeypatch, tmp_path):
    """The same (training, rendering) calls in the same order, with
    skip_metrics; with every skip_* set, nothing runs and {} returns."""
    from wast3d_tpu.eval import full_eval as jfe
    from wast3d_tpu.eval import render_sets as jrs
    from wast3d_tpu_torch.eval import full_eval as tfe
    from wast3d_tpu_torch.eval import render_sets as trs

    calls = {"jax": [], "port": []}
    for name, fe, rs in (("jax", jfe, jrs), ("port", tfe, trs)):
        def train(source, model_path, images="images", resolution=-1, *a, _n=name, **k):
            calls[_n].append(("train", source, model_path, images, resolution))

        def render(model_path, source, iteration=-1, skip_train=False, *a, _n=name, **k):
            calls[_n].append(("render", model_path, source, iteration, skip_train))

        monkeypatch.setattr(fe, "run_training", train)
        monkeypatch.setattr(rs, "render_sets", render)
    dirs = dict(mipnerf360_dir="m360", tanksandtemples_dir="tat", deepblending_dir="db",
                output_dir=str(tmp_path), scenes=scenes)
    assert jfe.full_eval(**dirs, skip_metrics=True) == {}
    assert tfe.full_eval(**dirs, skip_metrics=True, device="cpu") == {}
    assert calls["port"] == calls["jax"] and calls["jax"]
    calls = {"jax": [], "port": []}
    skip = dict(skip_training=True, skip_rendering=True, skip_metrics=True)
    assert jfe.full_eval(**dirs, **skip) == tfe.full_eval(**dirs, **skip, device="cpu") == {}
    assert calls == {"jax": [], "port": []}


# ---- neural style transfer -----------------------------------------------------------

def test_style_transfer_matches_jax():
    from wast3d_tpu.models.nst import style_transfer as jnst
    from wast3d_tpu_torch.models.nst import style_transfer as tnst

    c, s = _image((24, 24, 3), 15), _image((20, 20, 3), 16)
    ji, jl = jnst(c, s, steps=2)
    ti, tl = tnst(c, s, steps=2, device="cpu")
    np.testing.assert_allclose(tl, np.asarray(jl), rtol=1e-4)
    np.testing.assert_allclose(ti, np.asarray(ji), rtol=1e-4, atol=1e-6)
