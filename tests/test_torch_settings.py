"""`RasterizeSettings` takes the JAX package's renderer names and fields.

"pallas" runs the kernels (on CPU tensors each wrapper takes its plain
version) and "tiled" the plain versions, as "cuda" and "torch" do; "oracle"
runs the per-pixel oracle and an unknown name raises. JAX's capacity fields are
accepted with its defaults and change nothing, and `cli.train --renderer`
takes JAX's choices with JAX's default."""

import pytest
import torch

from tests.test_rasterizer import _random_scene
from tests.test_torch_scene import port_cam, port_scene
from wast3d_tpu.ops.rasterizer import api as japi
from wast3d_tpu_torch.cli import train as tcli
from wast3d_tpu_torch.ops.rasterizer import api as tapi
from wast3d_tpu_torch.ops.rasterizer import render_path


def render(settings, **kw):
    scene = port_scene(_random_scene(n=60, seed=2))
    return tapi.render(port_cam(w=48, h=32), scene, torch.ones(3), settings=settings,
                       device="cpu", **kw)


@pytest.mark.parametrize("fast_chain", [False, True])
def test_tiled_with_jaxs_capacities_renders_as_torch(fast_chain):
    jaxs = tapi.RasterizeSettings(renderer="tiled", dup_capacity=1 << 21, max_per_tile=256,
                                  chunk=16, fast_chain=fast_chain)
    a = render(jaxs)
    b = render(tapi.RasterizeSettings(renderer="torch", fast_chain=fast_chain))
    for key in ("render", "depth", "final_T", "radii"):
        assert torch.equal(a[key], b[key]), key
    assert float(a["render"].max()) > 0


@pytest.mark.parametrize("renderer,kernels", [("pallas", True), ("cuda", True),
                                              ("tiled", False), ("torch", False)])
def test_renderer_names_pick_the_route(renderer, kernels, monkeypatch):
    assert tapi.use_kernels(renderer) is kernels
    seen = {}
    real = render_path.render_sorted

    def spy(*args, **kw):
        seen["use_kernel"] = kw["use_kernel"]
        return real(*args, **kw)

    monkeypatch.setattr(tapi, "render_sorted", spy)
    render(tapi.RasterizeSettings(renderer=renderer))
    assert seen == {"use_kernel": kernels}


def test_the_default_is_the_kernels():
    assert tapi.RasterizeSettings().renderer == "pallas"
    assert tapi.use_kernels(tapi.RasterizeSettings().renderer)


def test_unknown_renderers_raise():
    assert tapi.use_kernels("oracle") is False
    for name in ("xla", "Oracle", ""):
        with pytest.raises(ValueError, match="renderer"):
            render(tapi.RasterizeSettings(renderer=name))


def test_fields_and_defaults_are_jaxs():
    """Every field of JAX's settings, in its order, with its default; the
    renderer's and the gradient reduction's defaults are the port's own."""
    j, t = japi.RasterizeSettings(), tapi.RasterizeSettings()
    assert t._fields == j._fields
    for name in j._fields:
        if name not in ("renderer", "grad_reduce"):
            assert getattr(t, name) == getattr(j, name), name
    assert j.renderer == "tiled" and t.renderer == "pallas"


@pytest.mark.parametrize("renderer", ["pallas", "tiled", "oracle", "cuda", "torch"])
def test_cli_train_takes_jaxs_renderers(renderer):
    ns = tcli.build_parser().parse_args(["-s", "x", "-m", "y", "--renderer", renderer])
    assert ns.renderer == renderer
    assert tcli.build_parser().parse_args(["-s", "x"]).renderer == "pallas"


def test_cli_train_with_renderer_pallas_runs_on_cpu(tmp_path):
    from tests.test_torch_train import blender_scene

    src, model = str(tmp_path / "scene"), str(tmp_path / "model")
    blender_scene(src)
    tcli.main(["-s", src, "-m", model, "--iterations", "2", "--save_iterations", "2",
               "--renderer", "pallas", "--quiet", "--device", "cpu"])
    ply = tmp_path / "model" / "point_cloud" / "iteration_2" / "point_cloud.ply"
    assert ply.exists() and ply.stat().st_size > 0
    tcli.main(["-s", src, "-m", str(tmp_path / "oracle"), "--iterations", "2",
               "--save_iterations", "2", "--renderer", "oracle", "--quiet", "--device", "cpu"])
    ply = tmp_path / "oracle" / "point_cloud" / "iteration_2" / "point_cloud.ply"
    assert ply.exists() and ply.stat().st_size > 0
