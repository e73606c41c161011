"""The port's package rules: no JAX and no wast3d_tpu anywhere in it, no
PIL anywhere in the package (nor at import in the scripts), CUDA by default with the CPU only on request, the plain
path leaves the kernel's launch count alone, and the kernel build is a
plain nvcc + ctypes one."""

import ast
import ctypes
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from wast3d_tpu_torch import _build
from wast3d_tpu_torch.device import resolve_device
from wast3d_tpu_torch.ops.rasterizer import api, blend
from wast3d_tpu_torch.core.camera import look_at_camera

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "wast3d_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "wast3d_tpu")
PY_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                         ROOT / "tools" / "quality_gate_torch.py"]


def _imports(tree):
    """(top-level module, at module level?) for every import."""
    module_level = {id(n) for n in tree.body}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], id(node) in module_level
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0], id(node) in module_level


@pytest.mark.parametrize("path", PY_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for name, top in _imports(tree):
        assert name not in FORBIDDEN, f"{path} imports {name}"
        if path.is_relative_to(PORT):  # images go through utils/image_io.py
            assert name != "PIL", f"{path} imports PIL"
        assert not (name == "PIL" and top), f"{path} imports PIL at module level"


def test_cli_import_pulls_in_no_jax_or_pil():
    code = ("import sys, wast3d_tpu_torch.cli.render, wast3d_tpu_torch.eval.render_sets, "
            "wast3d_tpu_torch.cli.metrics, wast3d_tpu_torch.eval.metrics, "
            "wast3d_tpu_torch.refine.drivers, wast3d_tpu_torch.models.nst; "
            "print(sorted(m for m in ('jax', 'PIL', 'wast3d_tpu') if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


def test_entry_points_need_cuda_unless_cpu_is_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the no-CUDA error cannot occur")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    kw = dict(eye=[0, 0, -5], target=[0, 0, 0], up=[0, -1, 0], fovx=0.8, fovy=0.8,
              width=32, height=32)
    with pytest.raises(RuntimeError):
        look_at_camera(**kw)
    cam = look_at_camera(**kw, device="cpu")
    from tests.test_rasterizer import _random_scene
    from tests.test_torch_scene import port_scene

    scene = port_scene(_random_scene(n=20, seed=0))
    with pytest.raises(RuntimeError):
        api.render(cam, scene, torch.zeros(3))
    from wast3d_tpu_torch.cli import render as cli
    from wast3d_tpu_torch.eval.render_sets import render_sets

    with pytest.raises(RuntimeError):
        render_sets(str(tmp_path), str(tmp_path))
    with pytest.raises(RuntimeError):
        cli.main(["-m", str(tmp_path), "-s", str(tmp_path)])


def test_cpu_path_leaves_launch_count_alone():
    from tests.test_rasterizer import _random_scene
    from tests.test_torch_scene import port_scene

    before = blend.blend_fwd.launches
    cam = look_at_camera(eye=[0, 0, -5], target=[0, 0, 0], up=[0, -1, 0], fovx=0.8,
                         fovy=0.8, width=32, height=32, device="cpu")
    out = api.render(cam, port_scene(_random_scene(n=50, seed=1)), torch.zeros(3),
                     settings=api.RasterizeSettings(renderer="cuda"), device="cpu")
    assert float(out["render"].max()) > 0
    assert blend.blend_fwd.launches == before == 0


def test_build_command_is_plain_nvcc_for_sm90a():
    """One plain `nvcc -c` per source for sm_90a (started together), then
    one `nvcc -shared` over the objects."""
    compiles, link = _build.nvcc_commands(Path("/x/lib.so"))
    for cmd in compiles + [link]:
        assert "arch=compute_90a,code=sm_90a" in cmd and "--use_fast_math" not in cmd
    for cmd in compiles:
        assert {"-c", "-O3", "-std=c++17"} <= set(cmd)
    assert "-shared" in link and link[link.index("-o") + 1] == "/x/lib.so"
    srcs = _build.sources()
    assert srcs and [cmd[-1] for cmd in compiles] == [str(s) for s in srcs]
    objects = [cmd[cmd.index("-o") + 1] for cmd in compiles]
    assert link[link.index("-o") + 2:] == objects and len(set(objects)) == len(srcs)
    for s in srcs:
        text = s.read_text()
        assert "torch/extension.h" not in text and "pybind" not in text
    for path in PY_FILES:  # no torch.utils.cpp_extension anywhere in the port
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] + [getattr(node, "module", None) or ""]
                     if isinstance(node, (ast.Import, ast.ImportFrom)) else
                     [node.attr] if isinstance(node, ast.Attribute) else [])
            assert not any("cpp_extension" in n for n in names), path
    argtypes, restype = _build.SIGNATURES["w3d_blend_fwd"]
    assert argtypes[:8] == [ctypes.c_void_p] * 8 and argtypes[-1] is ctypes.c_void_p
    assert restype is ctypes.c_int
    assert _build.BUILD_DIR == PORT / "_build"
    assert _build.library_path().parent == _build.BUILD_DIR


def test_build_failure_raises_with_nvcc_output(tmp_path, monkeypatch):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: fake compiler says no' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="fake compiler says no"):
        _build.build()
    assert not list((tmp_path / "build").glob("*.so"))


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_cli_train_import_pulls_in_no_jax_or_pil():
    code = ("import sys, wast3d_tpu_torch.cli.train, wast3d_tpu_torch.train.driver; "
            "print(sorted(m for m in ('jax', 'PIL', 'wast3d_tpu', 'orbax') "
            "if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


def test_train_entry_points_need_cuda_unless_cpu_is_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the no-CUDA error cannot occur")
    from wast3d_tpu_torch.cli import train as cli
    from wast3d_tpu_torch.train.driver import train_scene

    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_scene(str(tmp_path), str(tmp_path / "m"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["-s", str(tmp_path), "-m", str(tmp_path / "m")])


def test_cpu_train_step_leaves_launch_counts_alone():
    from tests.test_rasterizer import _random_scene
    from tests.test_torch_scene import port_scene
    from wast3d_tpu_torch.config import OptimizationConfig
    from wast3d_tpu_torch.ops.rasterizer import grad_reduce
    from wast3d_tpu_torch.train import reconstruct as R

    cam = look_at_camera(eye=[0, 0, -5], target=[0, 0, 0], up=[0, -1, 0], fovx=0.8,
                         fovy=0.8, width=32, height=32, device="cpu")
    state = R.init_train_state(port_scene(_random_scene(n=50, seed=2)), OptimizationConfig(), 1.0)
    before = (blend.blend_fwd.launches, blend.blend_bwd.launches,
              grad_reduce.segment_sum.launches)
    state, aux = R.train_step(state, cam, torch.rand(32, 32, 3), torch.zeros(3),
                              torch.Generator().manual_seed(0), OptimizationConfig(),
                              api.RasterizeSettings(renderer="cuda"), 32, 32)
    assert torch.isfinite(aux["loss"]) and state.step == 1
    assert (blend.blend_fwd.launches, blend.blend_bwd.launches,
            grad_reduce.segment_sum.launches) == before == (0, 0, 0)


@pytest.mark.parametrize("name", ["w3d_blend_bwd", "w3d_segsum"])
def test_new_kernels_are_declared_with_pointer_argtypes(name):
    argtypes, restype = _build.SIGNATURES[name]
    assert restype is ctypes.c_int and argtypes[-1] is ctypes.c_void_p
    assert set(argtypes) <= {ctypes.c_void_p, ctypes.c_int}
    src = (_build.SOURCE_DIR / {"w3d_blend_bwd": "blend_bwd.cu",
                                "w3d_segsum": "segsum.cu"}[name]).read_text()
    assert f"int {name}(" in src and "atomicAdd" not in src


def test_cli_stylize_import_pulls_in_no_jax_or_pil():
    code = ("import sys, wast3d_tpu_torch.cli.stylize, wast3d_tpu_torch.cli.save_clusters, "
            "wast3d_tpu_torch.stylize.pipeline; "
            "print(sorted(m for m in ('jax', 'PIL', 'wast3d_tpu', 'orbax') "
            "if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


def test_stylize_entry_points_need_cuda_unless_cpu_is_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the no-CUDA error cannot occur")
    from wast3d_tpu_torch.cli import save_clusters, stylize
    from wast3d_tpu_torch.stylize.fit import compute_target_descriptors, fit_all_balls
    from wast3d_tpu_torch.stylize.pipeline import stylize_from_files

    pts = np.random.default_rng(0).normal(size=(20, 3)).astype(np.float32)
    for call in (lambda: stylize_from_files("a.ply", "b.npz", "c.ply"),
                 lambda: compute_target_descriptors(pts),
                 lambda: fit_all_balls(pts, pts, [np.arange(20)]),
                 lambda: stylize.main(["--content", "a.ply", "--style_cluster", "b.npz",
                                       "--output", "c.ply"]),
                 lambda: save_clusters.main(["--ckpt_path", "a.ply", "--output_dir",
                                             str(tmp_path)])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


@pytest.mark.parametrize("name,source", [("w3d_desc_loss", "desc_loss.cu"),
                                         ("w3d_desc_grad", "desc_grad.cu")])
def test_stylize_kernels_are_declared_with_pointer_argtypes(name, source):
    argtypes, restype = _build.SIGNATURES[name]
    assert restype is ctypes.c_int and argtypes[-1] is ctypes.c_void_p
    assert argtypes[:3] == [ctypes.c_void_p] * 3  # x, tp, the pair list's row_ptr
    assert argtypes.count(ctypes.c_float) == 2  # cg, cl
    src = (_build.SOURCE_DIR / source).read_text()
    assert f"int {name}(" in src and not re.search(r"\batomic[A-Z]\w*\s*\(", src)


def test_cpu_stylize_fit_leaves_launch_counts_alone():
    from wast3d_tpu_torch.config import StylizeConfig
    from wast3d_tpu_torch.stylize import desc_kernel
    from tests.test_torch_stylize import kernel_path_descriptors
    from wast3d_tpu_torch.stylize.fit import fit_balls

    rng = np.random.default_rng(1)
    pts = (rng.normal(size=(1100, 3)) * 0.3).astype(np.float32)
    cfg = StylizeConfig(global_knn=8, global_stride=8, local_knn=4, fit_steps=2, domain_knn=3,
                        desc_block=1024)
    td = kernel_path_descriptors(pts, cfg)
    assert td.pair_code is not None and td.points.shape[0] % desc_kernel.MP_ALIGN == 0
    out = fit_balls(torch.from_numpy(pts), td, torch.randn(1, 50, 3), torch.ones(1, 50, dtype=bool),
                    cfg)
    assert out.shape == (1, 1100, 3) and bool(torch.isfinite(out).all())
    assert desc_kernel.desc_loss.launches == desc_kernel.desc_grad.launches == 0


def test_blend_fwd_walk_all_is_a_test_hook_only():
    """K1 with its cull off has an entry of K1's signature, and the port's
    blend wrapper never reaches it (only chip_smoke.py calls it)."""
    assert _build.SIGNATURES["w3d_blend_fwd_walk_all"] == _build.SIGNATURES["w3d_blend_fwd"]
    argtypes, restype = _build.SIGNATURES["w3d_blend_fwd_walk_all"]
    assert argtypes[:8] == [ctypes.c_void_p] * 8 and argtypes[8:13] == [ctypes.c_int] * 5
    assert argtypes[-1] is ctypes.c_void_p and restype is ctypes.c_int
    src = (_build.SOURCE_DIR / "blend_fwd.cu").read_text()
    assert "int w3d_blend_fwd_walk_all(" in src and not re.search(r"\batomic[A-Z]\w*\s*\(", src)
    assert "walk_all" not in (PORT / "ops" / "rasterizer" / "blend.py").read_text()
    # By name, so that a call through getattr or a string is caught too.
    files = PY_FILES + sorted((ROOT / "tools").glob("*.py")) + sorted(ROOT.glob("*.py"))
    naming = {p.relative_to(ROOT).as_posix() for p in files
              if "w3d_blend_fwd_walk_all" in p.read_text()}
    assert naming == {"wast3d_tpu_torch/_build.py", "chip_smoke.py"}


@pytest.mark.parametrize("fail", [False, True])
def test_build_runs_each_compile_then_the_link(tmp_path, monkeypatch, fail):
    """`build()` with a stand-in `nvcc` that records its arguments and
    writes its `-o` file: every source compiled, then one link, the library
    moved into place and the objects gone; a failing compile raises with
    its output and leaves no library."""
    log = tmp_path / "calls.txt"
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\n"
                    f"echo \"$*\" >> {log}\n"
                    + ("case \"$*\" in *blend_bwd.cu*) echo broken; exit 3;; esac\n" if fail else "")
                    + 'while [ "$1" != "-o" ]; do shift; done; touch "$2"\n')
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    if fail:
        with pytest.raises(RuntimeError, match=r"exit 3\):\nbroken"):
            _build.build()
    else:
        built = _build.build()
        assert built.path == _build.library_path() and built.path.exists()
    calls = log.read_text().splitlines()
    compiles = [c for c in calls if " -c " in f" {c} "]
    assert len(compiles) == len(_build.sources())
    assert len(calls) == len(compiles) + (not fail) and ("-shared" in calls[-1]) != fail
    assert [p.name for p in (tmp_path / "build").iterdir()] == ([] if fail else [built.path.name])


def test_blend_fwd_fast_walk_all_is_a_test_hook_only():
    """K1f with its cull off has an entry of K1f's signature, and the port's
    blend wrapper never reaches it (only chip_smoke.py calls it). K1f and K2f
    take K1's and K2's arguments and, after `bg`, the tables' pointer."""
    fast = _build.SIGNATURES["w3d_blend_fwd_fast"]
    assert _build.SIGNATURES["w3d_blend_fwd_fast_walk_all"] == fast
    for tier, f32 in ((fast, _build.SIGNATURES["w3d_blend_fwd"]),
                      (_build.SIGNATURES["w3d_blend_bwd_fast"],
                       _build.SIGNATURES["w3d_blend_bwd"])):
        assert tier[1] == f32[1] and tier[0] == f32[0][:5] + [ctypes.c_void_p] + f32[0][5:]
    src = (_build.SOURCE_DIR / "blend_fwd.cu").read_text()
    assert "int w3d_blend_fwd_fast(" in src and "int w3d_blend_fwd_fast_walk_all(" in src
    assert "int w3d_blend_bwd_fast(" in (_build.SOURCE_DIR / "blend_bwd.cu").read_text()
    files = PY_FILES + sorted((ROOT / "tools").glob("*.py")) + sorted(ROOT.glob("*.py"))
    naming = {p.relative_to(ROOT).as_posix() for p in files
              if "w3d_blend_fwd_fast_walk_all" in p.read_text()}
    assert naming == {"wast3d_tpu_torch/_build.py", "chip_smoke.py"}


def test_cli_pipeline_import_pulls_in_no_jax_or_pil():
    code = ("import sys, wast3d_tpu_torch.cli.pipeline, wast3d_tpu_torch.eval.camera_path, "
            "wast3d_tpu_torch.train.spheres; "
            "print(sorted(m for m in ('jax', 'PIL', 'wast3d_tpu', 'orbax') "
            "if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


def test_pipeline_entry_points_need_cuda_unless_cpu_is_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the no-CUDA error cannot occur")
    from wast3d_tpu_torch.cli import pipeline as cli
    from wast3d_tpu_torch.eval import camera_path

    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--content_data", str(tmp_path), "--style_data", str(tmp_path),
                  "--workdir", str(tmp_path / "w")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        camera_path.spiral_path(np.zeros(3), 3.0, 0.5, num_frames=2)
    cams = camera_path.spiral_path(np.zeros(3), 3.0, 0.5, num_frames=2, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        camera_path.render_path(None, cams, str(tmp_path / "frames"))


def test_cpu_fast_tier_leaves_launch_counts_alone():
    from tests.test_rasterizer import _random_scene
    from tests.test_torch_scene import port_scene

    cam = look_at_camera(eye=[0, 0, -5], target=[0, 0, 0], up=[0, -1, 0], fovx=0.8,
                         fovy=0.8, width=32, height=32, device="cpu")
    scene = port_scene(_random_scene(n=50, seed=3))
    xyz = scene.xyz.clone().requires_grad_(True)
    out = api.render(cam, scene.replace(xyz=xyz), torch.zeros(3), device="cpu",
                     settings=api.RasterizeSettings(renderer="cuda", fast_chain=True))
    out["render"].sum().backward()
    assert float(out["render"].detach().max()) > 0 and bool(xyz.grad.abs().sum() > 0)
    assert (blend.blend_fwd_fast.launches, blend.blend_bwd_fast.launches,
            blend.blend_fwd.launches, blend.blend_bwd.launches) == (0, 0, 0, 0)
