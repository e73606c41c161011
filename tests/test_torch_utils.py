"""`wast3d_tpu_torch/utils/{profiling,debug,cache}.py` against the JAX
package's `utils/` on the CPU: `StepTimer` on patched clocks, `nan_check`'s
paths for the same nested structure, `debug_groups_loss` within rtol 1e-4,
`standardize_xyz` within 1e-6; the profiler writes a trace and the CPU has
no device memory statistics; `cache.enable` moves the build directory and
`WAST3D_NO_CACHE` builds into a private one."""

import collections
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wast3d_tpu.utils import debug as jdebug
from wast3d_tpu.utils import profiling as jprof
from wast3d_tpu_torch import _build
from wast3d_tpu_torch.utils import cache, debug, profiling

ROOT = Path(__file__).resolve().parent.parent
Pair = collections.namedtuple("Pair", "first second")


def test_step_timer_equals_jaxs_on_patched_clocks(monkeypatch):
    clock = iter([0.0, 0.5, 0.7, 1.6, 1.65, 3.0, 3.1])
    ticks = list(clock)
    runs = []
    for mod in (profiling, jprof):
        seq = iter(ticks)
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(seq))
        timer = mod.StepTimer(ema=0.6)
        runs.append([(timer.tick(), timer.steps_per_sec) for _ in ticks])
    assert runs[0] == runs[1] and runs[0][0] == (None, None)


@dataclasses.dataclass
class Params:
    xyz: object
    scale: object


def _tree(lib, nan):
    a = lib.ones(3)
    bad = lib.asarray([1.0, float("nan")]) if nan else lib.zeros(2)
    inf = lib.asarray([float("inf")]) if nan else lib.ones(1)
    return {"grads": [a, (bad, Pair(inf, None))], "b": Pair(a, [a, bad]), "step": 3,
            "ok": lib.zeros(4)}


def test_nan_check_names_jaxs_paths():
    assert debug.nan_check(_tree(torch, False)) and jdebug.nan_check(_tree(jnp, False))
    with pytest.raises(FloatingPointError) as t:
        debug.nan_check(_tree(torch, True), "grads")
    with pytest.raises(FloatingPointError) as j:
        jdebug.nan_check(_tree(jnp, True), "grads")
    assert str(t.value) == str(j.value)
    assert "['grads'][1][0]" in str(t.value) and ".first" in str(t.value)
    with pytest.raises(FloatingPointError, match=r"\['p'\]\.scale"):
        debug.nan_check({"p": Params(torch.ones(2), torch.tensor([float("-inf")]))})
    assert debug.nan_check({"i": torch.arange(3), "n": np.zeros(2), "f": 1.5})


@pytest.mark.parametrize("steps", [50, 150])
def test_debug_groups_loss_matches_jax(steps):
    """Within rtol 1e-4 of JAX's while the loss is above the floor that the
    1e-12 inside the distance's root sets (at the default 200 steps it is
    ~2e-10 there, where one rounding moves it by ~1e-3 relative); there
    both reach that floor."""
    a = debug.debug_groups_loss(n=8, k=2, steps=steps)
    b = jdebug.debug_groups_loss(n=8, k=2, steps=steps)
    np.testing.assert_allclose(a, b, rtol=1e-4)
    assert a < debug.debug_groups_loss(n=8, k=2, steps=1)
    assert debug.debug_groups_loss() < 1e-9 and jdebug.debug_groups_loss() < 1e-9


@pytest.mark.parametrize("masked", [False, True])
def test_standardize_xyz_matches_jax(masked):
    rng = np.random.default_rng(2)
    xyz = (rng.normal(size=(50, 3)) * [1.0, 2.0, 0.5] + [3.0, -1.0, 0.2]).astype(np.float32)
    mask = rng.random(50) > 0.3 if masked else None
    got = debug.standardize_xyz(torch.from_numpy(xyz),
                                None if mask is None else torch.from_numpy(mask))
    want = jdebug.standardize_xyz(jnp.asarray(xyz), None if mask is None else jnp.asarray(mask))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
    back = debug.destandardize_xyz(*got)
    np.testing.assert_allclose(back.numpy(), xyz, atol=1e-5)


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    with profiling.trace(str(tmp_path)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = list(tmp_path.iterdir())
    assert len(files) == 1 and files[0].suffix == ".json" and "aten::mm" in files[0].read_text()


def test_device_memory_stats_is_empty_on_the_cpu():
    assert profiling.device_memory_stats(device="cpu") == {}


def test_cache_enable_moves_the_build_directory(tmp_path, monkeypatch):
    monkeypatch.delenv("WAST3D_NO_CACHE", raising=False)
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)  # restored after the test
    default = _build.BUILD_DIR
    assert cache.enable() == default  # no path: the directory stays
    assert cache.enable(str(tmp_path)) == tmp_path.resolve() == _build.BUILD_DIR
    assert _build.library_path().parent == tmp_path.resolve()
    assert _build.native_library_path().parent == tmp_path.resolve()


def test_no_cache_builds_privately(tmp_path):
    code = ("import sys, os; sys.path.insert(0, sys.argv[1]); "
            "from wast3d_tpu_torch.utils import cache; from wast3d_tpu_torch import _build, native; "
            "d = cache.enable(sys.argv[2]); lib = native.library(); "
            "print(d, os.path.dirname(lib._name))")
    env = dict(os.environ, WAST3D_NO_CACHE="1")
    outs = [subprocess.run([sys.executable, "-c", code, str(ROOT), str(tmp_path)], env=env,
                           capture_output=True, text=True, timeout=300) for _ in range(2)]
    assert all(o.returncode == 0 for o in outs), [o.stderr for o in outs]
    dirs = [o.stdout.split() for o in outs]
    assert all(d[0] == d[1] != str(tmp_path) for d in dirs)  # the path is overridden
    assert dirs[0][0] != dirs[1][0]  # each process its own directory
    assert not any(Path(d[0]).exists() for d in dirs)  # removed at exit
    assert list(tmp_path.iterdir()) == []
