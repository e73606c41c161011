"""Port parity on the CPU: scene-adaptive plan tuning
(`ops/rasterizer/autoplan.py`) against the JAX package on the same scenes
and cameras (`tests/test_autoplan.py`'s mini scene and three 128x128
cameras, and a seeded random scene).

The straddle counts and the duplicate counts are integers of the same
float32 geometry: they agree exactly, except that a radius or extent on a
ceil() tie may differ by one pixel (`test_torch_preprocess.py`), so counts
are held exactly and the test reports the largest difference if they are
not. JAX's plan synthesis is numpy on those counts and the port's is a copy:
the same plan. Duplicate counts are compared where JAX's plan does not
overflow; the port never overflows (its flag is always False).
"""

import numpy as np
import pytest

from tests.test_rasterizer import _random_scene
from tests.test_torch_scene import port_scene
from tests.test_train import _mini_scene
from wast3d_tpu.core.camera import look_at_camera as jlook
from wast3d_tpu.ops.rasterizer import api as japi
from wast3d_tpu.ops.rasterizer import autoplan as jap
from wast3d_tpu_torch.core.camera import look_at_camera as tlook
from wast3d_tpu_torch.ops.rasterizer import api as tapi
from wast3d_tpu_torch.ops.rasterizer import autoplan as tap

CPU = "cpu"
EYES = ((0.0, 0, -4), (1.0, 0, -4), (-0.5, 0, -4))


def _cams(look, **kw):
    return [look(eye=list(e), target=[0, 0, 0], up=[0, -1, 0], fovx=0.9, fovy=0.9,
                 width=128, height=128, **kw) for e in EYES]


def _scenes(kind):
    js = _mini_scene(n=300, cap=512) if kind == "mini" else _random_scene(n=400, seed=7)
    return js, port_scene(js)


def _thresholds(max_tiles=512):
    return sorted({s for ra in tap._RA_CANDIDATES for s in tap._band_starts(ra, max_tiles)})


@pytest.mark.parametrize("kind", ["mini", "random"])
def test_probe_straddle_matches_jax(kind):
    js, ts = _scenes(kind)
    thr = _thresholds()
    jc, jm = jap.probe_straddle(js, _cams(jlook), thr)
    tc, tm = tap.probe_straddle(ts, _cams(tlook, device=CPU), thr, device=CPU)
    assert tc.shape == jc.shape == (3, len(thr))
    np.testing.assert_array_equal(tc, jc, err_msg=f"max diff {np.abs(tc - jc).max()}")
    np.testing.assert_array_equal(tm, jm)
    assert int(jm.max()) > 4


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_synthesize_plan_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n, max_tiles = int(rng.integers(1_000, 300_000)), int(rng.choice([64, 256, 512]))
    thr = _thresholds(max_tiles)
    counts = np.sort(rng.integers(0, n // 4, len(thr)))[::-1]
    need = dict(zip(thr, counts.tolist()))
    for margin in (1.0, 1.5):
        assert (tap.synthesize_plan(n, need, max_tiles, margin)
                == jap.synthesize_plan(n, need, max_tiles, margin))


@pytest.mark.parametrize("kind", ["mini", "random"])
@pytest.mark.parametrize("tile_cull,jitter_margin", [(True, 0.0), (True, 1.0), (False, 0.0)])
def test_measure_duplicates_matches_jax(kind, tile_cull, jitter_margin):
    js, ts = _scenes(kind)
    thr = _thresholds()
    counts, _ = jap.probe_straddle(js, _cams(jlook), thr)
    plan = jap.synthesize_plan(int(js.xyz.shape[0]), dict(zip(thr, counts.max(0).tolist())),
                               512)
    jd, jovf = jap.measure_duplicates(js, _cams(jlook), plan, 512, tile_cull=tile_cull,
                                      jitter_margin=jitter_margin)
    td, tovf = tap.measure_duplicates(ts, _cams(tlook, device=CPU), plan, 512,
                                      tile_cull=tile_cull, jitter_margin=jitter_margin,
                                      device=CPU)
    assert not jovf and tovf is False
    np.testing.assert_array_equal(td, jd)
    assert int(jd.min()) > 0


@pytest.mark.parametrize("kind", ["mini", "random"])
@pytest.mark.parametrize("kw", [{}, {"cap_quantile": 0.5}, {"jitter": True, "band_margin": 1.2}])
def test_tune_serving_settings_matches_jax(kind, kw):
    js, ts = _scenes(kind)
    jbase = japi.RasterizeSettings(renderer="pallas", dup_capacity=1 << 14)
    tbase = tapi.RasterizeSettings(renderer="pallas", dup_capacity=1 << 14)
    j = jap.tune_serving_settings(js, _cams(jlook), jbase, **kw)
    t = tap.tune_serving_settings(ts, _cams(tlook, device=CPU), tbase, device=CPU, **kw)
    assert j.phase_plan
    for field in ("phase_plan", "dup_capacity", "max_tiles_per_gaussian"):
        assert getattr(t, field) == getattr(j, field), field
    assert t._replace(phase_plan=(), dup_capacity=1 << 14,
                      max_tiles_per_gaussian=512) == tbase


def test_tuned_settings_render_as_the_base():
    """The port's binning reads none of the tuned fields: the same image."""
    _, ts = _scenes("mini")
    cam = _cams(tlook, device=CPU)[1]
    base = tapi.RasterizeSettings(renderer="tiled")
    tuned = tap.tune_serving_settings(ts, [cam], base, device=CPU)
    assert tuned != base
    a = tapi.render(cam, ts, [0.0, 0.0, 0.0], settings=base, device=CPU)
    b = tapi.render(cam, ts, [0.0, 0.0, 0.0], settings=tuned, device=CPU)
    assert bool((a["render"] == b["render"]).all())


def test_empty_cameras_return_base():
    _, ts = _scenes("mini")
    base = tapi.RasterizeSettings()
    assert tap.tune_serving_settings(ts, [], base, device=CPU) is base
