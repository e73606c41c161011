"""Kg, the bf16 tier's serving gather (`RasterizeSettings.pack_gather`,
`ops/rasterizer/pack_gather.py`), against the JAX package on the CPU.

JAX's rows are captured from its own render: `pallas_path.render_pallas`
with `fast_chain=True, pack_gather=True` runs under `jax.disable_jit()`
while `pallas_path._blend_untile` is replaced by a recorder of its `packed`
argument ([16, K + G] bf16, fields by row). The port's plain Kg must equal
its first K columns (K = `binning.tile_end[-1]`) bit for bit, on the cases
of JAX's `test_pack_gather_matches_fast_chain` (80 x 48; 200 Gaussians at
seed 3, 120 at seed 0). Those rows differ from the port's non-packed fast
rows (`fast_rows`, one rounding of m - ox) by one bf16 step on a share of
the means, which the test counts, and the render stays within JAX's own
bounds of the plain fast render (colour and final_T 1.5e-2, depth rtol and
atol 3e-2).
"""

import jax
import numpy as np
import pytest
import torch

from tests.test_rasterizer import _cam, _random_scene
from tests.test_torch_scene import port_cam, port_scene
from wast3d_tpu.ops.rasterizer import api as japi
from wast3d_tpu.ops.rasterizer import pallas_path
from wast3d_tpu_torch.ops.rasterizer import api as tapi
from wast3d_tpu_torch.ops.rasterizer import pack_gather as kg
from wast3d_tpu_torch.ops.rasterizer import render_path

W, H = 80, 48
CASES = [(200, 3), (120, 0)]  # (Gaussians, seed)
JAX_PACKED = japi.RasterizeSettings(renderer="pallas", dup_capacity=1 << 13,
                                    pallas_interpret=True, fast_chain=True,
                                    pack_gather=True)
FAST = tapi.RasterizeSettings(renderer="tiled", fast_chain=True)
PACKED = FAST._replace(pack_gather=True)
WHITE = torch.ones(3)


def jax_packed_rows(jscene, monkeypatch):
    """JAX's [K, 10] bf16 pack-gather rows as uint16 bits, from its own
    render (module docstring)."""
    captured = {}
    untile = pallas_path._blend_untile

    def record(packed, binning, *args, **kwargs):
        captured["packed"] = np.asarray(packed)
        captured["k"] = int(np.asarray(binning.tile_end)[-1])
        return untile(packed, binning, *args, **kwargs)

    monkeypatch.setattr(pallas_path, "_blend_untile", record)
    with jax.disable_jit():
        japi.render(_cam(w=W, h=H), jscene, np.ones(3, np.float32), settings=JAX_PACKED)
    packed, k = captured["packed"], captured["k"]
    return packed[:10, :k].T.view(np.uint16)


def port_rows(jscene, pack_gather):
    prep = tapi.preprocess_scene(port_cam(w=W, h=H), port_scene(jscene))
    with torch.no_grad():
        binning, rows = render_path.bin_and_pack(prep, W, H, fast=True,
                                                 pack_gather=pack_gather)
    return binning, rows


@pytest.mark.parametrize("n,seed", CASES)
def test_pack_gather_rows_equal_jaxs_bit_for_bit(n, seed, monkeypatch):
    jscene = _random_scene(n=n, seed=seed)
    want = jax_packed_rows(jscene, monkeypatch)
    binning, rows = port_rows(jscene, pack_gather=True)
    got = rows[:, :10].view(torch.int16).numpy().view(np.uint16)
    assert got.shape == want.shape and got.shape[0] == int(binning.tile_end[-1]) > 0
    np.testing.assert_array_equal(got, want)
    assert not rows[:, 10:].view(torch.int16).any()
    # The f32 gather and one rounding (`fast_rows`) differ from JAX's
    # split-bf16 rows on a share of the means: the fault this fixes.
    _, plain = port_rows(jscene, pack_gather=False)
    plain = plain[:, :10].view(torch.int16).numpy().view(np.uint16)
    differ = (plain != want).any(axis=0)
    assert differ[:2].any() and not differ[2:].any(), differ
    print(f"n={n} seed={seed}: K={want.shape[0]}, rows differing from the "
          f"non-packed rows: x {(plain[:, 0] != want[:, 0]).sum()}, "
          f"y {(plain[:, 1] != want[:, 1]).sum()}")


@pytest.mark.parametrize("n,seed", CASES)
def test_pack_gather_render_within_jaxs_bounds(n, seed):
    scene = port_scene(_random_scene(n=n, seed=seed))
    cam = port_cam(w=W, h=H)
    with torch.no_grad():
        f = tapi.render(cam, scene, WHITE, settings=FAST, device="cpu")
        g = tapi.render(cam, scene, WHITE, settings=PACKED, device="cpu")
    np.testing.assert_allclose(g["render"].numpy(), f["render"].numpy(), atol=1.5e-2)
    np.testing.assert_allclose(g["final_T"].numpy(), f["final_T"].numpy(), atol=1.5e-2)
    np.testing.assert_allclose(g["depth"].numpy(), f["depth"].numpy(), rtol=3e-2, atol=3e-2)


def test_wrapper_takes_plain_version_on_cpu_and_counts_nothing():
    jscene = _random_scene(n=60, seed=2)
    prep = tapi.preprocess_scene(port_cam(w=W, h=H), port_scene(jscene))
    with torch.no_grad():
        binning, _ = render_path.bin_and_pack(prep, W, H, fast=True)
        args = (prep.means2d, prep.conics, prep.opacities, prep.depths, prep.colors,
                binning.depth_order, binning.rank, binning.tile_of_dup, W)
        before = kg.pack_gather.launches
        rows = kg.pack_gather(*args)
    assert torch.equal(rows, kg.pack_gather_reference(*args))
    assert rows.dtype == torch.bfloat16 and rows.shape == (binning.rank.shape[0], 16)
    assert kg.pack_gather.launches == before == 0
    packed = kg.pack_rows_reference(*args[:6])
    assert packed.shape == (prep.means2d.shape[0] + 1, 12) and not packed[-1].any()
    with pytest.raises(ValueError, match="int64"):
        kg.pack_gather(*args[:6], binning.rank.to(torch.int32), *args[7:])


def test_pack_gather_raises_without_fast_chain_and_under_autograd():
    scene = port_scene(_random_scene(n=16, seed=0))
    cam = port_cam(w=32, h=32)
    with pytest.raises(ValueError, match="fast_chain"):
        tapi.render(cam, scene, WHITE, settings=PACKED._replace(fast_chain=False),
                    device="cpu")
    live = scene.replace(xyz=scene.xyz.clone().requires_grad_(True))
    with pytest.raises(ValueError, match="forward only"):
        tapi.render(cam, live, WHITE, settings=PACKED, device="cpu")
    with torch.no_grad():  # the same inputs render without a graph
        out = tapi.render(cam, live, WHITE, settings=PACKED, device="cpu")
    assert torch.isfinite(out["render"]).all()
