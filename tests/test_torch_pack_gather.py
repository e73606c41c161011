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


class _Captured(Exception):
    """Raised by the recorder once it holds JAX's rows: the blend is not run."""


def jax_packed_rows(jscene, monkeypatch, w=W, h=H, blend=True):
    """JAX's [K, 10] bf16 pack-gather rows as uint16 bits, from its own
    render (module docstring); `blend=False` stops the render once the rows
    are made."""
    captured = {}
    untile = pallas_path._blend_untile

    def record(packed, binning, *args, **kwargs):
        captured["packed"] = np.asarray(packed)
        captured["k"] = int(np.asarray(binning.tile_end)[-1])
        if not blend:
            raise _Captured
        return untile(packed, binning, *args, **kwargs)

    monkeypatch.setattr(pallas_path, "_blend_untile", record)
    with jax.disable_jit():
        try:
            japi.render(_cam(w=w, h=h), jscene, np.ones(3, np.float32), settings=JAX_PACKED)
        except _Captured:
            pass
    packed, k = captured["packed"], captured["k"]
    return packed[:10, :k].T.view(np.uint16)


def port_rows(jscene, pack_gather, w=W, h=H):
    prep = tapi.preprocess_scene(port_cam(w=w, h=h), port_scene(jscene))
    with torch.no_grad():
        binning, rows = render_path.bin_and_pack(prep, w, h, fast=True,
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


def test_pack_gather_rows_equal_jaxs_on_a_1296_pixel_wide_frame(monkeypatch):
    """JAX's rows at the BASELINE ladder's width. Past x = 1024 a mean's
    bf16 high part is 8 pixels apart and its low part carries the rest, so
    more x means land a bf16 step (1/16 pixel on [8, 16)) away from the
    non-packed rows there than below x = 512. The port's rows are JAX's bit
    for bit."""
    from tests.test_rasterizer import _scene_from

    rng = np.random.default_rng(7)
    n, w, h = 200, 1296, 48
    jscene = _scene_from(
        xyz=np.stack([rng.uniform(-2.0, 2.0, n), rng.uniform(-1.0, 1.0, n),
                      rng.uniform(-0.2, 0.2, n)], 1),
        rgb=rng.uniform(0.1, 0.9, (n, 3)), scale=rng.uniform(0.004, 0.012, (n, 3)),
        opacity=rng.uniform(0.4, 0.9, (n, 1)))
    want = jax_packed_rows(jscene, monkeypatch, w, h, blend=False)
    binning, rows = port_rows(jscene, pack_gather=True, w=w, h=h)
    got = rows[:, :10].view(torch.int16).numpy().view(np.uint16)
    assert got.shape == want.shape and got.shape[0] == int(binning.tile_end[-1]) > 0
    np.testing.assert_array_equal(got, want)
    x = (rows[:, 0].float() + (binning.tile_of_dup % -(-w // 16) * 16).float()).numpy()
    _, plain = port_rows(jscene, pack_gather=False, w=w, h=h)
    plain = plain[:, :10].view(torch.int16).numpy().view(np.uint16)
    moved = plain[:, 0] != want[:, 0]
    assert moved[x >= 1024].mean() > moved[x < 512].mean() > 0
    assert (plain[:, 2:] == want[:, 2:]).all()


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
    # The kernel counts duplicates and Gaussians in an int: 2^31 duplicates
    # (a stride-0 view, no memory) are refused before anything runs.
    many = torch.zeros(1, dtype=torch.int64).expand(2 ** 31)
    with pytest.raises(ValueError, match="2\\^31"):
        kg.pack_gather(*args[:6], many, many, W)


def test_cooperative_designs_32_byte_rows_hold_the_packs_values():
    """The kernel's data path (csrc/pack_gather.cu): row g of its scratch
    holds Gaussian g's 12 fields in 16 bf16 slots (32 bytes, the last four
    zero), row N is zero; a duplicate reads row depth_order[rank] (row N
    for the sentinel rank), recentres the mean words 0-1 on its tile and
    copies words 2-5 to the output's words 1-4. Modelled here word for
    word, it gives `pack_gather_reference`'s rows bit for bit."""
    jscene = _random_scene(n=80, seed=4)
    prep = tapi.preprocess_scene(port_cam(w=W, h=H), port_scene(jscene))
    with torch.no_grad():
        binning, _ = render_path.bin_and_pack(prep, W, H, fast=True)
    fields = (prep.means2d, prep.conics, prep.opacities, prep.depths, prep.colors)
    n = prep.means2d.shape[0]
    rank = torch.cat([binning.rank, torch.tensor([n])])  # and one sentinel duplicate
    tile_of_dup = torch.cat([binning.tile_of_dup, torch.tensor([1])])
    scratch = torch.nn.functional.pad(kg.pack_rows_reference(*fields, torch.arange(n)),
                                      (0, kg.PACKED_ROW_BYTES // 2 - kg.PACKED))
    g = torch.cat([binning.depth_order, torch.tensor([n])])[rank]
    words = scratch[g].view(torch.int32)  # [K, 8]: packed words 0-7
    grid_x = -(-W // 16)
    o = torch.stack([tile_of_dup % grid_x, tile_of_dup // grid_x], 1) * 16
    half = scratch[g].float()  # slots 0-3: hi_x lo_x hi_y lo_y
    mean = ((half[:, 0:4:2] - o.float()) + half[:, 1:4:2]).to(torch.bfloat16)
    out = torch.cat([mean.view(torch.int32), words[:, 2:6],
                     torch.zeros_like(words[:, :3])], dim=1)
    want = kg.pack_gather_reference(*fields, binning.depth_order, rank, tile_of_dup, W)
    assert torch.equal(out, want.view(torch.int32)) and kg.PACKED_ROW_BYTES == 32
    assert not scratch[:, kg.PACKED:].view(torch.int16).any()


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
