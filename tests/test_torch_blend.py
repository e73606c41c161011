"""Port parity: the plain version of K1 (`blend_fwd_reference`) against the
JAX package's blends, on the same sorted rows.

Inputs come from the JAX pipeline (preprocess + bin_gaussians), so both
sides blend the same duplicates in the same order. Tolerances are those the
JAX kernel is held to against its own f32 reference
(`tests/test_pallas_blend.py`): 3e-3 on colour and final_T and 3e-2 on
depth (chunked products reassociate the f32 transmittance, and a pixel may
stop on the other side of the 1e-4 test); 1e-4 on final_T in the saturating
scene."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_rasterizer import _cam, _random_scene, _scene_from
from tests.test_torch_preprocess import jax_prep
from wast3d_tpu.ops.rasterizer import binning as jbin
from wast3d_tpu.ops.rasterizer import pallas_blend as pb
from wast3d_tpu.ops.rasterizer.tiled import render_tiled
from wast3d_tpu_torch.ops.rasterizer import blend as tblend

BG = np.array([0.2, 0.5, 0.9], np.float32)


def jax_rows(prep, w, h, offsets=None):
    """Sorted [K, 12] rows, ranges and tile ids from the JAX binning."""
    b = jbin.bin_gaussians(
        prep.means2d, prep.depths, prep.radii, w, h, dup_capacity=0,
        max_tiles_per_gaussian=4096, ext_x=prep.extent_x, ext_y=prep.extent_y,
        conics=prep.conics, opacities=prep.opacities,
        jitter_margin=0.0 if offsets is None else 1.0)
    assert not bool(b.overflow)
    k = int(np.asarray(b.tile_end)[-1])
    g = np.asarray(b.gauss_idx)[:k]
    cols = [np.asarray(prep.means2d)[:, 0], np.asarray(prep.means2d)[:, 1],
            *np.asarray(prep.conics).T, np.asarray(prep.opacities),
            np.asarray(prep.depths), *np.asarray(prep.colors).T]
    rows = np.zeros((k, 12), np.float32)
    rows[:, :10] = np.stack(cols, 1)[g]
    return (rows, np.array(b.tile_start, np.int32), np.array(b.tile_end, np.int32),
            np.asarray(b.tile_of_dup)[:k])


def port_blend(rows, starts, ends, w, h, offsets=None, bg=BG):
    out = tblend.blend_fwd_reference(
        torch.from_numpy(rows), torch.from_numpy(starts), torch.from_numpy(ends),
        w, h, torch.from_numpy(bg), None if offsets is None else torch.from_numpy(offsets))
    return [x.numpy() for x in out]


def offsets_for(h, w, seed):
    return -np.random.default_rng(seed).uniform(0, 1, (h, w, 2)).astype(np.float32)


def saturating_scene():
    rng = np.random.default_rng(4)
    n = 100
    return _scene_from(
        xyz=np.concatenate([rng.normal(size=(n, 2)) * 0.05,
                            np.linspace(-1, 1, n)[:, None]], axis=1),
        rgb=rng.uniform(0.2, 1.0, (n, 3)),
        scale=np.full((n, 3), 0.3),
        opacity=np.full((n, 1), 0.95))


@pytest.mark.parametrize("case", ["square", "nonmultiple", "jitter", "jitter_nonmultiple"])
def test_plain_matches_tiled(case):
    w, h = (64, 64) if case in ("square", "jitter") else (50, 34)
    jcam = _cam(w=w, h=h)
    prep = jax_prep(_random_scene(n=200, seed=len(case)), jcam)
    offsets = offsets_for(h, w, 7) if case.startswith("jitter") else None
    rows, starts, ends, _ = jax_rows(prep, w, h, offsets)
    color, depth, final_t = port_blend(rows, starts, ends, w, h, offsets)
    t = render_tiled(prep, w, h, jnp.asarray(BG),
                     None if offsets is None else jnp.asarray(offsets),
                     dup_capacity=1 << 14, max_per_tile=512, chunk=16)
    assert not bool(t.overflow)
    assert color.shape == (h, w, 3) and depth.shape == final_t.shape == (h, w)
    np.testing.assert_allclose(color, np.asarray(t.color), atol=3e-3)
    np.testing.assert_allclose(final_t, np.asarray(t.final_T), atol=3e-3)
    np.testing.assert_allclose(depth, np.asarray(t.depth), atol=3e-2)


def test_plain_saturating_scene():
    w = h = 32
    prep = jax_prep(saturating_scene(), _cam(w=w, h=h))
    rows, starts, ends, _ = jax_rows(prep, w, h)
    color, depth, final_t = port_blend(rows, starts, ends, w, h, bg=np.zeros(3, np.float32))
    t = render_tiled(prep, w, h, jnp.zeros(3), None, dup_capacity=1 << 14,
                     max_per_tile=512, chunk=16)
    assert final_t.min() < 1e-3  # saturated somewhere: the early stop ran
    np.testing.assert_allclose(color, np.asarray(t.color), atol=3e-3)
    np.testing.assert_allclose(final_t, np.asarray(t.final_T), atol=1e-4)


def test_plain_matches_pallas_kernel_interpret():
    """One tiny case against the TPU kernel itself (interpret mode, exact
    tier, no quad power): rows 6-9 of its accumulator and final_T."""
    w = h = 32
    offsets = offsets_for(h, w, 3)
    prep = jax_prep(_random_scene(n=40, seed=8), _cam(w=w, h=h))
    rows, starts, ends, tile_of_dup = jax_rows(prep, w, h, offsets)
    color, depth, final_t = port_blend(rows, starts, ends, w, h, offsets,
                                       bg=np.zeros(3, np.float32))
    gx = w // 16
    packed = np.zeros((16, rows.shape[0] + pb.G), np.float32)
    packed[:10, : rows.shape[0]] = rows[:, :10].T
    packed[0, : rows.shape[0]] -= (tile_of_dup % gx) * 16.0
    packed[1, : rows.shape[0]] -= (tile_of_dup // gx) * 16.0
    p = np.arange(256)
    pixf = np.zeros((starts.shape[0], 256, 2), np.float32)
    for t in range(starts.shape[0]):
        ys, xs = (t // gx) * 16 + p // 16, (t % gx) * 16 + p % 16
        pixf[t, :, 0] = p % 16 + offsets[ys, xs, 0]
        pixf[t, :, 1] = p // 16 + offsets[ys, xs, 1]
    acc, tfin = pb.blend(jnp.asarray(packed), jnp.asarray(pixf), jnp.asarray(starts),
                         jnp.asarray(ends), starts.shape[0], True, False, False)

    def untile(x):
        return np.asarray(x).reshape(h // 16, gx, 16, 16, -1).transpose(0, 2, 1, 3, 4).reshape(h, w, -1)

    acc = untile(acc)
    np.testing.assert_allclose(color, acc[..., pb.R_R:pb.R_B2 + 1], atol=3e-3)
    np.testing.assert_allclose(depth, acc[..., pb.R_DEPTH], atol=3e-2)
    np.testing.assert_allclose(final_t, untile(tfin)[..., 0], atol=3e-3)


def test_empty_tiles_and_no_rows():
    """Tiles with empty ranges give the background, depth 0 and T = 1, also
    when there are no rows at all."""
    w, h = 40, 20
    num_tiles = 3 * 2
    z = np.zeros(num_tiles, np.int32)
    color, depth, final_t = port_blend(np.zeros((0, 12), np.float32), z, z, w, h)
    np.testing.assert_array_equal(color, np.broadcast_to(BG, (h, w, 3)))
    assert (depth == 0).all() and (final_t == 1).all()


def test_wrapper_rejects_bad_inputs():
    rows = torch.zeros((4, 12))
    se = torch.zeros(4, dtype=torch.int32)
    bg = torch.zeros(3)
    with pytest.raises(ValueError):
        tblend.blend_fwd(rows[:, :10].contiguous(), se, se, 32, 32, bg)
    with pytest.raises(ValueError):
        tblend.blend_fwd(rows, se.long(), se, 32, 32, bg)
    with pytest.raises(ValueError):
        tblend.blend_fwd(rows, se[:3], se[:3], 32, 32, bg)
    with pytest.raises(ValueError):
        tblend.blend_fwd(rows.double(), se, se, 32, 32, bg)
    with pytest.raises(ValueError):
        tblend.blend_fwd(rows, se, se, 32, 32, bg, torch.zeros((32, 32, 2)).transpose(0, 1))
