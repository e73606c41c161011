"""Port parity: `wast3d_tpu_torch` binning against `wast3d_tpu`.

Both binnings get the same input, the JAX preprocess output (or raw
means/radii) converted to torch, so the comparison is exact: the same
sorted (tile, rank) sequence and the same tile_start / tile_end wherever the
JAX binning does not overflow its static capacities. The port has no
capacities, so its overflow flags are always False."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_rasterizer import _cam, _random_scene
from tests.test_tile_cull import _aniso_scene
from tests.test_torch_preprocess import run_both
from tests.test_torch_scene import port_cam
from wast3d_tpu.ops.rasterizer import binning as jbin
from wast3d_tpu_torch.ops.rasterizer import binning as tbin


def _t(x):
    return torch.from_numpy(np.array(x))


def bin_both(means2d, depths, radii, w, h, ext=None, cull=None, jitter_margin=0.0,
             two_key=False, jit=False):
    """cull: (conics, opacities) or None; ext: (ext_x, ext_y) or None;
    two_key: JAX takes its two-key (tile, rank) sort, the route of
    (num_tiles + 1) * N > 2^32, at any size; jit: JAX's binning as one
    compiled program (a few seconds less than op by op at a new N)."""
    jkw, tkw = {}, {}
    if ext is not None:
        jkw.update(ext_x=jnp.asarray(ext[0]), ext_y=jnp.asarray(ext[1]))
        tkw.update(ext_x=_t(ext[0]), ext_y=_t(ext[1]))
    if cull is not None:
        jkw.update(conics=jnp.asarray(cull[0]), opacities=jnp.asarray(cull[1]))
        tkw.update(conics=_t(cull[0]), opacities=_t(cull[1]))
    binning = functools.partial(
        jbin.bin_gaussians, width=w, height=h, dup_capacity=0, max_tiles_per_gaussian=4096,
        jitter_margin=jitter_margin, _force_two_key=two_key)
    j = (jax.jit(binning) if jit else binning)(
        jnp.asarray(means2d, jnp.float32), jnp.asarray(depths, jnp.float32),
        jnp.asarray(radii, jnp.int32), **jkw)
    t = tbin.bin_gaussians(
        _t(np.asarray(means2d, np.float32)), _t(np.asarray(depths, np.float32)),
        _t(np.asarray(radii, np.int32)), w, h, jitter_margin=jitter_margin, **tkw)
    return j, t


def assert_same_binning(j, t):
    assert not bool(j.overflow)
    assert not bool(t.overflow | t.overflow_emit | t.overflow_dup | t.overflow_rect)
    k = int(np.asarray(j.tile_end)[-1])
    assert int(t.num_duplicates) == k == int(j.num_duplicates) == t.rank.shape[0]
    np.testing.assert_array_equal(t.tile_of_dup.numpy(), np.asarray(j.tile_of_dup)[:k])
    np.testing.assert_array_equal(t.rank.numpy(), np.asarray(j.rank)[:k])
    np.testing.assert_array_equal(t.gauss_idx.numpy(), np.asarray(j.gauss_idx)[:k])
    np.testing.assert_array_equal(t.tile_start.numpy(), np.asarray(j.tile_start))
    np.testing.assert_array_equal(t.tile_end.numpy(), np.asarray(j.tile_end))


def test_small_splats():
    rng = np.random.default_rng(0)
    n = 256
    j, t = bin_both(rng.uniform(50, 750, (n, 2)), rng.uniform(1, 5, n),
                    np.full(n, 10), 800, 800)
    assert_same_binning(j, t)


def test_huge_splat_full_rect():
    """A screen-filling splat among small ones: the JAX ladder covers it
    with max_tiles_per_gaussian raised; the port needs no ceiling."""
    rng = np.random.default_rng(1)
    n = 256
    means = rng.uniform(100, 700, (n, 2))
    radii = np.full(n, 8)
    means[0], radii[0] = [400, 400], 180
    j, t = bin_both(means, rng.uniform(1, 5, n), radii, 800, 800)
    assert_same_binning(j, t)
    assert int(t.num_duplicates) >= 500


def test_depth_order_within_tile():
    means = np.array([[100.0, 100.0], [100.0, 100.0], [104.0, 104.0]])
    j, t = bin_both(means, [1.0, 2.0, 3.0], [60, 5, 5], 320, 320)
    assert_same_binning(j, t)
    tile = (100 // 16) * 20 + (100 // 16)
    s, e = int(t.tile_start[tile]), int(t.tile_end[tile])
    assert t.gauss_idx[s:e].tolist() == [0, 1, 2]


def test_culled_and_offscreen():
    """radii 0 (culled) and splats off the image emit nothing."""
    rng = np.random.default_rng(5)
    n = 100
    means = rng.uniform(-100, 200, (n, 2))
    radii = rng.integers(0, 30, n)
    j, t = bin_both(means, rng.uniform(1, 5, n), radii, 100, 70)
    assert_same_binning(j, t)


@pytest.mark.parametrize("two_key", [False, True], ids=["packed_key", "two_key"])
@pytest.mark.parametrize("tile_cull", [False, True])
@pytest.mark.parametrize("jitter_margin", [0.0, 1.0])
@pytest.mark.parametrize("scene", ["random", "aniso"])
def test_from_preprocess(tile_cull, jitter_margin, scene, two_key):
    """Tight extents and the exact tile cull on real preprocess output,
    against JAX's packed 32-bit key and against its two-key sort."""
    js = _random_scene(n=200, seed=2) if scene == "random" else _aniso_scene(n=120, seed=3)
    prep, _ = run_both(js, _cam(w=80, h=48), port_cam(w=80, h=48))
    cull = ((np.asarray(prep.conics), np.asarray(prep.opacities))
            if tile_cull else None)
    j, t = bin_both(np.asarray(prep.means2d), np.asarray(prep.depths),
                    np.asarray(prep.radii), 80, 48,
                    ext=(np.asarray(prep.extent_x), np.asarray(prep.extent_y)),
                    cull=cull, jitter_margin=jitter_margin, two_key=two_key)
    assert_same_binning(j, t)


def test_past_two_to_the_32_keys():
    """(num_tiles + 1) * N > 2^32, so JAX takes its two-key sort unforced,
    as at 4M Gaussians and 1296 x 832 (bench.py:383-395): 20,000 small
    splats on an 8192 x 8192 image, 262,144 tiles. The port's single int64
    key `tile * N + rank` reaches 5.2e9 here and must give JAX's lists."""
    rng = np.random.default_rng(13)
    n, side = 20_000, 8192
    num_tiles = tbin.tile_grid(side, side)[0] * tbin.tile_grid(side, side)[1]
    assert (num_tiles + 1) * n > 2 ** 32
    means = rng.uniform(-8, side + 8, (n, 2))
    radii = rng.integers(0, 8, n)  # at most 2 x 2 tiles: inside JAX's first emission phase
    j, t = bin_both(means, rng.uniform(1, 5, n), radii, side, side, jit=True)
    assert_same_binning(j, t)
    assert int(t.tile_of_dup[-1]) * n + int(t.rank[-1]) > 2 ** 32


def test_rank_of_inverts_depth_order():
    rng = np.random.default_rng(7)
    n = 64
    _, t = bin_both(rng.uniform(0, 64, (n, 2)), rng.uniform(1, 5, n),
                    rng.integers(0, 12, n), 64, 64)
    assert torch.equal(t.depth_order[t.rank_of], torch.arange(n))
    assert torch.equal(t.gauss_idx, t.depth_order[t.rank])


@pytest.mark.parametrize("tile_cull", [False, True])
@pytest.mark.parametrize("jitter_margin", [0.0, 1.0])
@pytest.mark.parametrize("scene", ["random", "aniso"])
def test_gaussian_segments_follow_the_stable_rank_sort(tile_cull, jitter_margin, scene):
    """The binning's own grouping (`sort_perm`, `presort_gauss`): every
    rank's segment holds the same sorted positions, in the same order, as
    the stable sort of `rank` gives it."""
    from wast3d_tpu_torch.ops.rasterizer import grad_reduce as tgr

    js = _random_scene(n=200, seed=11) if scene == "random" else _aniso_scene(n=120, seed=12)
    prep, _ = run_both(js, _cam(w=80, h=48), port_cam(w=80, h=48))
    cull = ((np.asarray(prep.conics), np.asarray(prep.opacities))
            if tile_cull else None)
    _, t = bin_both(np.asarray(prep.means2d), np.asarray(prep.depths),
                    np.asarray(prep.radii), 80, 48,
                    ext=(np.asarray(prep.extent_x), np.asarray(prep.extent_y)),
                    cull=cull, jitter_margin=jitter_margin)
    n, k = t.rank_of.shape[0], int(t.num_duplicates)
    assert k > 0 and t.presort_gauss.shape == (k,)
    assert bool((t.presort_gauss[1:] >= t.presort_gauss[:-1]).all())
    assert torch.equal(torch.sort(t.sort_perm).values, torch.arange(k))
    seg = tgr.binning_segments(t.sort_perm, t.presort_gauss, t.depth_order)
    offsets = tgr.segment_offsets(seg)
    assert offsets.dtype == torch.int32
    assert int(offsets[0]) == 0 and int(offsets[-1]) == k
    bare = tgr.rank_segments(t.rank, n)
    (lo, hi), (blo, bhi) = tgr.segment_bounds(seg), tgr.segment_bounds(bare)
    length = hi - lo
    assert torch.equal(length, bhi - blo)
    # the positions of every segment, row by row
    row = torch.repeat_interleave(torch.arange(n), length)
    p = lo[row] + torch.arange(k) - (torch.cumsum(length, 0) - length)[row]
    idx = tgr.source_index(seg)
    assert torch.equal(idx[p], bare.idx.long())
    assert torch.equal(t.rank[idx[p]], row)
