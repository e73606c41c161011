"""K1's per-warp cull, plain (`blend.warp_boxes`, `warp_keep_reference`,
`warp_walk_counts`): the cull must never drop an entry that some sample of
the warp would take, so that culling changes no bit of the blend.

Rows come from the JAX pipeline (as in `tests/test_torch_blend.py`) or are
drawn directly: thin rotated conics (|B| near sqrt(AC)), opacities near
1/255, jitter offsets in [-1, 1]. A lane takes an entry where power <= 0
and alpha = min(0.99, opa exp(power)) >= 1/255, evaluated here as the
kernel does in float32, and again in float64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_rasterizer import _cam, _random_scene, _scene_from
from tests.test_torch_blend import BG, jax_rows, offsets_for, saturating_scene
from tests.test_torch_preprocess import jax_prep
from wast3d_tpu.ops.rasterizer.tiled import render_tiled
from wast3d_tpu_torch.ops.rasterizer import blend as tblend
from wast3d_tpu_torch.ops.rasterizer.binning import TILE, tile_grid

A255 = float(np.float32(1.0 / 255.0))


def corner_scene():
    """A few small splats in one corner: most tiles of a 96² view are empty."""
    rng = np.random.default_rng(5)
    n = 6
    return _scene_from(
        xyz=np.concatenate([rng.uniform(-1.6, -1.3, (n, 2)), np.zeros((n, 1))], 1),
        rgb=rng.uniform(0.2, 1.0, (n, 3)), scale=np.full((n, 3), 0.05),
        opacity=np.full((n, 1), 0.8))


SCENES = {  # name -> (scene, w, h, jittered)
    "random": (lambda: _random_scene(n=200, seed=0), 64, 64, False),
    "saturating": (saturating_scene, 32, 32, False),
    "jittered": (lambda: _random_scene(n=200, seed=2), 64, 48, True),
    "nonmultiple": (lambda: _random_scene(n=200, seed=1), 50, 34, False),
    "empty_tiles": (corner_scene, 96, 96, False),
}


def scene_inputs(name):
    make, w, h, jittered = SCENES[name]
    offsets = offsets_for(h, w, 7) if jittered else None
    prep = jax_prep(make(), _cam(w=w, h=h))
    rows, starts, ends, _ = jax_rows(prep, w, h, offsets)
    t = (torch.from_numpy(rows), torch.from_numpy(starts), torch.from_numpy(ends), w, h,
         None if offsets is None else torch.from_numpy(offsets))
    return t, prep


def warp_pixels(w, h, warp):
    """[H, W] mask of the image pixels that warp `warp` of each tile holds
    (8 x 4 pixels at (8 (warp % 2), 4 (warp // 2)))."""
    y = np.arange(h)[:, None] % TILE // tblend.WARP_H
    x = np.arange(w)[None, :] % TILE // tblend.WARP_W
    return torch.from_numpy((y * 2 + x) == warp)


def culled_blend(rows, starts, ends, w, h, offsets, bg):
    """The blend as K1 computes it with the cull: each warp's pixels from a
    plain blend whose culled entries (for that warp) have opacity 0."""
    keep = tblend.warp_keep_reference(rows, starts, ends, w, h, offsets)
    out = [t.clone() for t in tblend.blend_fwd_reference(rows, starts, ends, w, h, bg, offsets)]
    for warp in range(tblend.WARPS):
        r = rows.clone()
        r[~keep[:, warp], tblend.R_OPA] = 0.0
        part = tblend.blend_fwd_reference(r, starts, ends, w, h, bg, offsets)
        mask = warp_pixels(w, h, warp)
        for o, p in zip(out, part):
            o[mask] = p[mask]
    return out, keep


@pytest.mark.parametrize("name", sorted(SCENES))
def test_cull_changes_no_bit_of_the_blend(name):
    (rows, starts, ends, w, h, offsets), _ = scene_inputs(name)
    bg = torch.from_numpy(BG)
    plain = tblend.blend_fwd_reference(rows, starts, ends, w, h, bg, offsets)
    culled, keep = culled_blend(rows, starts, ends, w, h, offsets, bg)
    for a, b in zip(plain, culled):
        assert torch.equal(a, b)
    if rows.shape[0]:
        assert 0 < int(keep.sum()) < keep.numel()  # the cull both keeps and culls


@pytest.mark.parametrize("case", ["square", "jitter_nonmultiple"])
def test_culled_blend_matches_tiled(case):
    """The culled blend against JAX `renderer="tiled"`, at the tolerances of
    `test_torch_blend.py::test_plain_matches_tiled`."""
    w, h = (64, 64) if case == "square" else (50, 34)
    prep = jax_prep(_random_scene(n=200, seed=len(case)), _cam(w=w, h=h))
    offsets = offsets_for(h, w, 7) if case.startswith("jitter") else None
    rows, starts, ends, _ = jax_rows(prep, w, h, offsets)
    (color, depth, final_t), keep = culled_blend(
        torch.from_numpy(rows), torch.from_numpy(starts), torch.from_numpy(ends), w, h,
        None if offsets is None else torch.from_numpy(offsets), torch.from_numpy(BG))
    assert not bool(keep.all())
    t = render_tiled(prep, w, h, jnp.asarray(BG),
                     None if offsets is None else jnp.asarray(offsets),
                     dup_capacity=1 << 14, max_per_tile=512, chunk=16)
    assert not bool(t.overflow)
    np.testing.assert_allclose(color.numpy(), np.asarray(t.color), atol=3e-3)
    np.testing.assert_allclose(final_t.numpy(), np.asarray(t.final_T), atol=3e-3)
    np.testing.assert_allclose(depth.numpy(), np.asarray(t.depth), atol=3e-2)


def thin_rows(rng, w, h, per_tile):
    """[K, 12] rows drawn per tile: thin, rotated conics (axis ratios up to
    ~600, so |B| comes within ~1e-5 of sqrt(AC)), means around the tile,
    opacities from 0.9/255 to 3/255, some exactly 1/255; and the ranges."""
    grid_x, grid_y = tile_grid(w, h)
    rows, starts = [], []
    for t in range(grid_x * grid_y):
        x0, y0 = (t % grid_x) * TILE, (t // grid_x) * TILE
        theta = rng.uniform(0, np.pi, per_tile)
        l1 = 1.0 / rng.uniform(1.0, 40.0, per_tile) ** 2
        l2 = 1.0 / rng.uniform(0.07, 2.0, per_tile) ** 2
        c, s = np.cos(theta), np.sin(theta)
        r = np.zeros((per_tile, 12))
        r[:, 0] = x0 + rng.uniform(-12, 28, per_tile)
        r[:, 1] = y0 + rng.uniform(-12, 28, per_tile)
        r[:, 2], r[:, 3], r[:, 4] = l1 * c * c + l2 * s * s, (l1 - l2) * s * c, l1 * s * s + l2 * c * c
        r[:, 5] = A255 * np.exp(rng.uniform(np.log(0.9), np.log(3.0), per_tile))
        r[::7, 5] = A255
        r[:, 6] = rng.uniform(1, 5, per_tile)
        r[:, 7:10] = rng.uniform(0.1, 0.9, (per_tile, 3))
        starts.append(t * per_tile)
        rows.append(r)
    starts = np.array(starts, np.int32)
    return (torch.from_numpy(np.concatenate(rows).astype(np.float32)), torch.from_numpy(starts),
            torch.from_numpy(starts + per_tile))


def threshold_rows(rng, w, h, per_warp=26):
    """[K, 12] rows that put a sample exactly on the threshold: without
    jitter each warp's box corner (x0, y0) is a sample; per warp, splats
    with axis-aligned conics (B = 0: the least Q over the box is at that
    corner) centred just outside it, with opacities within a few ulps of
    exp(Q_corner / 2) / 255, where alpha at the corner is 1/255."""
    grid_x, grid_y = tile_grid(w, h)
    rows, starts = [], []
    for t in range(grid_x * grid_y):
        tx, ty = (t % grid_x) * TILE, (t // grid_x) * TILE
        for warp in range(tblend.WARPS):
            x0 = tx + tblend.WARP_W * (warp % 2)
            y0 = ty + tblend.WARP_H * (warp // 2)
            r = np.zeros((per_warp, 12))
            a, b = rng.uniform(0.5, 3.0, per_warp), rng.uniform(0.5, 3.0, per_warp)
            r[:, 0], r[:, 1] = x0 - a, y0 - b
            r[:, 2], r[:, 4] = rng.uniform(0.05, 0.6, per_warp), rng.uniform(0.05, 0.6, per_warp)
            r = r.astype(np.float32).astype(np.float64)  # the corner's Q from the float32 row
            q = r[:, 2] * (r[:, 0] - x0) ** 2 + r[:, 4] * (r[:, 1] - y0) ** 2
            ulps = rng.integers(-8, 9, per_warp)
            r[:, 5] = np.minimum(np.exp(q / 2) / 255.0 * (1.0 + ulps * 2.0 ** -23), 1.0)
            r[:, 6] = rng.uniform(1, 5, per_warp)
            r[:, 7:10] = rng.uniform(0.1, 0.9, (per_warp, 3))
            rows.append(r)
        starts.append(t * tblend.WARPS * per_warp)
    starts = np.array(starts, np.int32)
    return (torch.from_numpy(np.concatenate(rows).astype(np.float32)), torch.from_numpy(starts),
            torch.from_numpy(starts + tblend.WARPS * per_warp))


def lane_takes(rows, px, py, dtype):
    """[E, L] whether a sample (px, py) [E, L] takes each entry's row [E]:
    the kernel's expressions, in `dtype`."""
    r = rows.to(dtype)
    mx, my, a, b, c, opa = (r[:, i, None] for i in range(6))
    dx, dy = mx - px.to(dtype), my - py.to(dtype)
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    alpha = torch.clamp_max(opa * torch.exp(power), tblend.ALPHA_MAX)
    alpha_min = A255 if dtype == torch.float32 else 1.0 / 255.0
    return (power <= 0.0) & (alpha >= alpha_min)


@pytest.mark.parametrize("rows_from,seed", [("thin", 0), ("thin", 1), ("thin", 2),
                                           ("threshold", 3), ("threshold", 4)])
def test_culled_entries_are_skipped_at_every_sample(rows_from, seed):
    """For every (entry, warp) the cull drops, no sample of the warp takes
    the entry, in float32 (the kernel's arithmetic) or in float64: thin
    rotated splats under jitter, and splats whose alpha at a sample is
    1/255 to within a few ulps (where a cull without its margin fails)."""
    rng = np.random.default_rng(seed)
    w, h = 64, 48
    if rows_from == "thin":
        rows, starts, ends = thin_rows(rng, w, h, per_tile=150)
        offsets = torch.from_numpy(rng.uniform(-1, 1, (h, w, 2)).astype(np.float32))
    else:
        rows, starts, ends = threshold_rows(rng, w, h)
        offsets = None
    keep = tblend.warp_keep_reference(rows, starts, ends, w, h, offsets)
    px, py, _ = tblend._pixel_coords(w, h, offsets, "cpu")  # [T, 256]
    tile = torch.repeat_interleave(torch.arange(len(starts)), (ends - starts).long())
    near = 0
    for warp in range(tblend.WARPS):
        lanes = tblend.WARP_PIXELS[warp]
        culled = ~keep[:, warp]
        for dtype in (torch.float32, torch.float64):
            takes = lane_takes(rows[culled], px[tile[culled]][:, lanes],
                               py[tile[culled]][:, lanes], dtype)
            assert not bool(takes.any()), f"warp {warp}: a culled entry is taken ({dtype})"
        # how close the culled entries come: alpha at their best sample
        r = rows[culled].double()
        dx = r[:, 0, None] - px[tile[culled]][:, lanes].double()
        dy = r[:, 1, None] - py[tile[culled]][:, lanes].double()
        q = r[:, 2, None] * dx * dx + 2 * r[:, 3, None] * dx * dy + r[:, 4, None] * dy * dy
        alpha = r[:, 5, None] * torch.exp(-0.5 * q)
        near += int((alpha.amax(1) > 0.5 / 255.0).sum())
    assert 0 < int(keep.sum()) < keep.numel()
    assert near > 0  # some culled entries reach past half the threshold: the test bites


def test_rows_that_are_never_culled():
    """Non-finite rows and conics that are not positive definite are kept
    for every warp, whatever their opacity or distance; so are rows whose
    terms pass the cull's 1e30 bound."""
    w = h = 32
    far = [-40.0, -40.0]
    bad = [
        [*far, np.nan, 0.0, 1.0, 1e-4], [*far, 1.0, np.inf, 1.0, 1e-4],
        [*far, 1.0, 0.0, -np.inf, 0.5], [np.nan, 5.0, 1.0, 0.0, 1.0, 0.5],
        [5.0, np.inf, 1.0, 0.0, 1.0, 0.5], [*far, 1.0, 0.0, 1.0, np.nan],
        [*far, 1.0, 0.0, 1.0, np.inf],
        [*far, 0.0, 0.0, 1.0, 1e-4], [*far, 1.0, 0.0, 0.0, 0.5],  # semi-definite
        [*far, -1.0, 0.0, -1.0, 0.5], [*far, 0.3, 0.0, -0.05, 1e-4],  # negative, indefinite
        [*far, 1.0, 1.0, 1.0, 0.5],  # B^2 = AC
        [*far, 1.0, 0.9999995, 1.0, 0.5],  # AC - B^2 within the cull's 2^-20
        [*far, 1e-31, 0.0, 1.0, 0.5], [*far, 1e32, 0.0, 1.0, 0.5],
    ]
    rows = np.zeros((len(bad), 12), np.float32)
    rows[:, :6] = np.array(bad, np.float32)
    starts = np.zeros(4, np.int32)
    ends = np.full(4, len(bad), np.int32)  # every tile walks every row
    keep = tblend.warp_keep_reference(torch.from_numpy(rows), torch.from_numpy(starts),
                                      torch.from_numpy(ends), w, h)
    assert bool(keep.all())
    # the same rows, finite and positive definite, far away: culled everywhere
    good = rows.copy()
    good[:, :6] = [*far, 1.0, 0.0, 1.0, 0.5]
    keep = tblend.warp_keep_reference(torch.from_numpy(good), torch.from_numpy(starts),
                                      torch.from_numpy(ends), w, h)
    assert not bool(keep.any())


@pytest.mark.parametrize("w,h,jittered", [(64, 64, False), (50, 34, False), (50, 34, True)])
def test_warp_boxes_are_the_samples_min_and_max(w, h, jittered):
    offsets = (torch.from_numpy(np.random.default_rng(4).uniform(-1, 1, (h, w, 2))
                                .astype(np.float32)) if jittered else None)
    boxes = tblend.warp_boxes(w, h, offsets, device="cpu")
    grid_x, grid_y = tile_grid(w, h)
    assert boxes.shape == (grid_x * grid_y, tblend.WARPS, 4) and boxes.dtype == torch.float32
    off = np.zeros((h, w, 2), np.float32) if offsets is None else offsets.numpy()
    for t in range(grid_x * grid_y):
        for warp in range(tblend.WARPS):
            ys = (t // grid_x) * TILE + 4 * (warp // 2) + np.arange(4)
            xs = (t % grid_x) * TILE + 8 * (warp % 2) + np.arange(8)
            ys, xs = ys[ys < h], xs[xs < w]
            if len(ys) == 0 or len(xs) == 0:
                assert boxes[t, warp, 0] == np.inf and boxes[t, warp, 1] == -np.inf
                continue
            sx = xs[None, :].astype(np.float32) + off[ys][:, xs, 0]
            sy = ys[:, None].astype(np.float32) + off[ys][:, xs, 1]
            np.testing.assert_array_equal(boxes[t, warp].numpy(),
                                          [sx.min(), sx.max(), sy.min(), sy.max()])


def brute_force_counts(rows, starts, ends, w, h, offsets, keep):
    """K1's walk pixel by pixel in float32 numpy: (evaluated pairs, warp
    iterations, warp iterations of kept entries, contributing pairs)."""
    px, py, inside = (x.numpy() for x in tblend._pixel_coords(w, h, offsets, "cpu"))
    rows, keep = rows.numpy(), keep.numpy()
    f32 = np.float32
    evaluated = iters = iters_kept = contributing = 0
    for t in range(len(starts)):
        s, e = int(starts[t]), int(ends[t])
        T = np.ones(256, f32)
        done = ~inside[t]
        walked = np.zeros(256, np.int64)  # entries each pixel evaluates
        for j in range(s, e):
            walked[~done] += 1
            mx, my, a, b, c, opa = rows[j, :6]
            dx, dy = mx - px[t], my - py[t]
            power = f32(-0.5) * (a * dx * dx + c * dy * dy) - b * dx * dy
            alpha = np.minimum(f32(0.99), opa * np.exp(power))
            take = ~done & (power <= 0) & (alpha >= f32(1 / 255))
            test_t = T * (f32(1) - alpha)
            stop = take & (test_t < f32(1e-4))
            add = take & ~stop
            contributing += int(add.sum())
            T = np.where(add, test_t, T)
            done = done | stop
        evaluated += int(walked.sum())
        for warp in range(tblend.WARPS):
            n = int(walked[tblend.WARP_PIXELS[warp]].max())  # entries the warp issues
            iters += n
            iters_kept += int(keep[s:s + n, warp].sum())
    return evaluated, iters, iters_kept, contributing


@pytest.mark.parametrize("name", ["jittered", "saturating"])
def test_warp_walk_counts_match_brute_force(name):
    (rows, starts, ends, w, h, offsets), _ = scene_inputs(name)
    counts = tblend.warp_walk_counts(rows, starts, ends, w, h, offsets)
    keep = tblend.warp_keep_reference(rows, starts, ends, w, h, offsets)
    assert tuple(counts) == brute_force_counts(rows, starts, ends, w, h, offsets, keep)
    assert counts.evaluated_pairs == tblend.evaluated_pairs(rows, starts, ends, w, h, offsets)
    assert counts.contributing_pairs <= counts.evaluated_pairs
    assert 0 < counts.warp_iterations_culled < counts.warp_iterations


@pytest.mark.parametrize("w,h", [(64, 64), (50, 34)])
def test_fast_warp_boxes_are_tile_local(w, h):
    """K1f's warp boxes (`local=True`): the image boxes less each tile's
    origin, the jitter applied to the tile-local pixel in f32 as K1f adds
    it."""
    offsets = torch.from_numpy(np.random.default_rng(6).uniform(-1, 1, (h, w, 2))
                               .astype(np.float32))
    boxes = tblend.warp_boxes(w, h, offsets, device="cpu", local=True)
    grid_x, grid_y = tile_grid(w, h)
    off = offsets.numpy()
    for t in range(grid_x * grid_y):
        for warp in range(tblend.WARPS):
            ly, lx = 4 * (warp // 2) + np.arange(4), 8 * (warp % 2) + np.arange(8)
            ys, xs = (t // grid_x) * TILE + ly, (t % grid_x) * TILE + lx
            keep_y, keep_x = ys < h, xs < w
            if not keep_y.any() or not keep_x.any():
                assert boxes[t, warp, 0] == np.inf
                continue
            ys, xs, ly, lx = ys[keep_y], xs[keep_x], ly[keep_y], lx[keep_x]
            sx = lx[None, :].astype(np.float32) + off[ys][:, xs, 0]
            sy = ly[:, None].astype(np.float32) + off[ys][:, xs, 1]
            np.testing.assert_array_equal(boxes[t, warp].numpy(),
                                          [sx.min(), sx.max(), sy.min(), sy.max()])
