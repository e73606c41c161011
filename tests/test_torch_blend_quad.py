"""The quad route of the blend forward (JAX's `quad_power`): the port's plain
versions of K1q and K1fq (`blend.blend_fwd_reference(..., quad=True)`,
`blend.blend_fwd_fast_reference(..., quad=True)`) against the JAX package on
the CPU, its Pallas kernel in interpret mode.

- The power stage, on seeded (16, G) chunks (means on pixel centres among
  them, opacities near 1/255): JAX's `_chunk_quantities(..., pix8=)` (f32
  tier, triple split) and `_chunk_quantities_fast_quad` (bf16 tier, double
  split), called directly, against the port's `_quad_sum` and
  `_chunk(..., quad=True)`. Power within 2 ulps of the largest term c_k m_k
  of the expansion (measured: at most half an ulp of it, 99.7-99.99% of the
  values bit-equal); where the two powers are the same bits, the skip mask
  equal, and alpha equal in the bf16 tier and within 2^-22 relative in the
  f32 tier, where XLA's exp and torch's differ by an ulp (measured 2.1e-7).
- Frames on `tests/test_rasterizer._random_scene(n=120)` at 80 x 48, seeds
  0 and 1: the port's "pallas" frame (the plain quad route on the CPU)
  against JAX `renderer="pallas"` (the quad route, its default). bf16 tier:
  colour and final_T mean within 2e-6, max within the tier's 3e-2
  (measured: max 1.2e-7, mean 2.4-2.9e-9; the direct form's frame is at mean
  1.5-3.6e-5, held here to be at least ten times further). f32 tier: max
  2e-3 (K1's limit, stop flips), mean 1e-6 (measured: max 1.2-1.9e-5, mean
  3.2-4.0e-7, as far as the direct form's frame).
- The f32 tier's frame against JAX's power on the port's rows: the route's
  expansion cancels terms up to ~100 times power, so its bits follow how
  the coefficients are rounded. Called op by op, JAX's
  `_chunk_quantities(..., pix8=)` rounds every operation, as the port does;
  inside JAX's kernel XLA fuses them (its jitted alphas differ from the op
  by op ones in 1.5% of pairs). The port's frame is within mean 1e-7 of the
  frame composed from JAX's op-by-op alphas (measured 0.6-1.4e-8) and ten
  times nearer to it than the direct form's frame; JAX's kernel's final_T
  (no split-bf16 product takes part in it) is ten times nearer the frame
  of its jitted alphas than of its op-by-op ones. That is the f32 gap
  above, not JAX's split-bf16 scans.
- The gradient of JAX's ramp loss through K2's plain version, on the quad
  route's forward, against JAX's quad render: within JAX's own 2e-3 of the
  largest value (`tests/test_pallas_blend.py:503-530`).
- Routing, as JAX routes it: "pallas" and "cuda" without jitter take the
  quad route when `quad_power` is set; a jittered render, `quad_power=False`,
  "tiled", "torch" and "oracle" never do; the tile-sharded strip path takes
  it whenever `quad_power` is set (one gloo rank,
  `test_torch_parallel_ranks.strip_routes`).
- The quad cull (`warp_keep_reference(..., quad=True)`): no (entry, warp)
  it drops is taken at a pixel of the warp on the quad route, in both
  tiers, on JAX's scenes, thin rotated splats, splats whose alpha at a
  sample lies within a few ulps of 1/255, and narrow splats at the box
  corner where the route errs most (there, in the bf16 tier, K1f's margin
  alone would drop taken entries); and the blend with each warp's culled
  entries dropped equals the plain quad blend bit for bit.

`JAX_PLATFORMS=cpu python -m tests.test_torch_blend_quad` prints the frame
gaps quoted here, in PERF.md and ROADMAP.md (`report`).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_rasterizer import WHITE, _cam, _random_scene
from tests.test_torch_blend_cull import (
    SCENES, scene_inputs, thin_rows, threshold_rows, warp_pixels)
from tests.test_torch_parallel_ranks import STRIP_ROUTE_SETTINGS, strip_routes
from tests.test_torch_scene import port_cam, port_scene
from wast3d_tpu.ops.rasterizer import api as japi
from wast3d_tpu.ops.rasterizer import pallas_blend as pb
from wast3d_tpu_torch.ops.rasterizer import api as tapi
from wast3d_tpu_torch.ops.rasterizer import blend as tblend
from wast3d_tpu_torch.ops.rasterizer import render_path
from wast3d_tpu_torch.ops.rasterizer.binning import TILE, tile_grid
from wast3d_tpu_torch.ops.rasterizer.render_path import fast_rows
from wast3d_tpu_torch.parallel import multihost

PALLAS = japi.RasterizeSettings(renderer="pallas", dup_capacity=1 << 13,
                                pallas_interpret=True, grad_reduce="segsum")
W, H = 80, 48
TIERS = {"f32": False, "bf16": True}
FRAME_SEEDS = (0, 1)
FRAME_TOL = {False: (2e-3, 1e-6), True: (3e-2, 2e-6)}  # (max, mean) of colour and final_T
F32_WRITTEN_MEAN = 1e-7  # the f32 frame's mean against JAX's power evaluated op by op
ALPHA_RTOL_F32 = 2.0 ** -22
GRAD_TOL = 2e-3  # of the largest gradient value
P = pb.P
PX = (np.arange(P) % TILE).astype(np.float32)[:, None]  # JAX's pixel order in a tile
PY = (np.arange(P) // TILE).astype(np.float32)[:, None]


# ---- the power stage ---------------------------------------------------------------

def chunk_data(seed, fast):
    """A seeded (16, G) chunk in JAX's layout, tile-local means (bf16 in the
    bf16 tier): 32 means on pixel centres (where power is 0 and the
    expansion's residual can make it positive), 16 opacities just above
    1/255, thin and round conics."""
    g = pb.G
    rng = np.random.default_rng(seed)
    d = np.zeros((16, g), np.float32)
    d[0], d[1] = rng.uniform(-20, 36, g), rng.uniform(-20, 36, g)
    d[0, :32], d[1, :32] = rng.integers(0, TILE, 32), rng.integers(0, TILE, 32)
    theta = rng.uniform(0, np.pi, g)
    l1, l2 = 1 / rng.uniform(0.5, 30, g) ** 2, 1 / rng.uniform(0.3, 5, g) ** 2
    c, s = np.cos(theta), np.sin(theta)
    d[2], d[3], d[4] = l1 * c * c + l2 * s * s, (l1 - l2) * s * c, l1 * s * s + l2 * c * c
    d[5] = rng.uniform(1 / 255, 0.99, g)
    d[5, 32:48] = rng.uniform(1 / 255, 1.2 / 255, 16)
    d[6], d[7:10] = rng.uniform(1, 5, g), rng.uniform(0, 1, (3, g))
    return jnp.asarray(d).astype(jnp.bfloat16) if fast else jnp.asarray(d)


class _FirstMinimum:
    """jax.numpy with `minimum` recording its first argument: the quad
    route's raw power, which its clamp takes first (`pallas_blend.py:223`,
    `:386`)."""

    def __init__(self):
        self.first = None

    def __getattr__(self, name):
        return getattr(jnp, name)

    def minimum(self, a, b):
        if self.first is None:
            self.first = a
        return jnp.minimum(a, b)


def jax_power_stage(data, fast):
    """JAX's raw power and alpha (0 where skipped) [P, G] on one chunk."""
    one, zero = np.ones_like(PX), np.zeros_like(PX)
    pix8 = jnp.asarray(np.concatenate([PX * PX, PY * PY, PX * PY, PX, PY, one, zero, zero],
                                      1)).astype(jnp.bfloat16)
    log_t, done = jnp.zeros((P, 1)), jnp.zeros((P, 1))
    spy, saved = _FirstMinimum(), pb.jnp
    pb.jnp = spy
    try:
        if fast:
            out = pb._chunk_quantities_fast_quad(data, pix8, log_t, done, 0, pb.G, 0)
        else:
            out = pb._chunk_quantities(data, jnp.asarray(PX), jnp.asarray(PY), log_t, done, 0,
                                       pb.G, 0, pix8=pix8)
    finally:
        pb.jnp = saved
    return np.asarray(spy.first, np.float32), np.asarray(out[0].astype(jnp.float32))


@pytest.fixture(scope="module")
def power_stage():
    """{(seed, fast): (rows as the port holds them, JAX's power, JAX's alpha)}."""
    out = {}
    for fast in (False, True):
        for seed in (0, 1, 2):
            data = chunk_data(seed, fast)
            rows = torch.from_numpy(np.asarray(data.astype(jnp.float32)).T.copy())
            rows = rows.to(torch.bfloat16) if fast else rows[:, :tblend.ROW].contiguous()
            out[seed, fast] = (rows, *jax_power_stage(data, fast))
    return out


def port_power_stage(rows, fast):
    """The port's raw power, alpha and skip [P, G] on one tile holding the
    chunk's rows (tile-local means: the tile at the origin)."""
    r = rows.to(torch.float32)
    coef = tblend._quad_coefficients(*(r[:, i] for i in range(5)))
    px, py = torch.from_numpy(PX), torch.from_numpy(PY)
    raw = tblend._quad_sum(coef[None], px, py, fast)
    g = rows.shape[0]
    state = torch.zeros(1, P) if fast else torch.ones(1, P)
    origin = (torch.zeros(1), torch.zeros(1))
    _, _, _, alpha, skip, *_ = tblend._chunk(rows, torch.arange(g)[None],
                                              torch.ones(1, g, dtype=torch.bool), px.T, py.T,
                                              state, fast, True, origin)
    return raw.numpy(), alpha[0].numpy(), skip[0].numpy(), coef.numpy()


@pytest.mark.parametrize("tier", sorted(TIERS))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_power_stage_matches_jax(power_stage, tier, seed):
    fast = TIERS[tier]
    rows, j_power, j_alpha = power_stage[seed, fast]
    power, alpha, skip, coef = port_power_stage(rows, fast)
    mono = np.concatenate([PX * PX, PY * PY, PX * PY, PX, PY, np.ones_like(PX)], 1)  # [P, 6]
    largest = np.abs(coef[None].astype(np.float64) * mono[:, None, :]).max(-1)  # [P, G]
    np.testing.assert_array_less(np.abs(power - j_power),
                                 2 * np.spacing(largest.astype(np.float32)) + 1e-45)
    same = power == j_power
    assert same.mean() > 0.99
    assert bool(skip.any()) and not bool(skip.all())
    np.testing.assert_array_equal(skip[same], (j_alpha == 0)[same])
    if fast:
        np.testing.assert_array_equal(alpha[same], j_alpha[same])
    else:
        np.testing.assert_allclose(alpha[same], j_alpha[same], rtol=ALPHA_RTOL_F32, atol=0)
    # a pixel centre under a mean: the expansion's residual and the clamp
    assert bool((power[:, :32] > 0).any()) and not bool(skip[power > 0].all())


def test_quad_coefficients_and_splits_are_jaxs():
    """The coefficients and their bf16 parts as JAX computes them
    (`pallas_blend.py:198-210`, `:364-374`) on one chunk's bf16 rows, where
    every product is exact and so the f32 values are the same bits."""
    data = chunk_data(3, True)
    f = np.asarray(data.astype(jnp.float32))
    mx, my, a, b, c = (jnp.asarray(f[i]) for i in range(5))
    ah, ch, bn = -0.5 * a, -0.5 * c, -b
    want = np.stack([ah, ch, bn, -2.0 * ah * mx - bn * my, -2.0 * ch * my - bn * mx,
                     ah * mx * mx + ch * my * my + bn * mx * my], -1)
    coef = tblend._quad_coefficients(*(torch.from_numpy(f[i]) for i in range(5)))
    np.testing.assert_array_equal(coef.numpy(), want)
    hi, lo = pb._split2(jnp.asarray(want))
    parts = tblend._split(coef, 2)
    np.testing.assert_array_equal(parts[0].numpy(), np.asarray(hi.astype(jnp.float32)))
    np.testing.assert_array_equal(parts[1].numpy(), np.asarray(lo.astype(jnp.float32)))


# ---- frames and the gradient ---------------------------------------------------------

@pytest.fixture(scope="module")
def jax_frames():
    """JAX `renderer="pallas"` (interpret mode, the quad route) frames."""
    out = {}
    for fast in (False, True):
        for seed in FRAME_SEEDS:
            j = japi.render(_cam(w=W, h=H), _random_scene(n=120, seed=seed), WHITE,
                            settings=PALLAS._replace(fast_chain=fast))
            assert not bool(j["overflow"])
            out[seed, fast] = {k: np.asarray(j[k]) for k in ("render", "final_T", "depth")}
    return out


def port_frame(seed, fast, **settings):
    out = tapi.render(port_cam(w=W, h=H), port_scene(_random_scene(n=120, seed=seed)),
                      torch.ones(3), device="cpu",
                      settings=tapi.RasterizeSettings(renderer="pallas", fast_chain=fast,
                                                      **settings))
    return {k: out[k].numpy() for k in ("render", "final_T", "depth")}


@pytest.mark.parametrize("tier", sorted(TIERS))
@pytest.mark.parametrize("seed", FRAME_SEEDS)
def test_frames_match_jax_pallas(jax_frames, tier, seed):
    fast = TIERS[tier]
    got, want = port_frame(seed, fast), jax_frames[seed, fast]
    tol_max, tol_mean = FRAME_TOL[fast]
    for key in ("render", "final_T"):
        d = np.abs(got[key] - want[key])
        assert np.isfinite(got[key]).all()
        assert d.max() <= tol_max and d.mean() <= tol_mean, (key, d.max(), d.mean())
    if fast:
        # the direct form's frame is the gap this route closes
        direct = port_frame(seed, fast, quad_power=False)
        for key in ("render", "final_T"):
            quad_mean = np.abs(got[key] - want[key]).mean()
            assert 10 * quad_mean < np.abs(direct[key] - want[key]).mean(), key


# ---- the f32 tier's frame against JAX's power, written and fused ---------------------

def port_tiles(seed):
    """The port's f32 rows of `_random_scene(n=120, seed)` at W x H, as JAX's
    kernel packs them ([16, K + G], means recentred on each tile, one
    rounding), each tile's range, and the number of tiles."""
    cam, scene = port_cam(w=W, h=H), port_scene(_random_scene(n=120, seed=seed))
    binning, rows = render_path.bin_and_pack(tapi.preprocess_scene(cam, scene), W, H)
    grid_x, grid_y = tile_grid(W, H)
    tile = binning.tile_of_dup[:rows.shape[0]].long()
    local = rows.clone()
    local[:, tblend.R_MX] -= (tile % grid_x * TILE).float()
    local[:, tblend.R_MY] -= (tile // grid_x * TILE).float()
    packed = np.zeros((pb.NROWS, rows.shape[0] + pb.G), np.float32)
    packed[:10, :rows.shape[0]] = local[:, :10].numpy().T
    return packed, binning.tile_start.numpy(), binning.tile_end.numpy(), grid_x * grid_y


def composed_frame(packed, starts, ends, num_tiles, jit):
    """Colour on a white background and final_T [T, P], composed in f32 one
    entry at a time in walk order (T <- T (1 - alpha), colour += (alpha T)
    rgb; JAX's stop test, T (1 - alpha) < 1e-4) from JAX's f32 quad alphas,
    `_chunk_quantities(..., pix8=)` on each tile's rows: called op by op
    (`jit=False`: every operation rounded, the order the port follows) or
    under `jax.jit` (as in JAX's kernel, where XLA fuses the coefficients'
    products and sums)."""
    one, zero = np.ones_like(PX), np.zeros_like(PX)
    pix8 = jnp.asarray(np.concatenate([PX * PX, PY * PY, PX * PY, PX, PY, one, zero, zero],
                                      1)).astype(jnp.bfloat16)

    def alphas(data):
        state = jnp.zeros((P, 1))
        return pb._chunk_quantities(data, jnp.asarray(PX), jnp.asarray(PY), state, state, 0,
                                    pb.G, 0, pix8=pix8)[0]

    fn = jax.jit(alphas) if jit else alphas
    t_run = np.ones((num_tiles, P), np.float32)
    color = np.zeros((num_tiles, P, 3), np.float32)
    for t in range(num_tiles):
        s, e = int(starts[t]), int(ends[t])
        assert e - s <= pb.G  # one chunk a tile
        if e == s:
            continue
        data = np.zeros((pb.NROWS, pb.G), np.float32)
        data[:, :e - s] = packed[:, s:e]
        a = np.asarray(fn(jnp.asarray(data)))
        done = np.zeros(P, bool)
        for k in range(e - s):
            test = t_run[t] * (np.float32(1) - a[:, k])
            done |= test < np.float32(tblend.T_EPS)
            live = ~done
            color[t, live] += (a[live, k] * t_run[t, live])[:, None] * data[7:10, k]
            t_run[t, live] = test[live]
    return color + t_run[..., None], t_run


def jax_kernel_final_t(packed, starts, ends, num_tiles):
    """final_T [T, P] of JAX's f32 quad kernel (`pallas_blend.blend`,
    interpret mode) on the same rows: exp of its plain running sum of
    log1p(-alpha), which no split-bf16 product touches."""
    p = np.arange(P)
    pixf = np.stack([np.broadcast_to(p % TILE, (num_tiles, P)),
                     np.broadcast_to(p // TILE, (num_tiles, P))], -1).astype(np.float32)
    _, t_fin = pb.blend(jnp.asarray(packed), jnp.asarray(pixf), jnp.asarray(starts),
                        jnp.asarray(ends), num_tiles, True, False, True)
    return np.asarray(t_fin)


@pytest.fixture(scope="module")
def f32_power_frames():
    """Per seed, [T, P] colour and final_T: the port's "pallas" frame (the
    plain quad route) and its direct-form frame, the frames composed from
    JAX's quad alphas as written and as fused, and JAX's kernel's final_T."""
    def tiled(frame):
        return (tblend._tile(torch.from_numpy(frame["render"]), W, H).numpy(),
                tblend._tile(torch.from_numpy(frame["final_T"])[..., None], W, H).numpy()[..., 0])

    out = {}
    for seed in FRAME_SEEDS:
        tiles = port_tiles(seed)
        out[seed] = dict(quad=tiled(port_frame(seed, False)),
                         direct=tiled(port_frame(seed, False, quad_power=False)),
                         written=composed_frame(*tiles, jit=False),
                         fused=composed_frame(*tiles, jit=True),
                         kernel_final_t=jax_kernel_final_t(*tiles))
    return out


@pytest.mark.parametrize("seed", FRAME_SEEDS)
def test_f32_frame_is_jax_quad_power_composed(f32_power_frames, seed):
    """The f32 quad route is JAX's, as written: the port's frame is within
    the acceptance's mean of the frame composed from JAX's quad alphas
    evaluated op by op, and at least ten times nearer to it than the
    direct form's frame (measured: colour and final_T mean 0.6-1.4e-8, max
    1.4-6.4e-6; the direct frame's mean 1.9-4.0e-7)."""
    f = f32_power_frames[seed]
    for i, key in enumerate(("render", "final_T")):
        quad = np.abs(f["quad"][i] - f["written"][i])
        direct = np.abs(f["direct"][i] - f["written"][i])
        assert quad.max() <= FRAME_TOL[False][0] and quad.mean() <= F32_WRITTEN_MEAN, (
            key, quad.max(), quad.mean())
        assert 10 * quad.mean() < direct.mean(), (key, quad.mean(), direct.mean())


@pytest.mark.parametrize("seed", FRAME_SEEDS)
def test_jax_f32_quad_frame_is_its_fused_power(f32_power_frames, seed):
    """Why the f32 tier's frame is not JAX's Pallas frame: the route's
    expansion cancels terms up to ~100 times power, so its bits follow how
    the coefficients are rounded, and XLA fuses them inside JAX's kernel.
    JAX's kernel's final_T is the composition of its jitted alphas (measured
    mean 8-9e-9, max 1.2e-7) and ten times further from that of the same
    function called op by op (3.7-3.9e-7), which the port follows."""
    f = f32_power_frames[seed]
    to_fused = np.abs(f["kernel_final_t"] - f["fused"][1])
    to_written = np.abs(f["kernel_final_t"] - f["written"][1])
    # the kernel's exp(sum log1p(-alpha)) against the running product: ulps
    assert to_fused.max() <= 1e-6 and 10 * to_fused.mean() < to_written.mean(), (
        to_fused.max(), to_fused.mean(), to_written.mean())


def test_gradient_matches_jax_quad_render():
    """JAX's own quad test's loss (`tests/test_pallas_blend.py:518-530`):
    the port's gradient through K2's plain version on the quad forward."""
    js = _random_scene(n=120, seed=2)
    ramp = np.linspace(0.0, 1.0, H, dtype=np.float32)[:, None, None]

    def jax_loss(xyz):
        out = japi.render(_cam(w=W, h=H), js.replace(xyz=xyz), WHITE, settings=PALLAS)
        return jnp.mean(out["render"] ** 2 * ramp)

    g_jax = np.asarray(jax.grad(jax_loss)(js.xyz))
    xyz = torch.from_numpy(np.array(js.xyz)).requires_grad_(True)
    out = tapi.render(port_cam(w=W, h=H), port_scene(js).replace(xyz=xyz), torch.ones(3),
                      device="cpu")
    (g,) = torch.autograd.grad((out["render"] ** 2 * torch.from_numpy(ramp)).mean(), [xyz])
    scale = np.abs(g_jax).max()
    assert scale > 0 and np.abs(g.numpy() - g_jax).max() <= GRAD_TOL * scale


# ---- routing -----------------------------------------------------------------------

@pytest.fixture
def walks(monkeypatch):
    """The (fast, quad) of every plain blend walk run (`blend._walk`)."""
    seen, plain = [], tblend._walk

    def spy(*args, **kwargs):
        seen.append((kwargs.get("fast", False), kwargs.get("quad", False)))
        return plain(*args, **kwargs)

    monkeypatch.setattr(tblend, "_walk", spy)
    return seen


@pytest.mark.parametrize("renderer,fast,quad_power,jitter,want", [
    ("pallas", False, True, False, [(False, True)]),
    ("cuda", False, True, False, [(False, True)]),
    ("pallas", True, True, False, [(True, True)]),
    ("pallas", False, True, True, [(False, False)]),
    ("pallas", True, True, True, [(True, False)]),
    ("pallas", False, False, False, [(False, False)]),
    ("pallas", True, False, False, [(True, False)]),
    ("tiled", False, True, False, [(False, False)]),
    ("tiled", True, True, False, [(True, False)]),
    ("torch", False, True, False, [(False, False)]),
    ("oracle", False, True, False, []),
])
def test_render_routes_as_jax(walks, renderer, fast, quad_power, jitter, want):
    w, h = 32, 32
    offsets = (-torch.from_numpy(np.random.default_rng(1).uniform(0, 1, (h, w, 2))
                                 .astype(np.float32)) if jitter else None)
    out = tapi.render(port_cam(w=w, h=h), port_scene(_random_scene(n=20, seed=4)),
                      torch.ones(3), device="cpu", sampling_offsets=offsets,
                      settings=tapi.RasterizeSettings(renderer=renderer, fast_chain=fast,
                                                      quad_power=quad_power))
    assert np.isfinite(out["render"].numpy()).all()
    assert walks == want


def test_blend_and_wrappers_refuse_offsets_on_the_quad_route(walks):
    """K1q's wrapper and plain version refuse offsets (and a row0 that is
    not a multiple of 16); `blend` never hands them offsets: with
    `quad_power` set, a jittered blend takes the direct form, as JAX's."""
    rows = torch.zeros((0, tblend.ROW))
    z = torch.zeros(4, dtype=torch.int32)
    offsets = torch.zeros((32, 32, 2))
    for call in (tblend.blend_fwd_quad, functools.partial(tblend.blend_fwd_reference, quad=True)):
        with pytest.raises(ValueError, match="integer pixel positions"):
            call(rows, z, z, 32, 32, torch.zeros(3), offsets)
        with pytest.raises(ValueError, match="row0"):
            call(rows, z, z, 32, 32, torch.zeros(3), row0=8)
    tblend.blend(rows, z, z, 32, 32, torch.zeros(3), offsets, quad_power=True)
    tblend.blend(rows, z, z, 32, 32, torch.zeros(3), quad_power=True)
    assert walks == [(False, False), (False, True)]


def test_strip_path_takes_the_quad_route():
    scene = _random_scene(n=60, seed=3)
    fields = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity")
    inp = {"scene": {f: np.asarray(getattr(scene, f))[:60] for f in fields}}
    (routes,) = multihost.spawn(strip_routes, 1, (inp,), "gloo")
    assert set(routes) == set(STRIP_ROUTE_SETTINGS)
    assert routes == {"pallas": [(False, True)], "cuda": [(False, True)],
                      "pallas_fast": [(True, True)], "pallas_quad_power_off": [(False, False)],
                      "tiled": [(False, False)]}


# ---- the quad cull -----------------------------------------------------------------

def quad_threshold_rows(rng, w, h, per_warp=26):
    """[K, 12] rows at the threshold where the quad route errs most: per
    warp, narrow splats (A, C in [30, 100], |B| up to 0.3 sqrt(AC)) centred
    just beyond the sample of the warp's box nearest the tile's far corner,
    (x1, y1), where the expansion's terms (~A mx^2 / 2 at tile-local mx ~
    16) are hundreds of times Q, with alpha there within 5% of 1/255. In the
    bf16 tier K1f's margin alone drops entries that pixels take here (32 of
    ~18,500 dropped pairs on seed 5's rows); the quad margin keeps
    them. In the f32 tier K1's own margin covers the route's error here."""
    grid_x, grid_y = (w + TILE - 1) // TILE, (h + TILE - 1) // TILE
    rows, starts = [], []
    for t in range(grid_x * grid_y):
        tx, ty = (t % grid_x) * TILE, (t // grid_x) * TILE
        for warp in range(tblend.WARPS):
            x1 = tx + tblend.WARP_W * (warp % 2) + tblend.WARP_W - 1
            y1 = ty + tblend.WARP_H * (warp // 2) + tblend.WARP_H - 1
            r = np.zeros((per_warp, 12))
            r[:, 0] = x1 + rng.uniform(0.02, 0.15, per_warp)
            r[:, 1] = y1 + rng.uniform(0.02, 0.15, per_warp)
            r[:, 2], r[:, 4] = rng.uniform(30, 100, per_warp), rng.uniform(30, 100, per_warp)
            r[:, 3] = rng.uniform(-0.3, 0.3, per_warp) * np.sqrt(r[:, 2] * r[:, 4])
            r = r.astype(np.float32).astype(np.float64)
            dx, dy = r[:, 0] - x1, r[:, 1] - y1
            q = r[:, 2] * dx * dx + 2 * r[:, 3] * dx * dy + r[:, 4] * dy * dy
            r[:, 5] = np.minimum(np.exp(q / 2 + rng.uniform(-0.05, 0.05, per_warp)) / 255.0, 1.0)
            r[:, 6] = rng.uniform(1, 5, per_warp)
            r[:, 7:10] = rng.uniform(0.1, 0.9, (per_warp, 3))
            rows.append(r)
        starts.append(t * tblend.WARPS * per_warp)
    starts = np.array(starts, np.int32)
    return (torch.from_numpy(np.concatenate(rows).astype(np.float32)), torch.from_numpy(starts),
            torch.from_numpy(starts + tblend.WARPS * per_warp))


def quad_cull_inputs(name, fast):
    """(rows, starts, ends, w, h) of a cull case (the bf16 tier's rows with
    `fast`): one of JAX's scenes, thin rotated splats, splats at 1/255 at a
    box corner, or narrow ones at the corner where the quad route errs most."""
    if name in SCENES:
        (rows, starts, ends, w, h, _), _ = scene_inputs(name)
    else:
        rng = np.random.default_rng(5)
        w, h = 64, 48
        make = {"thin": functools.partial(thin_rows, per_tile=150),
                "threshold": threshold_rows, "quad_threshold": quad_threshold_rows}[name]
        rows, starts, ends = make(rng, w, h)
    if fast:
        tiles = torch.repeat_interleave(torch.arange(len(starts)), (ends - starts).long())
        rows = fast_rows(rows, tiles, w)
    return rows, starts, ends, w, h


def quad_takes(rows, starts, ends, w, h, fast):
    """[T, 256, L] whether each pixel of each tile takes each entry of the
    tile's range on the quad route (its plain version's skip test; L the
    longest range, False past a range's end and for pixels beyond the
    image), and the entries' indices [T, L]."""
    px, py, inside = tblend._pixel_coords(w, h, None, "cpu", local=True)
    starts, ends = starts.long(), ends.long()
    idx = starts[:, None] + torch.arange(int((ends - starts).max()))[None, :]
    in_range = idx < ends[:, None]
    idx = torch.minimum(idx, ends[:, None] - 1)
    t = torch.arange(len(starts))
    grid_x = (w + TILE - 1) // TILE
    origin = ((t % grid_x * TILE).float(), (t // grid_x * TILE).float())
    state = torch.zeros_like(px) if fast else torch.ones_like(px)
    skip = tblend._chunk(rows, idx, in_range, px, py, state, fast, True, origin)[4]
    return ~skip & inside[..., None], idx


@pytest.mark.parametrize("tier", sorted(TIERS))
@pytest.mark.parametrize("name", ["random", "saturating", "nonmultiple", "thin", "threshold",
                                  "quad_threshold"])
def test_quad_cull_drops_no_entry_a_pixel_takes(tier, name):
    """Every (entry, warp) that the quad cull drops is skipped at every
    pixel of the warp on the quad route, so that dropping it changes no
    bit (a skipped entry changes neither T nor the sums)."""
    fast = TIERS[tier]
    rows, starts, ends, w, h = quad_cull_inputs(name, fast)
    keep = tblend.warp_keep_reference(rows, starts, ends, w, h, None, fast, quad=True)
    takes, idx = quad_takes(rows, starts, ends, w, h, fast)
    for warp in range(tblend.WARPS):
        dropped = ~keep[idx, warp]  # [T, L]
        taken = takes[:, tblend.WARP_PIXELS[warp], :].any(dim=1)  # [T, L]
        assert not bool((dropped & taken).any()), f"warp {warp} drops an entry it takes"
    assert 0 < int(keep.sum()) < keep.numel() and bool(takes.any())


def quad_takes_within_mma_error(rows, starts, ends, w, h, fast):
    """`quad_takes` for any raw power within `blend.quad_mma_bound` of the
    plain version's (what K1q and K1fq may compute on the tensor cores): a
    pixel may take an entry if some power p in [raw - b, raw + b] is not
    skipped, that is p <= eps and the alpha of its clamp, min(p, 0), reaches
    1/255 (alpha grows with p, so p = min(raw + b, eps) decides), or if the
    raw power is NaN, which JAX's clamp keeps. Also the entries' indices."""
    px, py, inside = tblend._pixel_coords(w, h, None, "cpu", local=True)
    starts, ends = starts.long(), ends.long()
    idx = starts[:, None] + torch.arange(int((ends - starts).max()))[None, :]
    in_range = idx < ends[:, None]
    idx = torch.minimum(idx, ends[:, None] - 1)
    r = rows[idx].float()  # [T, L, width]
    mx, my = r[..., 0], r[..., 1]
    if not fast:  # K1q's recentring on the tile, one rounding
        t = torch.arange(len(starts))
        grid_x = (w + TILE - 1) // TILE
        mx = mx - (t % grid_x * TILE).float()[:, None]
        my = my - (t // grid_x * TILE).float()[:, None]
    coef = tblend._quad_coefficients(mx, my, r[..., 2], r[..., 3], r[..., 4])[:, None]
    pxe, pye = px[:, :, None], py[:, :, None]  # [T, 256, 1]
    raw = tblend._quad_sum(coef, pxe, pye, fast)  # [T, 256, L]
    bound = tblend.quad_mma_bound(coef, pxe, pye, fast)
    power = torch.clamp_max(raw + bound, 0.0)
    opa = r[:, None, :, 5]
    if fast:
        e = tblend.exp_table(power.to(torch.bfloat16), tblend.fast_tables())
        alpha = torch.clamp_max(tblend._bf(opa * e), tblend.ALPHA_MAX_BF16)
    else:
        alpha = torch.clamp_max(opa * torch.exp(power), tblend.ALPHA_MAX)
    may = (raw - bound <= tblend.QUAD_EPS[fast]) & (alpha >= tblend.ALPHA_MIN)
    may = (may | torch.isnan(raw)) & in_range[:, None, :] & inside[..., None]
    return may, idx, bound


@pytest.mark.parametrize("tier", sorted(TIERS))
@pytest.mark.parametrize("name", ["random", "saturating", "nonmultiple", "thin", "threshold",
                                  "quad_threshold"])
def test_quad_cull_covers_the_tensor_cores_error(tier, name):
    """No (entry, warp) that the quad cull drops may be taken at a pixel of
    the warp under any power within the MMA error model of the plain power
    (`quad_takes_within_mma_error`): the re-derived margins cover what the
    tensor cores' sum may change, so K1q's and K1fq's culls change no bit."""
    fast = TIERS[tier]
    rows, starts, ends, w, h = quad_cull_inputs(name, fast)
    keep = tblend.warp_keep_reference(rows, starts, ends, w, h, None, fast, quad=True)
    may, idx, bound = quad_takes_within_mma_error(rows, starts, ends, w, h, fast)
    for warp in range(tblend.WARPS):
        dropped = ~keep[idx, warp]  # [T, L]
        taken = may[:, tblend.WARP_PIXELS[warp], :].any(dim=1)  # [T, L]
        assert not bool((dropped & taken).any()), f"warp {warp} drops an entry it may take"
    takes, _ = quad_takes(rows, starts, ends, w, h, fast)
    assert bool((may | ~takes).all())  # the plain version's own takes among them
    assert 0 < int(keep.sum()) < keep.numel() and bool((bound > 0).any())


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_quad_cull_changes_no_bit(tier):
    """The quad blend as K1q (K1fq) computes it with its cull: each warp's
    pixels from a plain quad blend whose culled entries (for that warp) have
    opacity 0, bit-equal to the plain quad blend."""
    fast = TIERS[tier]
    rows, starts, ends, w, h = quad_cull_inputs("random", fast)
    plain = tblend.blend_fwd_fast_reference if fast else tblend.blend_fwd_reference
    bg = torch.tensor([0.2, 0.5, 0.9])
    keep = tblend.warp_keep_reference(rows, starts, ends, w, h, None, fast, quad=True)
    want = plain(rows, starts, ends, w, h, bg, quad=True)
    out = [t.clone() for t in want]
    for warp in range(tblend.WARPS):
        r = rows.clone()
        r[~keep[:, warp], tblend.R_OPA] = 0.0
        part = plain(r, starts, ends, w, h, bg, quad=True)
        mask = warp_pixels(w, h, warp)
        for o, p in zip(out, part):
            o[mask] = p[mask]
    for o, p in zip(out, want):
        assert torch.equal(o.view(torch.int32), p.view(torch.int32))
    assert not bool(keep.all())


@pytest.mark.parametrize("tier", sorted(TIERS))
@pytest.mark.parametrize("name", ["thin", "threshold", "quad_threshold"])
def test_quad_flip_walks_hold_the_plain_version(tier, name):
    """chip_smoke's allowance for K1q (K1fq) past its max limits
    (`quad_flip_outputs`, `quad_flip_explains`): at the sampled pixels the
    plain quad version's output is one of the walks that flipped decisions
    allow (within 1e-5 in the f32 tier, the tier's 3e-2 in the bf16 tier,
    whose float64 walk does not round T to bf16); the plain version explains
    itself; and a gap of four times the limit where no decision can flip is
    not explained. Every thirteenth pixel, so that all 16 x 16 positions of
    a tile and every tile are sampled."""
    import chip_smoke as cs

    fast = TIERS[tier]
    rows, starts, ends, w, h = quad_cull_inputs(name, fast)
    inputs = (rows, starts, ends, w, h)
    bg = torch.tensor([0.2, 0.5, 0.9])
    plain = (tblend.blend_fwd_fast_reference if fast else tblend.blend_fwd_reference)(
        rows, starts, ends, w, h, bg, quad=True)
    tol_max, _, tol_depth = cs.QUAD_TOL[fast]
    exact = None
    for pixel in range(0, w * h, 13):
        y, x = divmod(pixel, w)
        walks = cs.quad_flip_outputs(inputs, pixel, fast, bg)
        assert walks is not None, pixel
        leaves, allowances = walks
        want = np.array([*plain.color[y, x].tolist(), float(plain.depth[y, x]),
                         float(plain.final_T[y, x])])
        assert float(np.abs(leaves - want).max(-1).min()) <= (3e-2 if fast else 1e-5), pixel
        assert cs.quad_flip_explains(inputs, pixel, fast, bg, plain, plain, tol_max, tol_depth)
        if exact is None and len(leaves) == 1 and not allowances.any():
            exact = pixel
    if name == "thin":
        y, x = divmod(exact, w)
        color = plain.color.clone()
        color[y, x, 1] += 4 * tol_max
        wrong = tblend.BlendOutput(color, plain.depth, plain.final_T)
        assert not cs.quad_flip_explains(inputs, exact, fast, bg, wrong, plain, tol_max, tol_depth)


def test_quad_cull_keeps_what_the_direct_cull_keeps():
    """The quad margin only widens the direct cull's: every (entry, warp)
    the direct cull keeps, the quad cull keeps (tile-local means in the f32
    tier are the image means less a multiple of 16, exact here)."""
    rng = np.random.default_rng(12)
    w, h = 64, 48
    rows, starts, ends = thin_rows(rng, w, h, per_tile=150)
    direct = tblend.warp_keep_reference(rows, starts, ends, w, h)
    quad = tblend.warp_keep_reference(rows, starts, ends, w, h, quad=True)
    assert bool((quad | ~direct).all()) and int(quad.sum()) > int(direct.sum())


def test_quad_walk_all_is_a_test_hook_only():
    """K1q and K1fq take K1's and K1f's arguments (offsets null; K1q also
    its row0); their walks of every entry have the same signatures, and
    only chip_smoke.py calls them and the probe of their power."""
    import ctypes
    from pathlib import Path

    from wast3d_tpu_torch import _build

    sig = _build.SIGNATURES
    assert sig["w3d_blend_fwd_quad"] == sig["w3d_blend_fwd_quad_walk_all"]
    k1_args, k1q_args = sig["w3d_blend_fwd"][0], sig["w3d_blend_fwd_quad"][0]
    assert k1q_args == k1_args[:12] + [ctypes.c_int] + k1_args[12:]  # row0 after num_tiles
    assert (sig["w3d_blend_fwd_fast_quad"] == sig["w3d_blend_fwd_fast_quad_walk_all"]
            == sig["w3d_blend_fwd_fast"])
    root = Path(__file__).resolve().parent.parent
    src = (_build.SOURCE_DIR / "blend_fwd.cu").read_text()
    files = (sorted((root / "wast3d_tpu_torch").rglob("*.py")) + sorted(root.glob("*.py"))
             + sorted((root / "tools").glob("*.py")))
    for name in ("w3d_blend_fwd_quad_walk_all", "w3d_blend_fwd_fast_quad_walk_all",
                 "w3d_blend_quad_power_probe"):
        assert f"int {name}(" in src
        naming = {p.relative_to(root).as_posix() for p in files if name in p.read_text()}
        assert naming == {"wast3d_tpu_torch/_build.py", "chip_smoke.py"}, name


def report():
    """The measurements quoted in the module docstring, ROADMAP.md and
    PERF.md (CPU; the plain versions against JAX in interpret mode): frame
    gaps in both tiers with the quad route on and off, JAX's own Pallas
    frame against its `tiled` frame, and the bf16 tier's gap under jitter."""
    stats = lambda a, b: (float(np.abs(a - b).max()), float(np.abs(a - b).mean()))  # noqa: E731
    tiled = japi.RasterizeSettings(renderer="tiled", dup_capacity=1 << 13, max_per_tile=256,
                                   chunk=16)
    for fast in (False, True):
        for seed in FRAME_SEEDS:
            js = _random_scene(n=120, seed=seed)
            jq = japi.render(_cam(w=W, h=H), js, WHITE, settings=PALLAS._replace(fast_chain=fast))
            for quad in (True, False):
                got = port_frame(seed, fast, quad_power=quad)
                print(f"{'bf16' if fast else 'f32'} seed {seed} port quad_power={quad} vs JAX "
                      "pallas (quad): " + ", ".join(
                          f"{k} max {m:.3e} mean {a:.3e}" for k in ("render", "final_T")
                          for m, a in [stats(got[k], np.asarray(jq[k]))]))
            if not fast:
                jt = japi.render(_cam(w=W, h=H), js, WHITE, settings=tiled)
                print(f"f32 seed {seed} JAX pallas (quad) vs JAX tiled: render max %.3e mean "
                      "%.3e" % stats(np.asarray(jq["render"]), np.asarray(jt["render"])))
    for seed in (0, 1, 2):
        off = -np.random.default_rng(seed).uniform(0, 1, (H, W, 2)).astype(np.float32)
        js = _random_scene(n=120, seed=seed)
        j = japi.render(_cam(w=W, h=H), js, WHITE, settings=PALLAS._replace(fast_chain=True),
                        sampling_offsets=jnp.asarray(off))
        p = tapi.render(port_cam(w=W, h=H), port_scene(js), torch.ones(3), device="cpu",
                        sampling_offsets=torch.from_numpy(off),
                        settings=tapi.RasterizeSettings(renderer="pallas", fast_chain=True))
        print(f"bf16 seed {seed} jittered, port vs JAX pallas: " + ", ".join(
            f"{k} max {m:.3e} mean {a:.3e}" for k in ("render", "final_T")
            for m, a in [stats(p[k].numpy(), np.asarray(j[k]))]))


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu python -m tests.test_torch_blend_quad
    jax.config.update("jax_platforms", "cpu")
    report()
