"""The bf16 tier of the blend (`fast_chain`: K1f and K2f through their plain
versions `blend_fwd_fast_reference` / `blend_bwd_fast_reference`, on JAX's
bf16 rows recentred on the tile, with the tables E and L) against the JAX
package on the CPU.

Fixture and bounds are JAX's own for its tier
(`tests/test_pallas_blend.py::test_fast_chain_close_to_f32`: 80 x 48, 120
Gaussians, the Pallas kernels in interpret mode): colour and final_T within
3e-2 of JAX `fast_chain=True` and of JAX `tiled` f32; the gradient of a ramp
loss with respect to xyz within max 0.15 and mean 5e-3 of the f32
gradient's largest value. The port's tier is also held to its own f32 plain
version at the same bounds. Measured on the three fixtures: colour within
1.6e-2 and final_T within 1.9e-2 of JAX `fast_chain=True`, gradients within
1.9e-2 (max) and 6.3e-4 (mean) of it, in units of the f32 gradient's
largest value (2.4e-2, 2.3e-2, 3.6e-2 and 9.4e-4 when the tier read f32
rows in image coordinates and took exp of f32 power); 1.8e-2 in colour and
4.5e-2 / 8.5e-4 in gradient from the f32 tier. The tables
are bf(exp) and bf(log1p(-a)) over every bf16 argument, and the rows keep a
splat near x = 790 subpixel-exact (recentred, then rounded). K1f's cull
(`warp_keep_reference(..., fast=True)`) must never drop an entry that some
sample of the warp takes under the bf16 chain, so culling changes no bit of
the fast blend."""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_datasets_eval import _make_blender_fixture
from tests.test_rasterizer import WHITE, _cam, _random_scene, _scene_from
from tests.test_torch_blend import BG
from tests.test_torch_blend_cull import (
    A255, SCENES, scene_inputs, thin_rows, threshold_rows, warp_pixels)
from tests.test_torch_scene import port_cam, port_scene
from wast3d_tpu.ops.rasterizer import api as japi
from wast3d_tpu.ops.rasterizer import pallas_blend
from wast3d_tpu.scene import datasets as jds
from wast3d_tpu.scene.ply import save_ply as jax_save_ply
from wast3d_tpu_torch.cli import render as tcli
from wast3d_tpu_torch.eval.render_sets import save_image
from wast3d_tpu_torch.ops.rasterizer import api as tapi
from wast3d_tpu_torch.ops.rasterizer import blend as tblend
from wast3d_tpu_torch.ops.rasterizer import render_path
from wast3d_tpu_torch.scene import datasets as tds
from wast3d_tpu_torch.scene.ply import load_ply
from wast3d_tpu_torch.utils.png import read_png

PALLAS = japi.RasterizeSettings(renderer="pallas", dup_capacity=1 << 13,
                                pallas_interpret=True, grad_reduce="segsum")
TILED = japi.RasterizeSettings(renderer="tiled", dup_capacity=1 << 13, max_per_tile=256,
                               chunk=16)
FAST = tapi.RasterizeSettings(renderer="tiled", fast_chain=True)
F32 = tapi.RasterizeSettings(renderer="tiled")
W, H = 80, 48
IMG_TOL = 3e-2
GRAD_MAX, GRAD_MEAN = 0.15, 5e-3


def offsets(jitter, seed):
    if not jitter:
        return None
    return -np.random.default_rng(seed).uniform(0, 1, (H, W, 2)).astype(np.float32)


def jax_out(js, settings, off):
    return japi.render(_cam(w=W, h=H), js, WHITE, settings=settings,
                       sampling_offsets=None if off is None else jnp.asarray(off))


def port_out(js, settings, off, xyz=None):
    ts = port_scene(js)
    if xyz is not None:
        ts = ts.replace(xyz=xyz)
    return tapi.render(port_cam(w=W, h=H), ts, torch.ones(3), settings=settings,
                       sampling_offsets=None if off is None else torch.from_numpy(off),
                       device="cpu")


@pytest.mark.parametrize("seed,jitter", [(0, False), (1, False), (2, True)])
def test_fast_render_matches_jax(seed, jitter):
    js = _random_scene(n=120, seed=seed)
    off = offsets(jitter, seed)
    f = port_out(js, FAST, off)
    p32 = port_out(js, F32, off)
    jf = jax_out(js, PALLAS._replace(fast_chain=True), off)
    jt = jax_out(js, TILED, off)
    assert not bool(jf["overflow"]) and not bool(jt["overflow"])
    for key in ("render", "final_T"):
        got = f[key].numpy()
        assert np.isfinite(got).all()
        for want in (np.asarray(jf[key]), np.asarray(jt[key]), p32[key].numpy()):
            np.testing.assert_allclose(got, want, atol=IMG_TOL, err_msg=key)
    # the tier rounds: it is not the f32 blend
    assert not np.array_equal(f["render"].numpy(), p32["render"].numpy())


@pytest.mark.parametrize("seed,jitter", [(0, False), (1, False), (2, True)])
def test_fast_gradients_match_jax(seed, jitter):
    js = _random_scene(n=120, seed=seed)
    off = offsets(jitter, seed)
    ramp = np.linspace(0.0, 1.0, H, dtype=np.float32)[:, None, None]

    def jax_grad(settings):
        def loss(xyz):
            out = jax_out(js.replace(xyz=xyz), settings, off)
            return jnp.mean(out["render"] ** 2 * ramp)
        return np.asarray(jax.grad(loss)(js.xyz))

    def port_grad(settings):
        xyz = torch.from_numpy(np.array(js.xyz)).requires_grad_(True)
        out = port_out(js, settings, off, xyz=xyz)
        loss = (out["render"] ** 2 * torch.from_numpy(ramp)).mean()
        return torch.autograd.grad(loss, [xyz])[0].numpy()

    g_fast, g32 = port_grad(FAST), port_grad(F32)
    g_jf, g_jt = jax_grad(PALLAS._replace(fast_chain=True)), jax_grad(TILED)
    scale = float(np.abs(g_jt).max()) + 1e-12
    assert np.isfinite(g_fast).all()
    for name, want in (("jax fast", g_jf), ("jax tiled", g_jt), ("port f32", g32)):
        d = np.abs(g_fast - want) / scale
        assert d.max() < GRAD_MAX, (name, d.max())
        assert d.mean() < GRAD_MEAN, (name, d.mean())
    assert not np.array_equal(g_fast, g32)


def test_fast_saturating_scene_matches_jax():
    """Early stop under the bf16 chain: stacked opaque splats (JAX's
    `test_fast_chain_saturating_scene`)."""
    rng = np.random.default_rng(4)
    n = 100
    js = _scene_from(
        xyz=np.concatenate([rng.normal(size=(n, 2)) * 0.05, np.linspace(-1, 1, n)[:, None]], 1),
        rgb=rng.uniform(0.2, 1.0, (n, 3)), scale=np.full((n, 3), 0.3),
        opacity=np.full((n, 1), 0.95))
    cam = _cam(w=32, h=32)
    jf = japi.render(cam, js, jnp.zeros(3), settings=PALLAS._replace(fast_chain=True))
    f = tapi.render(port_cam(w=32, h=32), port_scene(js), torch.zeros(3), settings=FAST,
                    device="cpu")
    np.testing.assert_allclose(f["render"].numpy(), np.asarray(jf["render"]), atol=IMG_TOL)
    np.testing.assert_allclose(f["final_T"].numpy(), np.asarray(jf["final_T"]), atol=IMG_TOL)
    assert float(f["final_T"].min()) < 1e-3


def jax_fast_blend_grads(rows, starts, ends, w, h, grads):
    """JAX's fast blend kernel (`pallas_blend.blend(fast=True)`, interpret
    mode) and its VJP on the port's rows: [K, 10] gradient columns. One
    tile at the image origin, so image and tile-local coordinates agree."""
    k = rows.shape[0]
    packed = np.zeros((16, k + pallas_blend.G), np.float32)
    packed[:10, :k] = rows[:, :10].numpy().T
    p = np.arange(tblend.PIXELS)
    pixf = np.stack([p % 16, p // 16], -1).astype(np.float32)[None]
    assert w == h == 16 and len(starts) == 1
    (_, _), vjp = jax.vjp(
        lambda pk: pallas_blend.blend(pk, jnp.asarray(pixf), jnp.asarray(starts.numpy()),
                                      jnp.asarray(ends.numpy()), 1, True, True, False),
        jnp.asarray(packed))
    g_acc = np.zeros((1, tblend.PIXELS, 16), np.float32)
    g_acc[0, :, pallas_blend.R_DEPTH] = grads.depth.numpy().reshape(-1)
    g_acc[0, :, pallas_blend.R_R:pallas_blend.R_B2 + 1] = grads.color.numpy().reshape(-1, 3)
    g_t = jnp.asarray(grads.final_T.numpy().reshape(1, -1))
    return np.asarray(vjp((jnp.asarray(g_acc), g_t))[0])[:10, :k].T


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_alpha_at_the_bf16_clamp_keeps_its_gradient_as_in_jax(seed):
    """A wide, fully opaque splat reaches the clamp bf(0.99) = 0.98828125 at
    every pixel. JAX's fast backward tests alpha < 0.99 in f32, which the
    clamp passes, so unlike the f32 tier the clamped splat keeps its power
    and opacity gradient; K2f's plain version gives JAX's kernel's
    gradients on the same rows, per column within 1e-2 of that column's
    largest value (the bound the card holds K2f to)."""
    w = h = 16
    rows = torch.zeros((2, tblend.ROW_FAST))
    rows[:, :6] = torch.tensor([[8.0, 8.0, 1e-6, 0.0, 1e-6, 1.0],
                                [4.0, 4.0, 0.5, 0.0, 0.5, 0.6]])
    rows[:, 6:10] = torch.tensor([[2.0, 0.2, 0.5, 0.8], [3.0, 0.9, 0.1, 0.3]])
    rows = rows.to(torch.bfloat16)  # one tile at the origin: local = image coordinates
    starts, ends = torch.tensor([0], dtype=torch.int32), torch.tensor([2], dtype=torch.int32)
    bg = torch.zeros(3)
    out = tblend.blend_fwd_fast_reference(rows, starts, ends, w, h, bg)
    rng = np.random.default_rng(seed)
    grads = tblend.BlendOutput(
        *(torch.from_numpy(rng.uniform(-1, 1, s).astype(np.float32))
          for s in ((h, w, 3), (h, w), (h, w))))
    d = tblend.blend_bwd_fast_reference(rows, starts, ends, w, h, bg, None, out, grads)
    want = jax_fast_blend_grads(rows.float(), starts, ends, w, h, grads)
    assert tblend.ALPHA_MAX_BF16 == 0.98828125
    np.testing.assert_allclose(out.final_T.numpy().max(), 1.0 - 0.98828125, rtol=1e-2)
    assert d.dtype == torch.bfloat16 and bool((d[:, 10:] == 0).all())
    assert bool((d[:, :10] != 0).all())  # the clamped splat too
    err = np.abs(d[:, :10].float().numpy() - want).max(0) / np.abs(want).max(0)
    assert err.max() <= 1e-2, err


def to_fast(rows, starts, ends, w):
    """f32 rows of the ranges [starts, ends) in image coordinates to the bf16
    tier's rows (`render_path.fast_rows`)."""
    tile = torch.repeat_interleave(torch.arange(len(starts)), (ends - starts).long())
    return render_path.fast_rows(rows, tile, w)


def lane_takes_fast(rows, px, py):
    """[E, L] whether a tile-local sample (px, py) takes each entry of the
    bf16 rows under the bf16 chain, evaluated as K1f does: f32 power from
    the rows' values in JAX's direct form, alpha = min(bf(0.99), bf(opa
    E[bf(power)]))."""
    mx, my, a, b, c, opa = (rows[:, i, None].float() for i in range(6))
    dx, dy = mx - px, my - py
    power = (-0.5 * a * dx) * dx + (-0.5 * c * dy) * dy + (-b * dx) * dy
    e = tblend.exp_table(power.to(torch.bfloat16), tblend.fast_tables())
    alpha = torch.clamp_max(tblend._bf(opa * e), tblend.ALPHA_MAX_BF16)
    return (power <= 0.0) & (alpha >= A255)


def near_fast_threshold_rows(rng, w, h):
    """`threshold_rows` as the bf16 tier's rows, with each opacity moved by
    up to 8 steps of bf16 (2^-8 relative at most), so that the rounded
    alpha at the warp's corner sample lands on either side of 1/255 and the
    cull's margin (2^-5 on tau: opacity within about 1.6% of the
    threshold) is crossed on both sides."""
    rows, starts, ends = threshold_rows(rng, w, h)
    rows = to_fast(rows, starts, ends, w)
    step = torch.from_numpy(rng.integers(-8, 9, rows.shape[0]).astype(np.int16))
    opa = rows[:, 5].view(torch.int16) + step  # neighbouring bf16 values
    rows[:, 5] = torch.clamp_max(opa.view(torch.bfloat16), 1.0)
    return rows, starts, ends


@pytest.mark.parametrize("rows_from,seed", [("thin", 0), ("thin", 1), ("threshold", 3),
                                           ("threshold", 4)])
def test_fast_cull_never_drops_a_taken_entry(rows_from, seed):
    rng = np.random.default_rng(seed)
    w, h = 64, 48
    if rows_from == "thin":
        rows, starts, ends = thin_rows(rng, w, h, per_tile=150)
        rows = to_fast(rows, starts, ends, w)
        off = torch.from_numpy(rng.uniform(-1, 1, (h, w, 2)).astype(np.float32))
    else:
        rows, starts, ends = near_fast_threshold_rows(rng, w, h)
        off = None
    keep = tblend.warp_keep_reference(rows, starts, ends, w, h, off, fast=True)
    px, py, _ = tblend._pixel_coords(w, h, off, "cpu", local=True)
    tile = torch.repeat_interleave(torch.arange(len(starts)), (ends - starts).long())
    near = 0
    for warp in range(tblend.WARPS):
        lanes = tblend.WARP_PIXELS[warp]
        culled = ~keep[:, warp]
        cpx, cpy = px[tile[culled]][:, lanes], py[tile[culled]][:, lanes]
        assert not bool(lane_takes_fast(rows[culled], cpx, cpy).any()), f"warp {warp}"
        r = rows[culled].double()
        dx, dy = r[:, 0, None] - cpx.double(), r[:, 1, None] - cpy.double()
        q = r[:, 2, None] * dx * dx + 2 * r[:, 3, None] * dx * dy + r[:, 4, None] * dy * dy
        near += int(((r[:, 5, None] * torch.exp(-0.5 * q)).amax(1) > 0.5 / 255.0).sum())
    assert 0 < int(keep.sum()) < keep.numel()
    assert near > 0  # culled entries come close to the threshold: the test bites
    # the fast cull keeps at least what the f32 cull keeps on the same values
    # (the f32 cull on image coordinates: the bf16 rows' means plus the origin)
    r32 = rows[:, :12].float()
    grid_x = -(-w // 16)
    r32[:, 0] += (tile % grid_x).float() * 16
    r32[:, 1] += (tile // grid_x).float() * 16
    keep32 = tblend.warp_keep_reference(r32, starts, ends, w, h, off)
    assert bool((keep | ~keep32).all())


@pytest.mark.parametrize("name", sorted(SCENES))
def test_fast_cull_changes_no_bit_of_the_fast_blend(name):
    """Each warp's pixels from a fast blend whose entries culled for that
    warp have opacity 0 equal the fast blend of every entry, bit for bit
    (what K1f against its walk of every entry shows on the card)."""
    (rows, starts, ends, w, h, off), _ = scene_inputs(name)
    rows = to_fast(rows, starts, ends, w)
    bg = torch.from_numpy(BG)
    plain = tblend.blend_fwd_fast_reference(rows, starts, ends, w, h, bg, off)
    keep = tblend.warp_keep_reference(rows, starts, ends, w, h, off, fast=True)
    for warp in range(tblend.WARPS):
        r = rows.clone()
        r[~keep[:, warp], tblend.R_OPA] = 0.0
        part = tblend.blend_fwd_fast_reference(r, starts, ends, w, h, bg, off)
        mask = warp_pixels(w, h, warp)
        for a, b in zip(plain, part):
            assert torch.equal(a[mask], b[mask])
    if rows.shape[0]:
        assert 0 < int(keep.sum()) < keep.numel()


def test_fast_wrappers_take_plain_versions_on_cpu():
    js = _random_scene(n=40, seed=1)
    prep = tapi.preprocess_scene(port_cam(w=32, h=32), port_scene(js))
    binning, rows = render_path.bin_and_pack(prep, 32, 32, fast=True)
    assert rows.dtype == torch.bfloat16 and rows.shape[1] == tblend.ROW_FAST
    args = (rows.detach(), binning.tile_start, binning.tile_end, 32, 32, torch.zeros(3))
    grads = tblend.BlendOutput(torch.ones(32, 32, 3), torch.ones(32, 32), torch.ones(32, 32))
    before = (tblend.blend_fwd_fast.launches, tblend.blend_bwd_fast.launches)
    out = tblend.blend_fwd_fast(*args)
    assert all(torch.equal(a, b) for a, b in zip(out, tblend.blend_fwd_fast_reference(*args)))
    d = tblend.blend_bwd_fast(*args, None, out, grads)
    assert torch.equal(d, tblend.blend_bwd_fast_reference(*args, None, out, grads))
    assert d.dtype == torch.bfloat16 and d.shape == rows.shape
    assert (tblend.blend_fwd_fast.launches, tblend.blend_bwd_fast.launches) == before == (0, 0)
    with pytest.raises(ValueError):
        tblend.blend_fwd_fast(args[0].double(), *args[1:])
    with pytest.raises(ValueError):  # the f32 tier's rows
        tblend.blend_fwd_fast(render_path.bin_and_pack(prep, 32, 32)[1].detach(), *args[1:])


def test_settings_accept_jaxs_tpu_tiers():
    s = tapi.RasterizeSettings()
    assert (s.fast_chain, s.quad_power, s.pack_gather) == (False, True, False)
    j = japi.RasterizeSettings()
    assert (j.fast_chain, j.quad_power, j.pack_gather) == (s.fast_chain, s.quad_power,
                                                           s.pack_gather)
    js = _random_scene(n=16, seed=0)
    with pytest.raises(ValueError, match="fast_chain"):
        tapi.render(port_cam(w=32, h=32), port_scene(js), torch.ones(3), device="cpu",
                    settings=FAST._replace(pack_gather=True, fast_chain=False))
    a = tapi.render(port_cam(w=32, h=32), port_scene(js), torch.ones(3), device="cpu",
                    settings=FAST._replace(pack_gather=True, quad_power=False))
    b = tapi.render(port_cam(w=32, h=32), port_scene(js), torch.ones(3), device="cpu",
                    settings=FAST)
    # pack_gather builds the rows with JAX's split-bf16 roundings (Kg,
    # tests/test_torch_pack_gather.py): within JAX's own bounds of the plain
    # fast render (tests/test_pallas_blend.py::test_pack_gather_matches_fast_chain).
    np.testing.assert_allclose(a["render"].numpy(), b["render"].numpy(), atol=1.5e-2)
    np.testing.assert_allclose(a["final_T"].numpy(), b["final_T"].numpy(), atol=1.5e-2)
    np.testing.assert_allclose(a["depth"].numpy(), b["depth"].numpy(), rtol=3e-2, atol=3e-2)


def test_cli_render_is_fast_by_default(tmp_path):
    """`cli.render` writes the bf16 tier's renders by default and the f32
    tier's with `--no-fast`, each the bytes of `api.render` with that
    setting."""
    src = str(tmp_path / "scene")
    _make_blender_fixture(src)
    rng = np.random.default_rng(0)
    jds.store_ply_points(os.path.join(src, "points3d.ply"),
                         rng.uniform(-1, 1, (200, 3)), rng.uniform(0, 255, (200, 3)))
    n = 150
    scene = _scene_from(
        xyz=rng.normal(size=(n, 3)) * [0.8, 0.8, 0.3] + [0, 0, -7],
        rgb=rng.uniform(0.1, 0.9, (n, 3)), scale=rng.uniform(0.05, 0.2, (n, 3)),
        opacity=rng.uniform(0.3, 0.95, (n, 1)))
    fast_model, f32_model = str(tmp_path / "fast"), str(tmp_path / "f32")
    jax_save_ply(scene, os.path.join(fast_model, "point_cloud", "iteration_7",
                                     "point_cloud.ply"))
    shutil.copytree(fast_model, f32_model)
    tcli.main(["-m", fast_model, "-s", src, "--device", "cpu"])
    tcli.main(["-m", f32_model, "-s", src, "--no-fast", "--device", "cpu"])

    info = tds.load_scene_info(src)
    cams = tds.build_cameras(info.train_cameras, device="cpu")
    ts = load_ply(os.path.join(fast_model, "point_cloud", "iteration_7", "point_cloud.ply"),
                  device="cpu")
    differ = False
    for model, settings in ((fast_model, FAST._replace(renderer="cuda")),
                            (f32_model, F32._replace(renderer="cuda"))):
        for i, (cam, _) in enumerate(cams):
            want = tapi.render(cam, ts, torch.zeros(3), settings=settings,
                               device="cpu")["render"].numpy()
            path = str(tmp_path / "want.png")
            save_image(path, want)
            got = read_png(os.path.join(model, "train", "ours_7", "renders", f"{i:05d}.png"))
            assert np.array_equal(got, read_png(path)), (model, i)
    for i in range(len(cams)):
        a, b = (read_png(os.path.join(m, "train", "ours_7", "renders", f"{i:05d}.png"))
                for m in (fast_model, f32_model))
        assert np.abs(a.astype(int) - b.astype(int)).max() <= round(IMG_TOL * 255)
        differ |= not np.array_equal(a, b)
    assert differ  # the two tiers wrote other bytes


def bf16_round64(v):
    """float64 values rounded once to bfloat16 (8 significant bits, to
    nearest, ties to even), as float64."""
    m, e = np.frexp(v)
    return np.ldexp(np.round(m * 256.0) / 256.0, e)


def test_tables_are_exp_and_log1p_rounded_to_bf16():
    """E and L over all 65,536 bf16 patterns: E[x] is bf(exp(x)) wherever x
    <= 0 and |x| < 16 (1 below 2^-9, where exp rounds to 1), and 0 from 16
    up and for -inf and NaN, where exp(x) < 1.2e-7 skips the entry or stops
    the pixel all the same; L[a] is bf(log1p(-a)) for every bf16 alpha in
    [1/255, 0.98828125]. The f32 construction rounds to the same bf16 values
    as a float64 one rounded once."""
    tables = tblend.fast_tables()
    assert tables.dtype == torch.bfloat16 and tables.numel() * 2 == 5376
    x = torch.arange(65536).to(torch.int16).view(torch.bfloat16)
    xf, xd = x.float(), x.double().numpy()
    e = tblend.exp_table(x, tables).double().numpy()
    neg = (xf <= 0).numpy()
    inside = neg & (np.abs(xd) < 16)
    table = inside & (np.abs(xd) >= 2.0 ** -9)
    # below the table: the 15,104 negative patterns under 2^-9 (-0 too), and +0
    assert int(table.sum()) == 1664 and int((inside & ~table).sum()) == 118 * 128 + 1
    want32 = torch.exp(xf).to(torch.bfloat16).double().numpy()
    want64 = bf16_round64(np.exp(xd, where=inside, out=np.zeros_like(xd)))
    np.testing.assert_array_equal(e[inside], want32[inside])
    np.testing.assert_array_equal(want32[inside], want64[inside])
    assert (e[inside & ~table] == 1.0).all()
    beyond = (neg & (np.abs(xd) >= 16)) | np.isnan(xd)
    assert (e[beyond] == 0.0).all() and np.exp(-16.0) < 1.2e-7

    a = xf.numpy()
    dom = (a >= np.float32(1.0 / 255.0)) & (a <= 0.98828125)
    assert int(dom.sum()) == 1021
    got = tblend.log1m_table(x[torch.from_numpy(dom)], tables).double().numpy()
    np.testing.assert_array_equal(
        got, torch.log1p(-xf[torch.from_numpy(dom)]).to(torch.bfloat16).double().numpy())
    np.testing.assert_array_equal(got, bf16_round64(np.log1p(-xd[dom])))


def right_edge_scene(n=12, seed=5):
    """Small splats whose means project near x = 790 of an 800-pixel-wide
    view (`_cam(w=800, h=32)`), where bf16's spacing is 4 pixels."""
    rng = np.random.default_rng(seed)
    return _scene_from(
        xyz=np.stack([rng.uniform(2.04, 2.08, n), rng.uniform(-0.6, 0.6, n),
                      rng.uniform(-0.2, 0.2, n)], 1),
        rgb=rng.uniform(0.1, 0.9, (n, 3)), scale=rng.uniform(0.004, 0.01, (n, 3)),
        opacity=rng.uniform(0.5, 0.95, (n, 1)))


def test_rows_are_recentred_before_rounding():
    """At x ~ 790 the bf16 rows hold the means relative to the owning tile's
    origin (768 or 784), rounded once there (within 2^-8 of the local value,
    1/16 px at most), as JAX packs them; the
    blend then stays within the tier's bound of JAX `fast_chain=True` and of
    the f32 tier. Rows rounded before recentring would move the means by up
    to 2 px and break that bound."""
    w, h = 800, 32
    js = right_edge_scene()
    prep = tapi.preprocess_scene(port_cam(w=w, h=h), port_scene(js))
    binning, rows32 = render_path.bin_and_pack(prep, w, h)
    rows = render_path.fast_rows(rows32, binning.tile_of_dup, w)
    origin = (binning.tile_of_dup % (w // 16)).float() * 16
    assert float(rows32[:, 0].min()) > 770.0 and bool((origin >= 768).all())
    local = rows32[:, 0] - origin
    assert torch.equal(rows[:, 0], local.to(torch.bfloat16))
    assert bool(((rows[:, 0].float() - local).abs() <= 2.0 ** -8 * local.abs()).all())
    assert float(local.abs().max()) < 32
    rounded_first = rows32[:, 0].to(torch.bfloat16).float() - origin
    assert float((rounded_first - local).abs().max()) > 1.0

    starts, ends = binning.tile_start, binning.tile_end
    bg = torch.ones(3)
    f = tblend.blend_fwd_fast_reference(rows.detach(), starts, ends, w, h, bg)
    f32 = tblend.blend_fwd_reference(rows32.detach(), starts, ends, w, h, bg)
    jf = japi.render(_cam(w=w, h=h), js, WHITE, settings=PALLAS._replace(fast_chain=True))
    assert not bool(jf["overflow"])
    for got, want in ((f.color, f32.color), (f.final_T, f32.final_T),
                      (f.color, np.asarray(jf["render"])),
                      (f.final_T, np.asarray(jf["final_T"]))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=IMG_TOL)
    assert float(f32.final_T.min()) < 0.5  # the splats cover pixels there
    bad = rows.clone()
    bad[:, 0] = rounded_first.to(torch.bfloat16)
    wrong = tblend.blend_fwd_fast_reference(bad.detach(), starts, ends, w, h, bg)
    assert float((wrong.color - f32.color).abs().max()) > IMG_TOL
