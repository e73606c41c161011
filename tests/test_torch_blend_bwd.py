"""Port parity: the blend backward (K2's plain version) and the whole
differentiable render against the JAX package, on the CPU.

- `blend_bwd_reference` against `jax.vjp` of `pallas_blend.blend` (the K2
  Pallas kernel, interpret mode) on one tiny case. The Pallas kernel's
  prefix scans are split-bf16 (~2^-16 relative, `pallas_blend.py:93-120`),
  so per-column errors are held at 2e-3 of the column's largest value, the
  tolerance `tests/test_pallas_blend.py` holds that kernel to.
- `api.render` gradients (means3d, scales, rotations, opacity, SH,
  `means2d_offset`, `view_depth_offset`) against `jax.grad` through
  `renderer="tiled"`, at bg = 0 and bg = 1, with jitter, on the
  saturating scene of `test_pallas_blend.py::test_grads_with_saturation`,
  and with alpha on its 0.99 clamp.
  Both sides are plain f32 arithmetic in the same order up to
  reassociation; errors are held at 1e-5 of each field's largest value
  (observed ~4e-7).
- A finite-difference check of the port in float64.
- Culled (behind the camera) and masked-out Gaussians get finite, zero
  gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_rasterizer import _cam, _random_scene, _scene_from
from tests.test_torch_scene import port_cam, port_scene
from wast3d_tpu.ops.rasterizer import api as japi
from wast3d_tpu.ops.rasterizer import pallas_blend as pb
from wast3d_tpu_torch.ops.rasterizer import api as tapi
from wast3d_tpu_torch.ops.rasterizer import blend as tblend
from wast3d_tpu_torch.ops.rasterizer import render_path

TILED = japi.RasterizeSettings(renderer="tiled", dup_capacity=1 << 14,
                               max_per_tile=512, chunk=16, grad_reduce="scatter")
FIELDS = ("xyz", "scaling", "rotation", "opacity", "features_dc", "features_rest")
GRAD_TOL = 1e-5


def saturating_scene(n=60):
    rng = np.random.default_rng(6)
    return _scene_from(
        xyz=np.concatenate([rng.normal(size=(n, 2)) * 0.05,
                            np.linspace(-1, 1, n)[:, None]], axis=1),
        rgb=rng.uniform(0.2, 1.0, (n, 3)), scale=np.full((n, 3), 0.3),
        opacity=np.full((n, 1), 0.95))


def sh_scene(n=200, seed=0):
    """Random scene with degree-3 SH active and random rotations."""
    rng = np.random.default_rng(seed + 100)
    js = _random_scene(n=n, seed=seed)
    rest = np.asarray(js.features_rest).copy()
    rest[:n] = rng.normal(size=(n, 15, 3)).astype(np.float32) * 0.2
    rot = np.asarray(js.rotation).copy()
    rot[:n] = rng.normal(size=(n, 4)).astype(np.float32)
    return js.replace(features_rest=jnp.asarray(rest), rotation=jnp.asarray(rot),
                      active_sh_degree=3)


# ---- K2's plain version against the Pallas kernel -------------------------

def test_plain_k2_matches_jax_vjp_of_pallas_blend():
    w = h = 32
    bg = np.array([0.3, 0.6, 0.9], np.float32)
    js = _random_scene(n=40, seed=11)
    ts = port_scene(js)
    prep = tapi.preprocess_scene(port_cam(w=w, h=h), ts)
    binning, rows = render_path.bin_and_pack(prep, w, h)
    rows = rows.detach()
    k = rows.shape[0]
    assert k > 0
    rng = np.random.default_rng(2)
    g_color = rng.normal(size=(h, w, 3)).astype(np.float32)
    g_depth = rng.normal(size=(h, w)).astype(np.float32) * 0.1
    g_t = rng.normal(size=(h, w)).astype(np.float32)

    starts, ends = binning.tile_start, binning.tile_end
    bgt = torch.from_numpy(bg)
    out = tblend.blend_fwd_reference(rows, starts, ends, w, h, bgt)
    grads = tblend.BlendOutput(*(torch.from_numpy(a) for a in (g_color, g_depth, g_t)))
    got = tblend.blend_bwd_reference(rows, starts, ends, w, h, bgt, None, out, grads)
    assert got.shape == (k, 12) and torch.isfinite(got).all()
    assert bool((got[:, 10:] == 0).all())

    # JAX layout: packed [16, K + G] rows, pixel coords per tile [T, 256, 2],
    # acc [T, 256, 16] before the background composite.
    packed = np.zeros((pb.NROWS, k + pb.G), np.float32)
    packed[:10, :k] = rows[:, :10].numpy().T
    nt = (w // 16) * (h // 16)
    t = np.arange(nt)
    p = np.arange(256)
    px = ((t % (w // 16))[:, None] * 16 + p % 16).astype(np.float32)
    py = ((t // (w // 16))[:, None] * 16 + p // 16).astype(np.float32)
    pixf = np.stack([px, py], -1)

    def tiles(img):
        c = img.shape[-1]
        return img.reshape(h // 16, 16, w // 16, 16, c).transpose(0, 2, 1, 3, 4).reshape(nt, 256, c)

    fwd = lambda pk: pb.blend(pk, jnp.asarray(pixf), jnp.asarray(starts.numpy()),
                              jnp.asarray(ends.numpy()), nt, True)
    (acc, tfin), vjp = jax.vjp(fwd, jnp.asarray(packed))
    g_acc = np.zeros((nt, 256, pb.NROWS), np.float32)
    g_acc[..., pb.R_R:pb.R_B2 + 1] = tiles(g_color)
    g_acc[..., pb.R_DEPTH] = tiles(g_depth[..., None])[..., 0]
    # The port's colour carries T bg, so JAX's final_T cotangent gains dcolor . bg.
    g_tfin = tiles(g_t[..., None])[..., 0] + tiles(g_color) @ bg
    (dpacked,) = vjp((jnp.asarray(g_acc), jnp.asarray(g_tfin)))
    want = np.asarray(dpacked)[:10, :k].T
    np.testing.assert_allclose(
        np.asarray(tfin).reshape(-1),
        tiles(out.final_T.numpy()[..., None]).reshape(-1), atol=1e-5)
    for col in range(10):
        scale = np.abs(want[:, col]).max() + 1e-12
        np.testing.assert_allclose(got[:, col].numpy() / scale, want[:, col] / scale,
                                   atol=2e-3, err_msg=f"column {col}")


# ---- the whole differentiable render against jax.grad through "tiled" ------

def loss_weights(w, h, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, (h, w, 3)).astype(np.float32),
            np.linspace(0, 1, h).astype(np.float32)[:, None])


def jax_grads(js, w, h, bg, offsets=None):
    gt, ramp = loss_weights(w, h)
    cam = _cam(w=w, h=h)
    c = js.capacity

    def loss(p, m2d, vd):
        o = japi.render(cam, js.replace(**p), jnp.asarray(bg), settings=TILED,
                        sampling_offsets=None if offsets is None else jnp.asarray(offsets),
                        means2d_offset=m2d, view_depth_offset=vd)
        return (jnp.mean(jnp.abs(o["render"] - gt)) + 0.1 * jnp.mean(o["depth"] * ramp)
                + 0.3 * jnp.mean(o["final_T"] * ramp))

    g = jax.grad(loss, argnums=(0, 1, 2))({f: getattr(js, f) for f in FIELDS},
                                           jnp.zeros((c, 2)), jnp.zeros((c,)))
    out = {f: np.asarray(g[0][f]) for f in FIELDS}
    out["means2d_offset"], out["view_depth_offset"] = np.asarray(g[1]), np.asarray(g[2])
    return out


def port_grads(ts, w, h, bg, offsets=None, renderer="torch", grad_reduce="segsum_sortpayload"):
    gt, ramp = (torch.from_numpy(a) for a in loss_weights(w, h))
    c = ts.capacity
    p = {f: getattr(ts, f).clone().requires_grad_(True) for f in FIELDS}
    m2d = torch.zeros((c, 2), requires_grad=True)
    vd = torch.zeros((c,), requires_grad=True)
    o = tapi.render(port_cam(w=w, h=h), ts.replace(**p), torch.as_tensor(bg),
                    settings=tapi.RasterizeSettings(renderer=renderer, grad_reduce=grad_reduce),
                    sampling_offsets=None if offsets is None else torch.from_numpy(offsets),
                    device="cpu", means2d_offset=m2d, view_depth_offset=vd)
    loss = ((o["render"] - gt).abs().mean() + 0.1 * (o["depth"] * ramp).mean()
            + 0.3 * (o["final_T"] * ramp).mean())
    g = torch.autograd.grad(loss, list(p.values()) + [m2d, vd])
    out = dict(zip(FIELDS, (x.numpy() for x in g)))
    out["means2d_offset"], out["view_depth_offset"] = g[-2].numpy(), g[-1].numpy()
    return out, loss


def assert_grads_close(got, want, tol=GRAD_TOL):
    for name, ref in want.items():
        assert np.isfinite(got[name]).all(), name
        scale = np.abs(ref).max() + 1e-12
        np.testing.assert_allclose(got[name] / scale, ref / scale, atol=tol, err_msg=name)


@pytest.mark.parametrize("bg", [0.0, 1.0])
@pytest.mark.parametrize("renderer", ["torch", "cuda"])
def test_render_grads_match_jax_tiled(bg, renderer):
    """renderer="cuda" on CPU tensors goes through the same autograd
    functions with each wrapper taking its plain version."""
    js = sh_scene(n=200, seed=0)
    bgv = np.full(3, bg, np.float32)
    got, _ = port_grads(port_scene(js), 64, 64, bgv, renderer=renderer)
    assert_grads_close(got, jax_grads(js, 64, 64, bgv))


def test_render_grads_with_jitter():
    w, h = 64, 48
    js = sh_scene(n=200, seed=2)
    off = -np.random.default_rng(9).uniform(0, 1, (h, w, 2)).astype(np.float32)
    bg = np.array([0.2, 0.5, 0.9], np.float32)
    got, _ = port_grads(port_scene(js), w, h, bg, offsets=off)
    assert_grads_close(got, jax_grads(js, w, h, bg, offsets=off))


def test_render_grads_saturating_scene():
    """Early stop in the backward: occluded entries get zero gradient, and
    (S_total - prefix) / (1 - alpha) cancels when T is small."""
    js = saturating_scene()
    bg = np.zeros(3, np.float32)
    got, _ = port_grads(port_scene(js), 32, 32, bg)
    assert_grads_close(got, jax_grads(js, 32, 32, bg))


def test_render_grads_alpha_clamp():
    """Opacities near 1 put alpha on its 0.99 clamp at the splats' centres,
    where the entry gets no alpha gradient (`pallas_blend.py:691-699`)."""
    rng = np.random.default_rng(8)
    n = 40
    js = _scene_from(xyz=rng.normal(size=(n, 3)) * [0.8, 0.8, 0.4],
                     rgb=rng.uniform(0.1, 0.9, (n, 3)),
                     scale=rng.uniform(0.05, 0.15, (n, 3)),
                     opacity=rng.uniform(0.995, 0.9999, (n, 1)))
    bg = np.array([1.0, 1.0, 1.0], np.float32)
    got, _ = port_grads(port_scene(js), 48, 48, bg)
    assert_grads_close(got, jax_grads(js, 48, 48, bg))


def test_culled_and_masked_gaussians_get_zero_finite_grads():
    js = sh_scene(n=200, seed=3)  # capacity 256: rows 200.. are masked out
    xyz = np.asarray(js.xyz).copy()
    xyz[:6, 2] = -5.0  # on the camera plane (eye at z = -5): near-culled
    xyz[6:9, 2] = -9.0  # behind the camera
    js = js.replace(xyz=jnp.asarray(xyz))
    got, loss = port_grads(port_scene(js), 64, 64, np.zeros(3, np.float32))
    assert torch.isfinite(loss)
    for name, g in got.items():
        assert np.isfinite(g).all(), name
        assert not g[:9].any(), name
        assert not g[200:].any(), name


def test_finite_difference_float64():
    """The port's render in float64 (plain versions) against central
    differences, on a few splats that cross no skip or stop threshold
    within the step."""
    js = _scene_from([[0.1, -0.1, 0.0], [-0.3, 0.2, 0.5], [0.25, 0.3, -0.2]],
                     [[0.9, 0.3, 0.5], [0.2, 0.8, 0.4], [0.5, 0.5, 0.9]],
                     [[0.4] * 3, [0.3, 0.2, 0.35], [0.25] * 3],
                     [[0.7], [0.5], [0.6]])
    ts = port_scene(js)
    w = h = 16
    gt, ramp = (torch.from_numpy(a).double() for a in loss_weights(w, h))

    def loss(xyz):
        s = ts.replace(**{f: getattr(ts, f).double() for f in FIELDS}).replace(xyz=xyz)
        o = tapi.render(port_cam(w=w, h=h), s, torch.zeros(3, dtype=torch.float64),
                        settings=tapi.RasterizeSettings(renderer="torch"), device="cpu")
        return ((o["render"] - gt) ** 2).mean() + 0.1 * (o["depth"] * ramp).mean() \
            + 0.3 * (o["final_T"] * ramp).mean()

    x0 = ts.xyz.double().clone().requires_grad_(True)
    (g,) = torch.autograd.grad(loss(x0), [x0])
    eps = 1e-6
    for i in range(3):
        for d in range(3):
            e = torch.zeros_like(x0)
            e[i, d] = eps
            with torch.no_grad():
                fd = (loss(x0 + e) - loss(x0 - e)) / (2 * eps)
            np.testing.assert_allclose(float(g[i, d]), float(fd), rtol=1e-4, atol=1e-9,
                                       err_msg=f"gaussian {i} dim {d}")


def test_blend_bwd_cpu_takes_plain_and_counts_nothing():
    js = _random_scene(n=40, seed=1)
    ts = port_scene(js)
    prep = tapi.preprocess_scene(port_cam(w=32, h=32), ts)
    binning, rows = render_path.bin_and_pack(prep, 32, 32)
    rows = rows.detach()
    bg = torch.zeros(3)
    args = (rows, binning.tile_start, binning.tile_end, 32, 32, bg)
    out = tblend.blend_fwd_reference(*args)
    grads = tblend.BlendOutput(torch.ones(32, 32, 3), torch.ones(32, 32), torch.ones(32, 32))
    before = tblend.blend_bwd.launches
    a = tblend.blend_bwd(*args, None, out, grads)
    b = tblend.blend_bwd_reference(*args, None, out, grads)
    assert tblend.blend_bwd.launches == before
    assert torch.equal(a, b)
    with pytest.raises(ValueError):
        tblend.blend_bwd(rows.double(), *args[1:], None, out, grads)
