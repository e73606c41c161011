"""Port parity on the CPU: Sinkhorn OT (`ops/sinkhorn.py`) and the cluster
geometry-transfer ladder v0 / v1 / v4 (`stylize/geom_transfer.py`) against
the JAX package, on the same seeded numpy inputs (n <= 64 points), and
JAX's behavioural cases of `tests/test_geom_ot.py`.

Tolerances, with their reasons:
- Sinkhorn's cost, f and g rtol 1e-5 (the same float32 log-sum-exp
  iterations; the exp / log implementations differ by an ulp);
- distance matrices atol 1e-5; their diagonals are the rounding noise of
  the expansion |a|^2 + |b|^2 - 2 a.b, which differs between XLA's and
  PyTorch's CPU matrix products, so gradients are held to 1e-4 of max |g|,
  not elementwise;
- the k-NN mask of `compute_targets` exactly (JAX's `d <= kth` on the
  same values);
- the optimiser's final xyz within 1e-4 of the cloud's extent after 100
  Adam steps (Adam normalises each gradient, so the gradients' last-bit
  differences move every step by a fraction of lr);
- v1's samples are JAX's own per-step draws, computed here with JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wast3d_tpu.ops import sinkhorn as JSK
from wast3d_tpu.stylize import geom_transfer as JGT
from wast3d_tpu_torch.ops import sinkhorn as TSK
from wast3d_tpu_torch.stylize import geom_transfer as TGT

RTOL = 1e-5
DIST_ATOL = 1e-5
GRAD_REL = 1e-4
XYZ_REL = 1e-4


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _setup(n=64, seed=0):
    """`tests/test_geom_ot.py::TestGeomTransfer._setup`, in numpy."""
    rng = np.random.default_rng(seed)
    xyz = rng.normal(size=(n, 3)).astype(np.float32)
    rot = rng.normal(size=(n, 4)).astype(np.float32)
    scal = rng.normal(size=(n, 3)).astype(np.float32)
    shape = rng.normal(size=(n, 3)).astype(np.float32)
    shape = (shape / np.linalg.norm(shape, axis=1, keepdims=True) * 5.0).astype(np.float32)
    return xyz, rot, scal, shape


def _targets_pair(xyz, rot, scal, k):
    jt = JGT.compute_targets(jnp.asarray(xyz), jnp.asarray(rot), jnp.asarray(scal), k=k)
    tt = TGT.compute_targets(_t(xyz), _t(rot), _t(scal), k=k)
    return jt, tt


def _close_grad(tg, jg):
    jg = np.asarray(jg)
    np.testing.assert_allclose(tg.numpy(), jg, atol=GRAD_REL * np.abs(jg).max(), rtol=0)


# ---- Sinkhorn -----------------------------------------------------------------

@pytest.mark.parametrize("shape,eps,iters", [((16, 24), 0.05, 200), ((32, 32), 0.01, 100)])
def test_sinkhorn_matches_jax(shape, eps, iters):
    c = np.random.default_rng(2).uniform(size=shape).astype(np.float32)
    jc, jf, jg = JSK.sinkhorn(jnp.asarray(c), epsilon=eps, iters=iters)
    tc, tf, tg = TSK.sinkhorn(_t(c), epsilon=eps, iters=iters)
    np.testing.assert_allclose(float(tc), float(jc), rtol=RTOL)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=RTOL, atol=1e-7)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=RTOL, atol=1e-7)


def test_sinkhorn_with_marginals_matches_jax():
    rng = np.random.default_rng(5)
    c = rng.uniform(size=(12, 20)).astype(np.float32)
    a = rng.uniform(0.5, 1.5, 12).astype(np.float32)
    b = rng.uniform(0.5, 1.5, 20).astype(np.float32)
    a, b = a / a.sum(), b / b.sum()
    jc, jf, jg = JSK.sinkhorn(jnp.asarray(c), jnp.asarray(a), jnp.asarray(b), 0.05, 150)
    tc, tf, tg = TSK.sinkhorn(_t(c), _t(a), _t(b), 0.05, 150)
    np.testing.assert_allclose(float(tc), float(jc), rtol=RTOL)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=RTOL, atol=1e-7)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=RTOL, atol=1e-7)


def test_emd2_approx_and_gradient_match_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(24, 3)).astype(np.float32)
    y = (rng.normal(size=(24, 3)) + 1.0).astype(np.float32)
    jv, jg = jax.value_and_grad(lambda a: JSK.emd2_approx(a, jnp.asarray(y), iters=80))(
        jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    tv = TSK.emd2_approx(xt, _t(y), iters=80)
    (tg,) = torch.autograd.grad(tv, [xt])
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=RTOL)
    _close_grad(tg, jg)


def test_identical_sets_near_zero():
    x = _t(np.random.default_rng(0).normal(size=(32, 3)))
    cost = float(TSK.emd2_approx(x, x, epsilon=0.005, iters=300))
    assert cost < 0.05 * float(torch.mean(TSK.cost_matrix(x, x)))


def test_translation_cost():
    # Two identical clouds offset by t: W2^2 = |t|^2 (squared ground cost).
    x = _t(np.random.default_rng(1).normal(size=(64, 3)))
    cost = float(TSK.emd2_approx(x, x + torch.tensor([2.0, 0.0, 0.0]), epsilon=0.005,
                                 iters=300))
    assert cost == pytest.approx(4.0, rel=0.15)


def test_marginals_satisfied():
    c = _t(np.random.default_rng(2).uniform(size=(16, 24)))
    _, f, g = TSK.sinkhorn(c, epsilon=0.05, iters=500)
    p = torch.exp((f[:, None] + g[None, :] - c) / 0.05) * (1 / 16) * (1 / 24)
    np.testing.assert_allclose(p.sum(1).numpy(), 1 / 16, rtol=1e-2)
    np.testing.assert_allclose(p.sum(0).numpy(), 1 / 24, rtol=1e-2)


def test_emd_gradient_points_toward_target():
    rng = np.random.default_rng(3)
    x = _t(rng.normal(size=(16, 3))).requires_grad_(True)
    y = _t(rng.normal(size=(16, 3)) + 1.0)
    (g,) = torch.autograd.grad(TSK.emd2_approx(x, y, iters=50), [x])
    assert bool(torch.isfinite(g).all())
    assert float(g[:, 0].mean()) < 0


# ---- geometry transfer --------------------------------------------------------

def test_attribute_distances_match_jax():
    xyz, rot, scal, _ = _setup()
    j = JGT.attribute_distances(jnp.asarray(xyz), jnp.asarray(rot), jnp.asarray(scal))
    t = TGT.attribute_distances(_t(xyz), _t(rot), _t(scal))
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=DIST_ATOL, rtol=0)


@pytest.mark.parametrize("k", [8, 16, 100])
def test_compute_targets_mask_matches_jax(k):
    xyz, rot, scal, _ = _setup()
    jt, tt = _targets_pair(xyz, rot, scal, k)
    np.testing.assert_array_equal(tt.knn_mask.numpy(), np.asarray(jt.knn_mask))
    assert int(tt.knn_mask.sum()) >= min(k, 64) * 64


def _perturbed(xyz, seed=1, sigma=0.3):
    return (xyz + np.random.default_rng(seed).normal(size=xyz.shape) * sigma).astype(np.float32)


def _jax_v1_indices(key, steps, n, m, num_samples):
    """The per-step (idx_a, idx_b) of JAX's optimiser: split the carried key,
    then split the step's key into the two permutations' keys."""
    ia, ib = [], []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        k1, k2 = jax.random.split(sub)
        ia.append(np.asarray(jax.random.permutation(k1, n)[:num_samples]))
        ib.append(np.asarray(jax.random.permutation(k2, m)[:num_samples]))
    return torch.from_numpy(np.stack(ia)), torch.from_numpy(np.stack(ib))


@pytest.mark.parametrize("variant", ["v0", "v1", "v4"])
def test_losses_and_gradients_match_jax(variant):
    xyz, rot, scal, shape = _setup(n=48)
    jt, tt = _targets_pair(xyz, rot, scal, 8)
    x0 = _perturbed(xyz)
    key = jax.random.PRNGKey(0)
    ns = 32

    def jloss(x):
        if variant == "v0":
            return JGT.loss_v0(x, jnp.asarray(rot), jnp.asarray(scal), jt)
        if variant == "v1":
            return JGT.loss_v1(x, jnp.asarray(rot), jnp.asarray(scal), jt,
                               jnp.asarray(shape), key, num_samples=ns)
        return JGT.loss_v4(x, jnp.asarray(rot), jnp.asarray(scal), jt, jnp.asarray(shape))

    k1, k2 = jax.random.split(key)
    idx = (torch.from_numpy(np.array(jax.random.permutation(k1, 48)[:ns])),
           torch.from_numpy(np.array(jax.random.permutation(k2, 48)[:ns])))

    def tloss(x):
        if variant == "v0":
            return TGT.loss_v0(x, _t(rot), _t(scal), tt)
        if variant == "v1":
            return TGT.loss_v1(x, _t(rot), _t(scal), tt, _t(shape), num_samples=ns,
                               indices=idx)
        return TGT.loss_v4(x, _t(rot), _t(scal), tt, _t(shape))

    jv, jg = jax.value_and_grad(jloss)(jnp.asarray(x0))
    xt = _t(x0).requires_grad_(True)
    tv = tloss(xt)
    (tg,) = torch.autograd.grad(tv, [xt])
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=RTOL)
    _close_grad(tg, jg)


def test_shape_attachment_matches_jax_and_pulls_toward_shape():
    xyz, _, _, shape = _setup()
    for pts in (xyz * 0.2, xyz + 50.0):
        j = float(JGT.shape_attachment_loss(jnp.asarray(pts), jnp.asarray(shape)))
        t = float(TGT.shape_attachment_loss(_t(pts), _t(shape)))
        np.testing.assert_allclose(t, j, rtol=RTOL)
    assert (float(TGT.shape_attachment_loss(_t(xyz * 0.2), _t(shape)))
            < float(TGT.shape_attachment_loss(_t(xyz + 50.0), _t(shape))))


@pytest.mark.parametrize("variant", ["v0", "v1", "v4"])
def test_optimize_cluster_geometry_matches_jax(variant):
    xyz, rot, scal, shape = _setup(n=48)
    jt, tt = _targets_pair(xyz, rot, scal, 8)
    x0 = _perturbed(xyz)
    steps, ns, lr = 100, 32, 1e-2
    key = jax.random.PRNGKey(0)
    j = JGT.optimize_cluster_geometry(jnp.asarray(x0), jnp.asarray(rot), jnp.asarray(scal),
                                      jt, jnp.asarray(shape), key, variant=variant,
                                      steps=steps, lr=lr, num_samples=ns)
    idx = _jax_v1_indices(key, steps, 48, 48, ns) if variant == "v1" else None
    losses = []
    t = TGT.optimize_cluster_geometry(_t(x0), _t(rot), _t(scal), tt, _t(shape),
                                      variant=variant, steps=steps, lr=lr, num_samples=ns,
                                      indices=idx, losses=losses)
    extent = float(np.ptp(x0, axis=0).max())
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=XYZ_REL * extent, rtol=0)
    assert len(losses) == steps and float(losses[-1]) < float(losses[0])


def test_zero_at_target_and_xyz_term_translation_invariant():
    xyz, rot, scal, _ = _setup()
    t = TGT.compute_targets(_t(xyz), _t(rot), _t(scal), k=16)
    assert float(TGT.loss_v0(_t(xyz), _t(rot), _t(scal), t)) < 1e-8
    d1 = TGT.attribute_distances(_t(xyz), _t(rot), _t(scal))[0]
    d2 = TGT.attribute_distances(_t(xyz + 3.0), _t(rot), _t(scal))[0]
    np.testing.assert_allclose(d1.numpy(), d2.numpy(), atol=5e-3)


def test_optimize_recovers_structure_with_a_generator():
    xyz, rot, scal, shape = _setup()
    t = TGT.compute_targets(_t(xyz), _t(rot), _t(scal), k=16)
    x0 = _t(_perturbed(xyz))
    l0 = float(TGT.loss_v0(x0, _t(rot), _t(scal), t))
    out = TGT.optimize_cluster_geometry(x0, _t(rot), _t(scal), t, _t(shape),
                                        torch.Generator().manual_seed(0), variant="v0",
                                        steps=300, lr=1e-2)
    assert float(TGT.loss_v0(out, _t(rot), _t(scal), t)) < 0.2 * l0
    g = torch.Generator().manual_seed(1)
    out1 = TGT.optimize_cluster_geometry(x0, _t(rot), _t(scal), t, _t(shape), g,
                                         variant="v1", steps=5, num_samples=16)
    assert bool(torch.isfinite(out1).all())
