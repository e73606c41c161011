"""Port parity: image losses, the 3-NN scale initialisation and the
learning-rate schedule against the JAX package, on the CPU.

Tolerances: the losses are the same f32 formulas in the same order
(SSIM's blur as the same 2 x 11 shifted multiply-adds), so values agree to
1e-6 relative and gradients to 1e-5 of their largest value; the 3-NN
distances use the same ||a||^2 + ||b||^2 - 2ab expansion, whose matrix
product sums in another order, so they agree to 1e-5 relative plus 2e-6
absolute (the expansion cancels terms of size ||a||^2 + ||b||^2 <= ~10 at
these coordinates, whose float32 ulp is ~1e-6); the schedule is float32 on
both sides, 1e-6 relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wast3d_tpu.core.lr import expon_lr as jexpon
from wast3d_tpu.ops import image_losses as jl
from wast3d_tpu.ops.knn import mean_sq_dist_to_3nn as jknn
from wast3d_tpu_torch.core.lr import expon_lr as texpon
from wast3d_tpu_torch.ops import image_losses as tl
from wast3d_tpu_torch.ops.knn import mean_sq_dist_to_3nn as tknn


def images(h=40, w=56, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(size=a.shape).astype(np.float32) * 0.1, 0, 1)
    return a, b


@pytest.mark.parametrize("name", ["l1_loss", "l2_loss", "mse", "psnr", "ssim",
                                  "photometric_loss"])
def test_loss_values_match_jax(name):
    a, b = images()
    want = float(getattr(jl, name)(jnp.asarray(a), jnp.asarray(b)))
    got = float(getattr(tl, name)(torch.from_numpy(a), torch.from_numpy(b)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_ssim_of_gray_images_and_identity():
    a, b = images(seed=1)
    np.testing.assert_allclose(
        float(tl.ssim(torch.from_numpy(a[..., 0]), torch.from_numpy(b[..., 0]))),
        float(jl.ssim(jnp.asarray(a[..., 0]), jnp.asarray(b[..., 0]))), rtol=1e-6)
    assert abs(float(tl.ssim(torch.from_numpy(a), torch.from_numpy(a))) - 1.0) < 1e-6


@pytest.mark.parametrize("lam", [0.0, 0.2, 1.0])
def test_photometric_loss_gradient_matches_jax(lam):
    a, b = images(h=33, w=47, seed=2)
    want = np.asarray(jax.grad(lambda x: jl.photometric_loss(x, jnp.asarray(b), lam))(
        jnp.asarray(a)))
    x = torch.from_numpy(a).requires_grad_(True)
    (got,) = torch.autograd.grad(tl.photometric_loss(x, torch.from_numpy(b), lam), [x])
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy() / scale, want / scale, atol=1e-5)


@pytest.mark.parametrize("n,block", [(200, 64), (1000, 1024), (3, 1024)])
def test_mean_sq_dist_to_3nn_matches_jax(n, block):
    pts = np.random.default_rng(n).uniform(-1.3, 1.3, (n, 3)).astype(np.float32)
    want = np.asarray(jknn(jnp.asarray(pts)))
    got = tknn(torch.from_numpy(pts), block=block).numpy()
    if n < 4:  # fewer than 3 other points: the missing neighbours are _BIG
        assert np.all(got > 1e29) and np.all(want > 1e29)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-6)


def test_mean_sq_dist_to_3nn_mask():
    pts = np.random.default_rng(3).normal(size=(150, 3)).astype(np.float32)
    mask = np.arange(150) % 5 != 0
    want = np.asarray(jknn(jnp.asarray(pts), mask=jnp.asarray(mask)))
    got = tknn(torch.from_numpy(pts), mask=torch.from_numpy(mask), block=64).numpy()
    np.testing.assert_allclose(got[mask], want[mask], rtol=1e-5, atol=2e-6)
    assert np.all(got[~mask] > 1e29)


@pytest.mark.parametrize("kw", [
    dict(lr_init=1.6e-4 * 3.2, lr_final=1.6e-6 * 3.2, lr_delay_mult=0.01, max_steps=30_000),
    dict(lr_init=0.01, lr_final=0.001, lr_delay_steps=100, lr_delay_mult=0.1, max_steps=1000),
    dict(lr_init=0.0, lr_final=0.0),
])
def test_expon_lr_matches_jax(kw):
    j, t = jexpon(**kw), texpon(**kw)
    for step in (-1, 0, 1, 7, 50, 99, 100, 500, 999, 1000, 15_000, 30_000, 40_000):
        np.testing.assert_allclose(t(step), float(j(step)), rtol=1e-6, err_msg=str(step))
