"""Port parity: `wast3d_tpu_torch.core` against `wast3d_tpu.core` on CPU.

Inputs are made with numpy from a seed and fed to both packages. Tolerance
atol 1e-6: both sides evaluate the same f32 formulas in the same order (the
camera matrices are built by the same float64 numpy code and cast once)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wast3d_tpu.core import camera as jcam
from wast3d_tpu.core import sh as jsh
from wast3d_tpu.core import transforms as jtr
from wast3d_tpu_torch.core import camera as tcam
from wast3d_tpu_torch.core import sh as tsh
from wast3d_tpu_torch.core import transforms as ttr

ATOL = 1e-6


def _close(port, ref, atol=ATOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), atol=atol, rtol=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_camera_matrices(seed):
    rng = np.random.default_rng(seed)
    eye = rng.normal(size=3) * 3 + [0, 0, -4]
    fovx, fovy = rng.uniform(0.5, 1.2, 2)
    kw = dict(eye=eye, target=rng.normal(size=3) * 0.2, up=[0, -1, 0],
              fovx=fovx, fovy=fovy, width=70, height=50)
    j = jcam.look_at_camera(**kw)
    t = tcam.look_at_camera(**kw, device="cpu")
    _close(t.view_transform, j.view_transform)
    _close(t.full_proj_transform, j.full_proj_transform)
    _close(t.camera_center, j.camera_center)
    _close(t.tan_fovx, j.tan_fovx)
    _close(t.tan_fovy, j.tan_fovy)
    assert (t.width, t.height) == (j.width, j.height)

    R = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    tvec = rng.normal(size=3)
    translate, scale = rng.normal(size=3), 1.7
    _close(tcam.world_to_view(R, tvec, translate, scale),
           jcam.world_to_view(R, tvec, translate, scale))
    _close(tcam.projection_matrix(0.01, 100.0, fovx, fovy),
           jcam.projection_matrix(0.01, 100.0, fovx, fovy))
    jm = jcam.make_camera(R, tvec, fovx, fovy, 64, 48, translate=translate, scale=scale)
    tm = tcam.make_camera(R, tvec, fovx, fovy, 64, 48, translate=translate,
                          scale=scale, device="cpu")
    _close(tm.full_proj_transform, jm.full_proj_transform)
    _close(tm.camera_center, jm.camera_center)
    assert tcam.fov2focal(fovx, 800) == jcam.fov2focal(fovx, 800)
    assert tcam.focal2fov(500.0, 800) == jcam.focal2fov(500.0, 800)


@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
def test_eval_sh(deg):
    rng = np.random.default_rng(10 + deg)
    sh = rng.normal(size=(50, 3, 25)).astype(np.float32)
    dirs = rng.normal(size=(50, 3))
    dirs = (dirs / np.linalg.norm(dirs, axis=1, keepdims=True)).astype(np.float32)
    _close(tsh.eval_sh(deg, torch.from_numpy(sh), torch.from_numpy(dirs)),
           jsh.eval_sh(deg, jnp.asarray(sh), jnp.asarray(dirs)), atol=1e-5)
    _close(tsh.eval_sh_color(deg, torch.from_numpy(sh), torch.from_numpy(dirs)),
           jsh.eval_sh_color(deg, jnp.asarray(sh), jnp.asarray(dirs)), atol=1e-5)


def test_sh_rgb_roundtrip_and_bad_degree():
    rgb = np.random.default_rng(3).uniform(size=(20, 3)).astype(np.float32)
    _close(tsh.rgb_to_sh(torch.from_numpy(rgb)), jsh.rgb_to_sh(jnp.asarray(rgb)))
    _close(tsh.sh_to_rgb(tsh.rgb_to_sh(torch.from_numpy(rgb))), rgb)
    with pytest.raises(ValueError):
        tsh.eval_sh(5, torch.zeros(1, 3, 36), torch.zeros(1, 3))


@pytest.mark.parametrize("seed", [0, 1])
def test_transforms(seed):
    rng = np.random.default_rng(20 + seed)
    q = rng.normal(size=(40, 4)).astype(np.float32)
    s = rng.uniform(0.01, 0.5, size=(40, 3)).astype(np.float32)
    x = rng.uniform(0.05, 0.95, size=(40, 1)).astype(np.float32)
    _close(ttr.inverse_sigmoid(torch.from_numpy(x)), jtr.inverse_sigmoid(jnp.asarray(x)))
    _close(ttr.quat_to_rotmat(torch.from_numpy(q)), jtr.quat_to_rotmat(jnp.asarray(q)))
    _close(ttr.quat_to_rotmat(torch.from_numpy(q), normalize=False),
           jtr.quat_to_rotmat(jnp.asarray(q), normalize=False), atol=1e-5)
    _close(ttr.covariance_from_scaling_rotation(torch.from_numpy(s), 0.8, torch.from_numpy(q)),
           jtr.covariance_from_scaling_rotation(jnp.asarray(s), 0.8, jnp.asarray(q)))
