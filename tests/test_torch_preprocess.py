"""Port parity: `wast3d_tpu_torch` preprocess against `wast3d_tpu`.

The same scene and camera (numpy, seeded) go through both packages.
Floats agree to atol 1e-5 relative to each field's scale: the formulas are
the same f32 chains in the same order, and only XLA's and PyTorch's
elementwise kernels (rsqrt, division, fused multiply-adds) differ in the
last bits. `radii`, `extent_x` and `extent_y` are ceil() of those floats:
they agree exactly, except where a value sits within an ulp of an integer
and the ceil lands on the other side; such cases may differ by 1 on at most
0.5% of the Gaussians, and the test counts them."""

import numpy as np
import pytest

from tests.test_rasterizer import _cam, _random_scene
from tests.test_torch_scene import port_cam, port_scene
from tests.test_tile_cull import _aniso_scene
from wast3d_tpu.ops.rasterizer import preprocess as jprep
from wast3d_tpu.scene import gaussians as G
from wast3d_tpu_torch.ops.rasterizer import preprocess as tprep

FLOAT_FIELDS = ("means2d", "depths", "conics", "colors", "opacities")
INT_FIELDS = ("radii", "extent_x", "extent_y")


def rotated_sh_scene(n=200, seed=0, deg=3):
    """Random rotations, anisotropic scales, random SH up to `deg`, and
    a few Gaussians behind the camera (near cull)."""
    rng = np.random.default_rng(seed)
    xyz = rng.normal(size=(n, 3)) * [1.2, 1.2, 1.5]
    xyz[:5, 2] = -6.0  # behind the camera at z = -5
    k = (deg + 1) ** 2
    rest = np.zeros((n, 15, 3), np.float32)
    rest[:, : k - 1] = rng.normal(size=(n, k - 1, 3)) * 0.3
    return G.from_arrays(
        xyz=xyz.astype(np.float32),
        features_dc=rng.normal(size=(n, 1, 3)).astype(np.float32),
        features_rest=rest,
        scaling=np.log(rng.uniform(0.01, 0.3, size=(n, 3))).astype(np.float32),
        rotation=rng.normal(size=(n, 4)).astype(np.float32),
        opacity=rng.normal(size=(n, 1)).astype(np.float32) * 2,
        active_sh_degree=deg,
    )


def jax_prep(jscene, jcam, scaling_modifier=1.0):
    return jprep.preprocess(
        means3d=jscene.get_xyz, opacities=jscene.get_opacity,
        view_transform=jcam.view_transform,
        full_proj_transform=jcam.full_proj_transform,
        camera_center=jcam.camera_center, tan_fovx=jcam.tan_fovx,
        tan_fovy=jcam.tan_fovy, width=jcam.width, height=jcam.height,
        sh_degree=jscene.active_sh_degree, shs=jscene.get_features,
        scales=jscene.get_scaling, rotations=jscene.get_rotation,
        scaling_modifier=scaling_modifier, mask=jscene.mask)


def run_both(jscene, jcam, tcam, scaling_modifier=1.0):
    j = jax_prep(jscene, jcam, scaling_modifier)
    s = port_scene(jscene)
    t = tprep.preprocess(
        means3d=s.get_xyz, opacities=s.get_opacity,
        view_transform=tcam.view_transform,
        full_proj_transform=tcam.full_proj_transform,
        camera_center=tcam.camera_center, tan_fovx=tcam.tan_fovx,
        tan_fovy=tcam.tan_fovy, width=tcam.width, height=tcam.height,
        sh_degree=s.active_sh_degree, shs=s.get_features,
        scales=s.get_scaling, rotations=s.get_rotation,
        scaling_modifier=scaling_modifier, mask=s.mask)
    return j, t


def assert_preprocess_close(j, t):
    valid = np.asarray(j.valid)
    np.testing.assert_array_equal(t.valid.numpy(), valid)
    for f in FLOAT_FIELDS:
        ref = np.asarray(getattr(j, f))[valid]
        got = getattr(t, f).numpy()[valid]
        scale = max(1.0, float(np.abs(ref).max())) if ref.size else 1.0
        np.testing.assert_allclose(got, ref, atol=1e-5 * scale, rtol=0, err_msg=f)
    n = valid.shape[0]
    for f in INT_FIELDS:
        diff = np.abs(getattr(t, f).numpy().astype(np.int64)
                      - np.asarray(getattr(j, f)).astype(np.int64))
        assert diff.max(initial=0) <= 1, f
        assert np.count_nonzero(diff) <= 0.005 * n, (f, np.count_nonzero(diff))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_scene(seed):
    js = _random_scene(n=200, seed=seed)
    assert_preprocess_close(*run_both(js, _cam(), port_cam()))


@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_rotated_sh_scene(deg):
    js = rotated_sh_scene(n=200, seed=10 + deg, deg=deg)
    j, t = run_both(js, _cam(w=80, h=48, fov=0.9), port_cam(w=80, h=48, fov=0.9))
    assert not bool(np.asarray(j.valid)[:5].any())  # near-culled
    assert_preprocess_close(j, t)


def test_anisotropic_scaling_modifier():
    js = _aniso_scene(n=150, seed=4)
    assert_preprocess_close(*run_both(js, _cam(w=50, h=34), port_cam(w=50, h=34),
                                      scaling_modifier=0.7))
