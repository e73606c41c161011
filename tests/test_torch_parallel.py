"""Port parity on the CPU: `parallel/` (mesh, multihost, ring KNN, the
halo-exchange loss, the tile-sharded render) and `densify.add_stats_batch`.

Two gloo ranks are spawned once (`rank_results`, through the port's own
`parallel.multihost.spawn`); they run every case
(`test_torch_parallel_ranks.parallel_cases`) and hand back numpy arrays,
which the tests below hold to JAX and to the port's single-device path in
this process.

- Ring KNN against JAX's `ring_knn_sq_dists` / `ring_mean_sq_dist_to_3nn`
  on the 8-device CPU mesh of `conftest.py`, at JAX's own bounds
  (`tests/test_parallel.py`: rtol 1e-4, atol 1e-5 on distances, 1e-6 on the
  3-NN means), and against the port's `ops.knn` at 1e-6 relative (each hop
  is `knn_sq_dists` on another column block, so only the matrix product's
  blocking can differ).
- The sharded loss against JAX's `photometric_loss_sharded` and against
  the unsharded loss: values at rtol 1e-5 (JAX's bound), gradients at rtol
  1e-4, atol 1e-6 (JAX's), zero on the padding rows.
- `render_tile_sharded` (201 Gaussians, uneven row slices of 101 and 100,
  64 x 48, strips of 32 rows): the stitched strips and every parameter's
  gradient equal the port's single-device `api.render` bit for bit (the
  plain versions on the CPU; contiguous slices keep the single-device
  order in every tile, K3's plain version sums in float64, and shifting
  the means by the strip's first row, a multiple of 16, rounds none of
  this scene's means: it can round one whose shifted value falls in a
  larger binade); against JAX `renderer="tiled"` (+
  `grad_reduce="scatter"`) at `test_torch_render.py`'s 3e-3 on colour and
  final_T, and gradients at 1e-5 of each field's largest value (the
  render path's gradient bound, ROADMAP queue 3). The bf16 tier's strips
  equal the port's single-device bf16 frame bit for bit."""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_rasterizer import _cam, _random_scene
from tests.test_torch_parallel_ranks import (
    EYE, FIELDS, RANKS, TALL_H, H, W, camera, parallel_cases)
from wast3d_tpu.ops.rasterizer import api as japi
from wast3d_tpu.parallel.mesh import make_mesh as j_make_mesh
from wast3d_tpu_torch.ops.rasterizer import api as tapi
from wast3d_tpu_torch.parallel import multihost

BG = np.array([0.1, 0.2, 0.3], np.float32)
PARAMS = ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation")
TILED = japi.RasterizeSettings(renderer="tiled", dup_capacity=1 << 14, max_per_tile=512,
                               chunk=16, grad_reduce="scatter")


def _tall_scene(n=64):
    """Large splats whose means lie near the top of a W x TALL_H image (image
    y in about [-20, 20]) and reach its last tile rows."""
    rng = np.random.default_rng(11)
    base = _random_scene(n=n, seed=9)
    arrays = {f: np.array(getattr(base, f))[:n] for f in FIELDS}
    arrays["xyz"] = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-2.6, -1.6, n),
                              rng.uniform(-0.5, 0.5, n)], 1).astype(np.float32)
    arrays["scaling"] = np.log(rng.uniform(0.8, 1.6, (n, 3))).astype(np.float32)
    return arrays


def _inputs():
    rng = np.random.default_rng(0)
    scene = _random_scene(n=201, seed=5)
    strip = rng.uniform(0, 1, (64, 64, 3)).astype(np.float32)
    return dict(
        ring_pts=np.random.default_rng(0).normal(size=(256, 3)).astype(np.float32),
        ring_uneven=rng.normal(size=(251, 3)).astype(np.float32),
        ring_q=np.random.default_rng(1).normal(size=(64, 3)).astype(np.float32),
        ring_data=np.random.default_rng(1).normal(size=(128, 3)).astype(np.float32),
        ring_mean=np.random.default_rng(3).normal(size=(512, 3)).astype(np.float32),
        loss_strip=strip, loss_gt=rng.uniform(0, 1, (48, 64, 3)).astype(np.float32),
        full_strip=rng.uniform(0, 1, (64, 32, 3)).astype(np.float32),
        full_gt=rng.uniform(0, 1, (64, 32, 3)).astype(np.float32),
        scene={f: np.asarray(getattr(scene, f))[:201] for f in FIELDS},
        target=rng.uniform(0, 1, (H, W, 3)).astype(np.float32),
        tall_scene=_tall_scene(),
    )


def _render_loss(image, target):
    """Squared error over the image's first H rows (the strips' padding
    rows carry no loss)."""
    return torch.sum((image[:H] - target) ** 2)


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def spawned(inputs):
    """The ranks at work, in a thread: this process computes the references
    meanwhile (the fixtures that `rank_results` takes)."""
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(multihost.spawn, parallel_cases, RANKS, ({**inputs, "bg": BG},), "gloo")


@pytest.fixture(scope="module")
def rank_results(spawned, single_device, jax_render):
    return spawned.result()


def _cat(results, key, index=None):
    parts = [r[key] if index is None else r[key][index] for r in results]
    return np.concatenate(parts)


@pytest.fixture(scope="module")
def jax_mesh():
    return j_make_mesh(8, data=1)


# ---- mesh and multihost ---------------------------------------------------------

def test_mesh_axes_and_row_slices(rank_results):
    for r, res in enumerate(rank_results):
        m = res["mesh"]
        assert m["shape"] == (1, RANKS) and m["names"] == ("data", "model")
        assert m["data_shape"] == (RANKS, 1)
        assert m["model_index"] == m["data_index"] == r
        assert m["all_rows"] == slice(0, 201)
    assert [res["mesh"]["rows"] for res in rank_results] == [slice(0, 101), slice(101, 201)]


def test_multihost_inside_and_outside_a_group(rank_results):
    """In a rank, `init_distributed` returns the rank (the group exists);
    rank 0 alone is the coordinator. In a single process it is a no-op
    returning 0, twice, as JAX's is."""
    assert [res["mesh"]["init"] for res in rank_results] == [0, 1]
    assert [res["mesh"]["coordinator"] for res in rank_results] == [True, False]
    assert multihost.init_distributed(device="cpu") == 0
    assert multihost.init_distributed(device="cpu") == 0
    assert multihost.is_coordinator()
    with pytest.raises(RuntimeError, match="process group"):
        multihost.global_mesh(data=1)


def test_shard_train_state_keeps_each_ranks_rows(inputs):
    """`shard_train_state` on a two-rank model axis, evaluated for each
    rank's slice without a group (`scene_sharding` is the row range)."""
    from types import SimpleNamespace

    from wast3d_tpu_torch.config import OptimizationConfig
    from wast3d_tpu_torch.parallel import mesh as pmesh
    from wast3d_tpu_torch.scene.gaussians import from_arrays
    from wast3d_tpu_torch.train.reconstruct import init_train_state

    scene = from_arrays(**{k: v[:9] for k, v in inputs["scene"].items()}, device="cpu")
    state = init_train_state(scene, OptimizationConfig(), 1.0)
    for rank, rows in ((0, slice(0, 5)), (1, slice(5, 9))):
        fake = SimpleNamespace(shape=(1, 2), get_local_rank=lambda axis, r=rank: r)
        part = pmesh.shard_train_state(state, fake)
        assert torch.equal(part.scene.xyz, state.scene.xyz[rows])
        assert torch.equal(part.scene.mask, state.scene.mask[rows])
        assert torch.equal(part.opt_state.mu["f_rest"], state.opt_state.mu["f_rest"][rows])
        assert torch.equal(part.stats.denom, state.stats.denom[rows])
        assert part.step == state.step and part.opt_state.count == state.opt_state.count


# ---- ring KNN --------------------------------------------------------------------

def test_ring_knn_matches_jax_and_single_device(rank_results, inputs, jax_mesh):
    from wast3d_tpu.parallel.ring import ring_knn_sq_dists as j_ring
    from wast3d_tpu_torch.ops.knn import knn_sq_dists

    d = _cat(rank_results, "ring", 0)
    pts = inputs["ring_pts"]
    jd, _ = j_ring(jnp.asarray(pts), jnp.asarray(pts), k=4, mesh=jax_mesh, exclude_self=True)
    np.testing.assert_allclose(d, np.asarray(jd), rtol=1e-4, atol=1e-5)
    td, ti = knn_sq_dists(torch.from_numpy(pts), torch.from_numpy(pts), 4, exclude_self=True)
    np.testing.assert_allclose(d, td.numpy(), rtol=1e-6, atol=0)
    np.testing.assert_array_equal(_cat(rank_results, "ring", 1), ti.numpy())
    # a (2, 1) mesh: each ring is one rank holding every point
    td3, _ = knn_sq_dists(torch.from_numpy(pts), torch.from_numpy(pts), 3, exclude_self=True)
    for res in rank_results:
        np.testing.assert_array_equal(res["ring_data_axis"], td3.numpy())


def test_ring_knn_uneven_slices(rank_results, inputs):
    """251 points over two ranks (126 and 125), hops in blocks of 32."""
    from wast3d_tpu_torch.ops.knn import knn_sq_dists

    pts = torch.from_numpy(inputs["ring_uneven"])
    td, ti = knn_sq_dists(pts, pts, 3, exclude_self=True)
    np.testing.assert_allclose(_cat(rank_results, "ring_uneven", 0), td.numpy(), rtol=1e-6,
                               atol=0)
    np.testing.assert_array_equal(_cat(rank_results, "ring_uneven", 1), ti.numpy())


def test_ring_knn_query_data_different_and_validity(rank_results, inputs, jax_mesh):
    from wast3d_tpu.parallel.ring import ring_knn_sq_dists as j_ring

    q, data = inputs["ring_q"], inputs["ring_data"]
    full = ((q[:, None] - data[None]) ** 2).sum(-1)
    got = _cat(rank_results, "ring_qd")
    np.testing.assert_array_equal(got[:, 0], full.argmin(1))
    _, ji = j_ring(jnp.asarray(q), jnp.asarray(data), k=1, mesh=jax_mesh)
    np.testing.assert_array_equal(got, np.asarray(ji))
    assert int(_cat(rank_results, "ring_valid").max()) < 32
    dq = _cat(rank_results, "ring_query_valid")
    assert (dq[32:] == rank_results[0]["big"]).all() and (dq[:32] < 1e3).all()


def test_ring_mean_sq_dist_matches_jax_and_single_device(rank_results, inputs, jax_mesh):
    from wast3d_tpu.parallel.ring import ring_mean_sq_dist_to_3nn as j_ring_mean
    from wast3d_tpu_torch.ops.knn import mean_sq_dist_to_3nn

    got = _cat(rank_results, "ring_mean")
    pts = inputs["ring_mean"]
    want = np.asarray(j_ring_mean(jnp.asarray(pts), jax_mesh))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    single = mean_sq_dist_to_3nn(torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(got, single, rtol=1e-6, atol=0)


# ---- the sharded loss ---------------------------------------------------------------

def test_sharded_loss_matches_jax_and_unsharded(rank_results, inputs, jax_mesh):
    from wast3d_tpu.parallel.losses import photometric_loss_sharded as j_sharded
    from wast3d_tpu_torch.ops.image_losses import photometric_loss

    strip, gt = inputs["loss_strip"], inputs["loss_gt"]
    values = [res["loss"] for res in rank_results]
    assert values[0] == values[1]
    grad = _cat(rank_results, "loss_grad")
    jv, jg = jax.jit(jax.value_and_grad(
        lambda s: j_sharded(s, jnp.asarray(gt), jax_mesh, H, 0.2)))(jnp.asarray(strip))
    np.testing.assert_allclose(values[0], float(jv), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(grad, np.asarray(jg), rtol=1e-4, atol=1e-6)
    ts = torch.from_numpy(strip).requires_grad_(True)
    tv = photometric_loss(ts[:H], torch.from_numpy(gt), 0.2)
    (tg,) = torch.autograd.grad(tv, [ts])
    np.testing.assert_allclose(values[0], float(tv.detach()), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(grad[:H], tg.numpy()[:H], rtol=1e-4, atol=1e-6)
    assert float(np.abs(grad[H:]).max()) == 0.0


def test_sharded_loss_unpadded_height_and_short_strip(rank_results, inputs):
    from wast3d_tpu_torch.ops.image_losses import photometric_loss

    want = float(photometric_loss(torch.from_numpy(inputs["full_strip"]),
                                  torch.from_numpy(inputs["full_gt"]), 0.2))
    for res in rank_results:
        np.testing.assert_allclose(res["loss_full"], want, rtol=1e-5, atol=1e-7)
        assert "strip of 4 rows < halo 5" in res["short_strip"]


# ---- the tile-sharded render --------------------------------------------------------

@pytest.fixture(scope="module")
def single_device(inputs, spawned):
    """The port's `api.render` (plain versions on the CPU) on the whole scene:
    the f32 frame, the gradients of `_render_loss`, and the bf16 frame."""
    from wast3d_tpu_torch.scene.gaussians import from_arrays

    scene = from_arrays(**inputs["scene"], device="cpu")
    params = {k: v.clone().requires_grad_(True) for k, v in scene.params().items()}
    cam = camera(W, H, EYE)
    out = tapi.render(cam, scene.with_params(params), torch.from_numpy(BG),
                      settings=tapi.RasterizeSettings(renderer="pallas"), device="cpu")
    grads = torch.autograd.grad(_render_loss(out["render"], torch.from_numpy(inputs["target"])),
                                list(params.values()))
    fast = tapi.render(cam, scene, torch.from_numpy(BG), device="cpu",
                       settings=tapi.RasterizeSettings(renderer="pallas", fast_chain=True))
    tall_cam = camera(W, TALL_H, EYE)
    tall_scene = from_arrays(**inputs["tall_scene"], device="cpu")
    tall = tapi.render(tall_cam, tall_scene, torch.from_numpy(BG), device="cpu",
                       settings=tapi.RasterizeSettings(renderer="pallas"))
    # means that rank 1's tile rows take (at image rows 64 and 80) and that
    # a shift by its first row (48) and then the tile's (16, 32) rounds
    # otherwise than one recentring on the tile's image origin
    prep = tapi.preprocess_scene(tall_cam, tall_scene)
    my, reach = prep.means2d[:, 1], prep.means2d[:, 1] + prep.radii.float()
    twice = sum(int(((reach >= 48 + d) & ((my - 48) - d != my - (48 + d))).sum())
                for d in (16, 32))
    return dict(out={k: out[k].detach().numpy() for k in ("render", "depth", "final_T")},
                radii=out["radii"].numpy(), fast=fast["render"].numpy(),
                grads={k: g.numpy() for k, g in zip(params, grads)},
                tall={k: tall[k].numpy() for k in ("render", "depth", "final_T")},
                tall_rounds_twice=twice)


def test_tile_sharded_frame_equals_single_device(rank_results, single_device):
    pad = rank_results[0]["render"]["height_pad"]
    assert pad == 64 and all(r["render"]["render"].shape == (32, W, 3) for r in rank_results)
    for key in ("render", "depth", "final_T"):
        np.testing.assert_array_equal(_cat([r["render"] for r in rank_results], key)[:H],
                                      single_device["out"][key], err_msg=key)
    np.testing.assert_array_equal(_cat([r["render"] for r in rank_results], "radii"),
                                  single_device["radii"])
    assert not any(r["render"]["overflow"] or r["render"]["route"] for r in rank_results)


def test_tile_sharded_bf16_frame_equals_single_device(rank_results, single_device):
    np.testing.assert_array_equal(_cat(rank_results, "render_fast")[:H], single_device["fast"])


def test_tile_sharded_quad_strips_recentre_once(rank_results, single_device):
    """The f32 quad route on strips of 48 rows (W x TALL_H): rank 1 takes
    splats whose means lie above image row 24, half its first row, where
    shifting a mean by 48 and then by its tile's row rounds twice; K1q's
    plain version recentres the unshifted mean on the tile's image origin
    once, as the single-device path and JAX's strip path do, so the
    stitched strips equal the single-device frame bit for bit."""
    assert single_device["tall_rounds_twice"] > 0
    for key in ("render", "depth", "final_T"):
        np.testing.assert_array_equal(_cat([r["render_tall"] for r in rank_results], key)[:TALL_H],
                                      single_device["tall"][key], err_msg=key)


def test_tile_sharded_gradients_equal_single_device(rank_results, single_device):
    for k in PARAMS:
        got = np.concatenate([r["render_grads"][k] for r in rank_results])
        np.testing.assert_array_equal(got, single_device["grads"][k], err_msg=k)


@pytest.fixture(scope="module")
def jax_render(inputs, spawned):
    """JAX `renderer="tiled"`: the frame and the gradients of `_render_loss`."""
    js = _random_scene(n=201, seed=5)
    cam = _cam(w=W, h=H, eye=EYE)
    tgt = jnp.asarray(inputs["target"])

    def loss(p):
        out = japi.render(cam, js.with_params(p), jnp.asarray(BG), settings=TILED)
        return jnp.sum((out["render"] - tgt) ** 2), out

    (_, out), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(js.params())
    return ({k: np.asarray(out[k]) for k in ("render", "final_T", "depth")},
            {k: np.asarray(g[k])[:201] for k in PARAMS})


def test_tile_sharded_frame_and_gradients_match_jax(rank_results, jax_render):
    out, g = jax_render
    frames = {k: _cat([r["render"] for r in rank_results], k)[:H]
              for k in ("render", "final_T", "depth")}
    np.testing.assert_allclose(frames["render"], out["render"], atol=3e-3)
    np.testing.assert_allclose(frames["final_T"], out["final_T"], atol=3e-3)
    np.testing.assert_allclose(frames["depth"], out["depth"], atol=3e-2)
    for k in PARAMS:
        got = np.concatenate([r["render_grads"][k] for r in rank_results])
        np.testing.assert_allclose(got, g[k], rtol=0, atol=1e-5 * np.abs(g[k]).max() + 1e-12,
                                   err_msg=k)


# ---- densify.add_stats_batch ----------------------------------------------------------

def test_add_stats_batch_matches_jax():
    from wast3d_tpu.train import densify as jd
    from wast3d_tpu_torch.train import densify as td

    rng = np.random.default_rng(3)
    b, n = 3, 50
    g = rng.normal(size=(b, n, 2)).astype(np.float32) * 1e-3
    radii = rng.integers(0, 9, (b, n)).astype(np.int32)
    vis = radii > 0
    base = [rng.uniform(0, 1, n).astype(np.float32) for _ in range(3)]
    want = jd.add_stats_batch(jd.DensifyStats(*map(jnp.asarray, base)), jnp.asarray(g),
                              jnp.asarray(radii), jnp.asarray(vis), 64, 48)
    got = td.add_stats_batch(td.DensifyStats(*map(torch.from_numpy, base)),
                             torch.from_numpy(g), torch.from_numpy(radii),
                             torch.from_numpy(vis), 64, 48)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-6, atol=1e-9)
    # one view is add_stats
    one = td.add_stats(td.DensifyStats(*map(torch.from_numpy, base)), torch.from_numpy(g[0]),
                       torch.from_numpy(radii[0]), torch.from_numpy(vis[0]), 64, 48)
    first = td.add_stats_batch(td.DensifyStats(*map(torch.from_numpy, base)),
                               torch.from_numpy(g[:1]), torch.from_numpy(radii[:1]),
                               torch.from_numpy(vis[:1]), 64, 48)
    for a, w in zip(first, one):
        assert torch.equal(a, w)
