"""Port parity for the stylization's host-side stages, on the CPU: kNN,
k-means, content preparation, ball coverage, merge and the cluster npz
files, against the JAX package on the same numpy inputs.

Tolerances, with their reasons:
- squared distances: the same float32 expansion |a|^2 + |b|^2 - 2 a.b in
  both packages, with the cross term from two different matrix-product
  libraries: 1e-5 relative + 1e-6 absolute;
- kNN indices: equal wherever the distances are not tied; where the two
  packages pick different neighbours, both picks are at the same float64
  distance within 1e-5 (a tie that rounding broke differently);
- k-means, prepare, coverage, merge: discrete results (labels, index sets,
  balls) are compared exactly on well-separated data; centres to 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wast3d_tpu.ops import kmeans as jkm
from wast3d_tpu.ops import knn as jknn
from wast3d_tpu.stylize import cluster as jcluster
from wast3d_tpu.stylize import coverage as jcov
from wast3d_tpu.stylize import merge as jmerge
from wast3d_tpu.stylize import prepare as jprep
from wast3d_tpu_torch.ops import kmeans as tkm
from wast3d_tpu_torch.ops import knn as tknn
from wast3d_tpu_torch.stylize import cluster as tcluster
from wast3d_tpu_torch.stylize import coverage as tcov
from wast3d_tpu_torch.stylize import merge as tmerge
from wast3d_tpu_torch.stylize import prepare as tprep

CPU = "cpu"


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _two_blobs(n=200, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n // 2, 3)) * 0.1 + [2, 0, 0]
    b = rng.normal(size=(n // 2, 3)) * 0.1 - [2, 0, 0]
    return np.concatenate([a, b]).astype(np.float32)


def _assert_knn_close(q, data, jd, ji, td, ti):
    jd, ji, td, ti = map(np.asarray, (jd, ji, td, ti))
    np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-6)
    differ = ji != ti
    if differ.any():
        d64 = ((q[:, None, :].astype(np.float64) - data[None].astype(np.float64)) ** 2).sum(-1)
        rows = np.nonzero(differ)[0]
        a = d64[rows, np.minimum(ji[differ], len(data) - 1)]
        b = d64[rows, np.minimum(ti[differ], len(data) - 1)]
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_pairwise_sq_dists_matches_jax():
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=(50, 3)).astype(np.float32), rng.normal(size=(70, 3)).astype(np.float32)
    j = np.asarray(jknn.pairwise_sq_dists(jnp.asarray(a), jnp.asarray(b)))
    t = tknn.pairwise_sq_dists(_t(a), _t(b)).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6)
    assert (t >= 0).all()
    batched = tknn.pairwise_sq_dists(_t(np.stack([a, a])), _t(np.stack([b, b]))).numpy()
    np.testing.assert_array_equal(batched[0], t)


KNN_CASES = {
    "plain": dict(n=60, m=90, k=5, block=32),
    "masks": dict(n=60, m=90, k=7, block=32, masks=True),
    "exclude_self": dict(n=70, m=70, k=3, block=16, self_=True),
    "k_above_valid": dict(n=20, m=30, k=25, block=16, masks=True),
}


@pytest.mark.parametrize("fn", ["knn_sq_dists", "knn_sq_dists_sort"])
@pytest.mark.parametrize("case", list(KNN_CASES))
def test_knn_matches_jax(fn, case):
    c = KNN_CASES[case]
    rng = np.random.default_rng(1)
    data = rng.normal(size=(c["m"], 3)).astype(np.float32)
    q = data if c.get("self_") else rng.normal(size=(c["n"], 3)).astype(np.float32)
    kw = {"exclude_self": bool(c.get("self_"))}
    jkw, tkw = dict(kw), dict(kw)
    if c.get("masks"):
        qm, dm = rng.random(len(q)) > 0.2, rng.random(c["m"]) > 0.4
        jkw.update(query_mask=jnp.asarray(qm), data_mask=jnp.asarray(dm))
        tkw.update(query_mask=_t(qm), data_mask=_t(dm))
    key = "block" if fn == "knn_sq_dists" else "row_block"
    jd, ji = getattr(jknn, fn)(jnp.asarray(q), jnp.asarray(data), k=c["k"],
                               **{key: c["block"]}, **jkw)
    td, ti = getattr(tknn, fn)(_t(q), _t(data), k=c["k"], **{key: c["block"]}, **tkw)
    assert td.shape == ti.shape == (len(q), c["k"])
    _assert_knn_close(q, data, jd, ji, td, ti)
    if case == "k_above_valid":  # rows short of valid neighbours keep _BIG
        np.testing.assert_array_equal(np.asarray(td) >= 1e29, np.asarray(jd) >= 1e29)


@pytest.mark.parametrize("fn", ["knn_sq_dists", "knn_sq_dists_sort"])
def test_knn_ties_keep_column_order(fn):
    """Duplicated points make exact ties; both packages put the lower
    column first (jax.lax.top_k / sort are stable, so is the port's sort)."""
    base = np.random.default_rng(2).normal(size=(10, 3)).astype(np.float32)
    data = np.concatenate([base, base, base])  # each point three times
    jd, ji = getattr(jknn, fn)(jnp.asarray(base), jnp.asarray(data), k=3)
    td, ti = getattr(tknn, fn)(_t(base), _t(data), k=3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ti.numpy(), np.arange(10)[:, None] + [0, 10, 20])


def test_kmeans_two_blobs_matches_jax():
    pts = _two_blobs()
    jc, jl = jkm.kmeans(pts, 2, iters=20)
    tc, tl = tkm.kmeans(pts, 2, iters=20, device=CPU)
    np.testing.assert_array_equal(tl, np.asarray(jl))
    np.testing.assert_allclose(tc, np.asarray(jc), atol=1e-5)
    assert tl[0] != tl[100] and (tl[:100] == tl[0]).all()


def test_kmeans_masked_matches_jax():
    pts = np.concatenate([_two_blobs(), np.full((50, 3), 100.0, np.float32)])
    mask = np.concatenate([np.ones(200, bool), np.zeros(50, bool)])
    jc, jl = jkm.kmeans(pts, 2, iters=20, mask=mask)
    tc, tl = tkm.kmeans(pts, 2, iters=20, mask=mask, device=CPU)
    np.testing.assert_array_equal(tl, np.asarray(jl))
    np.testing.assert_allclose(tc, np.asarray(jc), atol=1e-5)
    assert (tl[200:] == -1).all()


def test_kmeans_best_matches_jax():
    pts = np.concatenate([_two_blobs(seed=3), _two_blobs(seed=4) + [0, 4, 0]])
    jc, jl = jkm.kmeans_best(pts, 4, n_init=3, iters=10, seed=5)
    tc, tl = tkm.kmeans_best(pts, 4, n_init=3, iters=10, seed=5, device=CPU)
    np.testing.assert_array_equal(tl, np.asarray(jl))
    np.testing.assert_allclose(tc, np.asarray(jc), atol=1e-5)


def test_remove_outliers_matches_jax():
    rng = np.random.default_rng(0)
    pts = np.concatenate([rng.normal(size=(200, 3)) * 0.1,
                          np.array([[50, 0, 0], [0, 50, 0]])]).astype(np.float32)
    t = tprep.remove_outliers(pts, kth_neighbor=10, q=0.95, device=CPU)
    np.testing.assert_array_equal(t, jprep.remove_outliers(pts, kth_neighbor=10, q=0.95))
    assert 200 not in t and 201 not in t


def test_sample_points_by_density_matches_jax():
    rng = np.random.default_rng(1)
    pts = np.concatenate([rng.normal(size=(500, 3)) * 0.01,
                          rng.normal(size=(50, 3)) * 0.01 + [1, 0, 0]]).astype(np.float32)
    t = tprep.sample_points_by_density(pts, num_samples=200, radius=0.05, device=CPU)
    np.testing.assert_array_equal(t, jprep.sample_points_by_density(pts, num_samples=200,
                                                                     radius=0.05))
    assert (t >= 500).mean() > 0.3


@pytest.mark.parametrize("batched", [False, True])
def test_prepare_scene_matches_jax(batched):
    """The port's one form against each of JAX's two forms."""
    rng = np.random.default_rng(0)
    centres = rng.normal(size=(6, 3)) * 4
    pts = (centres[rng.integers(0, 6, 3000)] + rng.normal(size=(3000, 3)) * 0.3).astype(np.float32)
    j = jprep.prepare_scene(pts, num_clusters=6, seed=1, batched=batched)
    t = tprep.prepare_scene(pts, num_clusters=6, seed=1, device=CPU)
    np.testing.assert_array_equal(t, j)


def test_prepare_scene_batched_matches_sequential():
    """One host transfer per stage over all clusters picks what the
    cluster-by-cluster public functions pick."""
    pts = np.random.default_rng(0).normal(size=(3000, 3)).astype(np.float32)
    got = tprep.prepare_scene(pts, num_clusters=6, seed=1, device=CPU)
    _, labels = tkm.kmeans(pts, 6, iters=100, seed=1, device=CPU)
    want = []
    for lbl in range(6):
        ci = np.nonzero(labels == lbl)[0]
        clean = ci[tprep.remove_outliers(pts[ci], 30, 0.925, device=CPU)]
        want.append(clean[tprep.sample_points_by_density(pts[clean], seed=1, device=CPU)])
    np.testing.assert_array_equal(got, np.concatenate(want))


def test_cluster_radius_matches_jax():
    seg = (np.linspace(0, 1, 11)[:, None] * np.array([[1, 0, 0]])).astype(np.float32)
    assert tcov.cluster_radius(seg, device=CPU) == pytest.approx((0.5, 1.0), abs=1e-5)
    pts = np.random.default_rng(4).normal(size=(300, 3)).astype(np.float32)
    np.testing.assert_allclose(tcov.cluster_radius(pts, block=64, device=CPU),
                               jcov.cluster_radius(pts, block=64), rtol=1e-6)


def test_sample_circles_matches_jax():
    pts = _two_blobs(300)
    t = tcov.sample_circles(pts, r=0.5, min_points_per_cluster=10, device=CPU)
    j = jcov.sample_circles(pts, r=0.5, min_points_per_cluster=10)
    assert len(t) == len(j) >= 2
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a, b)
    covered = np.zeros(300, bool)
    for c in t:
        covered[c] = True
    assert covered.all()
    kept = tcov.filter_circles(t, min_points=21)
    assert [len(c) for c in kept] == [len(c) for c in jcov.filter_circles(j, min_points=21)]


def _patch(n=40, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "_xyz": rng.normal(size=(n, 3)).astype(np.float32),
        "_features_dc": rng.normal(size=(n, 1, 3)).astype(np.float32),
        "_features_rest": rng.normal(size=(n, 15, 3)).astype(np.float32),
        "_rotation": np.tile([[1, 0, 0, 0]], (n, 1)).astype(np.float32),
        "_scaling": rng.normal(size=(n, 3)).astype(np.float32),
        "_opacity": rng.normal(size=(n, 1)).astype(np.float32),
    }


def test_find_retained_and_merge_match_jax():
    arrays = _patch(40)
    jp, tp = jcluster.StylePatch(arrays), tcluster.StylePatch(arrays)
    rng = np.random.default_rng(2)
    fitted = [tp.xyz * 0.3 + [5, 0, 0], tp.xyz * 0.3 - [5, 0, 0], tp.xyz * 0.3 + [0, 5, 0]]
    fitted = [f.astype(np.float32) for f in fitted]
    domain = np.concatenate([rng.normal(size=(50, 3)) * 1.5 + c
                             for c in ([5, 0, 0], [-5, 0, 0], [0, 5, 0])]).astype(np.float32)
    jr = jmerge.find_retained_indices(domain, fitted)
    tr = tmerge.find_retained_indices(domain, fitted, device=CPU)
    for a, b in zip(tr, jr):
        np.testing.assert_array_equal(a, b)
    j = jmerge.merge_patches(jp, fitted, domain=domain)
    t = tmerge.merge_patches(tp, fitted, domain=domain, device=CPU)
    n = int(j.num_active)
    assert t.capacity == n == sum(len(r) for r in tr)
    for f in ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity"):
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f))[:n])
    assert float(t.features_rest.abs().max()) == 0.0


def test_merge_attributes_without_deoverlap():
    tp = tcluster.StylePatch(_patch(30))
    out = tmerge.merge_patches(tp, [tp.xyz + 10, tp.xyz - 10], domain=None, deoverlap=False,
                               device=CPU)
    assert out.capacity == 60
    np.testing.assert_allclose(out.scaling[:30].numpy(), tp.scaling * 0.885, rtol=1e-6)


def _port_scene(n=60, seed=0):
    from tests.test_train import _mini_scene
    from wast3d_tpu_torch.scene.convert import scene_from_numpy
    from wast3d_tpu_torch.scene.gaussians import FIELDS

    j = _mini_scene(n=n, cap=64, seed=seed)
    d = {f: np.asarray(getattr(j, f)) for f in FIELDS}
    d.update(active_sh_degree=j.active_sh_degree, max_sh_degree=j.max_sh_degree)
    return j, scene_from_numpy(d, device=CPU)


def test_cluster_export_matches_jax_and_loads_across(tmp_path):
    jscene, tscene = _port_scene()
    jpaths = jcluster.export_clusters(jscene, str(tmp_path / "jax"), num_clusters=3, n_init=2)
    tpaths = tcluster.export_clusters(tscene, str(tmp_path / "port"), num_clusters=3, n_init=2)
    assert [p.rsplit("/", 1)[1] for p in tpaths] == [p.rsplit("/", 1)[1] for p in jpaths]
    for jp, tp in zip(jpaths, tpaths):
        with np.load(jp) as a, np.load(tp) as b:
            assert set(a.files) == set(b.files) == set(tcluster.NPZ_KEYS)
            for k in tcluster.NPZ_KEYS:
                np.testing.assert_allclose(b[k], a[k], atol=1e-6)
        # each package loads the other's file
        port_from_jax, jax_from_port = tcluster.load_cluster(jp), jcluster.load_cluster(tp)
        for k in tcluster.NPZ_KEYS:
            np.testing.assert_allclose(getattr(port_from_jax, k[1:]),
                                       getattr(jax_from_port, k[1:]), atol=1e-6)
    patch = tcluster.load_cluster(tpaths[0])
    np.testing.assert_allclose(patch.xyz.mean(0), 0, atol=1e-4)
    assert len(patch.select(np.arange(2))) == 2
