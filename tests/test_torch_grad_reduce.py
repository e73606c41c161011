"""Port parity: the per-Gaussian gradient reduction (K3's plain version and
its three rank-major wrappers) against the JAX package and `np.add.at`.

Edge cases are those of `tests/test_grad_reduce.py`: a single giant
segment, sparse ranks with big jumps, n1 a multiple of 128, plus K = 0.
Tolerances:
- against `np.add.at` in float64: 1e-6 of the segment's sum of |values|
  (the plain version accumulates in float64 and rounds once);
  "segsum_sortpacked" rounds each value to bf16 first, so it is held to
  the float64 sum of the bf16-rounded values at the same tolerance;
- against JAX's Pallas kernel in interpret mode: 2e-4 relative and
  absolute, the tolerance `tests/test_grad_reduce.py` holds that
  split-bf16 kernel to (the sortpacked pair both round to bf16 first)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_rasterizer import _random_scene
from tests.test_torch_blend_bwd import port_grads
from tests.test_torch_scene import port_scene
from wast3d_tpu.ops.rasterizer import grad_reduce as jgr
from wast3d_tpu_torch.ops.rasterizer import grad_reduce as tgr

WRAPPERS = {
    "segsum": (tgr.segment_reduce_by_rank, jgr.segment_reduce_by_rank),
    "segsum_sortpayload": (tgr.segment_reduce_by_rank_sortpayload,
                           jgr.segment_reduce_by_rank_sortpayload),
    "segsum_sortpacked": (tgr.segment_reduce_by_rank_sortpacked,
                          jgr.segment_reduce_by_rank_sortpacked),
}


def bf16_round(d):
    return torch.from_numpy(d).to(torch.bfloat16).to(torch.float32).numpy()


def oracle(d, ranks, n1):
    out = np.zeros((n1, d.shape[1]), np.float64)
    np.add.at(out, ranks, d.astype(np.float64))
    mag = np.zeros((n1, d.shape[1]), np.float64)
    np.add.at(mag, ranks, np.abs(d.astype(np.float64)))
    return out, mag


def random_case(k, n1, seed, c=10):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(k, c)).astype(np.float32),
            rng.integers(0, n1, size=k).astype(np.int64), n1)


def giant_segment():
    return np.ones((2000, 10), np.float32) * np.linspace(0.5, 1.5, 10, dtype=np.float32), \
        np.full(2000, 7, np.int64), 100


def sparse_jumps():
    rng = np.random.default_rng(0)
    n1 = 100_000
    ranks = np.sort(rng.choice(n1, size=512, replace=False)).astype(np.int64)
    rng.shuffle(ranks)  # unsorted input, like the tile-major stream
    return rng.normal(size=(512, 10)).astype(np.float32), ranks, n1


CASES = {
    "random_64_40": lambda: random_case(64, 40, 1),
    "random_1000_300": lambda: random_case(1000, 300, 2),
    "giant_segment": giant_segment,
    "sparse_jumps": sparse_jumps,
    "n1_multiple_of_128": lambda: random_case(300, 256, 3),
    "k_zero": lambda: (np.zeros((0, 10), np.float32), np.zeros(0, np.int64), 50),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("mode", sorted(WRAPPERS))
def test_wrappers_match_add_at(mode, case):
    d, ranks, n1 = CASES[case]()
    got = WRAPPERS[mode][0](torch.from_numpy(d), torch.from_numpy(ranks), n1).numpy()
    assert got.shape == (n1, d.shape[1]) and got.dtype == np.float32
    want, mag = oracle(bf16_round(d) if mode == "segsum_sortpacked" else d, ranks, n1)
    assert np.all(np.abs(got - want) <= 1e-6 * mag + 1e-30)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("mode", sorted(WRAPPERS))
def test_wrappers_match_jax_interpret(mode, case):
    d, ranks, n1 = CASES[case]()
    got = WRAPPERS[mode][0](torch.from_numpy(d), torch.from_numpy(ranks), n1).numpy()
    want = np.asarray(WRAPPERS[mode][1](jnp.asarray(d), jnp.asarray(ranks.astype(np.int32)),
                                        n1, interpret=True))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_scatter_and_reduce_dispatch():
    d, ranks, n1 = random_case(500, 120, 4)
    dt, rt = torch.from_numpy(d), torch.from_numpy(ranks)
    for mode in tgr.GRAD_REDUCES:
        got = tgr.reduce(dt, rt, n1, mode).numpy()
        want, mag = oracle(bf16_round(d) if mode == "segsum_sortpacked" else d, ranks, n1)
        assert np.all(np.abs(got - want) <= 1e-5 * mag + 1e-30), mode
    with pytest.raises(ValueError):
        tgr.reduce(dt, rt, n1, "none")


def test_segment_sum_reads_strided_rows_and_perm():
    """The render path hands K3 the first 10 of 12 columns (row stride 12)
    and, for "segsum_sortpayload", the rows' order as `idx` or as the
    permutation it inverts."""
    rng = np.random.default_rng(5)
    full = torch.from_numpy(rng.normal(size=(300, 12)).astype(np.float32))
    ranks = torch.from_numpy(rng.integers(0, 90, 300))
    seg = tgr.rank_segments(ranks, 90)
    view = full[:, :10]
    assert view.stride(0) == 12 and tgr._vector_rows(view)
    assert not tgr._vector_rows(view[seg.idx])  # gathered rows: stride 10
    a = tgr.segment_sum(view, seg)
    b = tgr.segment_sum(view[seg.idx].contiguous(), seg._replace(idx=None))
    c = tgr.segment_sum(view, seg._replace(idx=None, perm=torch.argsort(seg.idx)))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(a, c, rtol=0, atol=0)
    before = tgr.segment_sum.launches
    tgr.segment_sum(view, seg)
    assert tgr.segment_sum.launches == before  # CPU: the plain version
    with pytest.raises(ValueError):
        tgr.segment_sum(full[:, :10].double(), seg._replace(idx=seg.idx.long()))
    with pytest.raises(ValueError):  # idx and perm at once
        tgr.segment_sum(view, seg._replace(perm=seg.idx.long()))


def test_segment_sum_takes_any_segments():
    """The contract out[r] = sum of rows[idx[p]] over p in [offsets[s],
    offsets[s + 1]), s = row_map[r]: segments visited out of order, twice,
    empty, without idx, and given as each position's segment."""
    rng = np.random.default_rng(8)
    rows = rng.normal(size=(50, 3)).astype(np.float32)
    idx = rng.permutation(50).astype(np.int32)
    offsets = np.array([0, 7, 7, 20, 40, 49, 50], np.int32)
    row_map = np.array([4, 0, 1, 1, 5, 2, 3], np.int64)
    seg = tgr.Segments(torch.from_numpy(offsets), torch.from_numpy(row_map),
                       torch.from_numpy(idx), None)
    assert seg.n1 == 7
    want = np.stack([rows[idx[offsets[s]:offsets[s + 1]]].astype(np.float64).sum(0)
                     for s in row_map])
    got = tgr.segment_sum(torch.from_numpy(rows), seg).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert np.all(got[2] == 0) and np.all(got[3] == 0)  # segment 1 is empty
    plain = tgr.segment_sum(torch.from_numpy(rows), seg._replace(idx=None)).numpy()
    np.testing.assert_allclose(plain[1], rows[:7].sum(0), rtol=1e-6, atol=1e-6)
    inverted = tgr.segment_sum(torch.from_numpy(rows), seg._replace(
        idx=None, perm=torch.argsort(torch.from_numpy(idx).long()))).numpy()
    np.testing.assert_array_equal(inverted, got)
    segment_of = torch.from_numpy(np.repeat(np.arange(6), np.diff(offsets)))
    by_position = seg._replace(offsets=None, segment_of=segment_of)
    assert torch.equal(tgr.segment_offsets(by_position)[:7], torch.from_numpy(offsets))
    np.testing.assert_array_equal(
        tgr.segment_sum(torch.from_numpy(rows), by_position).numpy(), got)
    for bad in (seg._replace(segment_of=segment_of),  # offsets and segment_of
                by_position._replace(row_map=None),  # segment_of needs a row map
                by_position._replace(segment_of=segment_of.int())):
        with pytest.raises(ValueError):
            tgr.segment_sum(torch.from_numpy(rows), bad)


def test_rank_segments_bound_each_rank():
    d, ranks, n1 = random_case(1000, 300, 9)
    seg = tgr.rank_segments(torch.from_numpy(ranks), n1)
    assert seg.idx.dtype == seg.offsets.dtype == torch.int32
    assert seg.row_map is None and seg.perm is None and seg.n1 == n1
    np.testing.assert_array_equal(seg.idx.numpy(), np.argsort(ranks, kind="stable"))
    np.testing.assert_array_equal(np.diff(seg.offsets.numpy()), np.bincount(ranks, minlength=n1))
    assert int(seg.offsets[0]) == 0 and int(seg.offsets[-1]) == 1000


def _binned(seed, tile_cull=True, jitter_margin=0.0, n=200, w=80, h=48):
    """A random scene's port binning, from the JAX preprocess output."""
    from tests.test_rasterizer import _cam
    from tests.test_torch_binning import bin_both
    from tests.test_torch_preprocess import run_both
    from tests.test_torch_scene import port_cam

    prep, _ = run_both(_random_scene(n=n, seed=seed), _cam(w=w, h=h), port_cam(w=w, h=h))
    cull = (np.asarray(prep.conics), np.asarray(prep.opacities)) if tile_cull else None
    _, t = bin_both(np.asarray(prep.means2d), np.asarray(prep.depths), np.asarray(prep.radii),
                    w, h, ext=(np.asarray(prep.extent_x), np.asarray(prep.extent_y)),
                    cull=cull, jitter_margin=jitter_margin)
    return t


@pytest.mark.parametrize("mode", sorted(WRAPPERS))
def test_binning_route_matches_jax_and_add_at(mode):
    """The render path's route (segments from the binning, no sort of the
    ranks) through the plain K3 against JAX's wrapper of the same mode in
    interpret mode, given the binning's ranks, and against `np.add.at`."""
    t = _binned(seed=4)
    k, n1 = int(t.num_duplicates), t.rank_of.shape[0]
    assert k > 100
    d = np.random.default_rng(6).normal(size=(k, 10)).astype(np.float32)
    seg = tgr.binning_segments(t.sort_perm, t.presort_gauss, t.depth_order)
    got = tgr.reduce_segments(torch.from_numpy(d), seg, mode).numpy()
    bare = WRAPPERS[mode][0](torch.from_numpy(d), t.rank, n1).numpy()
    np.testing.assert_array_equal(got, bare)
    ranks = t.rank.numpy()
    want = np.asarray(WRAPPERS[mode][1](jnp.asarray(d), jnp.asarray(ranks.astype(np.int32)),
                                        n1, interpret=True))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    ref, mag = oracle(bf16_round(d) if mode == "segsum_sortpacked" else d, ranks, n1)
    assert np.all(np.abs(got - ref) <= 1e-6 * mag + 1e-30)


@pytest.mark.parametrize("mode", ["segsum", "segsum_sortpayload", "segsum_sortpacked"])
def test_render_grads_binning_route_equal_bare_rank_route(mode, monkeypatch):
    """The render's backward takes the binning route; forced onto the
    bare-rank route it gives the same bits (the same sums in the same
    order)."""
    ts = port_scene(_random_scene(n=200, seed=7))
    bg = np.zeros(3, np.float32)
    calls = []
    real = tgr.binning_segments

    def counted(*args):
        calls.append(1)
        return real(*args)

    monkeypatch.setattr(tgr, "binning_segments", counted)
    got, _ = port_grads(ts, 64, 64, bg, grad_reduce=mode)
    assert calls

    def bare_rank(perm, presort_gauss, order):
        """The ranks of the sorted duplicates from the same fields, then
        the bare-rank route."""
        return tgr.rank_segments(torch.argsort(order)[presort_gauss[perm]], order.shape[0])

    monkeypatch.setattr(tgr, "binning_segments", bare_rank)
    bare, _ = port_grads(ts, 64, 64, bg, grad_reduce=mode)
    for name in got:
        np.testing.assert_array_equal(got[name], bare[name], err_msg=name)


@pytest.mark.parametrize("mode", ["segsum", "segsum_sortpayload", "segsum_sortpacked"])
def test_render_grads_by_mode_match_scatter(mode):
    """The whole render's gradients under each reduction against
    "scatter": exact f32 tiers to 1e-6 of each field's largest value, the
    bf16-rounded tier to 1e-2 (2^-9 per duplicate value, and the Adam-facing
    gradient sums a few duplicates)."""
    ts = port_scene(_random_scene(n=200, seed=7))
    bg = np.zeros(3, np.float32)
    ref, _ = port_grads(ts, 64, 64, bg, grad_reduce="scatter")
    got, _ = port_grads(ts, 64, 64, bg, grad_reduce=mode)
    tol = 1e-2 if mode == "segsum_sortpacked" else 1e-6
    for name, r in ref.items():
        scale = np.abs(r).max() + 1e-12
        np.testing.assert_allclose(got[name] / scale, r / scale, atol=tol, err_msg=name)
