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
    and, for "segsum_sortpayload", the sort's permutation."""
    rng = np.random.default_rng(5)
    full = torch.from_numpy(rng.normal(size=(300, 12)).astype(np.float32))
    ranks = torch.from_numpy(rng.integers(0, 90, 300))
    sorted_ranks, perm = tgr.sort_ranks(ranks)
    view = full[:, :10]
    assert view.stride(0) == 12
    a = tgr.segment_sum(view, sorted_ranks, 90, perm=perm)
    b = tgr.segment_sum(view[perm].contiguous(), sorted_ranks, 90)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    before = tgr.segment_sum.launches
    tgr.segment_sum(view, sorted_ranks, 90, perm=perm)
    assert tgr.segment_sum.launches == before  # CPU: the plain version
    with pytest.raises(ValueError):
        tgr.segment_sum(full[:, :10].double(), sorted_ranks, 90, perm=perm.int())


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
