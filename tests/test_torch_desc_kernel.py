"""K4/K5 (the pair-descriptor loss and its gradient): the plain versions
against the JAX Pallas kernels in interpret mode, and the cases where the
port could easily differ from JAX, on the CPU. On a CUDA card the kernels
themselves are held to the plain versions by `chip_smoke.py` (k4k5_cases).

Tolerances, with their reasons (the JAX package's own for its kernel
against its streaming path, tests/test_stylize.py):
- loss: rtol 1e-5; the same float32 sum in another order;
- gradient: atol 1e-4 x max |g|; R_ij divides by D, so pairs whose D is
  small carry the float32 rounding of the TPU kernel's distance expansion
  |a|^2 + |b|^2 - 2 a.b (the port takes D from coordinate differences).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wast3d_tpu.stylize import desc_kernel as jdk
from wast3d_tpu_torch.stylize import desc_kernel as tdk

LOSS_RTOL, GRAD_ATOL_REL = 1e-5, 1e-4


def _case(mp, balls, m, seed, density=0.02, coincident=False):
    """m real points of mp (padded rows zero, no code); a random code with
    every value of {0, 1, 2, 3}; optionally two coincident pairs with code."""
    rng = np.random.default_rng(seed)
    tp = np.zeros((mp, 3), np.float32)
    tp[:m] = rng.normal(size=(m, 3)) * 0.5
    x = np.zeros((balls, mp, 3), np.float32)
    x[:, :m] = tp[:m] * 1.3 + rng.normal(size=(balls, m, 3)) * 0.05
    code = np.zeros((mp, mp), np.uint8)
    code[:m, :m] = np.where(rng.random((m, m)) < density, rng.integers(1, 4, (m, m)), 0)
    if coincident:
        x[:, 5], x[:, 17] = x[:, 9], x[:, 40]
        code[5, 9], code[9, 5], code[17, 40] = 3, 1, 2
    return x, tp, code, np.float32(0.7), np.float32(1.9)


def _port(x, tp, code, cg, cl):
    xt, tpt, ct = map(torch.from_numpy, (x, tp, code))
    return (tdk.pair_loss_reference(xt, tpt, ct, float(cg), float(cl)).numpy(),
            tdk.pair_grad_reference(xt, tpt, ct, float(cg), float(cl)).numpy())


def _port_list(x, tp, code, cg, cl):
    """K5's plain version on its own inputs, the pair list of `code`."""
    xt, tpt, ct = map(torch.from_numpy, (x, tp, code))
    return tdk.pair_grad_list_reference(xt, tpt, tdk.build_pair_list(ct),
                                        float(cg), float(cl)).numpy()


def _assert_close(loss, grad, ref_loss, ref_grad):
    np.testing.assert_allclose(loss, ref_loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(grad, ref_grad, atol=GRAD_ATOL_REL * np.abs(ref_grad).max())


def test_plain_k4_k5_match_pallas_interpret_mp1024():
    x, tp, code, cg, cl = _case(1024, 1, 1000, seed=0)
    fn = lambda p: jdk.pair_loss(p, jnp.asarray(tp), jnp.asarray(code), cg, cl, True)  # noqa: E731
    jl, jg = jax.value_and_grad(fn)(jnp.asarray(x[0]))
    loss, grad = _port(x, tp, code, cg, cl)
    assert loss.shape == (1,) and grad.shape == (1, 1024, 3)
    _assert_close(loss[0], grad[0], float(jl), np.asarray(jg))


def test_plain_k4_k5_match_pallas_vmap_two_balls():
    x, tp, code, cg, cl = _case(1024, 2, 900, seed=1)

    def fn(p):
        return jdk.pair_loss(p, jnp.asarray(tp), jnp.asarray(code), cg, cl, True)

    jl = jax.vmap(fn)(jnp.asarray(x))
    jg = jax.vmap(jax.grad(fn))(jnp.asarray(x))
    loss, grad = _port(x, tp, code, cg, cl)
    _assert_close(loss, grad, np.asarray(jl), np.asarray(jg))


def test_plain_k5_matches_autograd_of_plain_k4():
    """On points with no coincident pairs autograd through the plain K4 is
    a reference for K5's written-out formula."""
    x, tp, code, cg, cl = _case(1024, 2, 1000, seed=2)
    xt = torch.from_numpy(x).requires_grad_(True)
    loss = tdk.pair_loss_reference(xt, torch.from_numpy(tp), torch.from_numpy(code),
                                   float(cg), float(cl))
    (g,) = torch.autograd.grad(loss.sum(), [xt])
    _, grad = _port(x, tp, code, cg, cl)
    np.testing.assert_allclose(grad, g.numpy(), atol=GRAD_ATOL_REL * np.abs(grad).max())


def test_pair_loss_op_takes_plain_versions_on_cpu():
    x, tp, code, cg, cl = _case(1024, 3, 700, seed=3)
    before = (tdk.desc_loss.launches, tdk.desc_grad.launches)
    xt = torch.from_numpy(x).requires_grad_(True)
    ct = torch.from_numpy(code)
    out = tdk.pair_loss(xt, torch.from_numpy(tp), ct, tdk.build_pair_list(ct), cg, cl)
    w = torch.tensor([1.0, -2.0, 0.5])
    (g,) = torch.autograd.grad((out * w).sum(), [xt])
    loss, _ = _port(x, tp, code, cg, cl)
    grad = _port_list(x, tp, code, cg, cl)
    np.testing.assert_array_equal(out.detach().numpy(), loss)
    np.testing.assert_allclose(g.numpy(), grad * w.numpy()[:, None, None], rtol=1e-6)
    assert (tdk.desc_loss.launches, tdk.desc_grad.launches) == before == (0, 0)


def test_coincident_points_contribute_no_gradient():
    """K5's max(D, 1e-12) floor: a coincident pair with nonzero code gives
    R_ij = -2 W T / 1e-12, times x_i - x_j = 0 exactly. The streaming path's
    sqrt(max(d^2, 1e-24)) gives it a zero gradient too, so both agree."""
    from wast3d_tpu_torch.ops.knn import pairwise_sq_dists

    x, tp, code, cg, cl = _case(1024, 1, 1000, seed=4, coincident=True)
    loss, grad = _port(x, tp, code, cg, cl)
    assert np.isfinite(grad).all()
    xt = torch.from_numpy(x).requires_grad_(True)
    d = torch.sqrt(torch.clamp_min(pairwise_sq_dists(xt, xt), 1e-24))
    t = torch.sqrt(torch.clamp_min(pairwise_sq_dists(*[torch.from_numpy(tp)] * 2), 1e-24))
    c = torch.from_numpy(code).to(torch.int32)
    w = float(cg) * (c & 1).float() + float(cl) * ((c >> 1) & 1).float()
    stream = torch.sum(w * (d - t) ** 2, dim=(1, 2))
    (gs,) = torch.autograd.grad(stream.sum(), [xt])
    np.testing.assert_allclose(loss, stream.detach().numpy(), rtol=1e-6)
    np.testing.assert_allclose(grad, gs.numpy(), atol=GRAD_ATOL_REL * np.abs(grad).max())
    # the same points with the coincident pairs' code cleared: only the
    # rows of the two pairs change, and by their other pairs only
    code2 = code.copy()
    code2[5, 9] = code2[9, 5] = code2[17, 40] = 0
    _, grad2 = _port(x, tp, code2, cg, cl)
    np.testing.assert_allclose(grad, grad2, atol=GRAD_ATOL_REL * np.abs(grad).max())


def test_near_coincident_points_match_float64():
    """Pairs 1e-7 to 1e-3 apart with nonzero code, in x and in tp: the plain
    K4/K5 in float32 against the same formula in float64. The distance
    expansion would leave D noise there and R_ij = 2 W (D - T) / D unbounded;
    from differences both stay within the tolerances above."""
    x, tp, code, cg, cl = _case(1024, 2, 1000, seed=9)
    rng = np.random.default_rng(10)
    near, orig = np.arange(100, 130), np.arange(200, 230)
    step = rng.normal(size=(30, 3)) * 10.0 ** rng.uniform(-7, -3, (30, 1))
    tp[near] = tp[orig] + step.astype(np.float32)
    x[:, near] = x[:, orig] + (step * 1.3).astype(np.float32)
    code[near, orig], code[orig, near] = 2, 3
    loss, grad = _port(x, tp, code, cg, cl)
    args64 = (torch.from_numpy(x).double(), torch.from_numpy(tp).double(),
              torch.from_numpy(code), float(cg), float(cl))
    loss64 = tdk.pair_loss_reference(*args64).numpy()
    grad64 = tdk.pair_grad_reference(*args64).numpy()
    assert np.isfinite(grad).all()
    _assert_close(loss, grad, loss64, grad64)


def test_padded_rows_contribute_nothing():
    x, tp, code, cg, cl = _case(1024, 2, 800, seed=5)
    loss, grad = _port(x, tp, code, cg, cl)
    moved = x.copy()
    moved[:, 800:] = np.random.default_rng(6).normal(size=(2, 224, 3))
    loss2, grad2 = _port(moved, tp, code, cg, cl)
    np.testing.assert_array_equal(loss2, loss)
    assert np.abs(grad2[:, 800:]).max() == 0.0 and np.abs(grad[:, 800:]).max() == 0.0
    np.testing.assert_allclose(grad2[:, :800], grad[:, :800], rtol=1e-6, atol=1e-6)


def test_code_bits_select_the_coefficients():
    """bit 0 weighs cg (global), bit 1 cl (local), 3 both."""
    x, tp, code, cg, cl = _case(1024, 1, 1000, seed=7)
    parts = {}
    for name, keep in (("g", 1), ("l", 2)):
        parts[name] = _port(x, tp, (code & keep).astype(np.uint8), cg, cl)[0]
    only_g = _port(x, tp, code, cg, np.float32(0.0))[0]
    np.testing.assert_allclose(parts["g"] + parts["l"], _port(x, tp, code, cg, cl)[0], rtol=1e-5)
    np.testing.assert_allclose(parts["g"], only_g, rtol=1e-6)


@pytest.mark.parametrize("bad", ["mp", "dtype", "tp", "code"])
def test_wrappers_check_their_inputs(bad):
    x, tp, code, cg, cl = (torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                           for a in _case(1024, 1, 1000, seed=8))
    if bad == "mp":
        x, tp, code = x[:, :1000], tp[:1000], code[:1000, :1000]
    elif bad == "dtype":
        x = x.double()
    elif bad == "tp":
        tp = tp[:512]
    else:
        code = code.to(torch.int32)
    pairs = tdk.build_pair_list(code.to(torch.uint8))
    if bad == "code":  # K5's inputs: a list whose entries are int64
        pairs = pairs._replace(entries=pairs.entries.long())
    for fn, c in ((tdk.desc_loss, code), (tdk.desc_grad, pairs)):
        with pytest.raises(ValueError):
            fn(x.contiguous(), tp.contiguous(), c, float(cg), float(cl))
    with pytest.raises(ValueError):  # K5 takes the list, not the code
        tdk.desc_grad(x.contiguous(), tp.contiguous(), code, float(cg), float(cl))


# ---- K5 on the pair list ---------------------------------------------------


@pytest.mark.parametrize("mp,m,seed", [(1024, 1000, 20), (2048, 1500, 21)])
def test_pair_list_round_trips_to_code_or_its_transpose(mp, m, seed):
    """The list holds exactly the pairs of code | code^T, ascending within a
    row, each entry's 4 bits code[i, j] | code[j, i] << 2 above its column;
    padded rows have no entries; the schedule visits every row once,
    longest first."""
    _, _, code, _, _ = _case(mp, 1, m, seed=seed)
    pl = tdk.build_pair_list(torch.from_numpy(code))
    row_ptr = pl.row_ptr.numpy().astype(np.int64)
    n = row_ptr[-1]
    assert pl.entries.shape == (n,) and pl.entries.dtype == torch.int32
    rows = np.repeat(np.arange(mp), np.diff(row_ptr))
    raw = pl.entries.numpy().view(np.uint32)
    cols, bits = raw & (2 ** tdk.COL_BITS - 1), (raw >> tdk.COL_BITS).astype(np.uint8)
    unpacked = tdk.unpack_entries(pl.entries)
    np.testing.assert_array_equal(unpacked[0].numpy(), cols)
    np.testing.assert_array_equal(unpacked[1].numpy(), bits)
    back = np.zeros((mp, mp), np.uint8)
    back[rows, cols] = bits
    np.testing.assert_array_equal(back & 3, code)
    np.testing.assert_array_equal(back >> 2, code.T)
    assert ((code | code.T) != 0).sum() == n and np.all(bits != 0)
    assert np.all(np.diff(cols)[np.diff(rows) == 0] > 0)
    assert np.all(np.diff(row_ptr)[m:] == 0)
    order = pl.row_order.numpy()
    np.testing.assert_array_equal(np.sort(order), np.arange(mp))
    assert np.all(np.diff(np.diff(row_ptr)[order]) <= 0)


def test_list_k5_matches_pallas_interpret_mp1024():
    x, tp, code, cg, cl = _case(1024, 1, 1000, seed=0)
    fn = lambda p: jdk.pair_loss(p, jnp.asarray(tp), jnp.asarray(code), cg, cl, True)  # noqa: E731
    jg = jax.grad(fn)(jnp.asarray(x[0]))
    grad = _port_list(x, tp, code, cg, cl)
    assert grad.shape == (1, 1024, 3) and grad.dtype == np.float32
    np.testing.assert_allclose(grad[0], np.asarray(jg),
                               atol=GRAD_ATOL_REL * np.abs(np.asarray(jg)).max())


def test_list_k5_matches_pallas_vmap_two_balls_and_dense_plain():
    x, tp, code, cg, cl = _case(1024, 2, 900, seed=1)

    def fn(p):
        return jdk.pair_loss(p, jnp.asarray(tp), jnp.asarray(code), cg, cl, True)

    jg = np.asarray(jax.vmap(jax.grad(fn))(jnp.asarray(x)))
    grad = _port_list(x, tp, code, cg, cl)
    np.testing.assert_allclose(grad, jg, atol=GRAD_ATOL_REL * np.abs(jg).max())
    _, dense = _port(x, tp, code, cg, cl)
    np.testing.assert_allclose(grad, dense, atol=GRAD_ATOL_REL * np.abs(dense).max())


def test_list_k5_near_coincident_points_match_float64():
    """`test_near_coincident_points_match_float64` on the list route."""
    x, tp, code, cg, cl = _case(1024, 2, 1000, seed=9)
    rng = np.random.default_rng(10)
    near, orig = np.arange(100, 130), np.arange(200, 230)
    step = rng.normal(size=(30, 3)) * 10.0 ** rng.uniform(-7, -3, (30, 1))
    tp[near] = tp[orig] + step.astype(np.float32)
    x[:, near] = x[:, orig] + (step * 1.3).astype(np.float32)
    code[near, orig], code[orig, near] = 2, 3
    grad = _port_list(x, tp, code, cg, cl)
    pairs = tdk.build_pair_list(torch.from_numpy(code))
    grad64 = tdk.pair_grad_list_reference(torch.from_numpy(x).double(),
                                          torch.from_numpy(tp).double(), pairs,
                                          float(cg), float(cl)).numpy()
    dense64 = tdk.pair_grad_reference(torch.from_numpy(x).double(),
                                      torch.from_numpy(tp).double(), torch.from_numpy(code),
                                      float(cg), float(cl)).numpy()
    assert np.isfinite(grad).all()
    np.testing.assert_allclose(grad64, dense64, atol=1e-12 * np.abs(dense64).max())
    np.testing.assert_allclose(grad, grad64, atol=GRAD_ATOL_REL * np.abs(grad64).max())


def test_list_k5_padded_rows_contribute_nothing():
    """`test_padded_rows_contribute_nothing` on the list route."""
    x, tp, code, cg, cl = _case(1024, 2, 800, seed=5)
    grad = _port_list(x, tp, code, cg, cl)
    moved = x.copy()
    moved[:, 800:] = np.random.default_rng(6).normal(size=(2, 224, 3))
    grad2 = _port_list(moved, tp, code, cg, cl)
    assert np.abs(grad2[:, 800:]).max() == 0.0 and np.abs(grad[:, 800:]).max() == 0.0
    np.testing.assert_array_equal(grad2[:, :800], grad[:, :800])


def test_list_k5_coincident_points_contribute_no_gradient():
    """`test_coincident_points_contribute_no_gradient` on the list route:
    the max(D, 1e-12) floor times x_i - x_j = 0 gives exactly 0."""
    x, tp, code, cg, cl = _case(1024, 1, 1000, seed=4, coincident=True)
    grad = _port_list(x, tp, code, cg, cl)
    _, dense = _port(x, tp, code, cg, cl)
    assert np.isfinite(grad).all()
    np.testing.assert_allclose(grad, dense, atol=GRAD_ATOL_REL * np.abs(dense).max())
