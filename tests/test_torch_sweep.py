"""Port parity on the CPU: the style sweep (`stylize/sweep.py`,
`cli/sweep.py`) against JAX's `stylize_sweep` with `mesh=None`.

Two style patches of different sizes and radii on `test_torch_stylize.py`'s
synthetic content sphere, with its small `StylizeConfig` (`PIPE_KW`). Both
packages start every style's fit from JAX's descriptors of that style's
patch, as `test_stylize_scene_matches_jax` does (kNN ties at large k).

- The host stages exactly: the domain, each cleaned and subsampled patch
  (one draw sequence over the styles), each style's balls and the common
  ball capacity.
- The stylized positions at `test_torch_stylize.py`'s bound for
  `stylize_scene` (rtol 1e-4, atol 1e-5): JAX fits every style's balls in
  one vmapped program, padded to the largest ball count; the port fits
  each style's real balls in batches. Each ball's fit is its own, so only
  rounding differs.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_stylize import (FIT_ATOL, FIT_RTOL, PIPE_KW, _cfgs, _converted,
                                      _flags, _jax_parser, _synthetic_pair)
from wast3d_tpu.stylize import fit as jfit
from wast3d_tpu_torch.stylize import fit as tfit
from wast3d_tpu_torch.stylize import sweep as tsweep
from wast3d_tpu_torch.stylize.cluster import NPZ_KEYS

CPU = "cpu"


def _patches():
    """Two grid patches small enough to need several balls on the content
    sphere: `_synthetic_pair`'s 7 x 7 grid at 0.3 of its size (three balls),
    and an 8 x 8 grid with some depth (two balls, of 23 and 18 points: the
    common capacity is 23, above the first style's largest ball). The
    second has more points, so it is subsampled to the first's count."""
    from wast3d_tpu.stylize.cluster import StylePatch as JPatch
    from wast3d_tpu_torch.stylize.cluster import StylePatch as TPatch

    jcontent, tcontent, jp1, _ = _synthetic_pair()
    rng = np.random.default_rng(1)
    g = np.stack(np.meshgrid(np.linspace(-1, 1, 8), np.linspace(-1, 1, 8)), -1).reshape(-1, 2)
    first = {k: np.asarray(getattr(jp1, k[1:])) for k in NPZ_KEYS}
    first["_xyz"] = first["_xyz"] * np.float32(0.3)
    second = {
        "_xyz": (np.concatenate([g, rng.normal(size=(64, 1)) * 0.05], 1) * 0.2)
        .astype(np.float32),
        "_features_dc": rng.normal(size=(64, 1, 3)).astype(np.float32),
        "_features_rest": np.zeros((64, 15, 3), np.float32),
        "_rotation": np.tile([[1, 0, 0, 0]], (64, 1)).astype(np.float32),
        "_scaling": np.full((64, 3), -4.0, np.float32),
        "_opacity": np.ones((64, 1), np.float32),
    }
    return (jcontent, tcontent, [JPatch(first), JPatch(second)],
            [TPatch(first), TPatch(second)])


def _jax_descriptors(monkeypatch, jc):
    """Every port fit starts from JAX's descriptors of its own patch."""
    monkeypatch.setattr(tfit, "compute_target_descriptors",
                        lambda pts, cfg=None, device=None: _converted(
                            jfit.compute_target_descriptors(np.asarray(pts), jc)))


def test_prepare_sweep_matches_jax_host_stages():
    from wast3d_tpu.stylize import coverage as jcov
    from wast3d_tpu.stylize import prepare as jprep
    from wast3d_tpu.stylize.pipeline import clean_style_patch

    jcontent, tcontent, jpatches, tpatches = _patches()
    jc, tc = _cfgs(**PIPE_KW)
    inp = tsweep.prepare_sweep(tcontent, tpatches, tc, seed=0, max_style_points=16384,
                               device=CPU)
    # JAX's stylize_sweep stages, as it runs them
    rng = np.random.default_rng(0)
    xyz = np.asarray(jcontent.xyz)[np.asarray(jcontent.mask)]
    dom = xyz[jprep.prepare_scene(xyz, num_clusters=jc.num_content_clusters,
                                  q=jc.outlier_quantile, kth_neighbor=jc.outlier_knn, seed=0)]
    cleaned = [clean_style_patch(p) for p in jpatches]
    m_common = min(min(len(p) for p in cleaned), 16384)
    cleaned = [p.select(rng.choice(len(p), size=m_common, replace=False)) for p in cleaned]
    np.testing.assert_array_equal(inp.domain, dom)
    assert [len(p) for p in inp.patches] == [m_common] * 2 and m_common < len(tpatches[1])
    for a, b in zip(inp.patches, cleaned):
        np.testing.assert_array_equal(a.xyz, b.xyz)
    circles = []
    for p in cleaned:
        r = jcov.cluster_radius(p.xyz)[1] * jc.ball_radius_factor
        circles.append(jcov.filter_circles(
            jcov.sample_circles(dom, r=r, min_points_per_cluster=jc.min_ball_points),
            min_points=max(1, jc.min_ball_points // 2)))
    assert [len(c) for c in inp.circles] == [len(c) for c in circles]
    assert [len(c) for c in circles] == [3, 2]
    for a, b in zip(inp.circles, circles):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert inp.d_cap == min(jc.ball_capacity, max(len(i) for c in circles for i in c))
    assert max(len(i) for i in circles[0]) < inp.d_cap


def test_stylize_sweep_matches_jax(monkeypatch):
    from wast3d_tpu.stylize import sweep as jsweep

    jcontent, tcontent, jpatches, tpatches = _patches()
    jc, tc = _cfgs(**PIPE_KW)
    j = jsweep.stylize_sweep(jcontent, jpatches, cfg=jc, mesh=None, seed=0)
    _jax_descriptors(monkeypatch, jc)
    t = tsweep.stylize_sweep(tcontent, tpatches, tc, seed=0, device=CPU)
    assert len(t) == len(j) == 2
    for a, b in zip(t, j):
        n = int(b.num_active)
        assert a.capacity == n > 40
        np.testing.assert_allclose(a.xyz.numpy(), np.asarray(b.xyz)[:n], rtol=FIT_RTOL,
                                   atol=FIT_ATOL)
        np.testing.assert_array_equal(a.scaling.numpy(), np.asarray(b.scaling)[:n])


def test_fit_balls_sweep_equals_fit_balls_per_batch():
    """Each style's balls in batches of 3 are `fit.fit_balls` on those
    batches, bit for bit."""
    _, tcontent, _, tpatches = _patches()
    _, tc = _cfgs(**{**PIPE_KW, "fit_steps": 5})
    inp = tsweep.prepare_sweep(tcontent, tpatches, tc, device=CPU)
    targets = torch.as_tensor(np.stack([p.xyz for p in inp.patches]))
    descs = [tfit.compute_target_descriptors(p.xyz, tc, device=CPU) for p in inp.patches]
    padded = [tfit.pad_balls(inp.domain, c, inp.d_cap) for c in inp.circles]
    balls = [torch.as_tensor(b) for b, _ in padded]
    masks = [torch.as_tensor(m) for _, m in padded]
    out = tsweep.fit_balls_sweep(targets, descs, balls, masks, tc, batch_size=3)
    for s in range(2):
        assert out[s].shape == (len(inp.circles[s]), len(inp.patches[s]), 3)
        for b in range(0, balls[s].shape[0], 3):
            direct = tfit.fit_balls(targets[s], descs[s], balls[s][b:b + 3],
                                    masks[s][b:b + 3], tc)
            assert torch.equal(out[s][b:b + 3], direct)


def test_cli_flags_match_jax():
    from wast3d_tpu.cli import sweep as jcli
    from wast3d_tpu_torch.cli import sweep as tcli

    j, t = _flags(_jax_parser(jcli)), _flags(tcli.build_parser())
    assert set(t) - set(j) == {"--device"}
    for opt, val in j.items():
        assert t[opt] == val, opt


def test_cli_sweep_writes_one_ply_per_style(tmp_path):
    from wast3d_tpu_torch.cli import sweep as tcli
    from wast3d_tpu_torch.scene.ply import load_ply, save_ply

    _, tcontent, _, tpatches = _patches()
    content = str(tmp_path / "content.ply")
    save_ply(tcontent, content)
    npzs = []
    for i, p in enumerate(tpatches):
        npzs.append(str(tmp_path / f"style{i}.npz"))
        np.savez(npzs[-1], **{k: getattr(p, k[1:]) for k in NPZ_KEYS})
    flags = [f"--{k}={v}" for k, v in {**PIPE_KW, "fit_steps": 10}.items()]
    out = tmp_path / "out"
    tcli.main(["--content", content, "--style_clusters", *npzs, "--output_dir", str(out),
               "--data_axis", "1", *flags, "--device", "cpu"])
    for i in range(2):
        scene = load_ply(str(out / f"stylized_style{i}.ply"), device=CPU)
        assert scene.capacity > 40 and bool(torch.isfinite(scene.xyz).all())


@pytest.mark.parametrize("axis", [2, 8])
def test_cli_sweep_data_axis_above_one_is_not_ported(axis, monkeypatch):
    """`--data_axis` runs one rank per card (tests/test_torch_train_sharded.py
    runs it on the CPU); more CUDA ranks than cards raise before any rank
    starts, as JAX's `make_mesh` fails with too few devices."""
    from wast3d_tpu_torch.cli import sweep as tcli

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match=f"{axis} CUDA ranks need {axis} cards"):
        tcli.main(["--content", "a.ply", "--style_clusters", "b.npz", "--output_dir", "o",
                   "--data_axis", str(axis), "--device", "cuda"])
