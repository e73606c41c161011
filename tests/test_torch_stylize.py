"""Port parity for the stylization path on the CPU: descriptors, the
descriptor loss on its three paths, the domain losses, the batched fit,
`stylize_scene` end to end and the two CLIs, against the JAX package.

kNN ties at large k may order neighbour indices differently in the two
packages, so the fit and pipeline comparisons start both from one
descriptor state (`scene.convert.target_descriptors_from_numpy` on the JAX
`TargetDescriptors`), as the training tests start from one train state.
The descriptors themselves are compared on points without ties.

Tolerances, with their reasons:
- descriptor distances 1e-5 absolute (a norm of float32 differences);
- losses rtol 1e-5 and gradients 1e-4 x max |g| (the JAX package's own
  bound for its kernel against its streaming path; the same float32
  formulas summed in another order);
- fit trajectories rtol 1e-4, atol 1e-5 (the JAX tests' own bound between
  fit paths, `tests/test_stylize.py`: Adam divides by sqrt(v), which
  amplifies the gradients' last-bit differences over the steps);
- pipeline: domain indices and balls exact; fitted points as the fit;
  the merged scene's count exact and its positions as the fit.
"""

import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wast3d_tpu.config import StylizeConfig as JCfg
from wast3d_tpu.stylize import fit as jfit
from wast3d_tpu_torch.config import StylizeConfig as TCfg
from wast3d_tpu_torch.scene.convert import target_descriptors_from_numpy
from wast3d_tpu_torch.stylize import desc_kernel as tdk
from wast3d_tpu_torch.stylize import fit as tfit

CPU = "cpu"
LOSS_RTOL, GRAD_ATOL_REL = 1e-5, 1e-4
FIT_RTOL, FIT_ATOL = 1e-4, 1e-5


def _cfgs(**kw):
    return JCfg(**kw), TCfg(**kw)


def _converted(td):
    d = {f: (None if getattr(td, f) is None else np.asarray(getattr(td, f)))
         for f in jfit.TargetDescriptors._fields}
    return target_descriptors_from_numpy(d, device=CPU)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def kernel_path_descriptors(pts, cfg):
    """The port's descriptors on the kernel path, built on the CPU (where
    JAX's rule leaves that path to CUDA): Mp padded to `MP_ALIGN` and the
    pair code made from the bit masks, bit 0 global and bit 1 local."""
    td = tfit.compute_target_descriptors(pts, cfg, device=CPU)
    pad = (-td.points.shape[0]) % tdk.MP_ALIGN
    bits = [torch.nn.functional.pad(b, (0, pad // 8, 0, pad))
            for b in (td.bits_global, td.bits_local)]
    code = (tfit.unpack_bits(bits[0]) + 2 * tfit.unpack_bits(bits[1])).to(torch.uint8)
    return td._replace(points=torch.nn.functional.pad(td.points, (0, 0, 0, pad)),
                       bits_global=bits[0], bits_local=bits[1], pair_code=code)


def test_stylize_config_matches_jax():
    assert [f.name for f in dataclasses.fields(TCfg)] == \
        [f.name for f in dataclasses.fields(JCfg)]
    assert dataclasses.asdict(TCfg()) == dataclasses.asdict(JCfg())
    assert TCfg().desc_block == 2048 and TCfg().desc_kernel is True


def test_descriptor_values():
    pts = np.asarray([[0, 0, 0], [1, 0, 0], [2, 0, 0]], np.float32)
    td = tfit.compute_target_descriptors(pts, TCfg(global_knn=3, global_stride=1, local_knn=2),
                                         device=CPU)
    np.testing.assert_allclose(td.desc_global[0].numpy(), [1, 2], atol=1e-6)
    np.testing.assert_allclose(td.desc_global[1].numpy(), [1, 1], atol=1e-6)


@pytest.mark.parametrize("k", [(16, 4, 8), (96, 5, 64)])  # top-k fold / sort path
def test_descriptors_match_jax(k):
    kg, stride, kl = k
    pts = np.random.default_rng(0).normal(size=(200, 3)).astype(np.float32)
    jc, tc = _cfgs(global_knn=kg, global_stride=stride, local_knn=kl)
    j = jfit.compute_target_descriptors(pts, jc)
    t = tfit.compute_target_descriptors(pts, tc, device=CPU)
    for f in ("idx_global", "idx_local"):
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)))
    for f in ("desc_global", "desc_local", "points"):
        np.testing.assert_allclose(getattr(t, f).numpy(), np.asarray(getattr(j, f)), atol=1e-5)
    for f in ("bits_global", "bits_local"):
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)))
    assert t.coef_global == float(j.coef_global) and t.coef_local == float(j.coef_local)
    # strided global queries: row r of the global descriptor is point r * stride
    np.testing.assert_array_equal(t.idx_global[:, 0].numpy(), np.arange(0, 200, stride))
    # exclude_self=False: every point's first neighbour is itself
    np.testing.assert_array_equal(t.idx_local[:, 0].numpy(), np.arange(200))


def test_pair_code_and_bits_match_jax_at_2048():
    """Bit 0 global, bit 1 local; bits little-endian as np.packbits; the
    port's pair code and masks byte-identical to JAX's."""
    pts = (np.random.default_rng(7).normal(size=(2000, 3)) * 0.3).astype(np.float32)
    kw = dict(global_knn=32, global_stride=8, local_knn=8, desc_block=1024)
    j = jfit.compute_target_descriptors(pts, JCfg(**kw, pallas_interpret=True))
    t = kernel_path_descriptors(pts, TCfg(**kw))
    assert j.pair_code is not None and tuple(t.pair_code.shape) == (2048, 2048)
    for f in ("pair_code", "bits_global", "bits_local", "idx_global", "idx_local"):
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)))
    dense_g = jfit._pair_dense(np.asarray(j.idx_global), np.arange(2000)[::8], 2048)
    np.testing.assert_array_equal(t.bits_global.numpy(), np.packbits(dense_g, axis=1,
                                                                     bitorder="little"))
    np.testing.assert_array_equal(tfit.unpack_bits(t.bits_global).numpy(), dense_g)
    np.testing.assert_array_equal(t.pair_code.numpy() & 1, dense_g)
    # CUDA decides the kernel path; on the CPU the rule leaves it off
    assert tfit.compute_target_descriptors(pts, TCfg(**kw), device=CPU).pair_code is None


@pytest.fixture(scope="module")
def paths_2048():
    """JAX descriptors for the dense, streaming and kernel paths at
    Mp = 2048, and a point set near the patch."""
    rng = np.random.default_rng(7)
    pts = (rng.normal(size=(2048, 3)) * 0.3).astype(np.float32)
    kw = dict(global_knn=32, global_stride=8, local_knn=8)
    tds = {"dense": jfit.compute_target_descriptors(pts, JCfg(**kw, desc_block=2048)),
           "streaming": jfit.compute_target_descriptors(pts, JCfg(**kw, desc_block=1024)),
           "kernel": jfit.compute_target_descriptors(
               pts, JCfg(**kw, desc_block=1024, pallas_interpret=True))}
    x = pts * 1.2 + (rng.normal(size=(2048, 3)) * 0.05).astype(np.float32)
    return tds, x


@pytest.mark.parametrize("path", ["dense", "streaming", "kernel"])
def test_descriptor_loss_paths_match_jax(paths_2048, path):
    tds, x = paths_2048
    jtd = tds[path]
    block = 2048 if path == "dense" else 1024
    jwt = jfit.dense_pair_terms(jtd) if path == "dense" else None
    jl, jg = jax.value_and_grad(
        lambda p: jfit.descriptor_loss(p, jtd, block, dense_wt=jwt,
                                       interpret=path == "kernel"))(jnp.asarray(x))
    ttd = _converted(jtd)
    assert (ttd.pair_code is not None) == (path == "kernel")
    twt = tfit.dense_pair_terms(ttd) if path == "dense" else None
    xt = _t(x)[None].requires_grad_(True)
    tl = tfit.descriptor_loss(xt, ttd, block, dense_wt=twt)
    (tg,) = torch.autograd.grad(tl.sum(), [xt])
    np.testing.assert_allclose(tl.detach().numpy()[0], float(jl), rtol=LOSS_RTOL)
    np.testing.assert_allclose(tg.numpy()[0], np.asarray(jg),
                               atol=GRAD_ATOL_REL * np.abs(np.asarray(jg)).max())


@pytest.mark.parametrize("dense_block", [4096, 1])
def test_domain_adaptation_loss_matches_jax(dense_block):
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 40, 3)).astype(np.float32)
    dom = rng.normal(size=(2, 64, 3)).astype(np.float32)
    mask = rng.uniform(size=(2, 64)) > 0.3
    for k, rows in ((1, None), (5, None), (20, None), (5, 25)):
        xt = _t(x).requires_grad_(True)
        tl = tfit.domain_adaptation_loss(xt, _t(dom), _t(mask), k, x_rows=rows,
                                         dense_block=dense_block)
        (tg,) = torch.autograd.grad(tl.sum(), [xt])
        for b in range(2):
            fn = lambda p: jfit.domain_adaptation_loss(  # noqa: E731
                p, jnp.asarray(dom[b]), jnp.asarray(mask[b]), k, x_rows=rows,
                dense_block=dense_block)
            jl, jg = jax.value_and_grad(fn)(jnp.asarray(x[b]))
            np.testing.assert_allclose(float(tl[b].detach()), float(jl), rtol=LOSS_RTOL)
            np.testing.assert_allclose(tg[b].numpy(), np.asarray(jg),
                                       atol=GRAD_ATOL_REL * np.abs(np.asarray(jg)).max())


def test_domain_coverage_loss_matches_jax():
    rng = np.random.default_rng(10)
    x = rng.normal(size=(2, 30, 3)).astype(np.float32)
    dom = rng.normal(size=(2, 50, 3)).astype(np.float32)
    mask = rng.uniform(size=(2, 50)) > 0.2
    xt = _t(x).requires_grad_(True)
    tl = tfit.domain_coverage_loss(xt, _t(dom), _t(mask), x_rows=24)
    (tg,) = torch.autograd.grad(tl.sum(), [xt])
    for b in range(2):
        jl, jg = jax.value_and_grad(lambda p: jfit.domain_coverage_loss(
            p, jnp.asarray(dom[b]), jnp.asarray(mask[b]), x_rows=24))(jnp.asarray(x[b]))
        np.testing.assert_allclose(float(tl[b].detach()), float(jl), rtol=LOSS_RTOL)
        np.testing.assert_allclose(tg[b].numpy(), np.asarray(jg),
                                   atol=GRAD_ATOL_REL * np.abs(np.asarray(jg)).max())
    assert float(tg[:, 24:].abs().max()) == 0.0


def _fit_pair(m, cfg_kw, balls, seed, kernel=False):
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(m, 3)) * 0.3).astype(np.float32)
    jc = JCfg(**cfg_kw, **({"pallas_interpret": True} if kernel else {}))
    tc = TCfg(**cfg_kw)
    jtd = jfit.compute_target_descriptors(pts, jc)
    dom = rng.normal(size=balls).astype(np.float32)
    mask = np.ones(balls[:2], bool)
    mask[-1, balls[1] // 2:] = False  # a partly padded ball
    jf = np.asarray(jfit.fit_balls(jnp.asarray(pts), jtd, jnp.asarray(dom), jnp.asarray(mask), jc))
    tf = tfit.fit_balls(_t(pts), _converted(jtd), _t(dom), _t(mask), tc).numpy()
    return jf, tf


@pytest.mark.parametrize("path", ["dense", "streaming", "kernel"])
def test_fit_balls_trajectory_matches_jax(path):
    if path == "dense":
        jf, tf = _fit_pair(32, dict(global_knn=8, global_stride=2, local_knn=4, fit_steps=20,
                                    domain_knn=3, w_coverage=0.5), (2, 40, 3), seed=1)
    elif path == "streaming":
        jf, tf = _fit_pair(300, dict(global_knn=24, global_stride=5, local_knn=6, fit_steps=15,
                                     domain_knn=4, desc_block=128), (1, 64, 3), seed=3)
    else:
        jf, tf = _fit_pair(2048, dict(global_knn=32, global_stride=8, local_knn=8, fit_steps=4,
                                      domain_knn=4, ball_capacity=128, desc_block=1024),
                           (2, 128, 3), seed=7, kernel=True)
    assert tf.shape == jf.shape and np.isfinite(tf).all()
    np.testing.assert_allclose(tf, jf, rtol=FIT_RTOL, atol=FIT_ATOL)


def test_fit_batched_matches_single():
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(32, 3)).astype(np.float32) * 0.2
    dom = rng.normal(size=(2, 40, 3)).astype(np.float32) + [[[0.0]], [[2.0]]]
    cfg = TCfg(global_knn=8, global_stride=2, local_knn=4, fit_steps=20, domain_knn=3)
    td = tfit.compute_target_descriptors(pts, cfg, device=CPU)
    both = tfit.fit_balls(_t(pts), td, _t(dom.astype(np.float32)), torch.ones(2, 40, dtype=bool), cfg)
    one = tfit.fit_balls(_t(pts), td, _t(dom[:1].astype(np.float32)), torch.ones(1, 40, dtype=bool), cfg)
    np.testing.assert_allclose(both[0].numpy(), one[0].numpy(), atol=1e-5)


def _use_jax_descriptors(monkeypatch, pts, jcfg):
    """Make the port's fit start from the JAX descriptor state."""
    jtd = jfit.compute_target_descriptors(pts, jcfg)
    monkeypatch.setattr(tfit, "compute_target_descriptors",
                        lambda *a, **k: _converted(jtd))


def test_fit_all_balls_short_last_batch_matches_jax(monkeypatch):
    """JAX pads the last batch with zero balls; the port fits only the
    balls that are left. Each ball's fit is its own, so they agree."""
    rng = np.random.default_rng(2)
    pts = (rng.normal(size=(40, 3)) * 0.2).astype(np.float32)
    domain = rng.normal(size=(120, 3)).astype(np.float32)
    circles = [np.arange(0, 50), np.arange(40, 90), np.arange(80, 120)]
    kw = dict(global_knn=8, global_stride=2, local_knn=4, fit_steps=10, domain_knn=3)
    j = jfit.fit_all_balls(pts, domain, circles, JCfg(**kw), batch_size=2)
    _use_jax_descriptors(monkeypatch, pts, JCfg(**kw))
    t = tfit.fit_all_balls(pts, domain, circles, TCfg(**kw), batch_size=2, device=CPU)
    assert len(t) == len(j) == 3
    for a, b in zip(t, j):
        np.testing.assert_allclose(a, np.asarray(b), rtol=FIT_RTOL, atol=FIT_ATOL)


def _synthetic_pair():
    """`tests/test_stylize.py::TestPipeline`'s content sphere and style grid."""
    from tests.test_train import _mini_scene
    from wast3d_tpu.stylize.cluster import StylePatch as JPatch
    from wast3d_tpu_torch.scene.convert import scene_from_numpy
    from wast3d_tpu_torch.scene.gaussians import FIELDS
    from wast3d_tpu_torch.stylize.cluster import StylePatch as TPatch

    rng = np.random.default_rng(0)
    n = 300
    pts = rng.normal(size=(n, 3)).astype(np.float32)
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    content = _mini_scene(n=n, cap=512, seed=0).replace(
        xyz=jnp.zeros((512, 3)).at[:n].set(jnp.asarray(pts)))
    d = {f: np.asarray(getattr(content, f)) for f in FIELDS}
    d.update(active_sh_degree=content.active_sh_degree, max_sh_degree=content.max_sh_degree)
    g = np.stack(np.meshgrid(np.linspace(-1, 1, 7), np.linspace(-1, 1, 7)), -1).reshape(-1, 2)
    arrays = {
        "_xyz": np.concatenate([g, np.zeros((49, 1))], 1).astype(np.float32) * 0.3,
        "_features_dc": rng.normal(size=(49, 1, 3)).astype(np.float32),
        "_features_rest": np.zeros((49, 15, 3), np.float32),
        "_rotation": np.tile([[1, 0, 0, 0]], (49, 1)).astype(np.float32),
        "_scaling": np.full((49, 3), -4.0, np.float32),
        "_opacity": np.ones((49, 1), np.float32),
    }
    return content, scene_from_numpy(d, device=CPU), JPatch(arrays), TPatch(arrays)


PIPE_KW = dict(num_content_clusters=4, global_knn=16, global_stride=4, local_knn=8,
               fit_steps=60, min_ball_points=10, domain_knn=5, ball_capacity=256)


def test_stylize_scene_matches_jax(monkeypatch):
    from wast3d_tpu.stylize import coverage as jcov
    from wast3d_tpu.stylize import pipeline as jpipe
    from wast3d_tpu.stylize import prepare as jprep
    from wast3d_tpu_torch.stylize import coverage as tcov
    from wast3d_tpu_torch.stylize import pipeline as tpipe
    from wast3d_tpu_torch.stylize import prepare as tprep

    jcontent, tcontent, jpatch, tpatch = _synthetic_pair()
    jc, tc = _cfgs(**PIPE_KW)
    # the stages' discrete results, exactly
    xyz = np.asarray(jcontent.xyz)[np.asarray(jcontent.mask)]
    kw = dict(num_clusters=jc.num_content_clusters, q=jc.outlier_quantile,
              kth_neighbor=jc.outlier_knn, seed=0)
    jdom, tdom = jprep.prepare_scene(xyz, **kw), tprep.prepare_scene(xyz, **kw, device=CPU)
    np.testing.assert_array_equal(tdom, jdom)
    jcp, tcp = jpipe.clean_style_patch(jpatch), tpipe.clean_style_patch(tpatch, device=CPU)
    np.testing.assert_array_equal(tcp.xyz, jcp.xyz)
    r = jcov.cluster_radius(jcp.xyz)[1] * jc.ball_radius_factor
    jcirc = jcov.sample_circles(xyz[jdom], r=r, min_points_per_cluster=jc.min_ball_points)
    tcirc = tcov.sample_circles(xyz[tdom], r=r, min_points_per_cluster=tc.min_ball_points,
                                device=CPU)
    assert len(tcirc) == len(jcirc)
    for a, b in zip(tcirc, jcirc):
        np.testing.assert_array_equal(a, b)
    # end to end, from one descriptor state
    j = jpipe.stylize_scene(jcontent, jpatch, cfg=jc, batch_size=4)
    _use_jax_descriptors(monkeypatch, jcp.xyz, jc)
    t = tpipe.stylize_scene(tcontent, tpatch, cfg=tc, batch_size=4, device=CPU)
    n = int(j.num_active)
    assert t.capacity == n > 40
    np.testing.assert_allclose(t.xyz.numpy(), np.asarray(j.xyz)[:n], rtol=FIT_RTOL, atol=FIT_ATOL)
    np.testing.assert_array_equal(t.scaling.numpy(), np.asarray(j.scaling)[:n])
    radius = np.linalg.norm(t.xyz.numpy(), axis=1)
    assert 0.3 < np.median(radius) < 3.0


def _jax_parser(module):
    """The parser a `wast3d_tpu.cli` module's main() builds, caught at parse time."""
    caught = {}

    class Caught(Exception):
        pass

    def parse(self, *a, **k):
        caught["parser"] = self
        raise Caught

    orig = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = parse
    try:
        with pytest.raises(Caught):
            module.main()
    finally:
        argparse.ArgumentParser.parse_args = orig
    return caught["parser"]


def _flags(p):
    return {opt: (a.default, a.nargs, a.type, type(a).__name__)
            for a in p._actions for opt in a.option_strings if opt not in ("-h", "--help")}


@pytest.mark.parametrize("name", ["stylize", "save_clusters"])
def test_cli_flags_match_jax(name):
    import importlib

    j = _flags(_jax_parser(importlib.import_module(f"wast3d_tpu.cli.{name}")))
    t = _flags(importlib.import_module(f"wast3d_tpu_torch.cli.{name}").build_parser())
    assert set(t) - set(j) == {"--device"}
    for opt, val in j.items():
        assert t[opt] == val, opt


def test_cli_stylize_more_devices_is_not_ported(tmp_path):
    from wast3d_tpu_torch.cli import stylize as cli

    with pytest.raises(NotImplementedError, match="queue 1"):
        cli.main(["--content", "a.ply", "--style_cluster", "b.npz", "--output", "c.ply",
                  "--devices", "2", "--device", "cpu"])


def test_cli_save_clusters_and_stylize_on_cpu(tmp_path):
    from wast3d_tpu_torch.cli import save_clusters, stylize
    from wast3d_tpu_torch.scene.ply import load_ply, save_ply
    from wast3d_tpu_torch.stylize.cluster import load_cluster

    _, tcontent, _, tpatch = _synthetic_pair()
    content = str(tmp_path / "content.ply")
    save_ply(tcontent, content)
    # a style scene to cluster: two copies of the grid patch, far apart
    style_scene = load_ply(content, device=CPU)
    style_scene = style_scene.replace(xyz=torch.cat([style_scene.xyz[:150] * 0.2 + 3.0,
                                                     style_scene.xyz[150:] * 0.2 - 3.0]))
    style_ply = str(tmp_path / "style.ply")
    save_ply(style_scene, style_ply)
    save_clusters.main(["--ckpt_path", style_ply, "--output_dir", str(tmp_path / "clusters"),
                        "--num_clusters", "2", "--n_init", "2", "--device", "cpu"])
    patch = load_cluster(str(tmp_path / "clusters" / "cluster_0.npz"))
    assert 100 < len(patch) < 200
    np.testing.assert_allclose(patch.xyz.mean(0), 0, atol=1e-4)
    out = str(tmp_path / "stylized.ply")
    flags = [f"--{k}={v}" for k, v in PIPE_KW.items()]
    stylize.main(["--content", content, "--style_cluster",
                  str(tmp_path / "clusters" / "cluster_0.npz"), "--output", out,
                  "--batch_size", "4", *flags, "--device", "cpu"])
    result = load_ply(out, device=CPU)
    assert result.capacity > 40 and bool(torch.isfinite(result.xyz).all())


def test_cli_save_clusters_reads_a_checkpoint(tmp_path):
    from wast3d_tpu_torch.cli import save_clusters
    from wast3d_tpu_torch.config import OptimizationConfig
    from wast3d_tpu_torch.train.checkpoint import save_checkpoint
    from wast3d_tpu_torch.train.reconstruct import init_train_state

    _, tcontent, _, _ = _synthetic_pair()
    ckpt = str(tmp_path / "chkpnt10.pth")
    save_checkpoint(ckpt, init_train_state(tcontent, OptimizationConfig(), 1.0))
    save_clusters.main(["--ckpt_path", ckpt, "--output_dir", str(tmp_path / "c"),
                        "--num_clusters", "3", "--n_init", "1", "--device", "cpu"])
    sizes = [len(np.load(tmp_path / "c" / f"cluster_{i}.npz")["_xyz"]) for i in range(3)]
    assert sum(sizes) == int(tcontent.mask.sum())
