"""The host-side training schedule: SH warm-up, densify/prune, opacity reset.

Port of `wast3d_tpu/train/schedule.py::run_schedule` (the reference loop's
control blocks, `train.py:77-147`): SH degree up every 1000 iterations,
densify and prune every `densification_interval` inside
(`densify_from_iter`, `densify_until_iter`), opacity resets every
`opacity_reset_interval` and, for white backgrounds, at
`densify_from_iter`. The JAX schedule also grows binning capacities on
overflow and the row capacity before densifying; the port's binning has no
capacities and its N is exact, so neither exists here
(`overflow_growth_update` is kept as a documented no-op).
"""

from __future__ import annotations

import time

from wast3d_tpu_torch.train import densify as densify_mod


def overflow_growth_update(settings, aux: dict):
    """Always None: the port's binning sizes everything from the data, so
    nothing overflows and no raster setting has to grow."""
    del settings, aux
    return None


def _log(tr, entry):
    tr.history.append(entry)
    if tr.history_sink is not None:
        tr.history_sink(entry)


def run_schedule(tr, iterations: int, log_every: int = 0):
    """Drive `iterations` steps of the reference schedule on a `Trainer` (or
    a `parallel.train_sharded.ShardedTrainer`, which densifies its own rows).

    What the loop needs of the trainer, as in JAX
    (`wast3d_tpu/train/schedule.py`): `state`, `opt_cfg`, `history`,
    `history_sink`, `_it`, `_white_bg`,
    `cameras_extent`, `generator`, `total_rows()`; `_pre_step(it)` runs
    before each step (the live viewer's frame) and `_do_step(it)` takes the
    step and returns its aux."""
    cfg = tr.opt_cfg
    for _ in range(iterations):
        it = tr._it + 1  # 1-based like the reference
        tr._it = it
        tr._pre_step(it)
        if it % 1000 == 0:
            tr.state = tr.state._replace(scene=tr.state.scene.one_up_sh_degree())
        aux = tr._do_step(it)
        if it < cfg.densify_until_iter:
            if it > cfg.densify_from_iter and it % cfg.densification_interval == 0:
                max_screen = 20.0 if it > cfg.opacity_reset_interval else 0.0
                scene, opt, stats, _ = densify_mod.densify_and_prune(
                    tr.state.scene, tr.state.opt_state, tr.state.stats,
                    max_grad=cfg.densify_grad_threshold, min_opacity=0.005,
                    extent=float(tr.cameras_extent), max_screen_size=max_screen,
                    percent_dense=cfg.percent_dense, generator=tr.generator)
                tr.state = tr.state._replace(scene=scene, opt_state=opt, stats=stats)
                _log(tr, {"iter": it, "event": "densify", "n": tr.total_rows()})
            if it % cfg.opacity_reset_interval == 0 or (
                    tr._white_bg and it == cfg.densify_from_iter):
                scene, opt = densify_mod.reset_opacity(tr.state.scene, tr.state.opt_state)
                tr.state = tr.state._replace(scene=scene, opt_state=opt)
        if log_every and it % log_every == 0:
            _log(tr, {"iter": it, "loss": float(aux["loss"]),
                      "n": int(aux["num_active"]), "t": time.time()})
    return tr.state
