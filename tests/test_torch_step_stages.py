"""The stages that the batched step of the candidate paths (``"kernel"``,
``"plain"``, ``"infomax"``) marks, on the CPU: ``front``, ``candidates``,
``familiarity`` and ``decide`` in that order, once each, with the lag
statistics inside ``front``; ``"kernel"`` with SSD forms its candidates
inside the distance kernel and marks ``front``, ``familiarity`` and
``decide``. The step built that way gives, bit for bit, what the same
pipeline with materialised candidates gives assembled by hand as one
familiarity function and the decision, on worlds of BASELINE config 4's
sensor and scan, in one chunk of lags and in several."""

import dataclasses

import numpy as np
import pytest
import torch

from navdv_torch import agent, baseline_config, make_landscape, make_route, train_library
from navdv_torch.agent import init_state, make_statics, make_step_batched
from navdv_torch.sensor import (
    make_pooled_panorama,
    make_render_batch,
    make_views_from_pooled,
    scan_lag_sets,
)

STAGES = ["front", "candidates", "familiarity", "decide"]
POOLED_STAGES = ["front", "familiarity", "decide"]  # kernel SSD: no candidate tensor


def _config4(metric: str = "ssd"):
    """BASELINE config 4's sensor and scan with the spectral knob cleared
    (the exact paths run without it), a short episode."""
    cfg = baseline_config(4)
    return dataclasses.replace(
        cfg, capture_spacing=1.0,
        scan=dataclasses.replace(cfg.scan, spectral_cutoff=0, metric=metric),
        agent=dataclasses.replace(cfg.agent, max_steps=4))


def _world(cfg, seed: int, batch: int = 6):
    land = make_landscape("blobs", size=(160, 160), seed=seed, n_features=60)
    route = make_route("sine", size=(160, 160), margin=40.0, length=20.0, amplitude=2.5)
    st = make_statics(land, train_library(land, route, cfg, device="cpu"), route, device="cpu")
    rng = np.random.default_rng(seed)
    xy = route[0][None] + rng.normal(0.0, 1.5, (batch, 2))
    d = route[1] - route[0]
    theta = np.arctan2(d[1], d[0]) + rng.normal(0.0, 0.15, batch)
    return st, init_state(xy, theta, device="cpu")


class _Log:
    """Stands in for ``profiling.stage`` as ``agent`` sees it: logs each
    stage's opening and closing."""

    def __init__(self):
        self.events = []

    def __call__(self, name):
        log = self.events

        class _Mark:
            def __enter__(self):
                log.append(("open", name))

            def __exit__(self, *exc):
                log.append(("close", name))

        return _Mark()

    def opened(self):
        return [n for what, n in self.events if what == "open"]


def _logged_step(monkeypatch, cfg, fam_impl):
    log = _Log()
    monkeypatch.setattr(agent, "stage", log)
    real = agent.make_lag_stats

    def lag_stats(*args, **kwargs):
        stats = real(*args, **kwargs)

        def logged(s):
            log.events.append(("run", "lag_stats"))
            return stats(s)

        return logged

    monkeypatch.setattr(agent, "make_lag_stats", lag_stats)
    return make_step_batched(cfg, fam_impl, device="cpu"), log


@pytest.mark.parametrize("fam_impl,metric", [("kernel", "ssd"), ("kernel", "ncc"),
                                             ("plain", "ssd")])
def test_a_step_opens_its_four_stages_once_each_in_order(monkeypatch, fam_impl, metric):
    cfg = _config4(metric)
    st, states = _world(cfg, seed=1)
    step, log = _logged_step(monkeypatch, cfg, fam_impl)
    step(states, st)
    stages = POOLED_STAGES if (fam_impl, metric) == ("kernel", "ssd") else STAGES
    assert log.opened() == stages
    # no stage opens inside another
    assert log.events == [(what, n) for n in stages for what in ("open", "close")]


def test_plain_ncc_computes_its_lag_statistics_inside_front(monkeypatch):
    cfg = _config4("ncc")
    st, states = _world(cfg, seed=2)
    step, log = _logged_step(monkeypatch, cfg, "plain")
    step(states, st)
    assert log.opened() == STAGES
    assert log.events[:3] == [("open", "front"), ("run", "lag_stats"), ("close", "front")]
    assert ("run", "lag_stats") not in log.events[3:]


def test_several_chunks_score_inside_familiarity(monkeypatch):
    cfg = _config4()
    monkeypatch.setattr(agent, "FAM_CHUNK_ELEMS", 25 * cfg.sensor.n_pixels)
    st, states = _world(cfg, seed=3)
    step, log = _logged_step(monkeypatch, cfg, "kernel")
    step(states, st)
    assert log.opened() == ["front", "familiarity", "decide"]


def _one_stage_step(cfg, fam_impl):
    """The candidate paths' step as one familiarity stage: render, pool,
    gather each chunk's candidates, score, concatenate, RIDF-pool, then
    ``agent._make_decide``'s decision; ``step.fam`` is that familiarity."""
    dev = "cpu"
    lags, window_idx = scan_lag_sets(cfg.scan)
    window_idx = torch.as_tensor(window_idx.astype(np.int64))
    render_b = make_render_batch(cfg.sensor, dev)
    pooled = make_pooled_panorama(cfg.sensor, dev)
    lib_min = agent._make_lib_min(cfg, fam_impl, dev)
    needs_stats = fam_impl == "plain" and cfg.scan.metric == "ncc"
    lag_stats = agent.make_lag_stats(cfg.sensor, lags, dev) if needs_stats else None
    p, n_lags = cfg.sensor.n_pixels, len(lags)
    chunk = max(1, agent.FAM_CHUNK_ELEMS // p)
    bounds = ([(0, n_lags)] if n_lags * p <= agent.FAM_CHUNK_ELEMS
              else [(i, min(i + chunk, n_lags)) for i in range(0, n_lags, chunk)])
    views = [(lo, hi, make_views_from_pooled(cfg.sensor, lags[lo:hi], dev)) for lo, hi in bounds]

    def fam_of(states, st, aux=None):
        s = pooled(render_b(st.landscape, states.xy, states.theta))
        lag_sum = lag_sq = None
        if lag_stats is not None:
            lag_sum, lag_sq = lag_stats(s.double())
        parts = [lib_min(v(s), st.lib, None if lag_sum is None else lag_sum[:, lo:hi],
                         None if lag_sq is None else lag_sq[:, lo:hi], aux)
                 for lo, hi, v in views]
        m = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
        return torch.min(m[:, window_idx], dim=2).values

    decide = agent._make_decide(cfg, dev)

    def step(states, st, aux=None):
        return decide(states, fam_of(states, st, aux), st)

    step.fam = fam_of
    return step, len(views)


def _assert_bit_equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


@pytest.mark.parametrize("fam_impl,metric,chunk_lags,seed", [
    ("kernel", "ssd", None, 11), ("kernel", "ssd", 25, 12), ("kernel", "ncc", 7, 13),
    ("plain", "ncc", None, 14), ("plain", "ncc", 25, 15), ("plain", "ssd", 25, 16),
])
def test_the_staged_step_equals_the_one_stage_step(monkeypatch, fam_impl, metric, chunk_lags,
                                                   seed):
    cfg = _config4(metric)
    if chunk_lags is not None:
        monkeypatch.setattr(agent, "FAM_CHUNK_ELEMS", chunk_lags * cfg.sensor.n_pixels)
    st, states = _world(cfg, seed)
    want_step, chunks = _one_stage_step(cfg, fam_impl)
    assert chunks == (1 if chunk_lags is None else -(-60 // chunk_lags))
    step = make_step_batched(cfg, fam_impl, device="cpu")
    _assert_bit_equal(step.fam(states, st), want_step.fam(states, st))
    got, want = states, states
    for _ in range(cfg.agent.max_steps):
        got, got_rec = step(got, st)
        want, want_rec = want_step(want, st)
        _assert_bit_equal(got, want)
        _assert_bit_equal(got_rec, want_rec)
    _assert_bit_equal(step.fam(got, st), want_step.fam(want, st))
