"""``navdv_torch.utils.profiling`` (counterpart of the JAX package's
``utils/profiling.py``) on small episodes on the CPU: ``trace`` writes a
Chrome trace and ``top_ops`` ranks operations by self time from the
profile; spans under a recording and under ``torch.profiler``, and nothing
when off; the step's stage marks and how a recording folds them;
``capture.capture_counts``."""

import dataclasses
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from navdv_torch import NavigationSimulator, capture, make_navigate_batch, train_library
from navdv_torch.agent import init_state, make_statics, make_step_batched
from navdv_torch.convert import config_from
from navdv_torch.utils import profiling
from navdv_torch.utils.profiling import top_ops, trace

# the spans of one NavigationSimulator.navigate call, in the order they
# open, each with its parent
NAVIGATE_SPANS = {
    "navigate": None, "init_state": "navigate", "episode": "navigate",
    "copy_in": "episode", "launch": "episode", "copy_out": "episode",
    "metrics": "navigate", "success": "metrics",
}


@pytest.fixture(scope="module")
def traced(small_cfg, small_world, tmp_path_factory):
    land, route = small_world
    cfg = config_from(small_cfg)
    st = make_statics(land, train_library(land, route, cfg, device="cpu"), route, device="cpu")
    states = init_state(np.full((4, 2), 64.0), np.zeros(4), device="cpu")
    run = make_navigate_batch(cfg, "kernel", device="cpu")
    log_dir = str(tmp_path_factory.mktemp("trace"))
    with trace(log_dir) as prof:
        run(states, st)
    return prof, log_dir, cfg.agent.max_steps


@pytest.fixture(scope="module")
def sim(small_cfg, small_world):
    land, route = small_world
    return NavigationSimulator(config_from(small_cfg), land, route, fam_impl="fft",
                               device="cpu").train()


def _navigate(sim):
    return sim.navigate(n_trials=4, seed=1)


def test_top_ops_sorted_by_self_time(traced):
    prof, _, _ = traced
    rows = top_ops(prof, n=10, device="cpu")
    assert len(rows) == 10
    times = [r["self_us"] for r in rows]
    assert times == sorted(times, reverse=True) and times[-1] >= 0.0
    assert all(set(r) == {"self_us", "op", "count"} and r["count"] >= 1 for r in rows)
    assert any(r["op"].startswith("aten::") for r in rows)


def test_divisor_and_the_full_table(traced):
    prof, _, steps = traced
    rows = top_ops(prof, n=None, device="cpu")
    per_step = top_ops(prof, n=None, divisor=steps, device="cpu")
    assert len(rows) > 10
    np.testing.assert_allclose([r["self_us"] / steps for r in rows],
                               [r["self_us"] for r in per_step])


def test_top_ops_refuses_what_the_profile_lacks(traced):
    prof, _, _ = traced
    with pytest.raises(ValueError, match="no cuda time"):
        top_ops(prof)  # a CPU run has no device time to rank
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        top_ops(prof, device="tpu")
    assert os.listdir(traced[1])[0].endswith(".json")


def test_span_tree_parents_and_self_times(monkeypatch):
    """Spans nest by the order they open; a span's self time is its
    duration less its children's, summed by name."""
    ticks = iter(range(0, 10**9, 10**6))  # each read of the clock 1 ms later
    monkeypatch.setattr(profiling, "_clock", lambda: next(ticks))
    with profiling.recording() as rec:
        with profiling.span("a"):  # 0 .. 7
            with profiling.span("b"):  # 1 .. 2
                pass
            with profiling.span("c"):  # 3 .. 6
                with profiling.span("b"):  # 4 .. 5
                    pass
        with profiling.span("a"):  # 8 .. 9
            pass
    assert [(s.name, s.parent) for s in rec.spans] == [
        ("a", -1), ("b", 0), ("c", 0), ("b", 2), ("a", -1)]
    assert [(s.start_ns // 10**6, s.end_ns // 10**6) for s in rec.spans] == [
        (0, 7), (1, 2), (3, 6), (4, 5), (8, 9)]
    assert rec.totals() == {
        "a": {"calls": 2, "ms": 8.0, "self_ms": 4.0},
        "b": {"calls": 2, "ms": 2.0, "self_ms": 2.0},
        "c": {"calls": 1, "ms": 3.0, "self_ms": 2.0},
    }


def test_navigate_spans_in_order_under_a_recording(sim):
    with profiling.recording() as rec:
        _navigate(sim)
        _navigate(sim)
    names = list(NAVIGATE_SPANS)
    assert [s.name for s in rec.spans] == names + names
    for s in rec.spans:
        parent = NAVIGATE_SPANS[s.name]
        assert (s.parent == -1) if parent is None else rec.spans[s.parent].name == parent
        assert s.end_ns >= s.start_ns
    totals = rec.totals()
    assert all(t["calls"] == 2 for t in totals.values())
    # the self times share out the root spans' time
    assert sum(t["self_ms"] for t in totals.values()) == pytest.approx(totals["navigate"]["ms"])
    assert not profiling.is_recording()


def test_navigate_spans_are_profiler_annotations(sim):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _navigate(sim)
    ours = sorted((e.time_range.start, e.name, e.is_user_annotation) for e in prof.events()
                  if e.name.startswith(profiling.PREFIX))
    assert [(n, a) for _, n, a in ours] == [(profiling.PREFIX + n, True) for n in NAVIGATE_SPANS]
    assert not profiling.is_recording()


def test_spans_off_enter_nothing_and_read_no_clock(sim, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("tracing ran while off")

    monkeypatch.setattr(profiling, "record_function", refuse)
    monkeypatch.setattr(profiling, "_clock", refuse)
    monkeypatch.setattr(profiling, "_event", refuse)
    assert profiling.span("navigate") is profiling._OFF
    assert profiling.stage("front") is profiling._OFF
    assert _navigate(sim).metrics["success"].shape == (4,)


def test_stage_marks_are_noops_on_the_cpu(sim, monkeypatch):
    """A recording on the CPU keeps the spans but no stage, and the CPU's
    graph key does not change with it: nothing is made again."""
    monkeypatch.setattr(profiling, "_event", lambda: pytest.fail("a mark on the CPU"))
    _navigate(sim)
    before = capture.capture_counts()
    with profiling.recording() as rec:
        _navigate(sim)
    assert rec.stages == {} and rec.graph_ms == [] and len(rec.spans) == len(NAVIGATE_SPANS)
    assert capture.capture_counts() == before


# the sector renderer's two front ends: fused (u = 1) and unfused
_SECTOR = {
    "fused": dict(sensor=dict(az_upsample=1, render_mode="sector"),
                  scan=dict(fused_dft_precision="default")),
    "unfused": dict(sensor=dict(render_mode="sector"), scan=dict(fused_dft_precision="off")),
}


@pytest.mark.parametrize("fam_impl,sector,stages", [
    ("fft", None, ["front", "familiarity", "decide"]),
    ("roll", None, ["front", "familiarity", "decide"]),
    ("kernel", None, ["front", "familiarity", "decide"]),
    ("plain", None, ["front", "candidates", "familiarity", "decide"]),
    ("conv", None, ["front", "familiarity", "decide"]),
    ("infomax", None, ["front", "candidates", "familiarity", "decide"]),
    ("fft", "fused", ["familiarity", "decide"]),
    ("fft", "unfused", ["familiarity", "decide"]),
])
def test_step_marks_its_stages_in_order(small_cfg, small_world, monkeypatch, fam_impl, sector,
                                        stages):
    """Inside a capture with marks on, each step marks its stages once, in
    order, and gives the result it gives outside one."""
    land, route = small_world
    cfg = config_from(small_cfg)
    if sector is not None:
        knobs = _SECTOR[sector]
        cfg = dataclasses.replace(
            cfg, sensor=dataclasses.replace(cfg.sensor, **knobs["sensor"]),
            scan=dataclasses.replace(cfg.scan, **knobs["scan"]))
    st = make_statics(land, train_library(land, route, cfg, device="cpu"), route, device="cpu")
    states = init_state(np.full((3, 2), 64.0), np.zeros(3), device="cpu")
    step = make_step_batched(cfg, fam_impl, device="cpu")
    if sector is not None:
        assert step.fam.fused is (sector == "fused")
    aux = None if step.lib_prepare is None else step.lib_prepare(st)
    monkeypatch.setattr(profiling, "_event", object)
    want = step(states, st, aux)
    with profiling.marking() as marks:
        got = step(states, st, aux)
        step(got[0], st, aux)
    assert [m[0] for m in marks] == stages + stages
    for a, b in zip([*want[0], *want[1]], [*got[0], *got[1]]):
        assert torch.equal(a, b)


def test_a_stage_inside_a_stage_is_part_of_it(monkeypatch):
    monkeypatch.setattr(profiling, "_event", object)
    with profiling.marking() as marks:
        with profiling.stage("familiarity"):
            with profiling.stage("lib_pmin"):
                pass
        with profiling.stage("decide"):
            pass
    assert [m[0] for m in marks] == ["familiarity", "decide"]
    assert profiling.stage("front") is profiling._OFF


class _Stamp:
    """A timing event at a fixed time (ms)."""

    def __init__(self, t):
        self.t = t

    def elapsed_time(self, end):
        return end.t - self.t

    def synchronize(self):
        pass


def test_recording_folds_a_replay_before_the_next_and_at_close():
    marks = [("front", _Stamp(0.0), _Stamp(1.0)), ("familiarity", _Stamp(1.0), _Stamp(4.0)),
             ("decide", _Stamp(4.25), _Stamp(4.5))]
    profiling.replaying(marks)  # no recording: nothing kept
    with profiling.recording() as rec:
        profiling.replaying(marks)
        assert rec.stages == {} and rec.graph_ms == []
        profiling.replaying(marks)  # the first replay's events are read now
        assert rec.stages == {"front": [1.0, 1], "familiarity": [3.0, 1], "decide": [0.25, 1]}
        assert rec.graph_ms == [4.5]
    assert rec.stages == {"front": [2.0, 2], "familiarity": [6.0, 2], "decide": [0.5, 2]}
    assert rec.graph_ms == [4.5, 4.5]


def test_recordings_do_not_nest_and_close_on_error():
    with pytest.raises(RuntimeError, match="already open"):
        with profiling.recording():
            with profiling.recording():
                pass
    assert not profiling.is_recording()
    with pytest.raises(KeyError):
        with profiling.recording() as rec:
            with profiling.span("a"):
                raise KeyError("x")
    assert not profiling.is_recording() and rec.spans[0].end_ns >= rec.spans[0].start_ns


def test_capture_counts_captures_and_releases(monkeypatch):
    """One capture per new signature, one release per graph evicted or
    released; a graph released twice counts once; on the CPU no capture
    takes device memory."""
    monkeypatch.setattr(capture, "MAX_GRAPHS", 2)
    cap = capture.Captured(lambda x: x * 2, "cpu", "test")
    before = capture.capture_counts()

    def delta():
        now = capture.capture_counts()
        return {k: now[k] - before[k] for k in now}

    cap(torch.ones(2))
    cap(torch.zeros(2))  # the same signature
    assert delta() == {"captures": 1, "releases": 0, "grew": 0}
    cap(torch.ones(3))
    cap(torch.ones(4))  # a third signature evicts the first
    assert delta() == {"captures": 3, "releases": 1, "grew": 0}
    graphs = list(cap._graphs.values())
    cap.release()
    graphs[0].release()
    assert delta() == {"captures": 3, "releases": 3, "grew": 0}
