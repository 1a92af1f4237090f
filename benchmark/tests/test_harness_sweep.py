"""The cell ``sweep_default``: passes over a sweep's grid through
``navdv_torch.sweep.run_cell``, the window and its rate, set-up's check of
the configuration against ``SweepSpec.cells()``, the check of each point's
timed episode, and the two readers; on a two-point grid at the fixtures'
size (:data:`SWEEP_TINY`: a 4x24 sensor at az_upsample 3 on ``"kernel"``
and an 8x64 one at az_upsample 2 on ``"fft"``, 12 headings, 15 steps, 4
trials a point)."""

from __future__ import annotations

import copy
import dataclasses
import json

import numpy as np
import pytest
import torch

import navdv_torch.agent as agent
import navdv_torch.sweep as program_sweep
from fixture import FEW, ROOT, TINY, make_checkout
from harness import drive, sweep, world
from harness.cells import find_cell, load_reader
from harness.trace import Trace
from reference.navref import resample_route

SPEC_TINY = {"sensor_px": [[24, 4, 3], [64, 8, 2]], "scan_granularity": [[12, 2]],
             "capture_spacing": [2.0], "metric": "ssd", "tol_bins": 0, "max_steps": 15,
             "start_anywhere": False, "lib_bucket": 0}
LIMITS = {"lib_err": 1e-5, "pose_mismatch": 0, "status_mismatch": 0, "fam_err": 1e-7,
          "decision_gap": 3e-8, "start_mismatch": 0}


def _points(spec: dict, world_: dict) -> list:
    """Each grid point spelled out as the program resolves it."""
    route = world.make_route(world_)
    s = program_sweep.SweepSpec(**{k: sweep._tuples(v) for k, v in spec.items()})
    out = []
    for key, cfg, params in s.cells():
        d = dataclasses.asdict(cfg)
        path = agent.resolve_fam_impl(cfg, "auto")
        out.append({"key": key, "spacing": params["spacing"],
                    "views": len(resample_route(route, params["spacing"])[0]),
                    "fam_impl": path, "familiarity": sweep.FAMILIARITY[path],
                    "sim": {k: d[k] for k in ("sensor", "scan", "agent")}, "limits": LIMITS})
    return out


SWEEP_TINY = {"name": "fixture_tiny", "kind": "sweep", "what": "a CPU-sized sweep",
              "fam_impl_arg": "auto", "recall_check_trials": 2, "step_budget": 0.3,
              "world": TINY["world"], "spec": SPEC_TINY,
              "points": _points(SPEC_TINY, TINY["world"])}
TRIALS = dict(FEW, why="4 trials a point", world_seed=0, trace_passes=2,
              check={"episodes": 1, "poses": 48})
READERS = ("graph_captures_per_pass.sweep", "pre_graph_ms_per_pass.sweep")


def _checkout(tmp_path):
    """A checkout whose fixture cell is :data:`SWEEP_TINY`, reporting what
    the sweep cell reports."""
    root = make_checkout(tmp_path, config=SWEEP_TINY, traffic=TRIALS)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"]:
        if m["name"] == "batch_ms_p95":
            m["workloads"].remove("fixture_cell")
    for m in bench["per_layer"]:
        if m["name"] in READERS:
            m["workloads"].append("fixture_cell")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return find_cell("fixture_cell", root)


def _run(cell, seed=11, seconds=0.2, traced=False, control=False):
    return sweep.run(cell, seed, seconds, traced, "cpu", 0.0, lambda: None, control)


@pytest.fixture
def run_cell_calls(monkeypatch):
    """Every call into ``navdv_torch.sweep.run_cell``: (args, kwargs)."""
    calls = []
    real = program_sweep.run_cell

    def run_cell(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    monkeypatch.setattr(program_sweep, "run_cell", run_cell)
    return calls


def test_a_pass_calls_run_cell_as_run_sweep_does(tmp_path, run_cell_calls):
    cell = _checkout(tmp_path)
    result = _run(cell)
    assert result["correct"], result["checks"]
    keys = [p["key"] for p in SWEEP_TINY["points"]]
    passes = [run_cell_calls[i:i + len(keys)] for i in range(0, len(run_cell_calls), len(keys))]
    assert len(run_cell_calls) == len(keys) * (1 + result["attempted"])  # set-up's pass too
    for calls in passes:
        cfgs = [args[2] for args, _ in calls]
        assert [c.sensor.n_azimuth for c in cfgs] == [24, 64]
        caches = {id(kw["nav_cache"]) for _, kw in calls}
        assert len(caches) == 1 and isinstance(calls[0][1]["nav_cache"], sweep.Recorder)
        assert len({args[4] for args, _ in calls}) == 1  # one trial seed a pass
    assert len({id(p[0][1]["nav_cache"]) for p in passes}) == len(passes)
    # run_sweep's own calls on the same spec and the pass's trial seed: the
    # same arguments but the cache
    spec = dataclasses.replace(sweep.grid(cell.config, world.make_route(cell.config["world"]),
                                          4)[0], seed=run_cell_calls[-1][0][4])
    mine = run_cell_calls[-len(keys):]
    del run_cell_calls[:]
    land = world.make_landscape(0, cell.config["world"], "cpu")
    program_sweep.run_sweep(land, world.make_route(cell.config["world"]), spec,
                            str(tmp_path / "out"), verbose=False, tensorboard=False,
                            recall_check_trials=2, device="cpu")
    for (a1, k1), (a2, k2) in zip(mine, run_cell_calls, strict=True):
        assert torch.equal(a1[0], a2[0]) and np.array_equal(a1[1], a2[1]) and a1[2:] == a2[2:]
        assert torch.device(k1.pop("device")) == torch.device(k2.pop("device"))
        assert ({k: v for k, v in k1.items() if k != "nav_cache"}
                == {k: v for k, v in k2.items() if k != "nav_cache"})


def test_the_window_ends_on_a_pass_and_counts_trials_by_the_budget(tmp_path, run_cell_calls):
    cell = _checkout(tmp_path)
    result = _run(cell, seed=2**31 + 3, seconds=0.5)
    assert result["correct"], result["checks"]
    n = result["attempted"]
    window = result["window"]
    assert window["episodes"] == n >= 1
    # set-up's warm-up pass, the window's passes, whole: every point each time
    assert len(run_cell_calls) == 2 * (1 + n)
    assert set(result["metrics"]) == {"agent_steps_per_s", "setup_s"}
    rate = result["metrics"]["agent_steps_per_s"]["value"]
    assert rate == pytest.approx(4 * 15 * 2 * n / window["wall_s"], rel=1e-12)


@pytest.mark.parametrize("edit", ["order", "scan", "path", "views", "budget", "familiarity"])
def test_set_up_refuses_a_file_that_is_not_the_programs_grid(edit):
    config = copy.deepcopy(find_cell("sweep_default").config)
    route = world.make_route(config["world"])
    sweep.grid(config, route, 256)  # the file as committed passes
    points = config["points"]
    if edit == "order":
        points[0], points[1] = points[1], points[0]
    elif edit == "scan":
        points[3]["sim"]["scan"]["n_headings"] = 60
    elif edit == "path":
        points[4]["fam_impl"] = "fft"
    elif edit == "views":
        points[1]["views"] += 1
    elif edit == "budget":
        config["spec"]["max_steps"] = 80
    else:
        points[0]["familiarity"] = "exact"
    with pytest.raises(ValueError):
        sweep.grid(config, route, 256)


def _one_point_decides_wrong(monkeypatch):
    """The 8x64 point's decision heads agent 0 for its least familiar view."""
    real = agent._make_decide

    def make(cfg, device):
        decide = real(cfg, device)
        if cfg.sensor.n_azimuth != 64:
            return decide

        def broken(state, fam, st):
            fam = fam.clone()
            fam[0] = -fam[0]
            return decide(state, fam, st)

        return broken

    monkeypatch.setattr(agent, "_make_decide", make)


def _library_a_view_short(monkeypatch):
    """Every point's library loses its last view."""
    real = program_sweep.train_library

    def train(*a, **kw):
        lib = real(*a, **kw)
        return type(lib)(*(x[:-1] for x in lib))

    monkeypatch.setattr(program_sweep, "train_library", train)


def _state_unchanged(monkeypatch):
    real = agent._make_decide

    def make(cfg, device):
        decide = real(cfg, device)

        def broken(state, fam, st):
            _, rec = decide(state, fam, st)
            return state, rec._replace(xy=state.xy, theta=state.theta)

        return broken

    monkeypatch.setattr(agent, "_make_decide", make)


def _half_batch(monkeypatch):
    """The program runs the first half of the trials, its rate their mean."""
    real = program_sweep.init_state

    def init(xy, theta, device=None):
        half = len(xy) // 2
        return real(xy[:half], theta[:half], device)

    monkeypatch.setattr(program_sweep, "init_state", init)


def _timed_episode_altered(monkeypatch):
    """The warm-up episode is sound; every second call of a program (each
    point's timed episode) moves agent 0's first pose by a unit."""
    real = program_sweep.make_navigate_batch

    def make(*a, **kw):
        run, calls = real(*a, **kw), []

        def wrapped(states0, st, aux=None):
            final, rec = run(states0, st, aux)
            calls.append(1)
            if len(calls) % 2 == 0:
                rec.xy[0, 0] += 1.0
            return final, rec

        wrapped.prepare, wrapped.release = run.prepare, run.release
        return wrapped

    monkeypatch.setattr(program_sweep, "make_navigate_batch", make)


@pytest.mark.parametrize("fault, failing", [
    (None, ()), (_one_point_decides_wrong, ("fam_err", "decision_gap", "pose_mismatch")),
    (_library_a_view_short, ("lib_err",)), (_state_unchanged, ("pose_mismatch",)),
    (_half_batch, ("start_mismatch",)), (_timed_episode_altered, ("pose_mismatch",))])
def test_the_check_judges_each_points_timed_episode(fault, failing, tmp_path, monkeypatch):
    cell = _checkout(tmp_path)
    if fault is not None:
        fault(monkeypatch)
    result = _run(cell, seed=23)
    assert result["correct"] is (fault is None), result["checks"]
    keys = [p["key"] for p in SWEEP_TINY["points"]]
    bad = {name for name, c in result["checks"].items() if c["value"] > c["limit"]}
    if fault is _one_point_decides_wrong:  # only the 8x64 point
        assert bad and all(name.startswith(keys[1] + "/") for name in bad)
    for name in failing[:1]:
        assert any(b.endswith("/" + name) for b in bad), bad
    for key in keys:
        assert result["checks"][f"{key}/pose_mismatch"]["limit"] == 0


def test_the_traced_slice_reads_the_captures(tmp_path):
    cell = _checkout(tmp_path)
    result = _run(cell, seed=5, traced=True)
    assert result["correct"], result["checks"]
    assert result["attempted"] == 2
    # on the CPU a graph is a direct call, counted as captured; no launch,
    # so the pre-graph reader has nothing to read and is left out
    assert set(result["metrics"]) == {"graph_captures_per_pass.sweep", "fixture_steps"}
    assert result["metrics"]["fixture_steps"]["value"] == 2 * 2 * 15  # passes x points x T
    # the kernel point's early-exit run, the fft point's and its recall run
    assert result["metrics"]["graph_captures_per_pass.sweep"]["value"] == 3
    assert result["window"]["captures"] == 6


def test_the_control_reads_above_the_limits(tmp_path):
    cell = _checkout(tmp_path)
    result = _run(cell, seed=2**31 + 99, control=True)
    assert result["correct"], result["checks"]
    for p in SWEEP_TINY["points"]:
        n = {k.split("/")[1]: v for k, v in result["numbers"].items()
             if k.startswith(p["key"] + "/")}
        assert n["lib_err_control"] > LIMITS["lib_err"]


def _trace(launch_at: list, context: dict) -> Trace:
    """Two passes of two points, spans of 100 us from 0; a launch 10 us
    long at each of ``launch_at`` (us)."""
    spans = [(100.0 * i, 100.0 * i + 90.0) for i in range(4)]
    host = [("cudaGraphLaunch", x, x + 10.0) for x in launch_at] + [("aten::copy_", 1.0, 2.0)]
    return Trace(device=[("k", "kernel", 50.0, 60.0)], spans=spans, host_ops=host, steps=4,
                 context=context)


def test_the_readers_read_the_counters_and_spans():
    captures = load_reader(ROOT, READERS[0])
    pre = load_reader(ROOT, READERS[1])
    ctx = {"passes": 2, "captures": 24}
    assert captures(_trace([], ctx)) == 12
    assert captures(_trace([], {"passes": 0, "captures": 0})) is None
    # spans start at 0, 100, 200, 300; first launches at 30, 140 (and 150),
    # none in the third, 320: (30 + 40 + 20) us over 2 passes
    t = _trace([30.0, 140.0, 150.0, 320.0], ctx)
    assert pre(t) == pytest.approx(1e-3 * 90.0 / 2)
    assert pre(_trace([], ctx)) is None
