"""Bounded memory for captured programs (ROADMAP C.13): the caches that keep
captured runs and probes hold the graphs of at most ``capture.MAX_PROGRAMS``
of them, release the rest, and give the same results as with nothing
evicted.

On the CPU a ``capture.Graph`` holds static buffers but no CUDA graph; the
bookkeeping is the same, so these tests count live ``Graph`` objects
(through ``gc``) at the small sizes of ``conftest.py``'s fixtures. The
``cuda`` cases read the card's allocator, where every graph is captured
into the card's one graph pool, and skip here.
"""

import dataclasses
import gc

import numpy as np
import pytest
import torch

from navdv_torch import analysis, capture, ops, sweep
from navdv_torch.analysis import familiarity_map
from navdv_torch.checkpoint import load_results
from navdv_torch.convert import config_from
from navdv_torch.training import train_library

CPU = "cpu"
TIMING_KEYS = {"wall_s", "warmup_s", "agent_steps_per_s"}  # host clock, not results


def _live_graphs(prefix: str) -> int:
    """Live, unreleased ``capture.Graph`` objects of captured functions
    whose name starts with ``prefix``."""
    gc.collect()
    return sum(1 for o in gc.get_objects()
               if type(o) is capture.Graph and o.args is not None
               and o.name.startswith(prefix))


def _grid_spec(**kw):
    """Six cells, each its own configuration (three sensors x two scans),
    each a captured early-exit run of one input signature."""
    return sweep.SweepSpec(
        sensor_px=((24, 4, 3), (16, 4, 3), (20, 3, 2)),
        scan_granularity=((12, 2), (8, 3)),
        capture_spacing=(1.5,),
        n_trials=4,
        max_steps=12,
        **kw,
    )


def _run_sweep_counting(landscape, route, spec, out_dir, monkeypatch):
    """``run_sweep`` with the live early-exit graphs and the runs' cache
    size read after each cell; returns (results, counts, cache sizes)."""
    live, sizes = [], []
    run_cell = sweep.run_cell

    def counted(*args, **kw):
        out = run_cell(*args, **kw)
        live.append(_live_graphs("early-exit chunk"))
        sizes.append(len(kw["nav_cache"]))
        return out

    monkeypatch.setattr(sweep, "run_cell", counted)
    res = sweep.run_sweep(landscape, route, spec, str(out_dir), verbose=False,
                          tensorboard=False, device=CPU)
    monkeypatch.setattr(sweep, "run_cell", run_cell)
    return res, live, sizes


def _same_results(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for key in a:
        assert a[key].keys() == b[key].keys(), key
        for name in a[key].keys() - TIMING_KEYS:
            np.testing.assert_array_equal(a[key][name], b[key][name], err_msg=f"{key} {name}")


def test_sweep_keeps_the_graphs_of_at_most_max_programs_configs(small_world, tmp_path,
                                                                monkeypatch):
    """Over six distinct configurations the sweep holds at most
    MAX_PROGRAMS captured runs, each of one graph here."""
    landscape, route = small_world
    base = _live_graphs("early-exit chunk")
    res, live, sizes = _run_sweep_counting(landscape, route, _grid_spec(), tmp_path, monkeypatch)
    assert len(res) == 6 > capture.MAX_PROGRAMS
    assert max(sizes) == capture.MAX_PROGRAMS
    assert max(live) - base == capture.MAX_PROGRAMS
    assert _live_graphs("early-exit chunk") == base  # the cache dies with the sweep


def test_sweep_results_equal_those_with_nothing_evicted(small_world, tmp_path, monkeypatch):
    """The bounded sweep's result files equal those of the same sweep with
    the bound lifted (nothing evicted), as do the kernels' launch counts."""
    landscape, route = small_world
    ops.reset_launch_counts()
    bounded, _, _ = _run_sweep_counting(landscape, route, _grid_spec(), tmp_path / "bounded",
                                        monkeypatch)
    launches = ops.launch_counts()
    monkeypatch.setattr(capture, "MAX_PROGRAMS", None)
    ops.reset_launch_counts()
    unbounded, live, sizes = _run_sweep_counting(landscape, route, _grid_spec(),
                                                 tmp_path / "unbounded", monkeypatch)
    assert sizes[-1] == 6 and max(live) >= 6  # nothing evicted
    assert ops.launch_counts() == launches
    _same_results(bounded, unbounded)
    for key in bounded:
        _same_results({key: load_results(str(tmp_path / "bounded" / f"cell_{key}.npz"))},
                      {key: load_results(str(tmp_path / "unbounded" / f"cell_{key}.npz"))})


def test_a_configuration_revisited_after_eviction_captures_again(small_cfg, small_world):
    """Configurations A, B, C, A through one ProgramCache: A's run is evicted
    (its graphs released) and built again, with the same result."""
    landscape, route = small_world
    cfgs = [config_from(dataclasses.replace(
        small_cfg, scan=dataclasses.replace(small_cfg.scan, n_headings=nh, scan_step_bins=sb)))
        for nh, sb in ((12, 2), (8, 3), (6, 4))]
    cache = capture.ProgramCache()
    results = [sweep.run_cell(landscape, route, cfg, 4, 0, nav_cache=cache, device=CPU)
               for cfg in (*cfgs, cfgs[0])]
    assert len(cache) == capture.MAX_PROGRAMS
    _same_results({"a": results[0]}, {"a": results[3]})


def _map_cfgs(small_cfg):
    """Five distinct probe configurations (metric x step x scan knobs)."""
    out = []
    for metric, step in (("ssd", 1.0), ("ncc", 1.0), ("ssd", 1.5), ("ncc", 1.5), ("ssd", 2.0)):
        out.append(config_from(dataclasses.replace(
            small_cfg, scan=dataclasses.replace(small_cfg.scan, metric=metric),
            agent=dataclasses.replace(small_cfg.agent, step_size=step))))
    return out


def test_probe_cache_keeps_the_graphs_of_at_most_max_programs(small_cfg, small_world,
                                                              monkeypatch):
    """Maps over five distinct configurations keep the graphs of at most
    MAX_PROGRAMS probe functions, while the probes themselves stay cached;
    every map equals the one made with the bound lifted, and a map revisited
    after its probe's graphs were released equals its first."""
    landscape, route = small_world
    analysis._make_familiarity_probe.cache_clear()
    base = _live_graphs("familiarity probe")
    cfgs = _map_cfgs(small_cfg)
    lib = train_library(landscape, route, cfgs[0], device=CPU)

    def maps():
        out, live = [], []
        for cfg in (*cfgs, cfgs[0]):
            out.append(familiarity_map(landscape, lib, cfg, stride=16.0, batch=32,
                                       fam_impl="kernel", device=CPU))
            live.append(_live_graphs("familiarity probe") - base)
        return out, live

    bounded, live = maps()
    assert max(live) == capture.MAX_PROGRAMS
    assert analysis._make_familiarity_probe.cache_info().currsize == len(cfgs)
    monkeypatch.setattr(capture, "MAX_PROGRAMS", None)
    analysis._make_familiarity_probe.cache_clear()
    unbounded, live_unbounded = maps()
    assert max(live_unbounded) == len(cfgs)
    for a, b in zip(bounded, unbounded):
        for name in ("fam", "best_heading"):
            np.testing.assert_array_equal(a[name], b[name])
    for name in ("fam", "best_heading"):
        np.testing.assert_array_equal(bounded[-1][name], bounded[0][name])
    analysis._make_familiarity_probe.cache_clear()


def test_released_captured_captures_again():
    """``Captured.release`` drops every graph; the next call captures again
    with the same result, and a released Graph refuses to replay."""
    cap = capture.Captured(lambda x: x * 2.0 + 1.0, CPU, "released test")
    x = torch.arange(6.0)
    want = cap(x)
    g = cap.graph(x)
    cap.release()
    assert not cap._graphs and _live_graphs("released test") == 0
    with pytest.raises(RuntimeError, match="released"):
        g.replay()
    assert torch.equal(cap(x), want) and len(cap._graphs) == 1


def test_capture_counts_grew_is_unchanged_by_a_cpu_run():
    """``capture_counts()`` carries ``"grew"``, the captures that took new
    device memory: a CPU run makes its graphs (``"captures"`` rises) and
    takes none."""
    before = capture.capture_counts()
    assert set(before) == {"captures", "releases", "grew"}
    cap = capture.Captured(lambda x: x * 2.0 + 1.0, CPU, "grew test")
    cap(torch.arange(6.0))
    cap(torch.arange(7.0))
    now = capture.capture_counts()
    assert now["captures"] == before["captures"] + 2
    assert now["grew"] == before["grew"]


def test_release_pool_is_a_no_op_on_the_cpu():
    """``release_pool`` on the CPU holds no pool to give up: a CPU run goes
    on as before, counting its graphs."""
    cap = capture.Captured(lambda x: x * 2.0 + 1.0, CPU, "release pool test")
    x = torch.arange(5.0)
    before = capture.capture_counts()
    capture.release_pool(CPU)
    assert torch.equal(cap(x), x * 2.0 + 1.0)
    capture.release_pool(CPU)
    assert torch.equal(cap(x), x * 2.0 + 1.0)
    assert capture.capture_counts()["captures"] == before["captures"] + 1


class _Program:
    def __init__(self):
        self.released = 0

    def release(self):
        self.released += 1


def test_program_cache_evicts_least_recently_used(monkeypatch):
    """Using a program refreshes it; past the bound the least recently
    used is evicted and released; ``None`` lifts the bound."""
    monkeypatch.setattr(capture, "MAX_PROGRAMS", 2)
    cache = capture.ProgramCache()
    a, b, c = _Program(), _Program(), _Program()
    cache["a"], cache["b"] = a, b
    assert cache["a"] is a  # a is now the most recent
    cache["c"] = c
    assert "b" not in cache and b.released == 1 and not a.released
    assert list(cache) == ["a", "c"] and len(cache) == 2
    with pytest.raises(KeyError):
        cache["b"]
    monkeypatch.setattr(capture, "MAX_PROGRAMS", None)
    for i in range(5):
        cache[i] = _Program()
    assert len(cache) == 7 and not a.released


def test_weak_program_cache_does_not_keep_programs_alive(monkeypatch):
    """A weak cache bounds the programs another owner holds: a program that
    dies leaves it, a live one evicted is released but stays usable."""
    monkeypatch.setattr(capture, "MAX_PROGRAMS", 1)
    cache = capture.ProgramCache(weak=True)
    a = _Program()
    cache["a"] = a
    cache["b"] = _Program()  # dies at once
    assert a.released == 1 and "b" not in cache
    cache["a"] = a
    assert cache["a"] is a and a.released == 1


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _graph_pool_bytes(dev) -> int:
    """Bytes of the card's CUDA-graph pools (segments outside the default
    pool) once the freed blocks are returned."""
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg["segment_pool_id"]) != (0, 0))


def _pool_segments(dev) -> set:
    """(address, bytes) of each segment of the card's one graph pool, once
    the freed blocks are returned."""
    pool = tuple(capture.graph_pool(torch.device("cuda", torch.cuda.current_device())))
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    return {(seg["address"], seg["total_size"]) for seg in torch.cuda.memory_snapshot()
            if tuple(seg["segment_pool_id"]) == pool}


@pytest.mark.cuda
def test_sweep_memory_stops_growing_on_card(dev, small_world):
    """On the card: six distinct configurations, then the first
    MAX_PROGRAMS again, through one ProgramCache: the graph pools after the
    revisit are what they were after the first ones (within 5%). Releasing
    every cached run gives its blocks back to the card's graph pool, which
    keeps its segments, and the six configurations run again in them: they
    add no segment."""
    landscape, route = small_world
    spec = _grid_spec()
    cells = [cfg for _, cfg, _ in spec.cells()]
    cache = capture.ProgramCache()
    land = torch.as_tensor(landscape, device=dev)
    pools = []
    for cfg in cells + cells[:capture.MAX_PROGRAMS]:
        sweep.run_cell(land, route, cfg, spec.n_trials, spec.seed, nav_cache=cache, device=dev)
        pools.append(_graph_pool_bytes(dev))
    assert pools[-1] <= 1.05 * pools[capture.MAX_PROGRAMS - 1], pools
    assert _live_graphs("early-exit chunk") <= capture.MAX_PROGRAMS
    held = _pool_segments(dev)
    for key in list(cache):
        cache[key].release()
    assert _pool_segments(dev) == held
    for cfg in cells:
        sweep.run_cell(land, route, cfg, spec.n_trials, spec.seed, nav_cache=cache, device=dev)
    assert _pool_segments(dev) <= held


@pytest.mark.cuda
def test_probe_graphs_are_bounded_on_card(dev, small_cfg, small_world):
    """On the card: maps over five distinct configurations leave the graphs
    of at most MAX_PROGRAMS probe functions alive."""
    landscape, route = small_world
    analysis._make_familiarity_probe.cache_clear()
    base = _live_graphs("familiarity probe")
    cfgs = _map_cfgs(small_cfg)
    land = torch.as_tensor(landscape, device=dev)
    lib = train_library(land, route, cfgs[0], device=dev)
    for cfg in cfgs:
        familiarity_map(land, lib, cfg, stride=16.0, batch=32, fam_impl="kernel", device=dev)
        assert _live_graphs("familiarity probe") - base <= capture.MAX_PROGRAMS
    analysis._make_familiarity_probe.cache_clear()
