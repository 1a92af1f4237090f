"""The port's compiled programs (``navdv_torch/capture.py``): the captured
episode, full and early-exit, infomax training and the analysis probe,
against their eager counterparts, bit for bit.

On the CPU there is no CUDA graph: the same copy-in, call and copy-out run
around a direct call (``capture.py``'s CPU mode), so these tests hold the
bookkeeping (static buffers, the chunked early exit with its device-side
flag, fresh outputs, new statics of the same shapes, counters) at the small
sizes of ``conftest.py``'s fixtures. The ``cuda`` cases capture on the card
and skip here.
"""

import dataclasses
import datetime
import sys
from typing import NamedTuple

import numpy as np
import pytest
import torch
import torch.distributed as dist

from navdv_torch import agent, capture, ops
from navdv_torch.agent import (
    EXIT_CHUNK,
    init_state,
    lib_pmin,
    make_navigate_batch,
    make_navigate_batch_fn,
    make_statics,
)
from navdv_torch.analysis import full_circle_scan, make_familiarity_probe
from navdv_torch.config import SimConfig
from navdv_torch.convert import config_from
from navdv_torch.familiarity_infomax import dose_schedule, initial_weights, train_infomax
from navdv_torch.landscape import make_landscape
from navdv_torch.oracle import resample_route
from navdv_torch.training import train_library
from navdv_torch.trials import make_trials
from navdv_torch.utils import profiling

CPU = "cpu"
B = 12


def _cfg(small_cfg, **agent) -> SimConfig:
    cfg = config_from(small_cfg)
    return dataclasses.replace(cfg, agent=dataclasses.replace(cfg.agent, **agent))


def _world(cfg, small_world, seed=None, spread=(1.5, 0.3), trial_seed=4):
    """Statics (another landscape of the same shape for a seed) and B
    starts along the route, ``spread`` (px, rad) around its first pose."""
    land, route = small_world
    if seed is not None:
        land = make_landscape("blobs", size=land.shape, seed=seed, n_features=60)
    lib = train_library(land, route, cfg, device=CPU)
    pts, hd = resample_route(route, cfg.capture_spacing)
    rng = np.random.default_rng(trial_seed)
    states = init_state(pts[0][None] + rng.normal(0.0, spread[0], (B, 2)),
                        hd[0] + rng.normal(0.0, spread[1], B), device=CPU)
    return make_statics(land, lib, route, CPU), states


def _fields(result):
    final, rec = result
    return [*final, *rec]


def _assert_equal(got, want):
    for name, g, w in zip(type(want[0])._fields + type(want[1])._fields,
                          _fields(got), _fields(want)):
        assert torch.equal(g, w), name


def _aux(run, st):
    return None if run.prepare is None else run.prepare(st)


@pytest.mark.parametrize("fam_impl", ["kernel", "fft", "roll", "conv"])
def test_captured_episode_equals_eager(small_cfg, small_world, fam_impl):
    """``make_navigate_batch`` gives ``make_navigate_batch_fn``'s final
    states and records bit for bit, with and without a prepared aux."""
    cfg = _cfg(small_cfg)
    st, states = _world(cfg, small_world)
    eager = make_navigate_batch_fn(cfg, fam_impl, device=CPU)
    run = make_navigate_batch(cfg, fam_impl, device=CPU)
    assert run.captured is False and run.exit_chunk is None
    want = eager(states, st)
    _assert_equal(run(states, st), want)
    _assert_equal(run(states, st, _aux(run, st)), want)


@pytest.mark.parametrize("chunk", [1, 3, 7, "max_steps"])
def test_chunked_early_exit_equals_eager(small_cfg, small_world, chunk, monkeypatch):
    """The early exit in chunks (a device-side flag masks the steps after
    every agent is done) gives the eager early exit bit for bit, the zero
    tail with ``done=True`` included, and the full loop's outcome."""
    cfg = _cfg(small_cfg, max_steps=70)
    st, states = _world(cfg, small_world, spread=(0.5, 0.1), trial_seed=3)  # all reach the goal
    chunk = cfg.agent.max_steps if chunk == "max_steps" else chunk
    want = make_navigate_batch_fn(cfg, "kernel", early_exit=True, device=CPU)(states, st)
    n_exec = int((~want[1].done).sum(dim=1).max())
    assert 0 < n_exec < cfg.agent.max_steps - 7  # a tail exists, past more than one chunk
    assert n_exec % 3 and n_exec % 7  # the exit falls inside a chunk
    monkeypatch.setattr(agent, "EXIT_CHUNK", chunk)
    run = make_navigate_batch(cfg, "kernel", early_exit=True, device=CPU)
    assert run.exit_chunk == chunk
    got = run(states, st)
    _assert_equal(got, want)
    tail = got[1]
    assert bool(tail.done[:, n_exec:].all())
    assert not tail.k[:, n_exec:].any() and not tail.xy[:, n_exec:].any()
    full = make_navigate_batch(cfg, "kernel", device=CPU)(states, st)
    assert all(torch.equal(a, b) for a, b in zip(full[0], got[0]))


def test_early_exit_when_every_agent_starts_done(small_cfg, small_world):
    """Agents done before the first step: no step changes anything, as the
    eager loop breaks before its first step."""
    cfg = _cfg(small_cfg)
    st, states = _world(cfg, small_world)
    states = states._replace(done=torch.ones_like(states.done),
                             status=torch.full_like(states.status, 2))
    want = make_navigate_batch_fn(cfg, "kernel", early_exit=True, device=CPU)(states, st)
    got = make_navigate_batch(cfg, "kernel", early_exit=True, device=CPU)(states, st)
    _assert_equal(got, want)
    assert bool(got[1].done.all()) and torch.equal(got[0].xy, states.xy)


@pytest.mark.parametrize("early_exit", [False, True])
def test_new_statics_of_same_shapes_give_their_own_result(small_cfg, small_world, early_exit):
    """Two landscapes with libraries of the same shapes, through one run:
    each call gives its own eager result (the statics are copied in)."""
    cfg = _cfg(small_cfg, max_steps=40)
    eager = make_navigate_batch_fn(cfg, "fft", early_exit=early_exit, device=CPU)
    run = make_navigate_batch(cfg, "fft", early_exit=early_exit, device=CPU)
    worlds = [_world(cfg, small_world), _world(cfg, small_world, seed=9)]
    assert worlds[0][0].lib.views.shape == worlds[1][0].lib.views.shape
    wants = [eager(states, st) for st, states in worlds]
    assert not torch.equal(wants[0][1].fam, wants[1][1].fam)
    for (st, states), want in zip(worlds * 2, wants * 2):
        _assert_equal(run(states, st, _aux(run, st)), want)


def test_held_result_is_unchanged_by_the_next_call(small_cfg, small_world):
    cfg = _cfg(small_cfg, max_steps=30)
    (st_a, s_a), (st_b, s_b) = _world(cfg, small_world), _world(cfg, small_world, seed=9)
    for early_exit in (False, True):
        run = make_navigate_batch(cfg, "kernel", early_exit=early_exit, device=CPU)
        first = run(s_a, st_a)
        kept = [t.clone() for t in _fields(first)]
        run(s_b, st_b)
        assert all(torch.equal(a, b) for a, b in zip(_fields(first), kept))


def test_counters_show_n_episodes(small_cfg, small_world, monkeypatch):
    """After n calls the launch counters show n times one episode's
    launches. On the CPU no wrapper counts, so the window gather is wrapped
    to count as it does on the card."""
    import navdv_torch.sensor as sensor

    wrapper = ops.window.window_gather

    def counting(*args):
        wrapper.launches += 1
        return wrapper(*args)

    monkeypatch.setattr(sensor, "window_gather", counting)
    cfg = _cfg(small_cfg, max_steps=20)
    st, states = _world(cfg, small_world)
    run = make_navigate_batch(cfg, "kernel", device=CPU)
    ops.reset_launch_counts()
    for n in (1, 2, 3):
        run(states, st)
        assert ops.launch_counts()["window_gather"] == n * cfg.agent.max_steps
    ops.reset_launch_counts()


def test_gloo_lib_axis_runs_the_eager_episode(small_cfg, small_world):
    """A lib group on gloo (host collectives) is never captured: the run is
    the eager episode, decided from the group's backend, and every step's
    MIN counts as it runs."""
    from navdv_torch.parallel import init_distributed

    assert not dist.is_initialized()
    init_distributed(device=CPU, timeout=datetime.timedelta(seconds=60))
    try:
        group = dist.group.WORLD
        assert capture.host_collectives(group) and not capture.host_collectives(None)
        cfg = _cfg(small_cfg, max_steps=20)
        st, states = _world(cfg, small_world)
        run = make_navigate_batch(cfg, "kernel", early_exit=True, device=CPU, lib_axis=group)
        assert run.captured is False and run.exit_chunk is None
        lib_pmin.calls = 0
        got = run(states, st)
        n_exec = int((~got[1].done).sum(dim=1).max())
        assert lib_pmin.calls == n_exec
        want = make_navigate_batch_fn(cfg, "kernel", lib_axis=group, early_exit=True,
                                      device=CPU)(states, st)
        _assert_equal(got, want)
        probe = make_familiarity_probe(full_circle_scan(cfg), "kernel", lib_axis=group,
                                       device=CPU)
        assert probe.captured is False
        assert probe is probe.eager and probe.best is probe.best.eager
    finally:
        lib_pmin.calls = 0
        dist.destroy_process_group()


def test_infomax_epoch_replay_equals_eager_training(small_cfg, small_world):
    """3 whole epochs through the captured epoch plus a fractional epoch:
    the same W as the eager loop, bit for bit; the caller's w0 untouched."""
    cfg = _cfg(small_cfg)
    st, _ = _world(cfg, small_world)
    lib = st.lib
    nl, p = lib.z.shape
    spacing = 3.5 / (0.8 * p)  # AUTO dose: 3 epochs and half an epoch
    whole, frac = dose_schedule(nl, p, 0, spacing)
    assert whole == 3 and 0 < len(frac) < nl
    w0 = initial_weights(p // 2, p, 5)
    kept = w0.clone()
    got = train_infomax(lib, p // 2, 0.02, 0, 5, capture_spacing=spacing, w0=w0)
    want = train_infomax(lib, p // 2, 0.02, 0, 5, capture_spacing=spacing, w0=w0, captured=False)
    assert torch.equal(got.w, want.w) and torch.equal(got.wsum, want.wsum)
    assert torch.equal(w0, kept)
    assert not torch.equal(got.w, w0)


@pytest.mark.parametrize("fam_impl", ["kernel", "fft"])
def test_probe_equals_eager_probe(small_cfg, small_world, fam_impl):
    """``probe`` and ``probe.best`` give their eager counterparts' results,
    with aux given or (fft) prepared per call."""
    cfg = full_circle_scan(_cfg(small_cfg))
    st, states = _world(cfg, small_world)
    probe = make_familiarity_probe(cfg, fam_impl, device=CPU)
    assert probe.captured is False
    aux = None if probe.prepare is None else probe.prepare(st)
    xy, theta = states.xy.numpy(), states.theta.numpy()
    want = probe.eager(xy, theta, st, aux)
    assert torch.equal(probe(xy, theta, st, aux), want)
    assert torch.equal(probe(xy, theta, st), want)
    for g, w in zip(probe.best(xy, theta, st, aux), probe.best.eager(xy, theta, st, aux)):
        assert torch.equal(g, w)


class _Pair(NamedTuple):
    a: torch.Tensor
    b: object


def test_captured_keeps_trees_signatures_and_fresh_outputs(monkeypatch):
    """Trees of NamedTuples, lists, dicts and constants pass through; each
    signature gets its own graph (the oldest dropped past ``MAX_GRAPHS``);
    a graph refuses inputs of another signature; unhashable constants raise;
    outputs are fresh tensors."""
    calls = []

    def fn(pair, scale, extra):
        calls.append(scale)
        return {"sum": pair.a * scale + extra[0], "b": pair.b, "list": [pair.a + 1]}

    monkeypatch.setattr(capture, "MAX_GRAPHS", 2)
    cap = capture.Captured(fn, CPU, "test")
    x = torch.arange(4.0)
    out = cap(_Pair(x, None), 2.0, [torch.ones(4)])
    assert torch.equal(out["sum"], x * 2 + 1) and out["b"] is None
    assert torch.equal(out["list"][0], x + 1)
    again = cap(_Pair(x + 1, None), 2.0, [torch.ones(4)])
    assert torch.equal(out["sum"], x * 2 + 1) and torch.equal(again["sum"], x * 2 + 3)
    cap(_Pair(x, None), 3.0, [torch.ones(4)])  # another constant: another graph
    cap(_Pair(torch.arange(5.0), None), 2.0, [torch.ones(5)])  # another shape
    assert len(cap._graphs) == 2
    g = cap.graph(_Pair(x, None), 3.0, [torch.ones(4)])
    with pytest.raises(ValueError, match="signature"):
        g.load(_Pair(torch.arange(5.0), None), 3.0, [torch.ones(5)])
    with pytest.raises(TypeError, match="hashable"):
        cap(_Pair(x, np.zeros(2)), 2.0, [torch.ones(4)])


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("fam_impl,early_exit", [("kernel", False), ("fft", False),
                                                 ("kernel", True), ("conv", False)])
def test_captured_episode_on_card(dev, small_cfg, small_world, fam_impl, early_exit):
    """On the card: CUDA graphs replay the eager episode bit for bit, a
    replay counts the captured launches, the capture adds nothing."""
    cfg = _cfg(small_cfg, max_steps=70)
    st_cpu, states_cpu = _world(cfg, small_world)
    st = type(st_cpu)(*(x.to(dev) if isinstance(x, torch.Tensor) else
                        type(x)(*(y.to(dev) for y in x)) for x in st_cpu))
    states = type(states_cpu)(*(x.to(dev) for x in states_cpu))
    eager = make_navigate_batch_fn(cfg, fam_impl, early_exit=early_exit, device=dev)
    run = make_navigate_batch(cfg, fam_impl, early_exit=early_exit, device=dev)
    assert run.captured
    aux = _aux(run, st)
    ops.reset_launch_counts()
    want = eager(states, st, aux)
    torch.cuda.synchronize()
    n_eager = ops.launch_counts()
    ops.reset_launch_counts()
    got = run(states, st, aux)
    got2 = run(states, st, aux)
    torch.cuda.synchronize()
    _assert_equal(got, want)
    _assert_equal(got2, want)
    n_exec = int((~want[1].done).sum(dim=1).max())
    steps = -(-n_exec // EXIT_CHUNK) * EXIT_CHUNK if early_exit else n_exec
    for name, n in ops.launch_counts().items():
        assert n == 2 * n_eager[name] // n_exec * steps, name


@pytest.mark.cuda
def test_captured_infomax_and_probe_on_card(dev, small_cfg, small_world):
    cfg = _cfg(small_cfg)
    st_cpu, states_cpu = _world(cfg, small_world)
    lib = type(st_cpu.lib)(*(x.to(dev) for x in st_cpu.lib))
    p = lib.z.shape[1]
    got = train_infomax(lib, p // 2, 0.02, 4, 5)
    want = train_infomax(lib, p // 2, 0.02, 4, 5, captured=False)
    assert torch.equal(got.w, want.w)
    st = make_statics(st_cpu.landscape, lib, np.array([[0.0, 0.0], [1.0, 1.0]]), dev)
    probe = make_familiarity_probe(full_circle_scan(cfg), "kernel", device=dev)
    assert probe.captured
    xy, theta = states_cpu.xy.numpy(), states_cpu.theta.numpy()
    assert torch.equal(probe(xy, theta, st), probe.eager(xy, theta, st))


@pytest.mark.cuda
@pytest.mark.parametrize("config,fam_impl,batch,views", [(1, "fft", 1024, 50),
                                                         (2, "roll", 512, 500)])
def test_stage_marks_on_card(dev, monkeypatch, config, fam_impl, batch, views):
    """At a benchmark cell's shapes: a graph captured inside a recording
    gives the unmarked graph's episode bit for bit; the unmarked capture
    records no event, the marked one a pair a stage and step; the warm-up
    and the capture add nothing to the recording; the stages cover at least
    90% of the graph's device time."""
    from chip_smoke import bench_config

    cfg, land, route = bench_config(config, views)
    st = make_statics(land, train_library(land, route, cfg, device=dev), route, dev)
    states = init_state(*make_trials(route, cfg, batch, seed=0), dev)
    run = make_navigate_batch(cfg, fam_impl, device=dev)
    aux = run.prepare(st)
    events = []
    event = profiling._event
    monkeypatch.setattr(profiling, "_event", lambda: events.append(1) or event())
    want = run(states, st, aux)
    torch.cuda.synchronize()
    assert events == []
    steps = cfg.agent.max_steps
    with profiling.recording() as rec:
        got = run(states, st, aux)  # warm-up, capture, one replay
    _assert_equal(got, want)
    assert len(events) == 2 * 3 * steps
    assert {k: v[1] for k, v in rec.stages.items()} == dict.fromkeys(
        ("front", "familiarity", "decide"), steps)
    assert len(rec.graph_ms) == 1
    with profiling.recording() as rec:
        got = [run(states, st, aux) for _ in range(2)]
    for g in got:
        _assert_equal(g, want)
    assert len(events) == 2 * 3 * steps and len(rec.graph_ms) == 2
    covered = sum(ms for ms, _ in rec.stages.values()) / sum(rec.graph_ms)
    assert 0.9 <= covered <= 1.0, rec.stages


@pytest.mark.cuda
def test_kernel_path_stage_marks_on_card(dev):
    """BASELINE config 4 on ``kernel`` at the benchmark cell's shapes (1024
    agents, 50 views): each replay of the captured episode adds one pooled
    min-distance launch a step and no launch of the rows entry; the graph
    captured inside a recording gives the unmarked graph's episode bit for
    bit and marks ``front``, ``familiarity`` and ``decide`` once a step,
    which cover at least 95% of the graph's device time."""
    from chip_smoke import bench_config, exact_cfg

    cfg, land, route = bench_config(4, 50)
    cfg = exact_cfg(cfg)
    st = make_statics(land, train_library(land, route, cfg, device=dev), route, dev)
    states = init_state(*make_trials(route, cfg, 1024, seed=0), dev)
    run = make_navigate_batch(cfg, "kernel", device=dev)
    steps = cfg.agent.max_steps
    want = run(states, st)  # warm-up, capture, one replay
    torch.cuda.synchronize()
    before = ops.launch_counts()
    got = run(states, st)
    torch.cuda.synchronize()
    added = {k: v - before[k] for k, v in ops.launch_counts().items()}
    assert added["min_distance_pooled"] == steps and added["min_distance"] == 0, added
    assert added["decide"] == steps and added["lag_fam"] == 0, added
    _assert_equal(got, want)
    with profiling.recording():
        _assert_equal(run(states, st), want)  # captures the marked graph
    with profiling.recording() as rec:
        for _ in range(3):
            _assert_equal(run(states, st), want)
    assert {k: v[1] for k, v in rec.stages.items()} == dict.fromkeys(
        ("front", "familiarity", "decide"), 3 * steps)
    covered = sum(ms for ms, _ in rec.stages.values()) / sum(rec.graph_ms)
    assert 0.95 <= covered <= 1.0, rec.stages


@pytest.mark.cuda
def test_kernel_ssd_step_equals_the_gathered_candidates_step_on_card(dev):
    """BASELINE config 4 on ``kernel`` at 1024 agents: the step that forms
    its candidates inside the min-distance kernel gives, step by step over
    an episode and bit for bit, the familiarity, states and records of the
    same step scoring gathered candidates through the rows entry."""
    from chip_smoke import bench_config, exact_cfg
    from navdv_torch.ops.familiarity import make_lib_min_kernel
    from navdv_torch.sensor import (
        make_pooled_panorama,
        make_render_batch,
        make_views_from_pooled,
        scan_lag_sets,
    )

    cfg, land, route = bench_config(4, 50)
    cfg = exact_cfg(cfg)
    st = make_statics(land, train_library(land, route, cfg, device=dev), route, dev)
    states = init_state(*make_trials(route, cfg, 1024, seed=2), dev)
    lags, window_idx = scan_lag_sets(cfg.scan)
    window_idx = torch.as_tensor(window_idx.astype(np.int64), device=dev)
    render_b = make_render_batch(cfg.sensor, dev)
    pooled = make_pooled_panorama(cfg.sensor, dev)
    views = make_views_from_pooled(cfg.sensor, lags, dev)
    lib_min = make_lib_min_kernel(cfg.sensor, cfg.scan)

    def gathered_fam(s, st, aux=None):
        m = lib_min(views(pooled(render_b(st.landscape, s.xy, s.theta))), st.lib)
        return torch.min(m[:, window_idx], dim=2).values

    step = agent.make_step_batched(cfg, "kernel", device=dev)
    decide = agent._make_decide(cfg, dev)
    ops.reset_launch_counts()
    got = want = states
    for _ in range(cfg.agent.max_steps):
        assert torch.equal(step.fam(got, st), gathered_fam(got, st))
        got, got_rec = step(got, st)
        want, want_rec = decide(want, gathered_fam(want, st), st)
        _assert_equal((got, got_rec), (want, want_rec))
    counts = ops.launch_counts()
    assert counts["min_distance_pooled"] == counts["min_distance"] == 2 * cfg.agent.max_steps


@pytest.mark.cuda
def test_kernel_path_episode_builds_no_candidate_tensor(dev):
    """BASELINE config 4 on ``kernel`` at 1024 agents: capturing and
    replaying the episode allocates under 200 MB at its peak, below one
    f32[1024, 60, 1152] candidate tensor (283 MB), and gives the eager
    episode bit for bit."""
    from chip_smoke import bench_config, exact_cfg

    cfg, land, route = bench_config(4, 50)
    cfg = exact_cfg(cfg)
    st = make_statics(land, train_library(land, route, cfg, device=dev), route, dev)
    states = init_state(*make_trials(route, cfg, 1024, seed=1), dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    run = make_navigate_batch(cfg, "kernel", device=dev)
    got = run(states, st)  # warm-up, capture, one replay
    got = run(states, st)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - base
    assert peak < 200e6, peak
    _assert_equal(got, make_navigate_batch_fn(cfg, "kernel", device=dev)(states, st))


NCCL_MESHES = ((4, 1), (1, 4), (2, 2))


def child(out_dir: str, device=None) -> None:
    """One rank of the four-card job: config-4-like small episodes on every
    mesh of NCCL_MESHES, each rank's captured slice against the eager
    episode on it, the unsharded captured episode, and the MINs counted."""
    import gc
    import os

    from navdv_torch.analysis import _make_familiarity_probe
    from navdv_torch.parallel import (
        collective_counts,
        init_distributed,
        make_mesh,
        make_navigate_sharded,
        reset_collective_counts,
        shard_statics,
    )
    from navdv_torch.routes import make_route
    from test_torch_distributed import GROUP_TIMEOUT

    dev = init_distributed(device=device, timeout=GROUP_TIMEOUT)
    rank = dist.get_rank()
    cfg = SimConfig()
    cfg = dataclasses.replace(
        cfg, capture_spacing=1.5,
        sensor=dataclasses.replace(cfg.sensor, n_radial=4, n_azimuth=24, az_upsample=3,
                                   r_min=2.0, r_max=8.0),
        scan=dataclasses.replace(cfg.scan, n_headings=12, scan_step_bins=2),
        agent=dataclasses.replace(cfg.agent, step_size=1.0, goal_radius=2.0, corridor=15.0,
                                  max_steps=48))
    land = make_landscape("blobs", size=(128, 128), seed=3, n_features=60)
    route = make_route("line", size=(128, 128), margin=32.0, length=40.0)
    st, states = _world(cfg, (land, route))
    st = type(st)(*(type(x)(*(y.to(dev) for y in x)) if isinstance(x, tuple) else x.to(dev)
                    for x in st))
    states = type(states)(*(x.to(dev) for x in states))
    ref = make_navigate_batch(cfg, "kernel", device=dev)(states, st)
    out = {"backend": dist.get_backend(), "device": str(dev)}
    for nd, nl in NCCL_MESHES:
        mesh = make_mesh(nd, nl, device=dev)
        st_m = shard_statics(st, mesh, shard_lib=nl > 1)
        nav = make_navigate_sharded(cfg, mesh, "kernel", shard_lib=nl > 1)
        nav(states, st_m)  # warm-up and capture
        reset_collective_counts()
        final, rec = nav(states, st_m)
        pmin = collective_counts()["lib_pmin"]
        rows = slice(mesh.data_index * (B // nd), (mesh.data_index + 1) * (B // nd))
        eager = make_navigate_batch_fn(cfg, "kernel", lib_axis=mesh.lib_group if nl > 1 else None,
                                       device=dev)
        want = eager(type(states)(*(x[rows] for x in states)), st_m)
        out[f"{nd}x{nl}"] = {
            "captured": nav.captured, "lib_pmin": pmin,
            "eager_equal": all(torch.equal(a, b[rows]) for a, b in zip(_fields(want),
                                                                        [*final, *rec])),
            "k_equal_unsharded": bool(torch.equal(rec.k, ref[1].k)),
            "fam_max_rel": float(((rec.fam - ref[1].fam).abs()
                                  / ref[1].fam.abs().clamp_min(1e-30)).max()),
        }
        if (nd, nl) == (1, 4):  # the lib-axis probe, captured with its all_reduce
            probe = make_familiarity_probe(cfg, "kernel", lib_axis=mesh.lib_group, device=dev)
            got = probe(states.xy, states.theta, st_m)
            out["probe"] = {"captured": probe.captured,
                            "eager_equal": bool(torch.equal(got, probe.eager(states.xy,
                                                                           states.theta, st_m)))}
            # the roll step's stages with the all_reduce marked apart
            roll = make_navigate_sharded(cfg, mesh, "roll")
            aux = roll.prepare(st_m)
            want = roll(states, st_m, aux)
            with profiling.recording() as rec:
                got = roll(states, st_m, aux)
            out["marked"] = {
                "equal": all(torch.equal(a, b) for a, b in zip(_fields(got), _fields(want))),
                "stages": {k: v[1] for k, v in rec.stages.items()},
                "spans": sorted(rec.totals())}
            roll.release()
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    # the teardown hangs while a CUDA graph that holds one of the groups'
    # collectives is alive: free them first (the probe cache holds probes)
    del nav, probe
    _make_familiarity_probe.cache_clear()
    gc.collect()
    dist.barrier()
    dist.destroy_process_group()


@pytest.mark.cuda
def test_nccl_lib_meshes_are_captured_on_four_cards(tmp_path):
    """Four ranks, a card each, NCCL: every mesh's episode replays CUDA
    graphs (the lib meshes with the step's all_reduce captured), each rank's
    slice equals the eager episode on it bit for bit, the unsharded
    episode's candidates are kept, and each replay counts one MIN a step;
    the lib-axis probe is captured and equals its eager run; the roll
    episode captured inside a recording equals the unmarked one and marks
    the all_reduce as a stage of its own; every rank destroys its process
    group once the graphs are freed."""
    from test_torch_distributed import launch_ranks

    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    ranks = launch_ranks(__file__, 4, str(tmp_path))
    for r in ranks:
        assert r["backend"] == "nccl"
        for nd, nl in NCCL_MESHES:
            m = r[f"{nd}x{nl}"]
            assert m["captured"] and m["eager_equal"], (nd, nl, m)
            assert m["k_equal_unsharded"] and m["fam_max_rel"] <= 1e-6, (nd, nl, m)
            assert m["lib_pmin"] == (48 if nl > 1 else 0), (nd, nl, m)
        assert r["probe"] == {"captured": True, "eager_equal": True}
        assert r["marked"] == {"equal": True, "stages": dict.fromkeys(
            ("front", "familiarity", "lib_pmin", "decide"), 48),
            "spans": ["copy_in", "copy_out", "episode", "launch"]}


if __name__ == "__main__" and sys.argv[1] == "child":
    child(*sys.argv[2:])
