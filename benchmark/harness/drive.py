"""One run of a cell on one process: set-up, the measured window or the
traced slice, and the comparison.

Single-card cells drive ``navdv_torch.simulator.NavigationSimulator
.navigate(starts=..., headings=...)``, trained once in set-up with the
configuration's ``fam_impl_arg`` ("auto" where it states none). Each
episode is one call: one batch of fresh trials, from the call until its
success rate is on the host. The loop is closed: each batch waits for the
last, as a researcher's sweep of trials does. Where the traffic states
``"early_exit": true``, the facade's episode is the program's early-exit
run, ``agent.make_navigate_batch(..., early_exit=True)``, the one every
sweep cell runs: it stops at the chunk in which every agent is done.
"""

from __future__ import annotations

import dataclasses
import gc
import time

import numpy as np
import torch

from harness import check, trace, world
from harness.cells import Cell, load_reader

WARMUP_EPISODES = 3  # the first captures the episode's CUDA graph


def sim_config(config: dict, spacing: float):
    """The program's SimConfig for a configuration file."""
    from navdv_torch.config import AgentConfig, ScanConfig, SensorConfig, SimConfig

    sim = config["sim"]
    return SimConfig(sensor=SensorConfig(**sim["sensor"]), scan=ScanConfig(**sim["scan"]),
                     agent=AgentConfig(**sim["agent"]), capture_spacing=spacing)


@dataclasses.dataclass
class Setup:
    """What set-up made: the world, the program's episode call and the
    library it trained."""

    landscape: torch.Tensor
    route: np.ndarray
    spacing: float
    pts: np.ndarray
    headings: np.ndarray
    call: object  # (starts, thetas) -> (success rate, final, record, steps taken [B])
    library: torch.Tensor  # the program's library views, f32[Nl, R, W]
    release: object


def make_world(cell: Cell, seed: int, device):
    """The run's landscape, route and route geometry: the landscape from
    ``seed``, or from the traffic's ``world_seed`` where it states one, so
    that every run of the cell navigates one world and ``seed`` draws only
    the trials."""
    land = world.make_landscape(cell.traffic.get("world_seed", seed), cell.config["world"],
                                device)
    route = world.make_route(cell.config["world"])
    spacing, pts, headings = world.route_geometry(cell.config, route)
    return land, route, spacing, pts, headings


def fam_impl_arg(config: dict, cfg) -> str:
    """The ``fam_impl`` the program is given: the configuration's
    ``fam_impl_arg``, "auto" where it states none. Raises unless the
    program resolves it to the path the configuration states
    (``fam_impl``)."""
    from navdv_torch.agent import resolve_fam_impl

    arg = config.get("fam_impl_arg", "auto")
    resolved = resolve_fam_impl(cfg, arg)
    if resolved != config["fam_impl"]:
        raise RuntimeError(f"fam_impl={arg!r} resolved to {resolved!r}, the configuration "
                           f"states {config['fam_impl']!r}")
    return arg


def early_exit(cell: Cell) -> bool:
    """Whether the cell's traffic runs the program's early-exit loop."""
    return bool(cell.traffic.get("early_exit", False))


def setup_single(cell: Cell, seed: int, device) -> Setup:
    from navdv_torch.agent import EXIT_CHUNK, make_navigate_batch
    from navdv_torch.simulator import NavigationSimulator

    land, route, spacing, pts, headings = make_world(cell, seed, device)
    cfg = sim_config(cell.config, spacing)
    sim = NavigationSimulator(cfg, land.clone(), route, fam_impl=fam_impl_arg(cell.config, cfg),
                              device=device)
    if early_exit(cell):
        # the facade has no early-exit option: give it the program's
        # early-exit run in place of the whole-episode one, before
        # train() prepares the library's constants for it
        if not hasattr(sim, "_navigate"):
            raise RuntimeError("the facade keeps no _navigate: its early-exit run cannot "
                               "be put in place")
        run = make_navigate_batch(cfg, fam_impl=sim.fam_impl, early_exit=True, device=sim.device)
        sim._navigate = run
    sim.train()
    if early_exit(cell) and (sim._navigate is not run or run.exit_chunk != EXIT_CHUNK):
        raise RuntimeError("the facade does not run the early-exit loop of "
                           f"{EXIT_CHUNK}-step chunks")

    def call(starts, thetas):
        r = sim.navigate(starts=starts, headings=thetas)
        return r.success_rate, tuple(r.final_state), tuple(r.record), r.metrics["n_steps"]

    return Setup(land, route, spacing, pts, headings, call, sim.library.views,
                 lambda: sim._navigate.release())


class Reservoir:
    """``keep`` episodes drawn uniformly from all that the window completes,
    by a generator seeded from the run's seed."""

    def __init__(self, seed: int, keep: int):
        self._rng = np.random.default_rng([int(seed), 2])
        self.keep, self.seen, self.items = keep, 0, []

    def offer(self, make):
        if len(self.items) < self.keep:
            self.items.append(make())
        else:
            j = int(self._rng.integers(0, self.seen + 1))
            if j < self.keep:
                self.items[j] = make()
        self.seen += 1


def _episode(starts, thetas, out) -> check.Episode:
    success, final, rec = out[:3]
    return check.Episode(starts, thetas, final, rec, success)


def measure(call, trials: world.Trials, seconds: float, reservoir: Reservoir,
            more=None, columns: list | None = None) -> tuple[list, float, int]:
    """The measured window: episodes until ``seconds`` have passed; returns
    (each episode's seconds, the window's wall seconds, failed episodes).
    ``more(t_now) -> bool``, where given, decides whether another episode
    follows (a mesh's ranks agree on it), outside the episodes' times.
    ``columns``, where given, gets each episode's exit column: how far its
    loop had to run, one past the last step any agent took (the most of
    the steps the program counted, ``out[3]``)."""
    times, failed = [], 0
    gc.collect()
    gc.freeze()  # set-up's objects stay out of the collections the window may run
    t_start = time.perf_counter()
    deadline = t_start + seconds
    while True:
        starts, thetas = trials.draw()
        t0 = time.perf_counter()
        out = call(starts, thetas)
        t1 = time.perf_counter()
        times.append(t1 - t0)
        if not 0.0 <= out[0] <= 1.0:
            failed += 1
        reservoir.offer(lambda: _episode(starts, thetas, out))
        if columns is not None:
            columns.append(int(out[3].max()))
        go = t1 < deadline if more is None else more(t1 < deadline)
        if not go:
            return times, time.perf_counter() - t_start, failed


def traced(call, trials: world.Trials, episodes: int, reservoir: Reservoir, steps: int,
           context: dict, columns: list | None = None) -> tuple[trace.Trace, int]:
    """The traced slice: ``episodes`` calls under the profiler, each in the
    harness's span, after one call under a profiler of its own that takes
    the profiler's first start; returns (the slice's trace, failed
    episodes). It calls the program ``episodes + 1`` times. ``columns`` as
    in :func:`measure`."""
    failed = 0
    with trace.profiled():
        call(*trials.draw())
    with trace.profiled() as prof:
        for _ in range(episodes):
            starts, thetas = trials.draw()
            with trace.span():
                out = call(starts, thetas)
            if not 0.0 <= out[0] <= 1.0:
                failed += 1
            reservoir.offer(lambda: _episode(starts, thetas, out))
            if columns is not None:
                columns.append(int(out[3].max()))
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    return trace.summarize(prof, episodes * steps, context), failed


def trace_context(cell: Cell, views_per_rank: int) -> dict:
    sim = cell.config["sim"]
    return {"batch": int(cell.traffic["batch"]), "sensor": sim["sensor"], "scan": sim["scan"],
            "views_per_rank": views_per_rank}


def per_layer(cell: Cell, tr: trace.Trace) -> dict:
    """The cell's per-layer metrics from the trace; a reader that finds
    nothing to read leaves its metric out."""
    out = {}
    for m in cell.per_layer:
        value = load_reader(cell.root, m["name"])(tr)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def end_to_end(cell: Cell, times: list, wall: float, setup_s: float) -> dict:
    """The cell's end-to-end metrics from the window's episode times."""
    b, steps = int(cell.traffic["batch"]), int(cell.config["sim"]["agent"]["max_steps"])
    p95 = float(np.percentile(np.asarray(times) * 1e3, 95))
    values = {
        "agent_steps_per_s": b * steps * len(times) / wall,
        "batch_ms_p95": p95,
        "trial_ms_p95": p95,
        "setup_s": setup_s,
    }
    out = {}
    for m in cell.end_to_end:
        if m["name"] not in values:
            raise KeyError(f"the harness does not measure {m['name']!r}")
        out[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    return out


def window_summary(times: list, wall: float) -> dict:
    """The window's episode times at a glance, for the error stream."""
    t = np.asarray(times) * 1e3
    return {"episodes": len(t), "wall_s": wall, "in_calls_s": float(t.sum()) * 1e-3,
            "median_ms": float(np.median(t)), "p95_ms": float(np.percentile(t, 95)),
            "max_ms": float(t.max()), "over_2x_median": int((t > 2 * np.median(t)).sum())}


def trace_summary(tr: trace.Trace) -> dict:
    """The traced slice at a glance, for the error stream."""
    return {"traced_window_s": tr.window_s, "busy_s": tr.busy_s(),
            "launch_stall_s": tr.launch_stall_s(), "device_ops": len(tr.device)}


def memory_peak(device) -> int:
    dev = torch.device(device)
    return int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0


def episodes_for_trace(cell: Cell) -> int:
    return int(cell.traffic["trace_episodes"])


def steps_of(cell: Cell) -> int:
    return int(cell.config["sim"]["agent"]["max_steps"])


def free(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def run_single(cell: Cell, seed: int, seconds: float, traced_run: bool, device,
               t_process: float, guard, control: bool = False) -> dict:
    """One run of a one-card cell; returns the result's fields (without
    ``device.platform``, ``kind`` and ``count``, which the caller adds).
    ``control`` adds the control's readings at the same poses."""
    t0 = time.time()
    s = setup_single(cell, seed, device)
    t1 = time.time()
    trials = world.Trials(seed, 0, s.pts, s.headings, cell.traffic)
    warm = world.Trials(seed, 1, s.pts, s.headings, cell.traffic)
    for _ in range(WARMUP_EPISODES):
        s.call(*warm.draw())
    stages = {"start": t0 - t_process, "world_and_program": t1 - t0,
              "warm_up": time.time() - t1}
    reservoir = Reservoir(seed, int(cell.traffic["check"]["episodes"]))
    columns = [] if early_exit(cell) else None
    result = {} if columns is None else {"exit_columns": columns}
    if traced_run:
        tr, failed = traced(s.call, trials, episodes_for_trace(cell), reservoir,
                            steps_of(cell), trace_context(cell, cell.config["views"]), columns)
        attempted = episodes_for_trace(cell)
        launches = sum(map(len, tr.span_launches())) / len(tr.spans)
        if columns is not None and torch.device(device).type == "cuda" and launches < 2:
            raise RuntimeError(f"early exit stated, but {launches:g} graph launches an "
                               "episode: the whole-episode graph ran")
        result["metrics"] = per_layer(cell, tr)
        result["device"] = {"busy_s": tr.busy_s(), "window_s": tr.window_s}
        result["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
        result["window"] = trace_summary(tr)
    else:
        t_window = time.time()  # set-up ends: the first timed episode starts
        times, wall, failed = measure(s.call, trials, seconds, reservoir, columns=columns)
        attempted = len(times)
        result["metrics"] = end_to_end(cell, times, wall, t_window - t_process)
        result["device"] = {}
        result["window"] = window_summary(times, wall)
    result["device"]["memory_peak_bytes"] = memory_peak(device)
    guard()
    library = s.library.detach().clone()
    land, route, spacing = s.landscape, s.route, s.spacing
    s.release()
    del s
    free(device)
    numbers = check.judge(cell.config, land, route, spacing, library, reservoir.items, seed,
                          int(cell.traffic["check"]["poses"]), control)
    ok, checks = check.verdict(numbers, cell.config["limits"])
    result.update(correct=ok, attempted=attempted, failed=failed, checks=checks,
                  numbers=numbers, setup_stages=stages)
    return result
