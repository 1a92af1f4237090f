"""One run of a sweep configuration on one process: passes over the grid
through ``navdv_torch.sweep.run_cell``, the measured window or the traced
slice, and the comparison of every grid point.

A sweep configuration (``"kind": "sweep"``) holds ``SweepSpec`` fields
under ``"spec"`` (read as ``SweepSpec(**...)``, with lists as tuples, the
way ``cli sweep --spec`` reads a file) and every grid point spelled out
under ``"points"``: its key, its capture spacing and view count, its
``sim`` as ``SweepSpec.cells()`` resolves it, the path ``fam_impl_arg``
resolves it to (``fam_impl``), the reference's ``familiarity`` and its
``limits``. Set-up refuses a file whose points or paths are not the
program's.

An episode of the window is one pass: ``run_cell`` once for each grid
point in ``SweepSpec.cells()`` order, with the arguments that
``sweep.run_sweep`` gives it (``n_trials`` the traffic's ``batch``, the
pass's trial seed, one ``ProgramCache`` for the pass), leaving out only
``run_sweep``'s result files, ``summary.json`` and tensorboard scalars. The
cache is a :class:`Recorder`: the programs it hands out keep references to
the inputs and the outputs of each call, and a point's second call on its
own path is its timed episode, which the check judges.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import math
import time

import numpy as np
import torch

from harness import check, drive, trace, world
from harness.cells import Cell
from navdv_torch.capture import ProgramCache, capture_counts
from reference.navref import resample_route

# the reference's name for the familiarity each path computes
FAMILIARITY = {"fft": "fft", "kernel": "exact"}
# numbers summed over the kept passes; the others are their maximum
COUNTS = ("pose_mismatch", "status_mismatch", "status_ambiguous", "poses_compared",
          "start_mismatch")


def is_sweep(cell: Cell) -> bool:
    return cell.config.get("kind") == "sweep"


@dataclasses.dataclass
class Timed:
    """A grid point's timed episode as the program ran it."""

    states0: tuple  # the AgentState it was given
    views: torch.Tensor  # its statics' library views, f32[Nl, R, W]
    final: tuple  # (xy, theta, done, status)
    rec: tuple  # (xy, theta, fam, k, dist_route, done), each [B, T, ...]
    success: float  # run_cell's success_rate


class _Recording:
    """A program handed out by a :class:`Recorder`: calls it and keeps
    (key, states0, library views, output) of each call, by reference."""

    def __init__(self, program, key, calls: list):
        self._program, self.key, self._calls = program, key, calls

    def __getattr__(self, name):  # prepare, release, captured, exit_chunk
        return getattr(self._program, name)

    def __call__(self, states0, st, aux=None):
        out = self._program(states0, st, aux)
        self._calls.append((self.key, states0, st.lib.views, out))
        return out


class Recorder(ProgramCache):
    """The pass's ``ProgramCache``, whose programs record their calls in
    ``calls``."""

    def __init__(self):
        super().__init__()
        self.calls: list = []

    def __setitem__(self, key, program) -> None:
        super().__setitem__(key, _Recording(program, key, self.calls))


def _tuples(v):
    """A JSON list as ``SweepSpec.from_json`` reads it: lists become tuples."""
    if isinstance(v, list):
        return tuple(tuple(x) if isinstance(x, list) else x for x in v)
    return v


def arc_steps(route: np.ndarray, step_size: float, budget: float) -> int:
    """The step budget ``cli sweep`` gives: ``budget`` times the route's arc
    in steps."""
    return int(np.hypot(*np.diff(route, axis=0).T).sum() / step_size * budget)


def make_trials(route: np.ndarray, spacing: float, n: int, seed: int,
                traffic: dict) -> tuple[np.ndarray, np.ndarray]:
    """The trials ``run_cell`` draws, worked out again: ``n`` starts round
    the route's first capture, from ``default_rng(seed)`` as
    ``navdv_torch.trials.make_trials(start_anywhere=False)`` draws them."""
    rng = np.random.default_rng(seed)
    pts, headings = resample_route(np.asarray(route, np.float64), spacing)
    starts = pts[np.zeros(n, dtype=int)] + rng.normal(0.0, traffic["pos_sigma"], size=(n, 2))
    thetas = headings[np.zeros(n, dtype=int)] + rng.normal(0.0, traffic["heading_sigma"],
                                                           size=n)
    return starts.astype(np.float32), thetas.astype(np.float32)


def trial_seed(seed: int, stream: int, index: int) -> int:
    """The trial seed of pass ``index`` of a stream (0 the window's and the
    traced slice's, 1 set-up's), from the run's seed."""
    return int(np.random.default_rng([int(seed), stream, index]).integers(2**62))


@dataclasses.dataclass
class Point:
    key: str
    cfg: object  # the program's SimConfig
    spacing: float
    config: dict  # the file's entry: a configuration for check.judge


def grid(config: dict, route: np.ndarray, n_trials: int):
    """(SweepSpec, points): the configuration's spec, and its points
    checked against ``SweepSpec.cells()`` and ``agent.resolve_fam_impl``;
    raises where the file is not what the program runs."""
    from navdv_torch.agent import resolve_fam_impl
    from navdv_torch.config import SimConfig
    from navdv_torch.sweep import SweepSpec

    spec = SweepSpec(**{k: _tuples(v) for k, v in config["spec"].items()}, n_trials=n_trials)
    # cli sweep's budget: the arc in steps of the default kinematics
    budget = arc_steps(route, SimConfig().agent.step_size, config["step_budget"])
    if spec.max_steps != budget:
        raise ValueError(f"max_steps {spec.max_steps} is not {config['step_budget']} x the "
                         f"route's arc in steps ({budget})")
    cells, stated = list(spec.cells()), config["points"]
    if [c[0] for c in cells] != [p["key"] for p in stated]:
        raise ValueError(f"the file's points {[p['key'] for p in stated]} are not "
                         f"SweepSpec.cells()' {[c[0] for c in cells]}")
    points = []
    for (key, cfg, params), p in zip(cells, stated):
        if p["spacing"] != params["spacing"] or drive.sim_config(p, p["spacing"]) != cfg:
            raise ValueError(f"{key}: the file's sim is not SweepSpec.cells()' {cfg}")
        path = resolve_fam_impl(cfg, config["fam_impl_arg"])
        if path != p["fam_impl"] or FAMILIARITY[path] != p["familiarity"]:
            raise ValueError(f"{key}: fam_impl={config['fam_impl_arg']!r} resolved to "
                             f"{path!r}, the file states {p['fam_impl']!r} judged as "
                             f"{p['familiarity']!r}")
        views = len(resample_route(route, p["spacing"])[0])
        if views != p["views"]:
            raise ValueError(f"{key}: {views} views along the route, not {p['views']}")
        points.append(Point(key, cfg, p["spacing"], p))
    return spec, points


@dataclasses.dataclass
class Setup:
    landscape: torch.Tensor  # the reference's copy of the world
    program_landscape: torch.Tensor
    route: np.ndarray
    spec: object  # SweepSpec
    points: list
    fam_impl_arg: str
    recall: int
    device: object


def setup(cell: Cell, seed: int, device) -> Setup:
    """The world (the landscape from the traffic's ``world_seed``, as
    ``drive.make_world`` draws it) and the grid."""
    land = world.make_landscape(cell.traffic.get("world_seed", seed), cell.config["world"],
                                device)
    route = world.make_route(cell.config["world"])
    spec, points = grid(cell.config, route, int(cell.traffic["batch"]))
    return Setup(land, land.clone(), route, spec, points, cell.config["fam_impl_arg"],
                 int(cell.config["recall_check_trials"]), device)


def run_pass(s: Setup, seed: int, spans: bool = False) -> list[Timed]:
    """One pass over the grid with trial seed ``seed``; each point in a
    harness span where ``spans``. Returns each point's timed episode."""
    from navdv_torch.sweep import run_cell

    cache = Recorder()
    out = []
    for p in s.points:
        first = len(cache.calls)
        with trace.span() if spans else contextlib.nullcontext():
            res = run_cell(s.program_landscape, s.route, p.cfg, s.spec.n_trials, seed,
                           s.fam_impl_arg, start_anywhere=s.spec.start_anywhere, mesh=None,
                           recall_check_trials=s.recall, lib_bucket=s.spec.lib_bucket,
                           nav_cache=cache, device=s.device)
        calls = cache.calls[first:]
        if len(calls) < 2 or calls[0][0] != calls[1][0]:
            raise RuntimeError(f"{p.key}: run_cell did not call one program for its warm-up "
                               "and its timed episode")
        _, states0, views, (final, rec) = calls[1]
        out.append(Timed(tuple(states0), views, tuple(final), tuple(rec),
                         float(res["success_rate"])))
    return out


class Passes:
    """The passes of a stream in turn, as ``drive.measure`` draws trials:
    ``draw() -> (pass index, its trial seed)``."""

    def __init__(self, seed: int, stream: int):
        self.seed, self.stream, self.index = seed, stream, 0

    def draw(self) -> tuple[int, int]:
        i = self.index
        self.index += 1
        return i, trial_seed(self.seed, self.stream, i)


class _Unkept:
    """``drive.measure``'s reservoir: the pass call keeps its own episodes."""

    def offer(self, make):
        pass


def _rate(timed: list[Timed]) -> float:
    """The pass's mean success rate, NaN (a failed pass) where a point's
    is not a share."""
    rates = [t.success for t in timed]
    return float(np.mean(rates)) if all(0.0 <= r <= 1.0 for r in rates) else math.nan


def traced(s: Setup, passes: Passes, n: int, reservoir: drive.Reservoir):
    """``n`` passes under the profiler, each point in the harness's span,
    after one pass under a profiler of its own that takes the profiler's
    first start; returns (the slice's trace, failed passes). The trace's
    context holds the passes and the graphs captured in them."""
    with trace.profiled():
        run_pass(s, passes.draw()[1])
    failed = 0
    before = capture_counts()["captures"]
    with trace.profiled() as prof:
        for _ in range(n):
            _, seed = passes.draw()
            timed = run_pass(s, seed, spans=True)
            failed += math.isnan(_rate(timed))
            reservoir.offer(lambda: (seed, timed))
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    context = {"passes": n, "captures": capture_counts()["captures"] - before}
    return trace.summarize(prof, n * len(s.points) * s.spec.max_steps, context), failed


def end_to_end(cell: Cell, s: Setup, times: list, wall: float, setup_s: float) -> dict:
    """Trials x the step budget x points x passes over the window's wall
    time, and set-up."""
    steps = s.spec.n_trials * s.spec.max_steps * len(s.points) * len(times)
    values = {"agent_steps_per_s": steps / wall, "setup_s": setup_s}
    out = {}
    for m in cell.end_to_end:
        if m["name"] not in values:
            raise KeyError(f"the sweep harness does not measure {m['name']!r}")
        out[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    return out


def start_mismatch(t: Timed, starts: np.ndarray, thetas: np.ndarray) -> int:
    """Trials not run as the harness drew them: every one, where the
    program ran another number of agents, else the agents whose start pose
    differs."""
    xy, theta = (x.cpu().numpy() for x in t.states0[:2])
    if xy.shape != starts.shape:
        return max(len(starts), len(xy))
    return int(((xy != starts).any(axis=1) | (theta != thetas)).sum())


def library_err_bf16(ref, config: dict, land, route, spacing: float) -> float:
    """The control's ``lib_err`` for a float32 hat: the panorama rounded to
    bfloat16, the precision below the configuration's, before it is pooled
    (navref's own control rounds to fp8 in the bf16 class only)."""
    spec = ref.spec_from_config(config)
    lib = ref.train_library(land, route, spacing, spec)
    low = ref.train_library(land, route, spacing,
                            dataclasses.replace(spec, hat_dtype="bfloat16"), torch.bfloat16)
    return float((low - lib).abs().max()) / float(lib.abs().max())


def judge_point(p: Point, land, route, kept: list, traffic: dict, seed: int,
                control: bool) -> dict:
    """A point's compared numbers over the kept passes: ``check.judge`` on
    each pass's timed episode with that episode's library, counts summed,
    the rest their maximum. A library of another shape than the
    reference's reads ``lib_err`` 1, a full-scale error."""
    ref = check.reference_of(p.config)
    spec = ref.spec_from_config(p.config)
    shape = (p.config["views"], spec.n_radial, spec.n_azimuth)
    n = int(traffic["batch"])
    readings = []
    for pass_seed, t in kept:
        starts, thetas = make_trials(route, p.spacing, n, pass_seed, traffic)
        xy, theta = (x.cpu().numpy() for x in t.states0[:2])
        same = tuple(t.views.shape) == shape
        ep = check.Episode(xy, theta, t.final, t.rec, t.success)
        numbers = check.judge(p.config, land, route, p.spacing,
                              t.views if same else torch.zeros(shape), [ep], seed,
                              int(traffic["check"]["poses"]), control)
        if not same:
            numbers["lib_err"] = 1.0
        numbers["start_mismatch"] = start_mismatch(t, starts, thetas)
        if control and spec.hat_dtype == "float32":
            numbers["lib_err_control"] = library_err_bf16(ref, p.config, land, route, p.spacing)
        readings.append(numbers)
    return {k: (sum if k in COUNTS else max)(r[k] for r in readings) for k in readings[0]}


def run(cell: Cell, seed: int, seconds: float, traced_run: bool, device, t_process: float,
        guard, control: bool = False) -> dict:
    """One run of a sweep cell; returns the result's fields as
    ``drive.run_single`` does."""
    t0 = time.time()
    s = setup(cell, seed, device)
    t1 = time.time()
    run_pass(s, trial_seed(seed, 1, 0))  # set-up's warm-up pass
    stages = {"start": t0 - t_process, "world_and_grid": t1 - t0,
              "warm_up_pass": time.time() - t1}
    reservoir = drive.Reservoir(seed, int(cell.traffic["check"]["episodes"]))
    passes = Passes(seed, 0)
    result = {}
    if traced_run:
        n = int(cell.traffic["trace_passes"])
        tr, failed = traced(s, passes, n, reservoir)
        attempted = n
        result["metrics"] = drive.per_layer(cell, tr)
        result["device"] = {"busy_s": tr.busy_s(), "window_s": tr.window_s}
        result["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
        result["window"] = dict(drive.trace_summary(tr), captures=tr.context["captures"])
    else:
        def call(_, pass_seed):
            timed = run_pass(s, pass_seed)
            reservoir.offer(lambda: (pass_seed, timed))
            return (_rate(timed),)

        t_window = time.time()  # set-up ends: the first timed pass starts
        times, wall, failed = drive.measure(call, passes, seconds, _Unkept())
        attempted = len(times)
        result["metrics"] = end_to_end(cell, s, times, wall, t_window - t_process)
        result["device"] = {}
        result["window"] = drive.window_summary(times, wall)
    result["device"]["memory_peak_bytes"] = drive.memory_peak(device)
    guard()
    kept, land, route, points = reservoir.items, s.landscape, s.route, s.points
    del s
    gc.collect()
    drive.free(device)
    numbers, checks, correct = {}, {}, True
    for i, p in enumerate(points):
        mine = [(pass_seed, timed[i]) for pass_seed, timed in kept]
        found = judge_point(p, land, route, mine, cell.traffic, seed, control)
        ok, found_checks = check.verdict(found, p.config["limits"])
        correct &= ok
        numbers.update({f"{p.key}/{k}": v for k, v in found.items()})
        checks.update({f"{p.key}/{k}": v for k, v in found_checks.items()})
    result.update(correct=correct, attempted=attempted, failed=failed, checks=checks,
                  numbers=numbers, setup_stages=stages)
    return result
