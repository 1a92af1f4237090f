"""Parameter sweeps (BASELINE config 5): a grid over sensor resolution x scan
granularity x library density, many trials per cell (counterpart of the JAX
package's ``sweep.py``).

- ``fam_impl="auto"`` resolves per cell (cells differ in exactly what the
  rule reads); results record the port's name for the path.
- ``SweepSpec.lib_bucket`` pads libraries to bucketed shapes, and
  ``run_sweep`` keeps one navigate function per traced configuration, as the
  JAX package keeps one compilation; the captured runs of at most
  ``capture.MAX_PROGRAMS`` configurations keep their graphs
  (:class:`navdv_torch.capture.ProgramCache`).
- Trials within a cell run as one batch; the episode stops once every trial
  is done (``early_exit``).
- Per-cell results land on disk atomically, so a sweep resumes at cell
  granularity; ``summary.json`` is the union of the cells on disk, so
  sharded processes against one directory complete it together.
- Over several ranks (:mod:`navdv_torch.parallel`), ``mesh`` spreads one
  cell's trials and library over the ranks and ``cells_mesh`` spreads the
  cells themselves. Every rank runs the same sweep and returns the same
  results; every rank looks for a cell's file at the same point, only rank
  0 writes cell files and ``summary.json``, and a barrier follows each
  write, so resume cannot diverge between ranks.

Result keys keep the JAX package's names (``success_rate_jnp`` included),
so result files and ``summary.json`` read the same in both packages
(ROADMAP C.9). Cells on ``fam_impl="infomax"`` resolve the learned
memory's AUTO training dose per cell (``resolve_infomax_epochs``).
"""

from __future__ import annotations

import dataclasses
import functools
import glob
import itertools
import json
import logging
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from navdv_torch.agent import AgentState, init_state, make_navigate_batch, make_statics, resolve_fam_impl
from navdv_torch.capture import ProgramCache
from navdv_torch.checkpoint import load_results, save_results
from navdv_torch.config import AgentConfig, ScanConfig, SensorConfig, SimConfig
from navdv_torch.device import as_tensor, resolve_device
from navdv_torch.familiarity import LibraryPack, pad_library
from navdv_torch.familiarity_infomax import auto_epochs
from navdv_torch.metrics import episode_metrics
from navdv_torch.oracle import resample_route
from navdv_torch.parallel.mesh import (
    DATA_AXIS,
    LIB_AXIS,
    Mesh,
    make_navigate_cells,
    make_navigate_sharded,
    shard_statics,
)
from navdv_torch.training import train_library
from navdv_torch.trials import make_trials

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """The BASELINE config-5 grid. Each axis is a tuple of values; the sweep
    is their cartesian product."""

    # sensor resolution axis: (n_azimuth, n_radial, az_upsample)
    sensor_px: tuple = ((72, 16, 5), (36, 8, 10))
    # scan granularity axis: (n_headings, scan_step_bins)
    scan_granularity: tuple = ((60, 2), (120, 1))
    # library density axis: capture spacing in world units (smaller = denser)
    capture_spacing: tuple = (1.0, 2.0)
    metric: str = "ssd"
    tol_bins: int = 0
    n_trials: int = 256
    max_steps: int = 256
    seed: int = 0
    # start trials uniformly along the route instead of at its start
    start_anywhere: bool = False
    # pad every cell's library up to a multiple of this many views (0 = off);
    # cells that differ only in capture_spacing then share one navigate fn.
    # Padded views carry +PAD_PENALTY distance: results are unchanged.
    lib_bucket: int = 0

    @classmethod
    def from_json(cls, path: str) -> "SweepSpec":
        """Load a spec from a JSON file; lists become the grid tuples. An
        unknown key raises (a typo'd ``n_trails`` must not run the grid with
        the default budget)."""
        with open(path) as f:
            raw = json.load(f)

        def tup(x):
            return tuple(tuple(v) if isinstance(v, list) else v for v in x)

        names = {field.name for field in dataclasses.fields(cls)}
        unknown = set(raw) - names
        if unknown:
            raise ValueError(
                f"unknown SweepSpec keys in {path}: {sorted(unknown)} "
                f"(valid: {sorted(names)})"
            )
        return cls(**{name: tup(v) if isinstance(v, list) else v for name, v in raw.items()})

    def cells(self):
        """Yields ``(key, cfg, params)`` per grid cell; ``params`` carries the
        structured axis values (persisted into each cell's results as
        ``ax_*`` entries)."""
        for (px, gran, spacing) in itertools.product(
            self.sensor_px, self.scan_granularity, self.capture_spacing
        ):
            w, r, u = px
            nh, step_bins = gran
            cfg = SimConfig(
                sensor=SensorConfig(n_azimuth=w, n_radial=r, az_upsample=u),
                scan=ScanConfig(
                    n_headings=nh,
                    scan_step_bins=step_bins,
                    metric=self.metric,
                    tol_bins=self.tol_bins,
                ),
                agent=AgentConfig(max_steps=self.max_steps),
                capture_spacing=spacing,
            )
            params = {
                "px": f"{w}x{r}u{u}",
                "scan": f"{nh}x{step_bins}",
                "spacing": spacing,
            }
            key = f"px{params['px']}_scan{params['scan']}_sp{spacing}"
            yield key, cfg, params


def resolve_infomax_epochs(cfg: SimConfig, n_views_true: int) -> SimConfig:
    """An infomax AUTO training dose (``infomax_epochs=0``) as an explicit
    epoch count when, and only when, the integer is a faithful dose (within
    5% of ``0.8 * P * spacing``), so the navigate-fn cache can leave the
    spacing out of its key. Otherwise (extreme density, where rounding would
    move the dose by up to ~2x into the overtraining collapse) ``cfg`` keeps
    ``epochs=0``, trained exactly by the fractional final epoch, and the
    cell keys its function on the spacing too."""
    if cfg.scan.infomax_epochs != 0:
        return cfg
    ideal = 0.8 * cfg.sensor.n_pixels * cfg.capture_spacing
    resolved = auto_epochs(n_views_true, cfg.sensor.n_pixels, cfg.capture_spacing)
    if abs(resolved - ideal) > 0.05 * ideal:
        return cfg
    return dataclasses.replace(cfg, scan=dataclasses.replace(cfg.scan, infomax_epochs=resolved))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _mesh_device(mesh, device) -> torch.device:
    """The device a sweep runs on: the mesh's, which ``device`` (if given)
    must name; without a mesh, ``device``."""
    if mesh is None:
        return resolve_device(device)
    if not isinstance(mesh, Mesh):
        raise TypeError(f"a mesh comes from navdv_torch.parallel.make_mesh, not {type(mesh).__name__}")
    if device is not None:
        dev = resolve_device(device)
        if dev.type != mesh.device.type or dev.index not in (None, mesh.device.index):
            raise ValueError(f"device {dev} is not the mesh's {mesh.device}")
    return mesh.device


def _rank0_writes(mesh, write) -> None:
    """Rank 0 runs ``write()``; with a mesh every rank then waits at a
    barrier, so no rank looks for a file before it exists."""
    if mesh is None or dist.get_rank() == 0:
        write()
    if mesh is not None:
        dist.barrier()


def run_cell(
    landscape,
    route: np.ndarray,
    cfg: SimConfig,
    n_trials: int,
    seed: int,
    fam_impl: str = "auto",
    mesh=None,
    start_anywhere: bool = False,
    recall_check_trials: int = 0,
    lib_bucket: int = 0,
    nav_cache: ProgramCache | None = None,
    device=None,
) -> dict:
    """Train on the route, run ``n_trials`` randomized recall episodes,
    aggregate.

    ``fam_impl="auto"`` resolves per cell (``agent.resolve_fam_impl``). With
    ``recall_check_trials > 0`` on a path other than ``"kernel"`` (the exact
    path, the JAX package's ``"jnp"``), the first that-many trials run again
    on ``"kernel"`` and the cell records ``success_rate_jnp`` /
    ``success_rate_subset``.

    Timing: one warm-up episode, then one timed episode, the host clock
    around work that ends in a synchronize; ``agent_steps_per_s`` counts the
    agent-steps that actually ran (the episode stops once every trial is
    done), not ``n_trials * max_steps``.

    ``lib_bucket > 1`` pads the library up to that multiple; ``nav_cache``
    (a :class:`~navdv_torch.capture.ProgramCache` the caller keeps across
    cells) reuses one navigate fn for every cell whose configuration
    differs only in ``capture_spacing``, and frees the graphs of the runs
    it evicts. On ``"infomax"`` the training dose comes from the true view
    count (``resolve_infomax_epochs``); a dose left at AUTO keeps the
    spacing in the cache key, since the training length derives from it.

    With ``mesh`` (:func:`navdv_torch.parallel.make_mesh`) the trials are
    split over its data axis (``n_trials`` a multiple of its size) and the
    library over its lib axis, one cell spanning every rank, which all
    return the same results; infomax replicates its library instead
    (its network trains on every view). ``n_library_padded`` records the
    library the run used, padded to a multiple of the lib axis; the
    ``"kernel"`` recall check runs on the unsharded statics.
    """
    dev = _mesh_device(mesh, device)
    fam_impl = resolve_fam_impl(cfg, fam_impl)
    land = as_tensor(landscape, torch.float32, dev)
    lib = train_library(land, route, cfg, pad_views_to=lib_bucket, device=dev)
    n_views_true = int(lib.views.shape[0])
    if lib_bucket > 1:
        lib = pad_library(lib, lib_bucket)
    if fam_impl == "infomax":
        cfg = resolve_infomax_epochs(cfg, n_views_true)
    st = make_statics(land, lib, route, dev)
    starts, thetas = make_trials(route, cfg, n_trials, seed=seed, start_anywhere=start_anywhere)
    if nav_cache is None:
        nav_cache = ProgramCache()
    # capture_spacing only sets the library's shape, which lib_bucket
    # normalizes: every other field makes the function (save an infomax
    # dose left at AUTO, whose training length derives from the spacing)
    if fam_impl == "infomax" and cfg.scan.infomax_epochs == 0:
        cfg_key = cfg
    else:
        cfg_key = dataclasses.replace(cfg, capture_spacing=0.0)

    def navigate_fn(impl: str):
        key = ("batch", cfg_key, impl)
        if key not in nav_cache:
            nav_cache[key] = make_navigate_batch(cfg, fam_impl=impl, early_exit=True, device=dev)
        return nav_cache[key]

    st_full = st
    n_padded = int(st.lib.views.shape[0])
    if mesh is None:
        nav = navigate_fn(fam_impl)
    else:
        shard_lib = mesh.shape[LIB_AXIS] > 1 and fam_impl != "infomax"
        st = shard_statics(st, mesh, shard_lib=shard_lib)
        if shard_lib:
            n_padded = int(st.lib.views.shape[0]) * mesh.shape[LIB_AXIS]
        key = ("mesh", cfg_key, fam_impl, mesh, shard_lib)
        if key not in nav_cache:
            nav_cache[key] = make_navigate_sharded(cfg, mesh, fam_impl, shard_lib=shard_lib)
        nav = nav_cache[key]
    states0 = init_state(starts, thetas, dev)
    aux = None if nav.prepare is None else nav.prepare(st)  # once per cell, both runs
    _sync(dev)
    t_w = time.perf_counter()
    nav(states0, st, aux)
    _sync(dev)
    warmup_s = time.perf_counter() - t_w
    t0 = time.perf_counter()
    final, rec = nav(states0, st, aux)
    _sync(dev)
    wall = time.perf_counter() - t0
    m = {k: v.cpu() for k, v in episode_metrics(final, rec).items()}
    executed_steps = float(m["n_steps"].sum())
    out = {
        "success_rate": np.asarray(float(m["success"].float().mean())),
        "mean_steps": np.asarray(float(m["n_steps"].float().mean())),
        "mean_path_error": np.asarray(float(m["mean_path_error"].mean())),
        "max_path_error": np.asarray(float(m["max_path_error"].max())),
        "status_counts": np.bincount(final.status.cpu().numpy(), minlength=4),
        "n_library_views": np.asarray(n_views_true),
        "n_library_padded": np.asarray(n_padded),
        "n_trials": np.asarray(n_trials),
        "wall_s": np.asarray(wall),
        "warmup_s": np.asarray(warmup_s),
        "executed_steps": np.asarray(executed_steps),
        "agent_steps_per_s": np.asarray(executed_steps / wall),
        "fam_impl": np.asarray(fam_impl),
    }
    if recall_check_trials > 0 and fam_impl != "kernel":
        nsub = min(recall_check_trials, n_trials)
        sub = AgentState(*(x[:nsub] for x in states0))
        final_k, rec_k = navigate_fn("kernel")(sub, st_full)
        m_k = episode_metrics(final_k, rec_k)
        out["success_rate_jnp"] = np.asarray(float(m_k["success"].float().mean()))
        out["success_rate_subset"] = np.asarray(float(m["success"][:nsub].float().mean()))
        out["recall_check_trials"] = np.asarray(nsub)
    return out


def _log_tensorboard(out_dir: str, key: str, res: dict) -> None:
    """Tensorboard scalars per cell; without the writer's package this logs
    a warning and skips them."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError as e:
        logger.warning("tensorboard writer unavailable (%s); skipping scalars", e)
        return
    w = SummaryWriter(log_dir=os.path.join(out_dir, "tb", key))
    try:
        for name in ("success_rate", "mean_path_error", "agent_steps_per_s"):
            w.add_scalar(name, float(res[name]), 0)
    finally:
        w.close()


def run_sweep(
    landscape,
    route: np.ndarray,
    spec: SweepSpec,
    out_dir: str,
    fam_impl: str = "auto",
    verbose: bool = True,
    shard: tuple[int, int] | None = None,
    mesh=None,
    tensorboard: bool = True,
    recall_check_trials: int = 0,
    cells_mesh=None,
    device=None,
) -> dict:
    """Run every cell, resuming from ``out_dir`` (cells with a result file are
    skipped). Returns {cell_key: results} and writes summary.json.

    ``shard=(i, n)`` runs only every n-th cell starting at i: n processes
    against one ``out_dir`` complete the grid together.

    ``mesh`` spreads each cell's trials (and library) over the ranks
    (:func:`run_cell`). ``cells_mesh`` instead spreads the cells over its
    data axis: cells that share a navigate function and a library shape run
    as one group, each rank its share of the group's cells
    (:func:`navdv_torch.parallel.make_navigate_cells`). The right mode when
    the grid has many more cells than ranks; it excludes ``mesh`` and
    ``recall_check_trials``. Per-cell resume is the same in every mode.
    """
    if cells_mesh is not None:
        if mesh is not None:
            raise ValueError("pass mesh OR cells_mesh, not both")
        if recall_check_trials:
            raise ValueError(
                "recall_check_trials is not supported with cells_mesh; run "
                "a per-cell pass (cells_mesh=None) for the kernel cross-check")
        return _run_sweep_cells_mesh(landscape, route, spec, out_dir, fam_impl, verbose, shard,
                                     tensorboard, cells_mesh, device)
    dev = _mesh_device(mesh, device)
    rank0 = mesh is None or dist.get_rank() == 0
    land = as_tensor(landscape, torch.float32, dev)
    os.makedirs(out_dir, exist_ok=True)
    all_results = {}
    nav_cache = ProgramCache()
    for idx, (key, cfg, params) in enumerate(spec.cells()):
        if shard is not None and idx % shard[1] != shard[0]:
            continue
        path = os.path.join(out_dir, f"cell_{key}.npz")
        if os.path.exists(path):
            all_results[key] = load_results(path)
            if rank0 and verbose:
                print(f"[sweep] {key}: resumed from disk")
            continue
        res = run_cell(
            land,
            route,
            cfg,
            spec.n_trials,
            spec.seed,
            fam_impl,
            start_anywhere=spec.start_anywhere,
            mesh=mesh,
            recall_check_trials=recall_check_trials,
            lib_bucket=spec.lib_bucket,
            nav_cache=nav_cache,
            device=dev,
        )
        for name, value in params.items():
            res[f"ax_{name}"] = np.asarray(value)
        _rank0_writes(mesh, functools.partial(save_results, path, res))
        all_results[key] = res
        if rank0 and tensorboard:
            _log_tensorboard(out_dir, key, res)
        if rank0 and verbose:
            print(
                f"[sweep] {key}: success={float(res['success_rate']):.3f} "
                f"steps/s={float(res['agent_steps_per_s']):,.0f}"
            )
    _rank0_writes(mesh, functools.partial(_write_summary, out_dir, all_results))
    return all_results


def _write_summary(out_dir: str, all_results: dict) -> None:
    """summary.json over every cell file on disk, written atomically: a
    sharded process holds only its own cells, so the union with the cells on
    disk keeps the summary complete whichever process writes last, and the
    pid-unique temporary file plus ``os.replace`` keeps readers from seeing
    a truncated file."""
    merged = dict(all_results)
    for path in sorted(glob.glob(os.path.join(out_dir, "cell_*.npz"))):
        key = os.path.basename(path)[len("cell_") : -len(".npz")]
        # a sibling shard's temporary file (save_results writes
        # cell_<key>.npz.tmp.npz, then renames it): that shard's own
        # _write_summary includes the cell
        if key not in merged and not key.endswith(".npz.tmp"):
            merged[key] = load_results(path)
    summary = {
        k: {kk: np.asarray(vv).tolist() for kk, vv in v.items()}
        for k, v in merged.items()
    }
    tmp = os.path.join(out_dir, f"summary.json.tmp.{os.getpid()}")
    with open(tmp, "w") as f:
        json.dump(summary, f, indent=2)
    os.replace(tmp, os.path.join(out_dir, "summary.json"))


def _run_sweep_cells_mesh(
    landscape,
    route: np.ndarray,
    spec: SweepSpec,
    out_dir: str,
    fam_impl: str,
    verbose: bool,
    shard: tuple[int, int] | None,
    tensorboard: bool,
    cells_mesh,
    device,
) -> dict:
    """Cells over the data axis of ``cells_mesh``.

    Pending cells are grouped by navigate function (configuration with the
    spacing stripped, resolved path, bucketed library shape); each group
    stacks its cells' libraries and trial batches along a leading cell axis
    and runs them over the ranks (:func:`make_navigate_cells`). A group whose
    cell count is not a multiple of the data-axis size is padded by
    repeating its last cell, whose copies' results are dropped. Every rank
    trains every cell's library, as the JAX package's one controller does.
    """
    dev = _mesh_device(cells_mesh, device)
    rank0 = dist.get_rank() == 0
    os.makedirs(out_dir, exist_ok=True)
    land = as_tensor(landscape, torch.float32, dev)
    n_data = cells_mesh.shape[DATA_AXIS]
    all_results = {}

    # pass 1: resume hits and grouping; grouping needs only the view count
    # (host-side), so libraries are trained one group at a time in pass 2
    groups: dict = {}
    for idx, (key, cfg, params) in enumerate(spec.cells()):
        if shard is not None and idx % shard[1] != shard[0]:
            continue
        path = os.path.join(out_dir, f"cell_{key}.npz")
        if os.path.exists(path):
            all_results[key] = load_results(path)
            if rank0 and verbose:
                print(f"[sweep] {key}: resumed from disk")
            continue
        impl = resolve_fam_impl(cfg, fam_impl)
        pts, _ = resample_route(np.asarray(route, np.float64), cfg.capture_spacing)
        n_views_true = len(pts)  # train_library's count
        nl_padded = n_views_true
        if spec.lib_bucket > 1:
            nl_padded += (-n_views_true) % spec.lib_bucket
        if impl == "infomax":
            cfg = resolve_infomax_epochs(cfg, n_views_true)
        strip = not (impl == "infomax" and cfg.scan.infomax_epochs == 0)
        cfg_key = dataclasses.replace(cfg, capture_spacing=0.0) if strip else cfg
        groups.setdefault((cfg_key, impl, nl_padded), []).append((key, cfg, params, n_views_true))

    if groups and max(len(c) for c in groups.values()) == 1 and n_data > 1:
        logger.warning(
            "cells_mesh: every cell is alone in its navigate-function group, so "
            "each group pads to %d replicated copies — (N-1)/N of the compute "
            "is wasted. Set SweepSpec.lib_bucket so spacing-only cells share "
            "a library shape (CLI: --lib-bucket).", n_data)

    # pass 2: one run over the ranks per group
    for (_, impl, _), cells in groups.items():
        c_true = len(cells)
        pad_n = (-c_true) % n_data
        libs, states = [], []
        for _, cfg, _, _ in cells:
            lib = train_library(land, route, cfg, pad_views_to=spec.lib_bucket, device=dev)
            if spec.lib_bucket > 1:
                lib = pad_library(lib, spec.lib_bucket)
            libs.append(lib)
            starts, thetas = make_trials(route, cfg, spec.n_trials, seed=spec.seed,
                                         start_anywhere=spec.start_anywhere)
            states.append(init_state(starts, thetas, dev))
        libs += [libs[-1]] * pad_n
        states += [states[-1]] * pad_n
        lib_stack = LibraryPack(*(torch.stack(xs) for xs in zip(*libs)))
        states0 = AgentState(*(torch.stack(xs) for xs in zip(*states)))
        shared = make_statics(land, libs[0], route, dev)._replace(lib=None)
        nav_cells = make_navigate_cells(cells[0][1], cells_mesh, impl)
        # the cells' library constants once per group, outside the timing
        aux = None if nav_cells.prepare is None else nav_cells.prepare(lib_stack, shared)
        _sync(dev)
        t0 = time.perf_counter()
        nav_cells(states0, lib_stack, shared, aux)
        _sync(dev)
        warmup_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = nav_cells(states0, lib_stack, shared, aux)
        _sync(dev)
        wall = time.perf_counter() - t0
        out = {k: v.cpu().numpy() for k, v in out.items()}
        group_steps = float(np.sum(out["executed_steps"][:c_true]))
        for i, (key, cfg, params, n_views_true) in enumerate(cells):
            res = {k: np.asarray(v[i]) for k, v in out.items()}
            res.update(
                n_library_views=np.asarray(n_views_true),
                n_library_padded=np.asarray(int(libs[i].views.shape[0])),
                n_trials=np.asarray(spec.n_trials),
                wall_s=np.asarray(wall),
                warmup_s=np.asarray(warmup_s),
                fam_impl=np.asarray(impl),
                # a group quantity in this mode: its cells ran concurrently
                # over the ranks
                agent_steps_per_s=np.asarray(group_steps / wall),
                group_size=np.asarray(c_true),
                group_pad=np.asarray(pad_n),
            )
            for name, value in params.items():
                res[f"ax_{name}"] = np.asarray(value)
            path = os.path.join(out_dir, f"cell_{key}.npz")
            _rank0_writes(cells_mesh, functools.partial(save_results, path, res))
            all_results[key] = res
            if rank0 and tensorboard:
                _log_tensorboard(out_dir, key, res)
            if rank0 and verbose:
                print(f"[sweep] {key}: success={float(res['success_rate']):.3f} "
                      f"group of {c_true} over {n_data} ranks")
    _rank0_writes(cells_mesh, functools.partial(_write_summary, out_dir, all_results))
    return all_results
