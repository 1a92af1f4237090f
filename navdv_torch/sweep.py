"""Parameter sweeps (BASELINE config 5): a grid over sensor resolution x scan
granularity x library density, many trials per cell (counterpart of the JAX
package's ``sweep.py``).

- ``fam_impl="auto"`` resolves per cell (cells differ in exactly what the
  rule reads); results record the port's name for the path.
- ``SweepSpec.lib_bucket`` pads libraries to bucketed shapes, and
  ``run_sweep`` keeps one navigate function per traced configuration, as the
  JAX package keeps one compilation.
- Trials within a cell run as one batch; the episode stops once every trial
  is done (``early_exit``).
- Per-cell results land on disk atomically, so a sweep resumes at cell
  granularity; ``summary.json`` is the union of the cells on disk, so
  sharded processes against one directory complete it together.

Result keys keep the JAX package's names (``success_rate_jnp`` included),
so result files and ``summary.json`` read the same in both packages
(ROADMAP C.9). Meshes wait for ROADMAP A.17, the learned memory for A.13.
"""

from __future__ import annotations

import dataclasses
import glob
import itertools
import json
import logging
import os
import time

import numpy as np
import torch

from navdv_torch.agent import AgentState, init_state, make_navigate_batch, make_statics, resolve_fam_impl
from navdv_torch.checkpoint import load_results, save_results
from navdv_torch.config import AgentConfig, ScanConfig, SensorConfig, SimConfig
from navdv_torch.device import as_tensor, resolve_device
from navdv_torch.familiarity import pad_library
from navdv_torch.metrics import episode_metrics
from navdv_torch.training import train_library
from navdv_torch.trials import make_trials

logger = logging.getLogger(__name__)

_MESH = "ROADMAP A.17 (parallelism)"
_INFOMAX = "ROADMAP A.13 (infomax learned memory)"


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


def resolve_infomax_epochs(cfg, n_views_true: int):
    """The JAX package resolves the learned memory's training dose here; the
    port has no learned memory yet."""
    raise NotImplementedError(f"the infomax memory is not ported yet: {_INFOMAX}")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


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
    nav_cache: dict | None = None,
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
    (a dict the caller keeps across cells) reuses one navigate fn for every
    cell whose configuration differs only in ``capture_spacing``.
    """
    if mesh is not None:
        raise NotImplementedError(f"sweep cells over a mesh are not ported yet: {_MESH}")
    dev = resolve_device(device)
    fam_impl = resolve_fam_impl(cfg, fam_impl)
    land = as_tensor(landscape, torch.float32, dev)
    lib = train_library(land, route, cfg, pad_views_to=lib_bucket, device=dev)
    n_views_true = int(lib.views.shape[0])
    if lib_bucket > 1:
        lib = pad_library(lib, lib_bucket)
    st = make_statics(land, lib, route, dev)
    starts, thetas = make_trials(route, cfg, n_trials, seed=seed, start_anywhere=start_anywhere)
    if nav_cache is None:
        nav_cache = {}
    # capture_spacing only sets the library's shape, which lib_bucket
    # normalizes: every other field makes the function
    cfg_key = dataclasses.replace(cfg, capture_spacing=0.0)

    def navigate_fn(impl: str):
        key = ("batch", cfg_key, impl)
        if key not in nav_cache:
            nav_cache[key] = make_navigate_batch(cfg, fam_impl=impl, early_exit=True, device=dev)
        return nav_cache[key]

    nav = navigate_fn(fam_impl)
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
        "n_library_padded": np.asarray(int(st.lib.views.shape[0])),
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
        final_k, rec_k = navigate_fn("kernel")(sub, st)
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
    """
    if mesh is not None or cells_mesh is not None:
        raise NotImplementedError(f"sweeps over a mesh are not ported yet: {_MESH}")
    dev = resolve_device(device)
    land = as_tensor(landscape, torch.float32, dev)
    os.makedirs(out_dir, exist_ok=True)
    all_results = {}
    nav_cache: dict = {}
    for idx, (key, cfg, params) in enumerate(spec.cells()):
        if shard is not None and idx % shard[1] != shard[0]:
            continue
        path = os.path.join(out_dir, f"cell_{key}.npz")
        if os.path.exists(path):
            all_results[key] = load_results(path)
            if verbose:
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
            recall_check_trials=recall_check_trials,
            lib_bucket=spec.lib_bucket,
            nav_cache=nav_cache,
            device=dev,
        )
        for name, value in params.items():
            res[f"ax_{name}"] = np.asarray(value)
        save_results(path, res)
        all_results[key] = res
        if tensorboard:
            _log_tensorboard(out_dir, key, res)
        if verbose:
            print(
                f"[sweep] {key}: success={float(res['success_rate']):.3f} "
                f"steps/s={float(res['agent_steps_per_s']):,.0f}"
            )
    _write_summary(out_dir, all_results)
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
