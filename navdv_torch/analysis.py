"""Analysis: RIDF curves, familiarity maps and catchment areas
(counterpart of the JAX package's ``analysis.py``).

- **RIDF** (rotational image difference function): familiarity against
  rotation at a fixed pose; its valley is the signal the heading scan
  follows.
- **Familiarity map / catchment area**: the best-over-headings familiarity
  and the preferred absolute heading on a grid of positions around the
  route; the region whose descent leads back to the route is the
  catchment area (Zeil et al. 2003).

Both probe the step's own familiarity stage (``step.fam`` of
:func:`navdv_torch.agent.make_step_batched`: renderer, lag dedup, metric,
RIDF pooling), so what is plotted is what the agent computes on every
``fam_impl``, the learned infomax memory included. A map is one batched
familiarity evaluation per ``batch`` positions: grid cells play the part
of agents. On the card a probe replays a CUDA graph per batch shape, as
the JAX package jits it (:mod:`navdv_torch.capture`). A probe with
``lib_axis`` scores this rank's library shard and combines the shards'
minima as the step does (:mod:`navdv_torch.parallel`).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from navdv_torch.agent import (
    EpisodeStatics,
    init_state,
    make_statics,
    make_step_batched,
    resolve_fam_impl,
)
from navdv_torch.capture import Captured, ProgramCache, host_collectives
from navdv_torch.config import SimConfig
from navdv_torch.device import as_tensor, resolve_device
from navdv_torch.familiarity import LibraryPack
from navdv_torch.oracle import point_to_polyline_dists
from navdv_torch.sensor import scan_shift_sets

__all__ = [
    "full_circle_scan",
    "make_familiarity_probe",
    "ridf",
    "familiarity_map",
    "catchment",
    "heading_error",
]

def full_circle_scan(cfg: SimConfig) -> SimConfig:
    """``cfg`` with the heading scan widened to the full azimuth circle: one
    candidate per fine bin (``n_headings = n_fine``, ``scan_step_bins = 1``)
    and no RIDF tolerance pooling (the full-circle scan is itself the
    rotation function). Metric and the other knobs are kept."""
    scan = dataclasses.replace(
        cfg.scan, n_headings=cfg.sensor.n_fine, scan_step_bins=1, tol_bins=0
    )
    return dataclasses.replace(cfg, scan=scan)


def make_familiarity_probe(cfg: SimConfig, fam_impl: str = "auto", lib_axis=None,
                           device=None):
    """Batched familiarity probe over the step's pipeline.

    Returns ``probe(xy[B, 2], theta[B], st, aux=None) -> fam f32[B, Nh]``
    (a tensor on the probe's device) with attributes:

    - ``probe.angles``: ``f32[Nh]`` candidate rotations relative to
      ``theta`` (radians, ascending);
    - ``probe.prepare``: the step's per-library stage (``st -> aux``:
      spectra, pre-rolled library, the trained infomax network), or None
      on ``"kernel"``, ``"plain"`` and ``"conv"``;
    - ``probe.best(xy, theta, st, aux=None) -> (fam_min f32[B], k i64[B])``:
      the minimum over headings with the step's tie-break (smallest |shift|
      first, then lowest index);
    - ``probe.fused``: whether the sector branch took the fused front end
      (``step.fam.fused``; False off the sector renderer);
    - ``probe.captured``: whether the probe replays CUDA graphs (on the
      card, one per batch shape, captured at its first call; not with a
      gloo ``lib_axis``, whose collectives run on the host);
      ``probe.eager`` and ``probe.best.eager`` run the same functions
      uncaptured.

    ``lib_axis`` is a process group over which the library is sharded, as
    in :func:`navdv_torch.agent.make_step_batched`: ``st`` is then this
    rank's shard (:func:`navdv_torch.parallel.shard_statics`), every rank of
    the group probes the same poses, and each gets the familiarity over the
    whole library. Probes are cached on ``(cfg, fam_impl, device,
    lib_axis)``. Past ``capture.MAX_PROGRAMS`` captured functions (a probe
    and its ``best`` are two) the graphs of the least recently called are
    released (:data:`_LIVE_PROBES`); such a function captures again at its
    next call."""
    return _make_familiarity_probe(cfg, fam_impl, resolve_device(device), lib_axis)


# the probes' captured functions that keep their graphs; the lru_cache
# below owns the probes
_LIVE_PROBES = ProgramCache(weak=True)


@functools.lru_cache(maxsize=32)
def _make_familiarity_probe(cfg: SimConfig, fam_impl: str, dev: torch.device, lib_axis):
    step = make_step_batched(cfg, fam_impl, dev, lib_axis)
    fam_of = step.fam
    prepare = step.lib_prepare
    # infomax scores only with the network the caller trained (aux); the
    # other prepare stages are rebuilt per call when aux is None
    prepares_itself = prepare is not None and resolve_fam_impl(cfg, fam_impl) != "infomax"
    shifts, _ = scan_shift_sets(cfg.scan)
    tie_order = torch.as_tensor(cfg.scan.tie_order(), dtype=torch.long, device=dev)

    def probe_eager(xy, theta, st: EpisodeStatics, aux=None) -> torch.Tensor:
        return fam_of(init_state(xy, theta, dev), st, aux)

    def best_eager(xy, theta, st: EpisodeStatics, aux=None):
        famo = probe_eager(xy, theta, st, aux)[:, tie_order]
        # argmin (first minimum) over the tie-order permutation: the
        # step's tie-break exactly (agent._make_decide)
        j = torch.argmin(famo, dim=1)
        return famo.gather(1, j[:, None])[:, 0], tie_order[j]

    if host_collectives(lib_axis):
        probe, best = probe_eager, best_eager
    else:
        def graphed(fn, name):
            captured = Captured(fn, dev, name)

            def call(xy, theta, st: EpisodeStatics, aux=None):
                if aux is None and prepares_itself:
                    aux = prepare(st)  # outside the graph, as the episode does
                _LIVE_PROBES[id(captured)] = captured
                return captured(as_tensor(xy, torch.float32, dev),
                                as_tensor(theta, torch.float32, dev), st, aux)

            return call

        probe = graphed(probe_eager, "familiarity probe")
        best = graphed(best_eager, "familiarity probe best")

    probe.angles = np.asarray(shifts, dtype=np.float32) * cfg.sensor.bin_width
    probe.prepare = prepare
    probe.best = best
    probe.fused = fam_of.fused
    probe.eager, best.eager = probe_eager, best_eager
    probe.captured = dev.type == "cuda" and not host_collectives(lib_axis)
    return probe


_DUMMY_ROUTE = np.array([[0.0, 0.0], [1.0, 1.0]])  # fam never reads the route

# Caches for the wrappers below, which are often called in a loop against
# one landscape and library: the statics on the device and the prepared aux
# (probe.prepare can be expensive; on "infomax" it trains the network).
# Each entry holds its id()-keyed objects, so no id is recycled while the
# entry lives; small FIFOs bound the device memory evicted libraries hold.
_AUX_CACHE: dict = {}
_STATICS_CACHE: dict = {}
_CACHE_MAX = 8


def _fifo_put(cache: dict, key, entry) -> None:
    while len(cache) >= _CACHE_MAX:
        cache.pop(next(iter(cache)))
    cache[key] = entry


def _statics_for(landscape, lib: LibraryPack, dev: torch.device) -> EpisodeStatics:
    key = (id(landscape), id(lib.views), dev)
    hit = _STATICS_CACHE.get(key)
    if hit is not None and hit[0] is landscape and hit[1] is lib.views:
        return hit[2]
    st = make_statics(landscape, lib, _DUMMY_ROUTE, dev)
    _fifo_put(_STATICS_CACHE, key, (landscape, lib.views, st))
    return st


def _aux_for(probe, st: EpisodeStatics):
    if probe.prepare is None:
        return None
    key = (id(probe), id(st.lib.views))
    hit = _AUX_CACHE.get(key)
    # both identities checked again: the probe's lru_cache slot (and its id)
    # can be evicted and recycled independently of this cache's entries
    if hit is not None and hit[0] is probe and hit[1] is st.lib.views:
        return hit[2]
    aux = probe.prepare(st)
    _fifo_put(_AUX_CACHE, key, (probe, st.lib.views, aux))
    return aux


def _setup(landscape, lib: LibraryPack, cfg: SimConfig, fam_impl: str, device):
    dev = resolve_device(device)
    probe = make_familiarity_probe(cfg, fam_impl, device=dev)
    st = _statics_for(landscape, lib, dev)
    return probe, st, _aux_for(probe, st)


def ridf(landscape, lib: LibraryPack, xy, theta, cfg: SimConfig, *,
         fam_impl: str = "auto", device=None) -> tuple[np.ndarray, np.ndarray]:
    """Full-circle RIDF at one pose or a batch of poses: ``(angles[Nh],
    fam[..., Nh])``, the familiarity at each rotation of the view captured at
    ``(xy, theta)``. ``xy`` is ``[2]`` or ``[B, 2]`` with one heading per
    pose."""
    xy = np.asarray(xy, dtype=np.float32)
    single = xy.ndim == 1
    xy_b = xy[None, :] if single else xy
    theta_b = np.atleast_1d(np.asarray(theta, dtype=np.float32))
    if theta_b.shape[0] != xy_b.shape[0]:
        raise ValueError(
            f"theta batch {theta_b.shape[0]} != xy batch {xy_b.shape[0]}: "
            "pass one heading per pose"
        )
    probe, st, aux = _setup(landscape, lib, full_circle_scan(cfg), fam_impl, device)
    fam = probe(xy_b, theta_b, st, aux).cpu().numpy()
    return probe.angles, (fam[0] if single else fam)


def familiarity_map(landscape, lib: LibraryPack, cfg: SimConfig, *, stride: float = 8.0,
                    margin: float | None = None, fam_impl: str = "auto", batch: int = 1024,
                    device=None) -> dict:
    """Best-over-headings familiarity on a position grid (catchment map).

    Probes the full heading circle at every grid position (spacing
    ``stride`` px, ``margin`` px clear of the edges: by default the sensor
    radius, the bound of the agent's off-landscape rule) in batches of
    ``batch`` positions; the last batch is padded with copies of its last
    position. Returns ``x[nx]``, ``y[ny]`` (grid coordinates),
    ``fam[ny, nx]`` (best familiarity, lower = more familiar),
    ``best_heading[ny, nx]`` (the absolute heading in radians that achieves
    it) and ``angles[Nh]``, all NumPy."""
    if margin is None:
        margin = float(cfg.sensor.r_max)
    hl, wl = tuple(landscape.shape)
    xs = np.arange(margin, wl - 1 - margin + 1e-9, stride, dtype=np.float32)
    ys = np.arange(margin, hl - 1 - margin + 1e-9, stride, dtype=np.float32)
    if xs.size == 0 or ys.size == 0:
        raise ValueError(
            f"no grid positions: landscape {(hl, wl)} leaves no interior at "
            f"margin {margin} (stride {stride})"
        )
    gx, gy = np.meshgrid(xs, ys)
    pts = np.stack([gx.ravel(), gy.ravel()], axis=1)  # [N, 2]
    n = pts.shape[0]

    probe, st, aux = _setup(landscape, lib, full_circle_scan(cfg), fam_impl, device)
    zeros = np.zeros(batch, np.float32)
    best = np.empty(n, dtype=np.float32)
    best_k = np.empty(n, dtype=np.int64)
    for lo in range(0, n, batch):
        hi = min(lo + batch, n)
        chunk = pts[lo:hi]
        if hi - lo < batch:  # pad to the one batch shape
            chunk = np.concatenate([chunk, np.repeat(chunk[-1:], batch - (hi - lo), axis=0)])
        b, k = probe.best(chunk, zeros, st, aux)
        best[lo:hi] = b[: hi - lo].cpu().numpy()
        best_k[lo:hi] = k[: hi - lo].cpu().numpy()

    return {
        "x": xs,
        "y": ys,
        "fam": best.reshape(len(ys), len(xs)),
        "best_heading": probe.angles[best_k].reshape(len(ys), len(xs)),
        "angles": probe.angles,
    }


def heading_error(landscape, lib: LibraryPack, cfg: SimConfig, xy, theta_ref, *,
                  theta_probe=None, fam_impl: str = "auto", full_circle: bool = True,
                  device=None) -> np.ndarray:
    """Open-loop angular error of the familiarity scan at given poses: the
    heading the scan selects (step tie-break) minus ``theta_ref``, wrapped
    to [-pi, pi), shape ``[B]``. ``theta_probe`` is the heading the agent
    faces while scanning (default ``theta_ref``); with ``full_circle`` the
    scan covers the whole circle, so the error does not depend on it."""
    xy = np.atleast_2d(np.asarray(xy, dtype=np.float32))
    theta_ref = np.atleast_1d(np.asarray(theta_ref, dtype=np.float32))
    theta_probe = (theta_ref if theta_probe is None
                   else np.atleast_1d(np.asarray(theta_probe, dtype=np.float32)))
    if theta_ref.shape[0] != xy.shape[0] or theta_probe.shape[0] != xy.shape[0]:
        raise ValueError(
            f"heading batches (ref {theta_ref.shape[0]}, probe "
            f"{theta_probe.shape[0]}) != xy batch {xy.shape[0]}"
        )
    pcfg = full_circle_scan(cfg) if full_circle else cfg
    probe, st, aux = _setup(landscape, lib, pcfg, fam_impl, device)
    _, k = probe.best(xy, theta_probe, st, aux)  # [B] to the host, not [B, Nh]
    chosen = theta_probe + probe.angles[k.cpu().numpy()]
    err = chosen - theta_ref
    return np.asarray((err + np.pi) % (2 * np.pi) - np.pi, dtype=np.float32)


def catchment(fmap: dict, route, corridor: float = 20.0) -> dict:
    """Catchment area of a familiarity map (host NumPy).

    Zeil's operational definition: from each grid cell, step to the
    lowest-familiarity cell of its 8-neighbourhood while that is strictly
    lower, until a local minimum; the start cell is *captured* when that
    minimum lies within ``corridor`` px of the training route. Returns
    ``{"captured": bool[ny, nx], "fraction": float, "route_dist":
    f32[ny, nx]}``."""
    fam = np.asarray(fmap["fam"], dtype=np.float64)
    ny, nx = fam.shape
    gx, gy = np.meshgrid(fmap["x"], fmap["y"])
    route = np.asarray(route, dtype=np.float64)
    pts = np.stack([gx.ravel(), gy.ravel()], axis=1)  # [N, 2]
    route_dist = point_to_polyline_dists(pts, route).reshape(ny, nx).astype(np.float32)

    # descent successor of every cell: the lowest strictly lower 8-neighbour
    # (-1 = local minimum); paths then resolve by pointer chasing with
    # memoization, O(cells)
    padded = np.full((ny + 2, nx + 2), np.inf)
    padded[1:-1, 1:-1] = fam
    neigh = np.stack([
        padded[1 + dy : 1 + dy + ny, 1 + dx : 1 + dx + nx]
        for dy in (-1, 0, 1)
        for dx in (-1, 0, 1)
        if not (dy == 0 and dx == 0)
    ])  # [8, ny, nx]
    offsets = np.asarray(
        [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1) if not (dy == 0 and dx == 0)]
    )
    kmin = np.argmin(neigh, axis=0)  # [ny, nx]
    vmin = np.take_along_axis(neigh, kmin[None], axis=0)[0]
    flat_succ = np.where(
        vmin < fam,
        (np.arange(ny)[:, None] + offsets[kmin][..., 0]) * nx
        + (np.arange(nx)[None, :] + offsets[kmin][..., 1]),
        -1,
    ).ravel()

    at_route = route_dist.ravel() <= corridor
    state = np.full(ny * nx, -1, dtype=np.int8)  # -1 unknown, 0 no, 1 yes
    for i in range(ny * nx):
        path = []
        j = i
        while state[j] == -1:
            path.append(j)
            state[j] = -2  # on the current path (cycle guard: strict descent
            # cannot cycle, but inf/NaN plateaus could)
            nxt = flat_succ[j]
            if nxt < 0:  # local minimum: captured iff it sits on the route
                state[j] = 1 if at_route[j] else 0
                path.pop()
                break
            j = nxt
            if state[j] == -2:  # plateau cycle: not captured
                state[j] = 0
        verdict = state[j]
        for p in path:
            state[p] = verdict
    captured = (state == 1).reshape(ny, nx)
    return {
        "captured": captured,
        "fraction": float(captured.mean()),
        "route_dist": route_dist,
    }
