"""Agent state, batched step and episode loop.

The batched step renders one panorama per agent, extracts the candidate
views at the deduplicated scan lags, takes the per-lag library minimum
(min-distance kernel or plain path), RIDF-min-pools it over each heading's
tolerance window, and decides: tie-ordered argmin, kinematics, stop rules.
The episode is a Python loop over ``max_steps`` with done-masking; nothing
in it waits for the device unless ``early_exit`` asks whether every agent
is done.

Status codes: 0 = running/budget, 1 = reached, 2 = diverged, 3 = off-landscape.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import NamedTuple

import numpy as np
import torch

from navdv_torch.config import SimConfig
from navdv_torch.device import as_tensor, resolve_device
from navdv_torch.familiarity import NCC_EPS, PAD_PENALTY, LibraryPack
from navdv_torch.ops.familiarity import make_lib_min_kernel
from navdv_torch.sensor import (
    make_lag_stats,
    make_pooled_panorama,
    make_render_batch,
    make_views_from_pooled,
    scan_lag_sets,
    scan_shift_sets,
)

STATUS_RUNNING = 0
STATUS_REACHED = 1
STATUS_DIVERGED = 2
STATUS_OFF = 3

# candidate-extraction fp32 elements per agent before the (L x P) lag stack
# is split into chunks (bounds the [B, L, P] transient at big sensors)
FAM_CHUNK_ELEMS = 2 << 20

# JAX familiarity implementations that the port does not have yet, with the
# ROADMAP item that ports each
_NOT_PORTED = {
    "fft": "ROADMAP A.10 (spectral familiarity)",
    "roll": "ROADMAP A.9 (rolled-library familiarity)",
    "conv": "ROADMAP A.12 (conv familiarity)",
    "infomax": "ROADMAP A.13 (infomax learned memory)",
    "auto": "ROADMAP A.10 (auto resolves to the fft/roll paths)",
}
# the port's names for the two JAX paths it has
_PORT_NAMES = {"pallas": "kernel", "jnp": "plain"}
# sensor and scan fields the port's paths read
_HONOURED_FIELDS = {
    "n_radial", "n_azimuth", "az_upsample", "r_min", "r_max", "hat_dtype",
    "render_mode", "n_headings", "scan_step_bins", "metric", "tol_bins",
}


class AgentState(NamedTuple):
    xy: torch.Tensor  # f32[2] or f32[B, 2]
    theta: torch.Tensor  # f32[] or f32[B]
    done: torch.Tensor  # bool
    status: torch.Tensor  # i32


class EpisodeStatics(NamedTuple):
    """Per-episode constants on the device (shared by all agents)."""

    landscape: torch.Tensor  # f32[Hl, Wl]
    lib: LibraryPack
    route_a: torch.Tensor  # f32[Nseg, 2] segment starts
    route_ab: torch.Tensor  # f32[Nseg, 2] segment vectors
    route_denom: torch.Tensor  # f32[Nseg] |ab|^2 (clamped)
    goal: torch.Tensor  # f32[2]


class StepRecord(NamedTuple):
    """Per-step trajectory record (stacked to [B, T] by the episode loop)."""

    xy: torch.Tensor
    theta: torch.Tensor
    fam: torch.Tensor  # selected familiarity min_k fam[k]
    k: torch.Tensor  # selected candidate index
    dist_route: torch.Tensor  # distance to route polyline after the step
    done: torch.Tensor  # was the episode already finished BEFORE this step


def make_statics(landscape, lib: LibraryPack, route, device=None) -> EpisodeStatics:
    dev = resolve_device(device)
    route = as_tensor(route, torch.float32, dev)
    a, b = route[:-1], route[1:]
    ab = b - a
    return EpisodeStatics(
        landscape=as_tensor(landscape, torch.float32, dev),
        lib=LibraryPack(*(t.to(dev) for t in lib)),
        route_a=a,
        route_ab=ab,
        route_denom=torch.sum(ab * ab, dim=1).clamp_min(1e-12),
        goal=route[-1],
    )


def init_state(xy, theta, device=None) -> AgentState:
    """Works for single ([2], []) or batched ([B, 2], [B]) starts."""
    dev = resolve_device(device)
    theta = as_tensor(theta, torch.float32, dev)
    return AgentState(
        xy=as_tensor(xy, torch.float32, dev),
        theta=theta,
        done=torch.zeros(theta.shape, dtype=torch.bool, device=dev),
        status=torch.full(theta.shape, STATUS_RUNNING, dtype=torch.int32, device=dev),
    )


def point_to_polyline_dist(p: torch.Tensor, st: EpisodeStatics) -> torch.Tensor:
    """Min point-to-segment distance from each p f32[B, 2] to the training
    route -> f32[B]."""
    rel = p[:, None, :] - st.route_a  # [B, Nseg, 2]
    t = (torch.sum(rel * st.route_ab, dim=2) / st.route_denom).clamp(0.0, 1.0)
    proj = st.route_a + t[:, :, None] * st.route_ab
    return torch.sqrt(torch.min(torch.sum((p[:, None, :] - proj) ** 2, dim=2), dim=1).values)


def _make_decide(cfg: SimConfig, device):
    """Post-familiarity logic, batched: argmin -> kinematics -> stop
    conditions. ``decide(states, fam f32[B, Nh], st) -> (states', StepRecord)``."""
    sensor, ag = cfg.sensor, cfg.agent
    shifts, _ = scan_shift_sets(cfg.scan)
    shifts_dev = torch.as_tensor(shifts, dtype=torch.float32, device=device)
    tie_order = torch.as_tensor(cfg.scan.tie_order(), dtype=torch.long, device=device)
    binw = sensor.bin_width

    def decide(state: AgentState, fam: torch.Tensor, st: EpisodeStatics):
        # ties -> smallest |shift|, then lowest index: argmin (first minimum)
        # over the tie-order permutation implements the rule exactly
        k = tie_order[torch.argmin(fam[:, tie_order], dim=1)]
        theta_new = state.theta + shifts_dev[k] * binw
        xy_new = state.xy + ag.step_size * torch.stack(
            [torch.cos(theta_new), torch.sin(theta_new)], dim=1
        )

        reached = torch.sum((xy_new - st.goal) ** 2, dim=1) <= ag.goal_radius**2
        dist_route = point_to_polyline_dist(xy_new, st)
        diverged = dist_route > ag.corridor
        hl, wl = st.landscape.shape
        margin = sensor.r_max
        x, y = xy_new[:, 0], xy_new[:, 1]
        off = ~((x >= margin) & (x <= wl - 1 - margin) & (y >= margin) & (y <= hl - 1 - margin))
        # priority: reached > diverged > off
        new_status = torch.where(
            reached,
            STATUS_REACHED,
            torch.where(diverged, STATUS_DIVERGED, torch.where(off, STATUS_OFF, STATUS_RUNNING)),
        ).to(torch.int32)

        was_done = state.done
        out = AgentState(
            xy=torch.where(was_done[:, None], state.xy, xy_new),
            theta=torch.where(was_done, state.theta, theta_new),
            done=was_done | (new_status != STATUS_RUNNING),
            status=torch.where(was_done, state.status, new_status),
        )
        rec = StepRecord(
            xy=out.xy,
            theta=out.theta,
            fam=torch.gather(fam, 1, k[:, None])[:, 0],
            k=k.to(torch.int32),
            dist_route=dist_route,
            done=was_done,
        )
        return out, rec

    return decide


def _make_lib_min(cfg: SimConfig, fam_impl: str, device):
    """Per-lag library minimum: ``(cand f32[B, L, P], lib, lag_sum f32[B, L],
    lag_sq f32[B, L]) -> M f32[B, L]``.

    ``"kernel"`` runs the min-distance kernel (counterpart of the JAX
    ``"pallas"`` path), which sums each row's norm itself. ``"plain"`` is the
    counterpart of the JAX ``"jnp"`` path: one matmul against the library
    plus per-candidate statistics, evaluated in fp64 from the fp32
    candidates (the kernel accumulates in fp64 too; see
    ops/familiarity.py). NCC takes mean and spread from the pooled
    panorama (sensor.make_lag_stats) and z-scores algebraically via
    ``z_c . z_l = (c . z_l - mu_c * sum(z_l)) / sigma_c``. SSD sums |c|^2
    over the candidates themselves: the decomposition cancels, and the
    lag-stat route rounds |c|^2 apart from the candidates the cross term
    sees by about the gap between the best headings.
    """
    if fam_impl in _NOT_PORTED:
        raise NotImplementedError(
            f"fam_impl={fam_impl!r} is not ported yet: {_NOT_PORTED[fam_impl]}"
        )
    if fam_impl in _PORT_NAMES:
        raise ValueError(
            f"fam_impl={fam_impl!r} is the JAX name; the port calls it "
            f"{_PORT_NAMES[fam_impl]!r}"
        )
    metric = cfg.scan.metric
    if metric not in ("ssd", "ncc"):
        raise ValueError(f"unknown familiarity metric {metric!r}")
    if fam_impl == "kernel":
        inner = make_lib_min_kernel(cfg.sensor, cfg.scan)
        return lambda cand, lib, lag_sum, lag_sq: inner(cand, lib)
    if fam_impl != "plain":
        raise ValueError(f"unknown fam_impl {fam_impl!r}")

    p = float(cfg.sensor.n_pixels)
    if metric == "ssd":
        def lib_min(cand, lib, lag_sum, lag_sq):
            c = cand.double()
            pen = (1.0 - lib.valid.double()) * PAD_PENALTY
            cross = torch.einsum("blp,vp->blv", c, lib.flat.double())
            csq = torch.sum(c * c, dim=2)
            d = -2.0 * cross + csq[:, :, None] + (lib.sq.double() + pen)[None, None, :]
            return torch.min(d, dim=2).values.clamp_min(0.0).float()
    else:
        def lib_min(cand, lib, lag_sum, lag_sq):
            z = lib.z.double()
            pen = (1.0 - lib.valid.double()) * PAD_PENALTY
            cross = torch.einsum("blp,vp->blv", cand.double(), z)
            mu = lag_sum / p
            var = (lag_sq / p - mu * mu).clamp_min(0.0)
            sigma = torch.sqrt(var + NCC_EPS)
            zsum = torch.sum(z, dim=1)  # [Nl]
            zdot = (cross - mu[:, :, None] * zsum[None, None, :]) / sigma[:, :, None]
            d = 1.0 - zdot / p + pen[None, None, :]
            return torch.min(d, dim=2).values.float()
    return lib_min


def _warn_unused_knobs(cfg: SimConfig, fam_impl: str) -> None:
    """Knobs of JAX-only paths (and the JAX matmul pass count, which the
    port's fp64 distances ignore) have no effect here; say so rather than
    letting a set knob read as free."""
    unused = [
        f"{type(part).__name__}.{f.name}"
        for part in (cfg.sensor, cfg.scan)
        for f in dataclasses.fields(part)
        if f.name not in _HONOURED_FIELDS and getattr(part, f.name) != f.default
    ]
    if unused:
        warnings.warn(
            f"{', '.join(unused)} have no effect with fam_impl={fam_impl!r}; "
            f"they apply only to JAX-only paths",
            stacklevel=3,
        )


def _step_from_fam(fam_of, decide):
    """Assemble a batched step from its familiarity stage. ``step.fam``
    exposes the pre-argmin familiarity ``fam_of(states, st) -> [B, Nh]``, so
    a probe (another familiarity route, an analysis) reads the exact step
    pipeline."""

    def step(states: AgentState, st: EpisodeStatics):
        return decide(states, fam_of(states, st), st)

    step.fam = fam_of
    return step


def make_step_batched(cfg: SimConfig, fam_impl: str = "kernel", device=None):
    """Batched step: ``(AgentState[B], EpisodeStatics) -> (AgentState[B], StepRecord[B])``.

    Pipeline: render one panorama per agent -> pooled panorama -> candidate
    views at the deduplicated scan lags -> per-lag library minimum M[B, L]
    -> RIDF min-pool via a static window gather -> argmin/kinematics. When
    (L x P) per agent exceeds FAM_CHUNK_ELEMS, lags are extracted and scored
    in chunks so only [B, chunk, P] is ever materialized. ``step.fam``
    exposes the pre-argmin familiarity ``fam_of(states, st) -> [B, Nh]``.
    """
    dev = resolve_device(device)
    if cfg.sensor.render_mode not in ("full", "sector"):
        raise ValueError(f"unknown render_mode {cfg.sensor.render_mode!r}")
    # the sector renderer serves the spectral path only; like the JAX
    # package, every other path renders "full" (numerically equivalent)
    lib_min = _make_lib_min(cfg, fam_impl, dev)
    _warn_unused_knobs(cfg, fam_impl)
    decide = _make_decide(cfg, dev)
    render_b = make_render_batch(cfg.sensor, dev)
    pooled = make_pooled_panorama(cfg.sensor, dev)
    lags, window_idx = scan_lag_sets(cfg.scan)
    plain_ncc = fam_impl == "plain" and cfg.scan.metric == "ncc"
    lag_stats = make_lag_stats(cfg.sensor, lags, dev) if plain_ncc else None

    p = cfg.sensor.n_pixels
    n_lags = len(lags)
    chunk = max(1, FAM_CHUNK_ELEMS // p)
    chunk_bounds = (
        [(0, n_lags)]
        if n_lags * p <= FAM_CHUNK_ELEMS
        else [(i, min(i + chunk, n_lags)) for i in range(0, n_lags, chunk)]
    )
    chunk_views = [
        (lo, hi, make_views_from_pooled(cfg.sensor, lags[lo:hi], dev))
        for lo, hi in chunk_bounds
    ]
    window_idx_dev = torch.as_tensor(window_idx.astype(np.int64), device=dev)  # [Nh, 2t+1]

    def fam_of(states: AgentState, st: EpisodeStatics) -> torch.Tensor:
        pano = render_b(st.landscape, states.xy, states.theta)  # [B, R, A]
        s = pooled(pano)  # [B, R, A]
        lag_sum = lag_sq = None
        if lag_stats is not None:
            lag_sum, lag_sq = lag_stats(s.double())  # [B, L] each
        parts = [
            lib_min(
                v(s),
                st.lib,
                None if lag_sum is None else lag_sum[:, lo:hi],
                None if lag_sq is None else lag_sq[:, lo:hi],
            )
            for lo, hi, v in chunk_views
        ]
        m = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)  # [B, L]
        return torch.min(m[:, window_idx_dev], dim=2).values  # [B, Nh]

    return _step_from_fam(fam_of, decide)


def make_navigate_batch(
    cfg: SimConfig, fam_impl: str = "kernel", early_exit: bool = False, device=None
):
    """Batched trials: ``run(states0, statics) -> (final[B], StepRecord[B, T])``.

    The full loop runs ``max_steps`` steps with done-masking and never waits
    for the device. ``early_exit`` stops once every agent is done (one
    device sync per step); its records are preallocated with ``done=True``
    and zeros so the untouched tail stays masked, giving the same result as
    the full loop.
    """
    dev = resolve_device(device)
    step = make_step_batched(cfg, fam_impl, dev)
    t_max = cfg.agent.max_steps

    def run(states0: AgentState, st: EpisodeStatics):
        states = states0
        if not early_exit:
            recs = []
            for _ in range(t_max):
                states, rec = step(states, st)
                recs.append(rec)
            return states, StepRecord(*(torch.stack(f, dim=1) for f in zip(*recs)))

        b = states0.theta.shape[0]
        buf = StepRecord(
            xy=torch.zeros((b, t_max, 2), dtype=torch.float32, device=dev),
            theta=torch.zeros((b, t_max), dtype=torch.float32, device=dev),
            fam=torch.zeros((b, t_max), dtype=torch.float32, device=dev),
            k=torch.zeros((b, t_max), dtype=torch.int32, device=dev),
            dist_route=torch.zeros((b, t_max), dtype=torch.float32, device=dev),
            done=torch.ones((b, t_max), dtype=torch.bool, device=dev),
        )
        for t in range(t_max):
            if bool(states.done.all()):
                break
            states, rec = step(states, st)
            for dst, src in zip(buf, rec):
                dst[:, t] = src
        return states, buf

    return run
