"""Agent state, batched step and episode loop.

The batched step renders one panorama per agent, pools it, and scores the
deduplicated scan lags against the library by one of four paths:

- ``"kernel"``: candidate views extracted at every lag, then the
  min-distance kernel (counterpart of the JAX ``"pallas"`` path);
- ``"plain"``: the same in plain PyTorch (the JAX ``"jnp"`` path);
- ``"roll"``: the rolled-library product, no candidate tensor
  (:mod:`navdv_torch.familiarity_roll`);
- ``"fft"``: the spectral correlation, no candidate tensor
  (:mod:`navdv_torch.familiarity_fft`);

or ``"auto"``, which resolves as the JAX package's ``choose_fam_impl`` does.
With ``render_mode="sector"`` the ``"fft"`` path renders through the sector
renderer and absorbs its roll in the spectra; every other path renders
"full", as in the JAX package. The step then RIDF-min-pools the per-lag
minimum over each heading's tolerance window and decides: tie-ordered
argmin, kinematics, stop rules. The episode is a Python loop over
``max_steps`` with done-masking; nothing in it waits for the device unless
``early_exit`` asks whether every agent is done. ``make_step``,
``make_navigate``, ``navigate`` and ``step`` are one-agent wrappers over the
batched step and loop.

Status codes: 0 = running/budget, 1 = reached, 2 = diverged, 3 = off-landscape.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import NamedTuple

import numpy as np
import torch

from navdv_torch.config import SimConfig, choose_fam_impl
from navdv_torch.device import as_tensor, resolve_device
from navdv_torch.familiarity import NCC_EPS, PAD_PENALTY, LibraryPack
from navdv_torch.familiarity_fft import make_lib_min_fft
from navdv_torch.familiarity_roll import make_lib_min_roll
from navdv_torch.ops.familiarity import make_lib_min_kernel
from navdv_torch.sensor import (
    make_lag_stats,
    make_pooled_panorama,
    make_render_batch,
    make_render_batch_rolled,
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
    "conv": "ROADMAP A.12 (conv familiarity)",
    "infomax": "ROADMAP A.13 (infomax learned memory)",
}
# the port's names for the two extract-then-score JAX paths
_PORT_NAMES = {"pallas": "kernel", "jnp": "plain"}
FAM_IMPLS = ("kernel", "plain", "fft", "roll")
# sensor and scan fields every path of the port reads
_HONOURED_FIELDS = {
    "n_radial", "n_azimuth", "az_upsample", "r_min", "r_max", "hat_dtype",
    "render_mode", "n_headings", "scan_step_bins", "metric", "tol_bins",
}
# knobs that one familiarity path reads, as in the JAX package
_IMPL_KNOBS = {"roll_rank": "roll", "fixed_point_bits": "roll", "spectral_cutoff": "fft"}
# knobs of the sector renderer, read by render_mode="sector" with "fft" only
_SECTOR_KNOBS = ("n_sectors", "ring_blocks", "phi_bins", "fused_dft_precision")
# JAX matmul pass counts: the port's distances are fp64 on every path (C.1)
_PRECISION_KNOBS = ("matmul_precision", "fft_product_precision")


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
    metric = cfg.scan.metric
    if metric not in ("ssd", "ncc"):
        raise ValueError(f"unknown familiarity metric {metric!r}")
    if fam_impl == "kernel":
        inner = make_lib_min_kernel(cfg.sensor, cfg.scan)
        return lambda cand, lib, lag_sum, lag_sq: inner(cand, lib)

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


def resolve_fam_impl(cfg: SimConfig, fam_impl: str) -> str:
    """The port's familiarity path for ``fam_impl``: ``"auto"`` resolves by
    the JAX package's rule (``config.choose_fam_impl``), its ``"jnp"``
    becoming ``"kernel"`` (the min-distance kernel computes that stage, and
    takes its plain version on CPU tensors). JAX names of paths the port has
    under another name raise ValueError; paths not ported raise
    NotImplementedError naming their ROADMAP item."""
    if fam_impl == "auto":
        fam_impl = choose_fam_impl(cfg)
        return "kernel" if fam_impl == "jnp" else fam_impl
    if fam_impl in _NOT_PORTED:
        raise NotImplementedError(
            f"fam_impl={fam_impl!r} is not ported yet: {_NOT_PORTED[fam_impl]}"
        )
    if fam_impl in _PORT_NAMES:
        raise ValueError(
            f"fam_impl={fam_impl!r} is the JAX name; the port calls it "
            f"{_PORT_NAMES[fam_impl]!r}"
        )
    if fam_impl not in FAM_IMPLS:
        raise ValueError(f"unknown fam_impl {fam_impl!r}")
    return fam_impl


def _warn_unused_knobs(cfg: SimConfig, fam_impl: str) -> None:
    """A knob set away from its default that ``fam_impl`` does not read
    warns, rather than letting it read as free: the impl-specific knobs of
    the JAX package (``roll_rank``/``fixed_point_bits`` outside ``"roll"``,
    ``spectral_cutoff`` outside ``"fft"``), the sector renderer's knobs
    outside ``render_mode="sector"`` with ``"fft"`` (one warning each, in the
    JAX package's words), the JAX matmul pass counts (the port's distances
    are fp64), and the knobs of paths not ported yet."""
    sector = cfg.sensor.render_mode == "sector" and fam_impl == "fft"
    unused = []
    for part in (cfg.sensor, cfg.scan):
        for f in dataclasses.fields(part):
            value = getattr(part, f.name)
            if f.name in _HONOURED_FIELDS or value == f.default:
                continue
            if _IMPL_KNOBS.get(f.name) == fam_impl:
                continue
            if f.name in _SECTOR_KNOBS:
                if not sector:
                    warnings.warn(
                        f"{type(part).__name__}.{f.name}={value!r} has no effect outside "
                        f"render_mode='sector' with fam_impl='fft' (got render_mode="
                        f"{cfg.sensor.render_mode!r}, fam_impl={fam_impl!r})", stacklevel=3)
                continue
            if f.name in _IMPL_KNOBS:
                why = f"it applies only to fam_impl={_IMPL_KNOBS[f.name]!r}"
            elif f.name in _PRECISION_KNOBS:
                why = "the port's distances are fp64 (ROADMAP C.1)"
            else:
                why = "it belongs to a JAX path the port does not have yet"
            unused.append((f"{type(part).__name__}.{f.name}", why))
    if unused:
        names = ", ".join(n for n, _ in unused)
        verb = "has" if len(unused) == 1 else "have"
        reasons = "; ".join(f"{n}: {why}" for n, why in unused)
        warnings.warn(f"{names} {verb} no effect with fam_impl={fam_impl!r} ({reasons})",
                      stacklevel=3)


def _step_from_fam(fam_of, decide):
    """Assemble a batched step from its familiarity stage. ``step.fam``
    exposes the pre-argmin familiarity ``fam_of(states, st, aux=None) ->
    [B, Nh]``, so a probe (another familiarity route, an analysis) reads the
    exact step pipeline."""

    def step(states: AgentState, st: EpisodeStatics, aux=None):
        return decide(states, fam_of(states, st, aux), st)

    step.fam = fam_of
    return step


def _make_sector_fam(cfg: SimConfig, lib_min, lags: np.ndarray, window_idx: torch.Tensor, dev):
    """The spectral familiarity through the sector renderer (the JAX
    package's two sector branches): ``(fam_of(states, st, aux=None) ->
    [B, Nh], prepare(st) -> aux)``, aux = (library spectra, padded
    landscape), both built once per statics.

    The panorama comes back in the phi frame with its roll k, which the
    spectra absorb (``roll_k``). With u == 1 and
    ``fused_dft_precision != "off"`` the front end is fused: the renderer
    returns the forward DFT of the phi-frame panorama (``contract=
    lib_min.forward_mats``) and its row sums, and every candidate tiles the
    full circle, so the lag statistics are the lag-independent totals. The
    JAX package runs that contraction at the knob's precision (config 3
    ships one bf16 pass); the port forms it in fp64, like every product on
    its distance path (ROADMAP C.1, C.10), and reads only "off" or not.
    Otherwise the pooled phi-frame panorama enters ``lib_min`` and the lag
    statistics gather the k-shifted residue classes."""
    drift = max(2.0, cfg.agent.step_size)
    n_lags = len(lags)
    fused = cfg.scan.fused_dft_precision != "off" and cfg.sensor.az_upsample == 1
    if fused:
        render = make_render_batch_rolled(cfg.sensor, drift, lib_min.forward_mats, dev)
        a_fine = cfg.sensor.n_fine
        fc = lib_min.forward_mats.shape[1] // 2

        def lag_min(land_pad, states, lib, lib_aux):
            spec, k, rowsum, rowsq = render.padded(land_pad, states.xy, states.theta)
            b = k.shape[0]
            lag_sum = rowsum.sum(dim=1)[:, None].expand(b, n_lags)
            lag_sq = rowsq.sum(dim=1)[:, None].expand(b, n_lags)
            mu = rowsum * (1.0 / a_fine)
            return lib_min.spectral((spec[..., :fc], spec[..., fc:], mu), lib, lag_sum, lag_sq,
                                    lib_aux, roll_k=k)
    else:
        render = make_render_batch_rolled(cfg.sensor, drift, device=dev)
        pooled = make_pooled_panorama(cfg.sensor, dev)
        stats = (make_lag_stats(cfg.sensor, lags, dev, dynamic_roll=True)
                 if cfg.scan.metric == "ncc" else None)

        def lag_min(land_pad, states, lib, lib_aux):
            pano, k = render.padded(land_pad, states.xy, states.theta)
            s = pooled(pano)
            lag_sum = lag_sq = None
            if stats is not None:
                lag_sum, lag_sq = stats(s.double(), k)
            return lib_min(s, lib, lag_sum, lag_sq, lib_aux, roll_k=k)

    def prepare(st: EpisodeStatics):
        return lib_min.prepare(st.lib), render.pad(st.landscape)

    def fam_of(states: AgentState, st: EpisodeStatics, aux=None) -> torch.Tensor:
        lib_aux, land_pad = prepare(st) if aux is None else aux
        m = lag_min(land_pad, states, st.lib, lib_aux)  # [B, L]
        return torch.min(m[:, window_idx], dim=2).values  # [B, Nh]

    fam_of.fused = fused  # which front end the step runs, for probes
    return fam_of, prepare


def make_step_batched(cfg: SimConfig, fam_impl: str = "kernel", device=None):
    """Batched step: ``step(AgentState[B], EpisodeStatics, aux=None) ->
    (AgentState[B], StepRecord[B])``.

    Pipeline: render one panorama per agent -> pooled panorama -> per-lag
    library minimum M[B, L] at the deduplicated scan lags -> RIDF min-pool
    via a static window gather -> argmin/kinematics.

    ``"kernel"``/``"plain"`` extract the candidate views first; when
    (L x P) per agent exceeds FAM_CHUNK_ELEMS, lags are extracted and scored
    in chunks so only [B, chunk, P] is ever materialized. They have no
    prepare stage (``step.lib_prepare`` is None) and ignore ``aux``.
    ``"roll"``/``"fft"`` score the pooled panorama directly; their
    per-library constants (pre-rolled library, library spectra) come from
    ``step.lib_prepare(st)``, passed as ``aux`` (built per call when None).
    With ``render_mode="sector"``, ``"fft"`` renders through the sector
    renderer (:func:`_make_sector_fam`), its aux also carries the padded
    landscape, and ``step.fam.fused`` says whether it took the fused front
    end. ``step.fam`` exposes the pre-argmin familiarity
    ``fam_of(states, st, aux=None) -> [B, Nh]``.
    """
    dev = resolve_device(device)
    fam_impl = resolve_fam_impl(cfg, fam_impl)
    if cfg.sensor.render_mode not in ("full", "sector"):
        raise ValueError(f"unknown render_mode {cfg.sensor.render_mode!r}")
    _warn_unused_knobs(cfg, fam_impl)
    decide = _make_decide(cfg, dev)
    lags, window_idx = scan_lag_sets(cfg.scan)
    window_idx_dev = torch.as_tensor(window_idx.astype(np.int64), device=dev)  # [Nh, 2t+1]
    # the sector renderer serves the spectral path only; like the JAX
    # package, every other path renders "full" (numerically equivalent)
    if cfg.sensor.render_mode == "sector" and fam_impl == "fft":
        lib_min_fft = make_lib_min_fft(cfg.sensor, cfg.scan, lags, dev)
        fam_of, prepare = _make_sector_fam(cfg, lib_min_fft, lags, window_idx_dev, dev)
        step = _step_from_fam(fam_of, decide)
        step.lib_prepare = prepare
        return step
    render_b = make_render_batch(cfg.sensor, dev)
    pooled = make_pooled_panorama(cfg.sensor, dev)
    ncc = cfg.scan.metric == "ncc"

    if fam_impl in ("fft", "roll"):
        make = make_lib_min_fft if fam_impl == "fft" else make_lib_min_roll
        lib_min_s = make(cfg.sensor, cfg.scan, lags, dev)
        stats = make_lag_stats(cfg.sensor, lags, dev) if ncc else None

        def fam_of(states: AgentState, st: EpisodeStatics, aux=None) -> torch.Tensor:
            s = pooled(render_b(st.landscape, states.xy, states.theta))  # [B, R, A]
            lag_sum = lag_sq = None
            if stats is not None:
                lag_sum, lag_sq = stats(s.double())  # [B, L] each
            m = lib_min_s(s, st.lib, lag_sum, lag_sq, aux)  # [B, L]
            return torch.min(m[:, window_idx_dev], dim=2).values  # [B, Nh]

        step = _step_from_fam(fam_of, decide)
        step.lib_prepare = lambda st: lib_min_s.prepare(st.lib)
        return step

    lib_min = _make_lib_min(cfg, fam_impl, dev)
    lag_stats = make_lag_stats(cfg.sensor, lags, dev) if fam_impl == "plain" and ncc else None
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

    def fam_of(states: AgentState, st: EpisodeStatics, aux=None) -> torch.Tensor:
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

    step = _step_from_fam(fam_of, decide)
    step.lib_prepare = None
    return step


def make_navigate_batch(
    cfg: SimConfig, fam_impl: str = "kernel", early_exit: bool = False, device=None
):
    """Batched trials: ``run(states0, statics, aux=None) -> (final[B],
    StepRecord[B, T])``.

    The full loop runs ``max_steps`` steps with done-masking and never waits
    for the device. ``early_exit`` stops once every agent is done (one
    device sync per step); its records are preallocated with ``done=True``
    and zeros so the untouched tail stays masked, giving the same result as
    the full loop.

    Callers running many episodes against one library build its constants
    once with ``run.prepare(statics)`` and pass them as ``aux``; otherwise
    each call prepares them once. ``run.prepare`` is None for paths with no
    prepare stage (``"kernel"``, ``"plain"``).
    """
    dev = resolve_device(device)
    step = make_step_batched(cfg, fam_impl, dev)
    t_max = cfg.agent.max_steps
    lib_prepare = step.lib_prepare

    def run(states0: AgentState, st: EpisodeStatics, aux=None):
        if aux is None and lib_prepare is not None:
            aux = lib_prepare(st)
        states = states0
        if not early_exit:
            recs = []
            for _ in range(t_max):
                states, rec = step(states, st, aux)
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
            states, rec = step(states, st, aux)
            for dst, src in zip(buf, rec):
                dst[:, t] = src
        return states, buf

    run.prepare = lib_prepare
    return run


def make_step(cfg: SimConfig, fam_impl: str = "kernel", device=None):
    """Single-agent step ``step(AgentState, EpisodeStatics, aux=None) ->
    (state', StepRecord)``: the batched step on a batch of one (for parity
    checks and debugging). ``"kernel"`` is the port's name for the JAX
    default ``"jnp"``."""
    batched = make_step_batched(cfg, fam_impl, device)

    def step(state: AgentState, st: EpisodeStatics, aux=None):
        out, rec = batched(AgentState(*(x[None] for x in state)), st, aux)
        return AgentState(*(x[0] for x in out)), StepRecord(*(x[0] for x in rec))

    step.lib_prepare = batched.lib_prepare
    return step


def make_navigate(cfg: SimConfig, fam_impl: str = "kernel", device=None):
    """Single episode ``navigate(state0, statics) -> (final_state,
    StepRecord[T])``, the record time-major as the JAX scan returns it: the
    full ``max_steps`` loop on a batch of one."""
    run = make_navigate_batch(cfg, fam_impl, device=device)

    def navigate(state0: AgentState, st: EpisodeStatics):
        final, rec = run(AgentState(*(x[None] for x in state0)), st)
        return AgentState(*(x[0] for x in final)), StepRecord(*(x[0] for x in rec))

    return navigate


def navigate(landscape, lib: LibraryPack, route, start_xy, start_theta, cfg: SimConfig,
             fam_impl: str = "kernel", device=None):
    """One episode from a start pose, with ``oracle.navigate``'s signature
    (the JAX package's convenience entry)."""
    dev = resolve_device(device)
    st = make_statics(landscape, lib, route, dev)
    return make_navigate(cfg, fam_impl, dev)(init_state(start_xy, start_theta, dev), st)


def step(state: AgentState, st: EpisodeStatics, cfg: SimConfig, device=None):
    """One step of one agent on the ``"kernel"`` path (tests, debugging)."""
    return make_step(cfg, device=device)(state, st)
