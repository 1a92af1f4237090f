"""Agent state, batched step and episode loop.

The batched step renders one panorama per agent, pools it, and scores the
deduplicated scan lags against the library by one of six paths:

- ``"kernel"``: candidate views extracted at every lag, then the
  min-distance kernel (counterpart of the JAX ``"pallas"`` path);
- ``"plain"``: the same in plain PyTorch (the JAX ``"jnp"`` path);
- ``"roll"``: the rolled-library product, no candidate tensor
  (:mod:`navdv_torch.familiarity_roll`);
- ``"fft"``: the spectral correlation, no candidate tensor
  (:mod:`navdv_torch.familiarity_fft`);
- ``"conv"``: the lag scan as one fp64 convolution, no candidate tensor
  (:mod:`navdv_torch.familiarity_conv`; opt-in);
- ``"infomax"``: the extracted candidates scored by a trained novelty
  network instead of the library (:mod:`navdv_torch.familiarity_infomax`;
  opt-in, another model than perfect memory);

or ``"auto"``, which resolves as the JAX package's ``choose_fam_impl`` does.
With ``render_mode="sector"`` the ``"fft"`` path renders through the sector
renderer and absorbs its roll in the spectra; every other path renders
"full", as in the JAX package. The step then RIDF-min-pools the per-lag
minimum over each heading's tolerance window and decides: tie-ordered
argmin, kinematics, stop rules, in one kernel on the card
(:mod:`navdv_torch.ops.decide`). The episode
(:func:`make_navigate_batch_fn`) is a Python loop over ``max_steps`` with
done-masking; nothing in it waits for the device unless ``early_exit`` asks
whether every agent is done. :func:`make_navigate_batch` replays it as CUDA
graphs on the card, as the JAX package jits it. With ``lib_axis`` (a
process group whose ranks hold one library shard each, as
:mod:`navdv_torch.parallel` builds them) the per-lag minima are combined by
:func:`lib_pmin` inside every step. ``make_step``,
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
import torch.distributed as dist

from navdv_torch.capture import Captured, copy_out, host_collectives
from navdv_torch.config import SimConfig, choose_fam_impl
from navdv_torch.device import as_tensor, resolve_device
from navdv_torch.familiarity import NCC_EPS, PAD_PENALTY, LibraryPack
from navdv_torch.familiarity_conv import make_lib_min_conv
from navdv_torch.familiarity_fft import make_lib_min_fft
from navdv_torch.familiarity_infomax import make_lib_min_infomax
from navdv_torch.familiarity_roll import make_lib_min_roll
from navdv_torch.ops.decide import (  # noqa: F401 (the status codes are agent.STATUS_*)
    STATUS_DIVERGED,
    STATUS_OFF,
    STATUS_REACHED,
    STATUS_RUNNING,
    Route,
    decide_constants,
)
from navdv_torch.ops.decide import decide as ops_decide
from navdv_torch.ops.familiarity import make_lib_min_kernel, make_lib_min_pooled
from navdv_torch.sensor import (
    make_lag_stats,
    make_pooled_panorama,
    make_render_batch,
    make_render_batch_rolled,
    make_views_from_pooled,
    scan_lag_sets,
)
from navdv_torch.utils.profiling import stage


# candidate-extraction fp32 elements per agent before the (L x P) lag stack
# is split into chunks (bounds the [B, L, P] transient at big sensors)
FAM_CHUNK_ELEMS = 2 << 20

# early exit on the card: steps per captured chunk, one host read each
# (chosen on the card as host reads against masked steps: PERF.md)
EXIT_CHUNK = 4

# the port's names for the two extract-then-score JAX paths
_PORT_NAMES = {"pallas": "kernel", "jnp": "plain"}
FAM_IMPLS = ("kernel", "plain", "fft", "roll", "conv", "infomax")
# sensor and scan fields every path of the port reads
_HONOURED_FIELDS = {
    "n_radial", "n_azimuth", "az_upsample", "r_min", "r_max", "hat_dtype",
    "render_mode", "n_headings", "scan_step_bins", "metric", "tol_bins",
}
# knobs that one familiarity path reads, as in the JAX package
_IMPL_KNOBS = {
    "roll_rank": "roll", "fixed_point_bits": "roll", "spectral_cutoff": "fft",
    "infomax_units": "infomax", "infomax_eta": "infomax", "infomax_epochs": "infomax",
    "infomax_seed": "infomax",
}
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


def lib_pmin(m: torch.Tensor, lib_axis) -> torch.Tensor:
    """The library shards' partial minima combined: ``all_reduce(MIN)`` over
    the process group ``lib_axis`` (the JAX package's ``lax.pmin`` over its
    ``lib`` mesh axis), the system's one collective. Every rank of the group
    holds the same agents, so after it they hold the same minima and decide
    alike. ``lib_axis=None`` (an unsharded library) returns ``m`` itself.
    ``lib_pmin.calls`` counts the collectives issued."""
    if lib_axis is None:
        return m
    with stage("lib_pmin"):
        m = m.contiguous()
        dist.all_reduce(m, op=dist.ReduceOp.MIN, group=lib_axis)
    lib_pmin.calls += 1
    return m


lib_pmin.calls = 0


def _make_decide(cfg: SimConfig, device):
    """Post-familiarity logic, batched: argmin -> kinematics -> stop
    conditions, one launch of the decide kernel on the card
    (:func:`navdv_torch.ops.decide.decide`). ``decide(states, fam f32[B,
    Nh], st) -> (states', StepRecord)``."""
    consts = decide_constants(cfg, device)

    def decide(state: AgentState, fam: torch.Tensor, st: EpisodeStatics):
        route = Route(st.route_a, st.route_ab, st.route_denom, st.goal)
        d = ops_decide(*state, fam, route, tuple(st.landscape.shape), consts)
        out = AgentState(xy=d.xy, theta=d.theta, done=d.done, status=d.status)
        rec = StepRecord(xy=d.xy, theta=d.theta, fam=d.fam, k=d.k, dist_route=d.dist_route,
                         done=state.done)
        return out, rec

    return decide


def _make_lib_min(cfg: SimConfig, fam_impl: str, device):
    """Per-lag library minimum: ``(cand f32[B, L, P], lib, lag_sum f64[B, L],
    lag_sq f64[B, L], aux=None) -> M f32[B, L]``.

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
    sees by about the gap between the best headings. ``"infomax"`` scores
    the candidates against the trained network in ``aux``
    (:func:`navdv_torch.familiarity_infomax.make_lib_min_infomax`, whose
    ``.prepare`` trains it).
    """
    if fam_impl == "infomax":
        return make_lib_min_infomax(cfg.sensor, cfg.scan, cfg.capture_spacing)
    metric = cfg.scan.metric
    if metric not in ("ssd", "ncc"):
        raise ValueError(f"unknown familiarity metric {metric!r}")
    if fam_impl == "kernel":
        inner = make_lib_min_kernel(cfg.sensor, cfg.scan)
        return lambda cand, lib, lag_sum, lag_sq, aux=None: inner(cand, lib)

    p = float(cfg.sensor.n_pixels)
    if metric == "ssd":
        def lib_min(cand, lib, lag_sum, lag_sq, aux=None):
            c = cand.double()
            pen = (1.0 - lib.valid.double()) * PAD_PENALTY
            cross = torch.einsum("blp,vp->blv", c, lib.flat.double())
            csq = torch.sum(c * c, dim=2)
            d = -2.0 * cross + csq[:, :, None] + (lib.sq.double() + pen)[None, None, :]
            return torch.min(d, dim=2).values.clamp_min(0.0).float()
    else:
        def lib_min(cand, lib, lag_sum, lag_sq, aux=None):
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
    under another name raise ValueError."""
    if fam_impl == "auto":
        fam_impl = choose_fam_impl(cfg)
        return "kernel" if fam_impl == "jnp" else fam_impl
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
    ``spectral_cutoff`` outside ``"fft"``, ``infomax_*`` outside
    ``"infomax"``), the sector renderer's knobs outside
    ``render_mode="sector"`` with ``"fft"`` (one warning each, in the JAX
    package's words), and the JAX matmul pass counts (the port's distances
    are fp64). A metric other than SSD warns under ``"infomax"``, whose
    learned readout replaces the image distance."""
    if fam_impl == "infomax" and cfg.scan.metric != "ssd":
        warnings.warn(
            f"ScanConfig.metric={cfg.scan.metric!r} is ignored with fam_impl='infomax': "
            "the learned novelty readout replaces the image-distance metric entirely "
            "(familiarity_infomax.py)", stacklevel=3)
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
            if f.name in _PRECISION_KNOBS:
                why = "the port's distances are fp64 (ROADMAP C.1)"
            else:
                why = f"it applies only to fam_impl={_IMPL_KNOBS[f.name]!r}"
            unused.append((f"{type(part).__name__}.{f.name}", why))
    if unused:
        names = ", ".join(n for n, _ in unused)
        verb = "has" if len(unused) == 1 else "have"
        reasons = "; ".join(f"{n}: {why}" for n, why in unused)
        warnings.warn(f"{names} {verb} no effect with fam_impl={fam_impl!r} ({reasons})",
                      stacklevel=3)


def _step_from_lag_min(lag_min, window_idx: torch.Tensor, decide):
    """Assemble a batched step from its per-lag library minimum
    ``lag_min(states, st, aux) -> M [B, L]``, which marks its own stages: the
    RIDF min-pool of M over each heading's tolerance window ``window_idx``
    and the decision form the stage ``decide``. ``step.fam`` exposes the
    pre-argmin familiarity ``fam_of(states, st, aux=None) -> [B, Nh]``, the
    same pool over the same minima, so a probe (another familiarity route,
    an analysis) reads the exact step pipeline; ``step.fam.fused`` says
    whether the sector renderer's fused front end runs (False off it)."""

    def pool(m: torch.Tensor) -> torch.Tensor:
        return torch.min(m[:, window_idx], dim=2).values  # [B, Nh]

    def fam_of(states: AgentState, st: EpisodeStatics, aux=None) -> torch.Tensor:
        return pool(lag_min(states, st, aux))

    def step(states: AgentState, st: EpisodeStatics, aux=None):
        m = lag_min(states, st, aux)
        with stage("decide"):
            return decide(states, pool(m), st)

    fam_of.fused = getattr(lag_min, "fused", False)
    step.fam = fam_of
    return step


def _make_sector_lag_min(cfg: SimConfig, lib_min, lags: np.ndarray, dev, lib_axis=None):
    """The spectral per-lag minimum through the sector renderer (the JAX
    package's two sector branches): ``(lag_min(states, st, aux=None) -> M
    [B, L], prepare(st) -> aux)``, aux = (library spectra, padded
    landscape), both built once per statics (per call when aux is None).
    Render, score and :func:`lib_pmin` form the stage ``familiarity``;
    ``lag_min.fused`` says which front end runs.

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

        def render_min(land_pad, states, lib, lib_aux):
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

        def render_min(land_pad, states, lib, lib_aux):
            pano, k = render.padded(land_pad, states.xy, states.theta)
            s = pooled(pano)
            lag_sum = lag_sq = None
            if stats is not None:
                lag_sum, lag_sq = stats(s.double(), k)
            return lib_min(s, lib, lag_sum, lag_sq, lib_aux, roll_k=k)

    def prepare(st: EpisodeStatics):
        return lib_min.prepare(st.lib), render.pad(st.landscape)

    def lag_min(states: AgentState, st: EpisodeStatics, aux=None) -> torch.Tensor:
        with stage("familiarity"):
            lib_aux, land_pad = prepare(st) if aux is None else aux
            return lib_pmin(render_min(land_pad, states, st.lib, lib_aux), lib_axis)  # [B, L]

    lag_min.fused = fused
    return lag_min, prepare


def _familiarity_stage(score):
    """``score`` marked as the stage ``familiarity``, its ``prepare`` kept."""

    def marked(s, lib, lag_sum, lag_sq, aux):
        with stage("familiarity"):
            return score(s, lib, lag_sum, lag_sq, aux)

    marked.prepare = getattr(score, "prepare", None)
    return marked


def _candidate_score(cfg: SimConfig, lib_min, lags: np.ndarray, dev):
    """A candidate scorer ``lib_min(cand f32[B, L, P], lib, lag_sum, lag_sq,
    aux)`` (:func:`_make_lib_min`) as a scorer of the pooled panorama: the
    candidate views are gathered from ``s`` (``sensor.make_views_from_pooled``)
    and scored, in chunks of lags once (L x P) per agent exceeds
    FAM_CHUNK_ELEMS, so only [B, chunk, P] is ever materialized. With one
    chunk the gather is marked as the stage ``candidates`` before
    ``familiarity``; with several, each chunk's gather and score alternate
    inside ``familiarity``, since a stage is marked once a step."""
    p, n_lags = cfg.sensor.n_pixels, len(lags)
    chunk = max(1, FAM_CHUNK_ELEMS // p)
    bounds = ([(0, n_lags)] if n_lags * p <= FAM_CHUNK_ELEMS
              else [(i, min(i + chunk, n_lags)) for i in range(0, n_lags, chunk)])
    views = [(lo, hi, make_views_from_pooled(cfg.sensor, lags[lo:hi], dev)) for lo, hi in bounds]

    def part(cand, lo, hi, lib, lag_sum, lag_sq, aux):
        return lib_min(cand, lib, None if lag_sum is None else lag_sum[:, lo:hi],
                       None if lag_sq is None else lag_sq[:, lo:hi], aux)

    if len(views) == 1:
        (lo, hi, gather), = views

        def score(s, lib, lag_sum, lag_sq, aux):
            with stage("candidates"):
                cand = gather(s)  # [B, L, P]
            with stage("familiarity"):
                return part(cand, lo, hi, lib, lag_sum, lag_sq, aux)
    else:
        def score(s, lib, lag_sum, lag_sq, aux):
            with stage("familiarity"):
                return torch.cat([part(v(s), lo, hi, lib, lag_sum, lag_sq, aux)
                                  for lo, hi, v in views], dim=1)  # [B, L]

    score.prepare = getattr(lib_min, "prepare", None)
    return score


def _make_full_lag_min(cfg: SimConfig, fam_impl: str, lags: np.ndarray, dev, lib_axis=None):
    """The per-lag minimum of every path that renders "full": ``(lag_min(
    states, st, aux) -> M [B, L], prepare(st) -> aux, or None)``. The front
    (render, pooled panorama s, and the lag statistics where the path reads
    them) is the stage ``front``; the path's scorer ``score(s f32[B, R, A],
    lib, lag_sum f64[B, L], lag_sq f64[B, L], aux) -> M f32[B, L]`` marks
    ``familiarity`` (the candidate paths ``candidates`` too); then
    :func:`lib_pmin` combines the library shards."""
    metric = cfg.scan.metric
    if fam_impl in ("fft", "roll"):
        make = make_lib_min_fft if fam_impl == "fft" else make_lib_min_roll
        score = _familiarity_stage(make(cfg.sensor, cfg.scan, lags, dev))
    elif fam_impl == "conv":
        score = _familiarity_stage(make_lib_min_conv(cfg.sensor, cfg.scan, dev))
    elif fam_impl == "kernel" and metric == "ssd":  # candidates formed inside the kernel
        score = _familiarity_stage(make_lib_min_pooled(cfg.sensor, lags, dev))
    else:  # "kernel" with NCC, "plain", "infomax": extract, then score
        score = _candidate_score(cfg, _make_lib_min(cfg, fam_impl, dev), lags, dev)
    render_s = make_render_batch(cfg.sensor, dev, pooled=True)
    # the lag statistics: NCC's mean and spread on every path but the
    # kernel's (which sums its own), both metrics' on infomax
    needs_stats = fam_impl == "infomax" or (metric == "ncc" and fam_impl != "kernel")
    lag_stats = make_lag_stats(cfg.sensor, lags, dev) if needs_stats else None

    def lag_min(states: AgentState, st: EpisodeStatics, aux) -> torch.Tensor:
        with stage("front"):
            s = render_s(st.landscape, states.xy, states.theta)  # pooled, [B, R, A]
            lag_sum = lag_sq = None
            if lag_stats is not None:
                lag_sum, lag_sq = lag_stats(s.double())  # [B, L] each
        return lib_pmin(score(s, st.lib, lag_sum, lag_sq, aux), lib_axis)  # [B, L]

    prepare = score.prepare  # fft, roll: library constants; infomax: training
    return lag_min, None if prepare is None else (lambda st: prepare(st.lib))


def make_step_batched(cfg: SimConfig, fam_impl: str = "kernel", device=None, lib_axis=None):
    """Batched step: ``step(AgentState[B], EpisodeStatics, aux=None) ->
    (AgentState[B], StepRecord[B])``.

    Pipeline: render one panorama per agent -> pooled panorama -> per-lag
    library minimum M[B, L] at the deduplicated scan lags -> RIDF min-pool
    via a static window gather -> argmin/kinematics.

    Every path scores the pooled panorama by one contract, ``score(s f32[B,
    R, A], lib, lag_sum, lag_sq, aux) -> M f32[B, L]``
    (:func:`_make_full_lag_min`): ``"fft"``, ``"roll"`` and ``"conv"``
    directly; ``"kernel"`` with the SSD metric in one min-distance launch
    that forms the candidate views inside the kernel
    (:func:`navdv_torch.ops.familiarity.min_distance_pooled`); ``"kernel"``
    with NCC, ``"plain"`` and ``"infomax"`` extract the candidate views
    first (:func:`_candidate_score`). Per-library constants (pre-rolled
    library, library spectra, the infomax network) come from
    ``step.lib_prepare(st)``, passed as ``aux``; they are built per call
    when None, except infomax's training, which raises without it. The
    kernel, plain and conv paths have no prepare stage
    (``step.lib_prepare`` is None) and ignore ``aux``. With
    ``render_mode="sector"``, ``"fft"`` renders through the sector renderer
    (:func:`_make_sector_lag_min`), its aux also carries the padded
    landscape, and ``step.fam.fused`` says whether it took the fused front
    end. ``step.fam`` exposes the pre-argmin familiarity ``fam_of(states,
    st, aux=None) -> [B, Nh]``.

    ``lib_axis`` is a process group over which the library is sharded:
    ``st.lib`` is this rank's shard, and the per-lag minima are combined by
    :func:`lib_pmin` before the RIDF pool, at the JAX package's four points.

    The step marks its stages on the device
    (:func:`navdv_torch.utils.profiling.stage`): the full renderer's paths
    mark ``front`` (render, pooled panorama, lag statistics),
    ``familiarity``, ``lib_pmin`` (with a lib axis) and ``decide`` (the
    RIDF min-pool and :func:`_make_decide`'s decision); the candidate paths
    mark their gather as ``candidates`` between ``front`` and
    ``familiarity`` when their lags form one chunk (:func:`_candidate_score`).
    The sector renderer's path marks ``familiarity`` (render, score and the
    collective) and ``decide``.
    """
    dev = resolve_device(device)
    fam_impl = resolve_fam_impl(cfg, fam_impl)
    if cfg.sensor.render_mode not in ("full", "sector"):
        raise ValueError(f"unknown render_mode {cfg.sensor.render_mode!r}")
    _warn_unused_knobs(cfg, fam_impl)
    decide = _make_decide(cfg, dev)
    lags, window_idx = scan_lag_sets(cfg.scan)
    # the sector renderer serves the spectral path only; like the JAX
    # package, every other path renders "full" (numerically equivalent)
    if cfg.sensor.render_mode == "sector" and fam_impl == "fft":
        lib_min_fft = make_lib_min_fft(cfg.sensor, cfg.scan, lags, dev)
        lag_min, prepare = _make_sector_lag_min(cfg, lib_min_fft, lags, dev, lib_axis)
    else:
        lag_min, prepare = _make_full_lag_min(cfg, fam_impl, lags, dev, lib_axis)
    window_idx = torch.as_tensor(window_idx.astype(np.int64), device=dev)  # [Nh, 2t+1]
    step = _step_from_lag_min(lag_min, window_idx, decide)
    step.lib_prepare = prepare
    return step


def _empty_records(b: int, t_max: int, dev) -> StepRecord:
    """The early-exit record buffer: zeros with ``done=True``, so the tail
    that no step writes stays masked."""
    return StepRecord(
        xy=torch.zeros((b, t_max, 2), dtype=torch.float32, device=dev),
        theta=torch.zeros((b, t_max), dtype=torch.float32, device=dev),
        fam=torch.zeros((b, t_max), dtype=torch.float32, device=dev),
        k=torch.zeros((b, t_max), dtype=torch.int32, device=dev),
        dist_route=torch.zeros((b, t_max), dtype=torch.float32, device=dev),
        done=torch.ones((b, t_max), dtype=torch.bool, device=dev),
    )


def _episode(step, t_max: int, early_exit: bool, dev):
    """The eager episode loop over ``step`` (see :func:`make_navigate_batch_fn`)."""
    lib_prepare = step.lib_prepare

    def navigate(states0: AgentState, st: EpisodeStatics, aux=None):
        if aux is None and lib_prepare is not None:
            aux = lib_prepare(st)
        states = states0
        if not early_exit:
            recs = []
            for _ in range(t_max):
                states, rec = step(states, st, aux)
                recs.append(rec)
            return states, StepRecord(*(torch.stack(f, dim=1) for f in zip(*recs)))

        buf = _empty_records(states0.theta.shape[0], t_max, dev)
        for t in range(t_max):
            if bool(states.done.all()):
                break
            states, rec = step(states, st, aux)
            for dst, src in zip(buf, rec):
                dst[:, t] = src
        return states, buf

    navigate.lib_prepare = lib_prepare
    return navigate


def make_navigate_batch_fn(cfg: SimConfig, fam_impl: str = "kernel", lib_axis=None,
                           early_exit: bool = False, device=None):
    """The eager batched episode, ``navigate(states0, statics, aux=None) ->
    (final[B], StepRecord[B, T])``: the unjitted counterpart of the JAX
    package's ``make_navigate_batch_fn``, which :func:`make_navigate_batch`
    captures.

    The full loop runs ``max_steps`` steps with done-masking and never waits
    for the device. ``early_exit`` stops once every agent is done (one
    device sync per step); its records are preallocated with ``done=True``
    and zeros so the untouched tail stays masked, giving the same result as
    the full loop. ``aux=None`` prepares the per-library constants in the
    call. ``navigate.lib_prepare`` is the step's prepare stage (None for
    ``"kernel"``, ``"plain"`` and ``"conv"``). ``lib_axis``: see
    :func:`make_step_batched`."""
    dev = resolve_device(device)
    step = make_step_batched(cfg, fam_impl, dev, lib_axis)
    return _episode(step, cfg.agent.max_steps, early_exit, dev)


def _exit_chunk(step, chunk: int, t_max: int):
    """``chunk`` steps of the early-exit loop as one function to capture:
    ``advance(states, t, buf, st, aux) -> all done`` updates the states,
    the step counter ``t`` (i64[]) and the record buffer in place. A step
    that starts with every agent done, or at ``t >= t_max``, leaves the
    states and the records as they are (a device-side flag and
    ``torch.where``), so chunks that run past the eager loop's exit give
    its result bit for bit."""

    def advance(states: AgentState, t: torch.Tensor, buf: StepRecord, st: EpisodeStatics, aux):
        for _ in range(chunk):
            go = (t < t_max) & ~states.done.all()
            new, rec = step(states, st, aux)
            col = t.clamp(max=t_max - 1).view(1)
            for dst, src in zip(buf, rec):  # first: rec.done is the states' own done
                dst.index_copy_(1, col, torch.where(go, src.unsqueeze(1), dst.index_select(1, col)))
            for cur, nxt in zip(states, new):
                cur.copy_(torch.where(go, nxt, cur))
            t.add_(1)
        return states.done.all()

    return advance


def make_navigate_batch(
    cfg: SimConfig, fam_impl: str = "kernel", early_exit: bool = False, device=None,
    lib_axis=None,
):
    """Batched trials: ``run(states0, statics, aux=None) -> (final[B],
    StepRecord[B, T])``, the episode of :func:`make_navigate_batch_fn`
    captured as CUDA graphs on the card (:mod:`navdv_torch.capture`), as
    the JAX package jits it; results equal the eager episode's bit for bit.

    - The full loop is one graph of ``max_steps`` steps (the JAX
      ``lax.scan``); it never waits for the device.
    - ``early_exit`` (the JAX ``lax.while_loop``, which stops on the
      device; a graph cannot) replays a graph of :data:`EXIT_CHUNK` steps
      (``run.exit_chunk``) and reads once per chunk whether every agent is
      done; steps after that inside a chunk change nothing. The records
      are preallocated with ``done=True`` and zeros so the untouched tail
      stays masked, giving the same result as the full loop.

    A graph is captured per batch and statics shape at its first call; each
    call copies its states, statics and ``aux`` into the graph's buffers, so
    a new landscape or library of the same shapes gives its own result.
    Callers running many episodes against one library build its constants
    once with ``run.prepare(statics)`` and pass them as ``aux``; otherwise
    each call prepares them once, outside the graph. ``run.prepare`` is None
    for paths with no prepare stage (``"kernel"``, ``"plain"``, ``"conv"``).

    ``lib_axis``: see :func:`make_step_batched`. Every rank of the group
    holds the same agents and, after the step's collective, the same
    minima, so under ``early_exit`` they stop at the same chunk. An NCCL
    group's ``all_reduce`` is captured with the step (the warm-up runs it
    once first); a group whose collectives run on the host (gloo) cannot
    be captured, so the run is then the eager episode. ``run.captured``
    says whether CUDA graphs run: on the card, unless ``lib_axis`` is a
    gloo group. On the CPU there is no graph; the run goes through the same
    copy-in, call and copy-out around a direct call (the chunked early exit
    included). ``run.release()`` frees its graphs (their outputs and static
    buffers); the next call captures again.
    """
    dev = resolve_device(device)
    step = make_step_batched(cfg, fam_impl, dev, lib_axis)
    t_max = cfg.agent.max_steps
    lib_prepare = step.lib_prepare
    eager = _episode(step, t_max, early_exit, dev)
    if host_collectives(lib_axis):
        eager.prepare, eager.captured, eager.exit_chunk = lib_prepare, False, None
        eager.release = lambda: None
        return eager

    if not early_exit:
        whole = Captured(eager, dev, "episode")

        def run(states0: AgentState, st: EpisodeStatics, aux=None):
            if aux is None and lib_prepare is not None:
                aux = lib_prepare(st)
            return whole(states0, st, aux)

        chunk, run.release = None, whole.release
    else:
        chunk = EXIT_CHUNK
        chunks = Captured(_exit_chunk(step, chunk, t_max), dev, "early-exit chunk")

        def run(states0: AgentState, st: EpisodeStatics, aux=None):
            if aux is None and lib_prepare is not None:
                aux = lib_prepare(st)
            args = (states0, torch.zeros((), dtype=torch.int64, device=dev),
                    _empty_records(states0.theta.shape[0], t_max, dev), st, aux)
            g = chunks.graph(*args)
            g.load(*args)
            for _ in range(0, t_max, chunk):
                if bool(g.replay()):  # the one host read per chunk
                    break
            states, _, buf, _, _ = g.args
            return copy_out((states, buf))

        run.release = chunks.release
    run.prepare, run.captured, run.exit_chunk = lib_prepare, dev.type == "cuda", chunk
    return run


def make_step(cfg: SimConfig, fam_impl: str = "kernel", device=None, lib_axis=None):
    """Single-agent step ``step(AgentState, EpisodeStatics, aux=None) ->
    (state', StepRecord)``: the batched step on a batch of one (for parity
    checks and debugging). ``"kernel"`` is the port's name for the JAX
    default ``"jnp"``."""
    batched = make_step_batched(cfg, fam_impl, device, lib_axis)

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
