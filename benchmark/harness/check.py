"""The comparison that decides ``correct``.

The program's outputs are judged against the plain reference that the
configuration file names under ``"reference"``: a module of
``benchmark/reference/``, ``navref`` where the file names none. It works
everything out again from the landscape, the route and the configuration
file, and every call the comparison makes to a reference goes through that
module:

- ``lib_err``: the library the program trained against the reference's,
  max |difference| / max |reference view|;
- ``pose_mismatch``: records of the sampled episodes (every agent, every
  step) whose pose is not one step of the reference's kinematics along the
  program's own chosen heading from the program's previous pose, whose
  distance to the route is not the reference's, or which moved after the
  agent had finished; and, from the first column in which every agent's
  record is done (where an early-exit loop stops writing), records that
  are neither that loop's untouched padding (every field 0, done) nor a
  done record that repeats the previous pose;
- ``status_mismatch``: agents whose finished flags or final status differ
  from the reference's stop rules along their trajectory (so a loop that
  stops while an agent is still running is caught by the padding's done
  flags), whose final pose is not their record in the column before that
  first all-done one (the last, where there is none), plus episodes whose
  success rate, as read on the host, is not the share of agents that
  reached the goal;
- ``fam_err`` and ``decision_gap``: at a sample of poses drawn from the
  seed among the steps that agents took, the reference computes every
  candidate heading's familiarity in float64 from the program's previous
  pose. ``fam_err`` is the widest |program's familiarity - reference's| at
  the program's chosen heading, ``decision_gap`` the widest amount by which
  the reference's familiarity at that heading lies above the reference's
  best; both over the reference's ``scale`` at that pose (navref's: the
  candidate view's squared norm plus the largest stored view's, the
  magnitude of an SSD's terms and so the scale of its float rounding).

The reference follows the program step by step from the program's own
previous pose: a trajectory that branched at a near-tie would otherwise be
compared with another trajectory. The start of each trajectory is the
harness's own trials, and every step's pose is checked against the
reference's kinematics, so the chain is checked link by link.

The control (``control=True``) reads, at the same poses, the reference
computed in float32 in the program's place: the gap of the heading float32
puts first, and its familiarity's error there; and the library trained
from an fp8 panorama (navref pools it in place of a bf16 one).
"""

from __future__ import annotations

import dataclasses
import importlib
import re

import numpy as np
import torch

POSE_TOL = 1e-3  # world units: a float32 step of a pose far below a fine bin's 0.017 rad
THETA_TOL = 1e-4  # rad
STATUS_BAND = 1e-3  # world units round a stop threshold where float32 may decide either way


@dataclasses.dataclass
class Episode:
    """One episode as the program returned it, with the trials it was given."""

    starts: np.ndarray  # f32[B, 2]
    thetas: np.ndarray  # f32[B]
    final: tuple  # (xy, theta, done, status)
    rec: tuple  # (xy, theta, fam, k, dist_route, done), each [B, T, ...]
    success: float  # the success rate as read on the host


def reference_of(config: dict):
    """The reference module the configuration names (``navref`` by
    default), from ``benchmark/reference/``."""
    name = config.get("reference", "navref")
    if not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", name):
        raise ValueError(f"reference {name!r} is not a module name")
    return importlib.import_module(f"reference.{name}")


def _trajectory_checks(ref, spec, route_t, hw, ep: Episode, dev):
    """(pose mismatches, status mismatches, ambiguous agents, active poses)
    of one episode; the active poses are (prev xy, prev theta, k, fam) of
    every step an agent took."""
    r_xy, r_th, r_fam, r_k, r_dist, r_done = (t.to(dev) for t in ep.rec)
    f_xy, f_th, f_done, f_status = (t.to(dev) for t in ep.final)
    b, t_max = r_th.shape
    xy0 = torch.from_numpy(ep.starts).to(dev)
    th0 = torch.from_numpy(ep.thetas).to(dev)
    prev_xy = torch.cat([xy0[:, None], r_xy[:, :-1]], dim=1)
    prev_th = torch.cat([th0[:, None], r_th[:, :-1]], dim=1)
    act = ~r_done
    k = r_k.long()
    bad = (k < 0) | (k >= spec.n_headings)
    xy_new, th_new = ref.advance(prev_xy.reshape(-1, 2), prev_th.reshape(-1),
                                 k.clamp(0, spec.n_headings - 1).reshape(-1), spec)
    dxy = (r_xy.double().reshape(-1, 2) - xy_new).abs().amax(dim=1).reshape(b, t_max)
    dth = (r_th.double().reshape(-1) - th_new).abs().reshape(b, t_max)
    dist = ref.polyline_dist(r_xy.double().reshape(-1, 2), route_t).reshape(b, t_max)
    ddist = (r_dist.double() - dist).abs()
    bad |= act & ((dxy > POSE_TOL) | (dth > THETA_TOL) | (ddist > POSE_TOL))
    # e: how far the loop ran, the first column in which every record is done
    every_done = r_done.all(dim=0)
    e = int(every_done.long().argmax()) if bool(every_done.any()) else t_max
    repeats = r_done & (r_xy == prev_xy).all(dim=2) & (r_th == prev_th)
    padding = (r_done & (r_xy == 0).all(dim=2) & (r_th == 0) & (r_fam == 0) & (r_k == 0)
               & (r_dist == 0))
    tail = torch.arange(t_max, device=dev) >= e
    bad |= torch.where(tail, ~(padding | repeats), r_done & ~repeats)
    pose_mismatch = int(bad.sum())

    status, amb = ref.stop_status(r_xy.double().reshape(-1, 2), route_t, hw, spec,
                                  STATUS_BAND)
    status, amb = status.reshape(b, t_max), amb.reshape(b, t_max)
    stops = act & (status != ref.STATUS_RUNNING)
    done_after = torch.cumsum(stops.long(), dim=1) > 0  # finished after step t
    expect_done = torch.cat([torch.zeros_like(done_after[:, :1]), done_after[:, :-1]], dim=1)
    first = torch.where(stops.any(dim=1), stops.long().argmax(dim=1), 0)
    ref_status = torch.where(stops.any(dim=1), status.gather(1, first[:, None])[:, 0], 0)
    ambiguous = (amb & act).any(dim=1)
    agent_bad = ((r_done != expect_done).any(dim=1)
                 | (f_status.long() != ref_status)
                 | (f_done != (ref_status != ref.STATUS_RUNNING))
                 | (f_xy != torch.cat([xy0[:, None], r_xy], dim=1)[:, e]).any(dim=1)
                 | (f_th != torch.cat([th0[:, None], r_th], dim=1)[:, e]))
    status_mismatch = int((agent_bad & ~ambiguous).sum())
    reached = float((f_status == ref.STATUS_REACHED).float().mean())
    if abs(ep.success - reached) > 1e-6:
        status_mismatch += 1
    poses = (prev_xy[act], prev_th[act], k[act], r_fam[act])
    return pose_mismatch, status_mismatch, int(ambiguous.sum()), poses


def judge(config: dict, landscape: torch.Tensor, route: np.ndarray, spacing: float,
          program_library: torch.Tensor, episodes: list[Episode], seed: int,
          n_poses: int, control: bool = False) -> dict:
    """The compared numbers of a run (and, with ``control``, the control's
    readings of ``lib_err``, ``fam_err`` and ``decision_gap`` under names
    ending in ``_control``)."""
    dev = landscape.device
    ref = reference_of(config)
    spec = ref.spec_from_config(config)
    route_t = torch.from_numpy(np.asarray(route, np.float64)).to(dev)
    hw = tuple(landscape.shape)
    lib = ref.train_library(landscape, route, spacing, spec)
    ref_scale = float(lib.abs().max())
    out = {"lib_err": float((program_library.to(dev).double() - lib).abs().max()) / ref_scale}

    counts, parts = np.zeros(3, dtype=np.int64), []
    for ep in episodes:
        *found, poses = _trajectory_checks(ref, spec, route_t, hw, ep, dev)
        counts += found
        parts.append(poses)
    out.update(pose_mismatch=int(counts[0]), status_mismatch=int(counts[1]),
               status_ambiguous=int(counts[2]))

    xy, th, k, fam = (torch.cat(p) for p in zip(*parts))
    n = xy.shape[0]
    pick = np.sort(np.random.default_rng([int(seed), 3]).choice(n, size=min(n_poses, n),
                                                                 replace=False))
    pick_t = torch.from_numpy(pick).to(dev)
    xy, th, k, fam = xy[pick_t], th[pick_t], k[pick_t], fam[pick_t]
    s = ref.candidate_panorama(landscape, xy, th, spec)
    e = ref.scale(s, lib, spec)
    f64 = ref.familiarity_blocked(s, lib, spec)
    best = f64.min(dim=1).values
    at_k = f64.gather(1, k[:, None])[:, 0]
    out["fam_err"] = float(((fam.double() - at_k).abs() / e).max())
    out["decision_gap"] = float(((at_k - best) / e).max())
    out["poses_compared"] = int(pick.size)
    if control:
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            f32 = ref.familiarity_blocked(s, lib, spec, torch.float32).double()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        k32 = ref.choose(f32, spec)
        at_k32 = f64.gather(1, k32[:, None])[:, 0]
        out["fam_err_control"] = float(((f32.gather(1, k32[:, None])[:, 0] - at_k32).abs()
                                        / e).max())
        out["decision_gap_control"] = float(((at_k32 - best) / e).max())
        lib8 = ref.train_library(landscape, route, spacing, spec, torch.float8_e4m3fn)
        out["lib_err_control"] = float((lib8 - lib).abs().max()) / ref_scale
    return out


COMPARED = ("lib_err", "pose_mismatch", "status_mismatch", "fam_err", "decision_gap")


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every compared number at or
    below its limit."""
    checks = {name: {"value": numbers[name], "limit": limits[name]}
              for name in COMPARED + tuple(n for n in limits if n not in COMPARED)}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
