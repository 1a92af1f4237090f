"""The step's decision (kernel ``csrc/decide.cu``): tie-ordered argmin over
the pooled familiarity, kinematics, distance to the route and stop rules.

Replaces no TPU kernel: in the JAX package XLA fuses this tail of the step
into the scan. :func:`decide_plain` is about 47 small PyTorch kernels a
step, each touching at most B x Nh floats, so on the card the stage would
be spent launching them; the kernel does it in one launch with the same
float32 operations, each rounded on its own, and equals
:func:`decide_plain` bit for bit.

Status codes: 0 = running/budget, 1 = reached, 2 = diverged, 3 = off-landscape.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from navdv_torch import _build
from navdv_torch.config import SimConfig

STATUS_RUNNING = 0
STATUS_REACHED = 1
STATUS_DIVERGED = 2
STATUS_OFF = 3


class DecideConstants(NamedTuple):
    """What the decision reads besides the agents, their familiarity and the
    route: fixed per configuration."""

    shifts: torch.Tensor  # f32[Nh] candidate heading shifts, in bins
    tie_order: torch.Tensor  # i32[Nh] candidates by smallest |shift|, then lowest index
    binw: float  # radians per bin
    step_size: float
    goal_radius: float
    corridor: float
    margin: float  # the sensor's reach: poses closer to the edge are off


def decide_constants(cfg: SimConfig, device) -> DecideConstants:
    """The decision's constants of configuration ``cfg`` on ``device``."""
    return DecideConstants(
        shifts=torch.as_tensor(cfg.scan.shifts(), dtype=torch.float32, device=device),
        tie_order=torch.as_tensor(cfg.scan.tie_order(), dtype=torch.int32, device=device),
        binw=cfg.sensor.bin_width, step_size=cfg.agent.step_size,
        goal_radius=cfg.agent.goal_radius, corridor=cfg.agent.corridor, margin=cfg.sensor.r_max,
    )


class Route(NamedTuple):
    """The training route as segments (``agent.EpisodeStatics``' fields)."""

    a: torch.Tensor  # f32[Nseg, 2] segment starts
    ab: torch.Tensor  # f32[Nseg, 2] segment vectors
    denom: torch.Tensor  # f32[Nseg] |ab|^2 (clamped)
    goal: torch.Tensor  # f32[2]


class Decision(NamedTuple):
    """The agents after the step, and what the step records."""

    xy: torch.Tensor  # f32[B, 2]
    theta: torch.Tensor  # f32[B]
    done: torch.Tensor  # bool[B]
    status: torch.Tensor  # i32[B]
    fam: torch.Tensor  # f32[B] the chosen candidate's familiarity
    k: torch.Tensor  # i32[B] the chosen candidate
    dist_route: torch.Tensor  # f32[B] distance to the route after the move


def point_to_polyline_dist(p: torch.Tensor, route: Route) -> torch.Tensor:
    """Min point-to-segment distance from each p f32[B, 2] to the training
    route -> f32[B]."""
    rel = p[:, None, :] - route.a  # [B, Nseg, 2]
    t = (torch.sum(rel * route.ab, dim=2) / route.denom).clamp(0.0, 1.0)
    proj = route.a + t[:, :, None] * route.ab
    return torch.sqrt(torch.min(torch.sum((p[:, None, :] - proj) ** 2, dim=2), dim=1).values)


def decide_plain(xy: torch.Tensor, theta: torch.Tensor, done: torch.Tensor,
                 status: torch.Tensor, fam: torch.Tensor, route: Route,
                 land_shape: tuple[int, int], c: DecideConstants) -> Decision:
    """Plain PyTorch version; every argument as :func:`decide` takes it."""
    tie_order = c.tie_order.long()
    # ties -> smallest |shift|, then lowest index: argmin (first minimum)
    # over the tie-order permutation implements the rule exactly
    k = tie_order[torch.argmin(fam[:, tie_order], dim=1)]
    theta_new = theta + c.shifts[k] * c.binw
    xy_new = xy + c.step_size * torch.stack([torch.cos(theta_new), torch.sin(theta_new)], dim=1)

    reached = torch.sum((xy_new - route.goal) ** 2, dim=1) <= c.goal_radius**2
    dist_route = point_to_polyline_dist(xy_new, route)
    diverged = dist_route > c.corridor
    hl, wl = land_shape
    margin = c.margin
    x, y = xy_new[:, 0], xy_new[:, 1]
    off = ~((x >= margin) & (x <= wl - 1 - margin) & (y >= margin) & (y <= hl - 1 - margin))
    # priority: reached > diverged > off
    new_status = torch.where(
        reached,
        STATUS_REACHED,
        torch.where(diverged, STATUS_DIVERGED, torch.where(off, STATUS_OFF, STATUS_RUNNING)),
    ).to(torch.int32)

    return Decision(
        xy=torch.where(done[:, None], xy, xy_new),
        theta=torch.where(done, theta, theta_new),
        done=done | (new_status != STATUS_RUNNING),
        status=torch.where(done, status, new_status),
        fam=torch.gather(fam, 1, k[:, None])[:, 0],
        k=k.to(torch.int32),
        dist_route=dist_route,
    )


def _check(xy, theta, done, status, fam, route, c):
    b = theta.shape[0] if theta.dim() == 1 else -1
    want = (("xy", xy, torch.float32, (b, 2)), ("theta", theta, torch.float32, (b,)),
            ("done", done, torch.bool, (b,)), ("status", status, torch.int32, (b,)))
    for name, t, dtype, shape in want:
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"decide: {name} must be {dtype}{list(shape)} for a batch of "
                             f"B agents; got {t.dtype}{list(t.shape)}")
    nh = c.shifts.shape[0]
    if fam.dtype != torch.float32 or tuple(fam.shape) != (b, nh) or nh == 0:
        raise ValueError(f"decide: fam must be float32[B, Nh] with Nh = {nh} candidates; "
                         f"got {fam.dtype}{list(fam.shape)}")
    if c.shifts.dtype != torch.float32 or c.shifts.dim() != 1:
        raise ValueError("decide: shifts must be f32[Nh]")
    if c.tie_order.dtype != torch.int32 or tuple(c.tie_order.shape) != (nh,):
        raise ValueError("decide: tie_order must be i32[Nh]")
    n_seg = route.a.shape[0]
    for name, t, shape in (("route_a", route.a, (n_seg, 2)), ("route_ab", route.ab, (n_seg, 2)),
                           ("route_denom", route.denom, (n_seg,)), ("goal", route.goal, (2,))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"decide: {name} must be float32{list(shape)}; "
                             f"got {t.dtype}{list(t.shape)}")
    if n_seg == 0:
        raise ValueError("decide: the route has no segment")
    devs = {t.device for t in (xy, theta, done, status, fam, c.shifts, c.tie_order, *route)}
    if len(devs) != 1:
        raise ValueError(f"decide: tensors on different devices {devs}")


def decide(xy: torch.Tensor, theta: torch.Tensor, done: torch.Tensor, status: torch.Tensor,
           fam: torch.Tensor, route: Route, land_shape: tuple[int, int],
           c: DecideConstants) -> Decision:
    """``(xy f32[B, 2], theta f32[B], done bool[B], status i32[B], fam
    f32[B, Nh], route, (Hl, Wl), constants) -> Decision``: agents already
    done keep their pose and status; the record's ``dist_route`` is the
    moved pose's either way. Nothing is written in place."""
    _check(xy, theta, done, status, fam, route, c)
    dev = fam.device
    if dev.type == "cpu":
        return decide_plain(xy, theta, done, status, fam, route, land_shape, c)
    if dev.type != "cuda":
        raise ValueError(f"decide: unsupported device {dev}")
    fn = _build.load_function("decide", "navdv_decide", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, ctypes.c_float,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ])
    xy, theta, done, status, fam = (t.contiguous() for t in (xy, theta, done, status, fam))
    route = Route(*(t.contiguous() for t in route))
    shifts, tie_order = c.shifts.contiguous(), c.tie_order.contiguous()
    b, nh = fam.shape
    out = Decision(
        xy=torch.empty((b, 2), dtype=torch.float32, device=dev),
        theta=torch.empty((b,), dtype=torch.float32, device=dev),
        done=torch.empty((b,), dtype=torch.bool, device=dev),
        status=torch.empty((b,), dtype=torch.int32, device=dev),
        fam=torch.empty((b,), dtype=torch.float32, device=dev),
        k=torch.empty((b,), dtype=torch.int32, device=dev),
        dist_route=torch.empty((b,), dtype=torch.float32, device=dev),
    )
    # each Python scalar rounded to float32 after its double arithmetic, as
    # PyTorch casts a wrapped scalar to the tensor's type
    hl, wl = land_shape
    scalars = (c.binw, c.step_size, c.goal_radius**2, c.corridor, c.margin,
               wl - 1 - c.margin, hl - 1 - c.margin)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(fam.data_ptr(), xy.data_ptr(), theta.data_ptr(), done.data_ptr(),
                  status.data_ptr(), shifts.data_ptr(), tie_order.data_ptr(),
                  route.a.data_ptr(), route.ab.data_ptr(), route.denom.data_ptr(),
                  route.goal.data_ptr(), b, nh, route.a.shape[0], *scalars,
                  *(t.data_ptr() for t in out), stream)
    decide.launches += 1
    _build.check_launch("decide", code)
    return out


decide.launches = 0
