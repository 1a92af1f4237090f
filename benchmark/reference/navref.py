"""Plain reference of scene-familiarity navigation (Baddeley et al. 2012),
in PyTorch and NumPy, for judging what the program produced.

It imports neither the program nor JAX and takes nothing the program has
made: it renders its own library from the landscape, builds its own sample
offsets, shift tables and tie order from the configuration file, and
computes the familiarity of every candidate heading in float64 (or, for the
control, in float32). It follows the rounding class the configuration
states where that class is part of the definition, and float64 elsewhere:

- the training library: one view per resampled route point at its float32
  pose, the float32 bilinear panorama (exact hat weights) mean-pooled over
  ``az_upsample`` fine bins, the panorama rounded to bf16 before the pooling
  when ``hat_dtype`` is ``bfloat16``, the view stored as ``fl32(S / u)``;
- the sensor at recall: the polar panorama in the bfloat16 rounding class
  when ``hat_dtype`` is ``bfloat16``: window values and hat weights rounded
  to bf16, products summed in float32, positions taken in the frame of the
  ``ceil(2 r_max) + 4`` square window round the agent;
- the pooled panorama S: the bf16-rounded panorama summed over ``u`` fine
  bins (exact), or with a ``float32`` hat the float32 panorama's taps added
  left to right in float32 (the class's own rounding), a candidate's pixels
  ``fl32(S / u)`` at the pooled columns ``w u + s`` for shift s;
- familiarity at shift s: the minimum over the library of the SSD between
  the candidate and each stored view, in float64 from those float32 values,
  with each stored view's squared norm summed in float32 (the library term
  the configuration takes); with ``spectral_cutoff = fc`` the cross term
  keeps only the first fc bins of the azimuth DFT (the truncated series the
  configuration ships), computed here by ``torch.fft``; distances clamp at 0;
- the decision: the tie-ordered argmin (smallest |shift| first, then the
  lowest index), one step along the new heading, and the stop rules
  (reached > diverged > off the landscape), with finished agents frozen;
- the scale of ``fam_err`` and ``decision_gap`` (:func:`scale`): the
  candidate view's squared norm plus the largest stored view's, the
  magnitude of an SSD's terms and so the scale of its float rounding.

A configuration file names the reference that judges it under
``"reference"`` (this module where it names none). Every reference module
gives the comparison (``harness/check.py``) these names: ``spec_from_config``,
``train_library``, ``candidate_panorama``, ``scale``, ``familiarity_blocked``,
``choose``, ``advance``, ``polyline_dist``, ``stop_status`` and the
``STATUS_*`` codes.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Spec:
    """The parts of a configuration file the reference reads."""

    n_radial: int
    n_azimuth: int
    az_upsample: int
    r_min: float
    r_max: float
    hat_dtype: str
    n_headings: int
    scan_step_bins: int
    metric: str
    tol_bins: int
    spectral_cutoff: int
    familiarity: str  # "fft" (truncated spectral series) or "exact"
    step_size: float
    goal_radius: float
    corridor: float
    max_steps: int

    @property
    def n_fine(self) -> int:
        return self.n_azimuth * self.az_upsample

    @property
    def bin_width(self) -> float:
        return 2.0 * math.pi / self.n_fine

    @property
    def n_pixels(self) -> int:
        return self.n_radial * self.n_azimuth

    def shifts(self) -> np.ndarray:
        half = self.n_headings // 2
        return np.array([(k - half) * self.scan_step_bins for k in range(self.n_headings)])

    def tie_order(self) -> np.ndarray:
        s = self.shifts()
        return np.array(sorted(range(self.n_headings), key=lambda k: (abs(int(s[k])), k)))


def read_spec(config: dict) -> Spec:
    """The configuration file's :class:`Spec`, whatever its metric."""
    sensor, scan, agent = config["sim"]["sensor"], config["sim"]["scan"], config["sim"]["agent"]
    return Spec(
        n_radial=sensor["n_radial"], n_azimuth=sensor["n_azimuth"],
        az_upsample=sensor["az_upsample"], r_min=sensor["r_min"], r_max=sensor["r_max"],
        hat_dtype=sensor["hat_dtype"], n_headings=scan["n_headings"],
        scan_step_bins=scan["scan_step_bins"], metric=scan["metric"],
        tol_bins=scan["tol_bins"], spectral_cutoff=scan["spectral_cutoff"],
        familiarity=config["familiarity"], step_size=agent["step_size"],
        goal_radius=agent["goal_radius"], corridor=agent["corridor"],
        max_steps=agent["max_steps"],
    )


def spec_from_config(config: dict) -> Spec:
    spec = read_spec(config)
    if spec.metric != "ssd" or spec.tol_bins != 0:
        raise ValueError("the reference covers SSD without a rotation tolerance")
    return spec


# --- route -------------------------------------------------------------------

def resample_route(route: np.ndarray, spacing: float) -> tuple[np.ndarray, np.ndarray]:
    """Arc-length resampling of the route polyline: (points, tangent headings)."""
    seg = np.diff(route, axis=0)
    seglen = np.hypot(seg[:, 0], seg[:, 1])
    cum = np.concatenate([[0.0], np.cumsum(seglen)])
    n = max(int(np.floor(cum[-1] / spacing)) + 1, 2)
    targets = np.arange(n) * spacing
    targets = targets[targets <= cum[-1] + 1e-9]
    pts = np.empty((len(targets), 2))
    for i, t in enumerate(targets):
        j = min(np.searchsorted(cum, t, side="right") - 1, len(seglen) - 1)
        pts[i] = route[j] + (t - cum[j]) / max(seglen[j], 1e-12) * seg[j]
    tan = np.diff(pts, axis=0)
    headings = np.arctan2(tan[:, 1], tan[:, 0])
    headings = np.concatenate([headings, headings[-1:]])
    return pts, headings[: len(pts)]


def polyline_dist(p: torch.Tensor, route: torch.Tensor) -> torch.Tensor:
    """Distance from each point f64[N, 2] to the route polyline f64[S, 2]."""
    a, ab = route[:-1], route[1:] - route[:-1]
    denom = (ab * ab).sum(dim=1).clamp_min(1e-12)
    rel = p[:, None, :] - a
    t = ((rel * ab).sum(dim=2) / denom).clamp(0.0, 1.0)
    d = p[:, None, :] - (a + t[:, :, None] * ab)
    return torch.sqrt((d * d).sum(dim=2).min(dim=1).values)


# --- sensor ------------------------------------------------------------------

def offsets(spec: Spec) -> tuple[np.ndarray, np.ndarray]:
    """Heading-relative polar sample offsets f64[R, A]: column a looks along
    ``(a + 0.5) * bin_width - pi``, ring r at ``linspace(r_min, r_max)``."""
    alpha = (np.arange(spec.n_fine) + 0.5) * spec.bin_width - np.pi
    d = np.linspace(spec.r_min, spec.r_max, spec.n_radial)
    return d[:, None] * np.cos(alpha)[None, :], d[:, None] * np.sin(alpha)[None, :]


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def window_size(spec: Spec) -> int:
    """Side of the square window round the agent that holds its footprint."""
    return int(np.ceil(2 * spec.r_max)) + 4


def polar_samples(land: torch.Tensor, bx: torch.Tensor, by: torch.Tensor, fx: torch.Tensor,
                  fy: torch.Tensor, c: torch.Tensor, s: torch.Tensor, spec: Spec,
                  pad: int = 0) -> torch.Tensor:
    """The panorama f32[N, R, A] sampled, in the configuration's rounding
    class, in each pose's square window: corner (bx, by) i32[N] on the
    landscape edge-replicated by ``pad`` cells, in-window position (fx, fy)
    and rotation (c, s), each f32[N, 1, 1]. A sample at in-window (xs, ys)
    is ``(fx, fy) + Rot @ offsets``, clamped to the window, blended from its
    four taps by hat weights."""
    h, w = land.shape
    wsz = window_size(spec)
    dx0, dy0 = (torch.from_numpy(o.astype(np.float32)).to(land.device) for o in offsets(spec))
    xs = ((fx + c * dx0) - s * dy0).clamp(0.0, wsz - 1.0)
    ys = ((fy + s * dx0) + c * dy0).clamp(0.0, wsz - 1.0)
    x0 = torch.floor(xs).clamp(max=wsz - 2)
    y0 = torch.floor(ys).clamp(max=wsz - 2)

    def hat(t, q):
        return (1.0 - (t - q).abs()).clamp_min(0.0)

    wx0, wx1, wy0, wy1 = hat(xs, x0), hat(xs, x0 + 1.0), hat(ys, y0), hat(ys, y0 + 1.0)
    xi = bx.long()[:, None, None] + x0.long() - pad
    yi = by.long()[:, None, None] + y0.long() - pad
    if pad:  # the padded landscape's cell (y, x) is the landscape's nearest edge cell
        xi, xj = xi.clamp(0, w - 1), (xi + 1).clamp(0, w - 1)
        yi, yj = yi.clamp(0, h - 1), (yi + 1).clamp(0, h - 1)
    else:
        xj, yj = xi + 1, yi + 1
    v00, v01 = land[yi, xi], land[yi, xj]
    v10, v11 = land[yj, xi], land[yj, xj]
    if spec.hat_dtype == "bfloat16":
        wx0, wx1, wy0, wy1 = _bf16(wx0), _bf16(wx1), _bf16(wy0), _bf16(wy1)
        v00, v01, v10, v11 = _bf16(v00), _bf16(v01), _bf16(v10), _bf16(v11)
    elif spec.hat_dtype != "float32":
        raise ValueError(f"unknown hat_dtype {spec.hat_dtype!r}")
    return wy0 * (wx0 * v00 + wx1 * v01) + wy1 * (wx0 * v10 + wx1 * v11)


def render_sensor(landscape: torch.Tensor, xy: torch.Tensor, theta: torch.Tensor,
                  spec: Spec) -> torch.Tensor:
    """The recall sensor's panorama f32[N, R, A] in the configuration's
    rounding class, from f32 poses."""
    land = landscape.float()
    h, w = land.shape
    wsz = window_size(spec)
    half = wsz // 2
    xy, theta = xy.float(), theta.float()
    bx = (torch.floor(xy[:, 0]).to(torch.int32) - half).clamp(0, w - wsz)
    by = (torch.floor(xy[:, 1]).to(torch.int32) - half).clamp(0, h - wsz)
    fx = (xy[:, 0] - bx.float())[:, None, None]
    fy = (xy[:, 1] - by.float())[:, None, None]
    c, s = torch.cos(theta)[:, None, None], torch.sin(theta)[:, None, None]
    return polar_samples(land, bx, by, fx, fy, c, s, spec)


def _tap_sum(pano: torch.Tensor, u: int, in_f32: bool) -> torch.Tensor:
    """sum_{j < u} pano[..., (a + j) mod A] as float64: exact, or with
    ``in_f32`` added left to right in float32, ``((p_a + p_{a+1}) +
    p_{a+2}) + ...``."""
    p = pano.float() if in_f32 else pano.double()
    s = p
    for j in range(1, u):
        s = s + torch.roll(p, -j, dims=-1)
    return s.double()


def pooled(pano: torch.Tensor, spec: Spec) -> torch.Tensor:
    """S[..., r, a] = sum_{j < u} pano[..., r, (a + j) mod A] as float64: in
    the bf16 class the bf16-rounded panorama's exact sum; in the float32
    class the float32 sum of the taps left to right, the rounding of the
    class's pooled panorama (its u float32 terms do not add exactly)."""
    if spec.hat_dtype == "bfloat16" and spec.az_upsample > 1:
        pano = _bf16(pano)
    return _tap_sum(pano, spec.az_upsample, spec.hat_dtype == "float32")


def train_library(landscape: torch.Tensor, route: np.ndarray, spacing: float,
                  spec: Spec, pool_dtype: torch.dtype | None = None) -> torch.Tensor:
    """One view f64[Nl, R, W] per resampled route point: the float32
    bilinear panorama (exact hat weights) at the float32 pose, rounded, in
    the bf16 class, to ``pool_dtype`` (bf16; the control passes fp8) before
    it is pooled, and pooled as :func:`pooled` pools in its class."""
    pts, headings = resample_route(np.asarray(route, np.float64), spacing)
    dev = landscape.device
    pano = render_sensor(landscape, torch.from_numpy(pts.astype(np.float32)).to(dev),
                         torch.from_numpy(headings.astype(np.float32)).to(dev),
                         dataclasses.replace(spec, hat_dtype="float32"))
    if spec.hat_dtype == "bfloat16" and spec.az_upsample > 1:
        pano = pano.to(pool_dtype or torch.bfloat16)
    n = pano.shape[0]
    s = _tap_sum(pano, spec.az_upsample, spec.hat_dtype == "float32")
    view = s[:, :, ::spec.az_upsample].float() * (1.0 / spec.az_upsample)  # fl32(S / u)
    return view.double().reshape(n, spec.n_radial, spec.n_azimuth)


def candidate_panorama(landscape: torch.Tensor, xy: torch.Tensor, theta: torch.Tensor,
                       spec: Spec) -> torch.Tensor:
    """What :func:`familiarity` scores at each pose: the pooled panorama S
    f64[N, R, A] of the recall sensor."""
    return pooled(render_sensor(landscape, xy, theta, spec), spec)


# --- familiarity -------------------------------------------------------------

def scale(s: torch.Tensor, lib: torch.Tensor, spec: Spec) -> torch.Tensor:
    """The scale of the float rounding in an SSD at each pose, which divides
    ``fam_err`` and ``decision_gap``: the magnitude of its terms, the
    candidate view's squared norm (the sum of fl32(S / u)^2 over the
    panorama / u) plus the largest stored view's (as :func:`familiarity`
    sums it, in float32). The cross term of non-negative pixels is not
    negative, so an SSD is at most about that sum, and a familiarity
    rounded once to float32 reads at most about 2^-24 of it. The
    candidate's norm alone bounds nothing: where the candidate is dark and
    the nearest view is not, the SSD is several times the candidate's norm,
    and a correctly rounded float32 can read above 1e-7 of it."""
    x = (s.float() * (1.0 / spec.az_upsample)).double()
    z32 = lib.float().reshape(lib.shape[0], -1)
    lsq = (z32 * z32).sum(dim=1).double()
    return (x * x).sum(dim=(1, 2)) / spec.az_upsample + lsq.max()


def familiarity(s: torch.Tensor, lib: torch.Tensor, spec: Spec,
                dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """fam[N, Nh] of every candidate heading from the pooled panoramas
    S f64[N, R, A] against the library f64[Nl, R, W], computed in ``dtype``
    (float64 for the reference; float32, with TF32 off, for the control)."""
    u, w, a = spec.az_upsample, spec.n_azimuth, spec.n_fine
    n = s.shape[0]
    x = (s.float() * (1.0 / u)).to(dtype)  # the candidate pixels, fl32(S / u)
    z = lib.to(dtype)
    shifts = torch.as_tensor(spec.shifts(), device=s.device)
    z32 = lib.float().reshape(lib.shape[0], -1)
    lsq = (z32 * z32).sum(dim=1).to(dtype)  # [Nl], the library norm as an f32 sum
    res_sq = (x * x).reshape(n, spec.n_radial, w, u).sum(dim=(1, 2))  # [N, u]
    csq = res_sq[:, shifts % u]  # [N, Nh]: a candidate's pixels are one residue class
    if spec.familiarity == "fft":
        fc = spec.spectral_cutoff or (a // 2 + 1)
        z_up = torch.zeros((z.shape[0], spec.n_radial, a), dtype=dtype, device=s.device)
        z_up[:, :, ::u] = z
        xf = torch.fft.rfft(x, dim=-1)[..., :fc]  # [N, R, fc]
        zf = torch.fft.rfft(z_up, dim=-1)[..., :fc]  # [Nl, R, fc]
        prod = torch.einsum("nrf,vrf->nvf", xf, zf.conj())
        cross = torch.fft.irfft(prod, n=a, dim=-1)[..., shifts % a]  # [N, Nl, Nh]
        cross = cross.transpose(1, 2)
    elif spec.familiarity == "exact":
        cols = (torch.arange(w, device=s.device)[None, :] * u + shifts[:, None]) % a  # [Nh, W]
        cand = x[:, :, cols].permute(0, 2, 1, 3).reshape(n, spec.n_headings, -1)
        cross = cand @ z.reshape(z.shape[0], -1).T  # [N, Nh, Nl]
    else:
        raise ValueError(f"unknown familiarity {spec.familiarity!r}")
    d = csq[:, :, None] - 2.0 * cross + lsq[None, None, :]
    return d.min(dim=2).values.clamp_min(0.0)


def familiarity_blocked(s: torch.Tensor, lib: torch.Tensor, spec: Spec,
                        dtype: torch.dtype = torch.float64, block: int = 256) -> torch.Tensor:
    """:func:`familiarity` in blocks of ``block`` panoramas (bounded memory)."""
    return torch.cat([familiarity(s[i:i + block], lib, spec, dtype)
                      for i in range(0, s.shape[0], block)])


def choose(fam: torch.Tensor, spec: Spec) -> torch.Tensor:
    """The tie-ordered argmin: smallest |shift| first, then the lowest index."""
    order = torch.as_tensor(spec.tie_order(), device=fam.device)
    return order[torch.argmin(fam[:, order], dim=1)]


# --- kinematics and stop rules --------------------------------------------------

STATUS_RUNNING, STATUS_REACHED, STATUS_DIVERGED, STATUS_OFF = 0, 1, 2, 3


def advance(xy: torch.Tensor, theta: torch.Tensor, k: torch.Tensor,
            spec: Spec) -> tuple[torch.Tensor, torch.Tensor]:
    """One step along the chosen heading, in float64."""
    shifts = torch.as_tensor(spec.shifts(), dtype=torch.float64, device=xy.device)
    theta_new = theta.double() + shifts[k.long()] * spec.bin_width
    xy_new = xy.double() + spec.step_size * torch.stack(
        [torch.cos(theta_new), torch.sin(theta_new)], dim=-1)
    return xy_new, theta_new


def stop_status(xy: torch.Tensor, route: torch.Tensor, landscape_hw: tuple[int, int],
                spec: Spec, band: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(status i64[N], ambiguous bool[N]) after a step to ``xy`` f64[N, 2]:
    reached > diverged > off the landscape. ``ambiguous`` marks points within
    ``band`` of a threshold that decides the status, where float32 rounding
    may decide either way."""
    h, w = landscape_hw
    goal = route[-1]
    dg = torch.sqrt(((xy - goal) ** 2).sum(dim=1))
    reached = dg <= spec.goal_radius
    dr = polyline_dist(xy, route)
    diverged = dr > spec.corridor
    m = spec.r_max
    x, y = xy[:, 0], xy[:, 1]
    edge = torch.stack([x - m, (w - 1 - m) - x, y - m, (h - 1 - m) - y], dim=1).min(dim=1).values
    off = edge < 0
    status = torch.where(reached, STATUS_REACHED, torch.where(
        diverged, STATUS_DIVERGED, torch.where(off, STATUS_OFF, STATUS_RUNNING)))
    ambiguous = ((dg - spec.goal_radius).abs() <= band) | ((dr - spec.corridor).abs() <= band) \
        | (edge.abs() <= band)
    return status, ambiguous
