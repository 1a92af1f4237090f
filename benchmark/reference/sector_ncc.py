"""Plain reference of BASELINE config 3 (64x360 NCC views, a rotation
tolerance, the sector renderer), in PyTorch and NumPy, for judging what the
program produced.

It imports neither the program nor JAX and takes nothing the program has
made. Like :mod:`reference.navref`, whose route, kinematics, decision and
stop rules it re-exports, it follows the rounding class the configuration
states where that class is part of the definition, and float64 elsewhere:

- the sensor at recall: the sector renderer's own sample points. The
  heading splits as ``theta = k bw + phi`` with ``k = round(theta / bw)``
  (half to even) mod A and ``phi = theta - k bw`` in float32; the window's
  corner and the in-window position are taken in float32 on the landscape
  edge-replicated by ``pad = max(0, half - floor(r_max - drift) + 1)``
  cells (``half`` the window's half side, ``drift = max(2, step_size)``);
  window values and hat weights are rounded to bf16 and the products summed
  in float32; the phi-frame panorama is then rolled by k to the true
  heading. Rendering at theta directly would move the sample points by
  float rounding, and a bf16 hat weight would then round the other way;
- the training library: as navref, the float32 exact-hat panorama at the
  route's float32 poses (at ``az_upsample = 1`` the view is the panorama);
- NCC familiarity at lag l, for a candidate panorama x and each stored
  view v: ``d = 1 - (C_fc(x, z_v)[l] - mu sum(z_v)) / (sigma P)``. x's mean
  mu and ``sigma = sqrt(var + 1e-8)`` are taken in float64 over the full
  circle (every candidate of a u = 1 panorama holds all of its pixels).
  ``z_v`` is view v z-scored in float32 with the same epsilon: the
  library's rounding class as the configuration takes it, the counterpart
  of navref's float32 library norm. ``C_fc`` is the cyclic
  cross-correlation over azimuth summed over rings, truncated to the first
  ``spectral_cutoff`` DFT bins (the truncated series the configuration
  ships), the DC bin exact, computed by ``torch.fft`` in float64;
- a heading's familiarity: the minimum over the views, then over the
  ``2 tol_bins + 1`` lags ``s_k + delta`` of its tolerance window;
- the scale of ``fam_err`` and ``decision_gap`` is 1: NCC distances have no
  units, and lie in [0, 2].

The control (``dtype=torch.float32``) computes the familiarity in float32,
with TF32 off, and rounds the stored views' panorama to ``pool_dtype``
(fp8) at ``az_upsample = 1`` too.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from reference.navref import (  # noqa: F401  (the route, kinematics, decision and stop rules)
    STATUS_DIVERGED,
    STATUS_OFF,
    STATUS_REACHED,
    STATUS_RUNNING,
    Spec,
    advance,
    choose,
    polar_samples,
    polyline_dist,
    read_spec,
    render_sensor as render_exact_frame,
    resample_route,
    stop_status,
    window_size,
)

NCC_EPS = 1e-8


def spec_from_config(config: dict) -> Spec:
    spec = read_spec(config)
    sensor = config["sim"]["sensor"]
    if spec.metric != "ncc" or spec.az_upsample != 1 or sensor["render_mode"] != "sector":
        raise ValueError("sector_ncc covers NCC at az_upsample 1 on the sector renderer")
    return spec


def pad_of(spec: Spec) -> int:
    """The sector renderer's edge pad: the footprint's overhang of the
    window's half side less the margin an agent keeps from the edge."""
    drift = max(2.0, spec.step_size)
    return max(0, window_size(spec) // 2 - int(np.floor(spec.r_max - drift)) + 1)


def render_sensor(landscape: torch.Tensor, xy: torch.Tensor, theta: torch.Tensor,
                  spec: Spec) -> torch.Tensor:
    """The recall sensor's true-heading panorama f32[N, R, A], from f32
    poses, at the sector renderer's sample points."""
    land = landscape.float()
    h, w = land.shape
    wsz = window_size(spec)
    half, pad = wsz // 2, pad_of(spec)
    xy, theta = xy.float(), theta.float()
    bw = spec.bin_width
    kf = torch.round(theta / bw)
    phi = theta - kf * bw
    k = kf.to(torch.int32) % spec.n_fine
    bx = (torch.floor(xy[:, 0]).to(torch.int32) + (pad - half)).clamp(0, w + 2 * pad - wsz)
    by = (torch.floor(xy[:, 1]).to(torch.int32) + (pad - half)).clamp(0, h + 2 * pad - wsz)
    fx = ((xy[:, 0] + pad) - bx.float())[:, None, None]
    fy = ((xy[:, 1] + pad) - by.float())[:, None, None]
    c, s = torch.cos(phi)[:, None, None], torch.sin(phi)[:, None, None]
    pano_phi = polar_samples(land, bx, by, fx, fy, c, s, spec, pad)
    a = spec.n_fine
    cols = (torch.arange(a, device=land.device)[None, :] + k.long()[:, None]) % a  # [N, A]
    return pano_phi.gather(2, cols[:, None, :].expand(-1, spec.n_radial, -1))


def candidate_panorama(landscape: torch.Tensor, xy: torch.Tensor, theta: torch.Tensor,
                       spec: Spec) -> torch.Tensor:
    """What :func:`familiarity` scores at each pose: the true-heading
    panorama f64[N, R, A] (at u = 1 the pooled panorama is the panorama)."""
    return render_sensor(landscape, xy, theta, spec).double()


def train_library(landscape: torch.Tensor, route: np.ndarray, spacing: float,
                  spec: Spec, pool_dtype: torch.dtype | None = None) -> torch.Tensor:
    """One view f64[Nl, R, W] per resampled route point: the float32
    bilinear panorama (exact hat weights) at the float32 pose, rounded to
    ``pool_dtype`` where given (the control's fp8)."""
    pts, headings = resample_route(np.asarray(route, np.float64), spacing)
    dev = landscape.device
    pano = render_exact_frame(landscape, torch.from_numpy(pts.astype(np.float32)).to(dev),
                              torch.from_numpy(headings.astype(np.float32)).to(dev),
                              dataclasses.replace(spec, hat_dtype="float32"))
    if pool_dtype is not None:
        pano = pano.to(pool_dtype).float()
    return pano.double()


def zscored(lib: torch.Tensor) -> torch.Tensor:
    """Each stored view z-scored over its P pixels in float32, f32[Nl, P]."""
    v = lib.float().reshape(lib.shape[0], -1)
    m = v.mean(dim=-1, keepdim=True)
    var = ((v - m) ** 2).mean(dim=-1, keepdim=True)
    return (v - m) / torch.sqrt(var + NCC_EPS)


def scale(s: torch.Tensor, lib: torch.Tensor, spec: Spec) -> torch.Tensor:
    """1 at each pose: NCC distances have no units."""
    return torch.ones(s.shape[0], dtype=torch.float64, device=s.device)


def familiarity(s: torch.Tensor, lib: torch.Tensor, spec: Spec,
                dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """fam[N, Nh] of every candidate heading from the panoramas S
    f64[N, R, A] against the library f64[Nl, R, W], computed in ``dtype``
    (float64 for the reference; float32, with TF32 off, for the control)."""
    a, p = spec.n_fine, spec.n_pixels
    x = s.to(dtype)
    mu = x.mean(dim=(1, 2))
    var = ((x - mu[:, None, None]) ** 2).mean(dim=(1, 2))
    sigma = torch.sqrt(var + NCC_EPS)
    z = zscored(lib).to(dtype).reshape(lib.shape[0], spec.n_radial, a)
    fc = a // 2 + 1
    if spec.familiarity == "fft" and spec.spectral_cutoff:
        fc = spec.spectral_cutoff
    xf = torch.fft.rfft(x, dim=-1)[..., :fc]  # [N, R, fc]
    zf = torch.fft.rfft(z, dim=-1)[..., :fc]  # [Nl, R, fc]
    cross = torch.fft.irfft(torch.einsum("nrf,vrf->nvf", xf, zf.conj()), n=a, dim=-1)
    d = 1.0 - (cross - mu[:, None, None] * z.sum(dim=(1, 2))[None, :, None]) \
        / (sigma * p)[:, None, None]  # [N, Nl, A]: every lag
    m = d.min(dim=1).values  # [N, A]
    deltas = np.arange(-spec.tol_bins, spec.tol_bins + 1)
    lags = (spec.shifts()[:, None] + deltas[None, :]) % a  # [Nh, 2 tol + 1]: each window
    return m[:, torch.as_tensor(lags, device=s.device)].min(dim=2).values


def familiarity_blocked(s: torch.Tensor, lib: torch.Tensor, spec: Spec,
                        dtype: torch.dtype = torch.float64, block: int = 256) -> torch.Tensor:
    """:func:`familiarity` in blocks of ``block`` panoramas (bounded memory)."""
    return torch.cat([familiarity(s[i:i + block], lib, spec, dtype)
                      for i in range(0, s.shape[0], block)])
