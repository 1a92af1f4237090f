"""Convolutional familiarity (``fam_impl="conv"``; opt-in, never picked by
``"auto"``): counterpart of the JAX package's ``familiarity_conv.py``.

The cross term ``sum_{r,w} S[r, w*u + s] * lib[v, r, w]`` over every scan
lag s is a 1D valid convolution over azimuth: split the pooled panorama S
by azimuth residue j = s mod u into ``T[j, r, w] = S[r, w*u + j] / u``,
extend it over the range of q = s // u, and one convolution ([B*u, R,
width] against [Nl, R, W]) gives every (j, q) lag.

The JAX package runs it as ``lax.conv_general_dilated``. On the H100 an
fp64 ``conv1d`` of config 4's shapes takes 2.29 ms, and the same
contraction as one fp64 product over an unfold of the signal 0.87 ms
(``chip_smoke.py`` conv phase, NVIDIA H100 80GB HBM3, 700.00 W), so the
port forms the unfold and one product: ``[B*u*qrange, R*W] @ [R*W, Nl]``
(:func:`unfold_contraction`).
The SSD candidate norms (the JAX ones-filter convolution of T^2) are the
window sums of T^2 summed over the rings.

Numerics (ROADMAP C.7): T is built from ``fl32(S / u)``, the fp32 values
the min-distance kernel scores (``sensor.make_views_from_pooled``), and
only then widened to fp64; the product, the norms and the distances are
fp64 (ROADMAP C.1). NCC takes mean and spread from the step's lag
statistics of the pooled panorama in fp64, as the plain NCC path does. The
path then equals the port's ``"plain"`` path up to fp64 summation order.
Like every other path, it scores the step's pooled panorama and returns the
per-lag minima; the step pools them.
"""

from __future__ import annotations

import numpy as np
import torch

from navdv_torch.config import ScanConfig, SensorConfig
from navdv_torch.device import resolve_device
from navdv_torch.familiarity import NCC_EPS, PAD_PENALTY, LibraryPack
from navdv_torch.sensor import scan_lag_sets


def conv_lag_geometry(sensor: SensorConfig, scan: ScanConfig):
    """Static mapping from scan lags to the (j, q) conv output grid:
    ``(lags, window_idx, qmin, qrange, lag_rows)``, lag i at row
    ``lag_rows[i]`` of the flattened [u, qrange] grid."""
    u = sensor.az_upsample
    lags, window_idx = scan_lag_sets(scan)
    qs = lags // u  # floor division (works for negative lags)
    js = lags - qs * u  # in [0, u)
    qmin, qmax = int(qs.min()), int(qs.max())
    qrange = qmax - qmin + 1
    lag_rows = (js * qrange + (qs - qmin)).astype(np.int32)
    return lags, window_idx, qmin, qrange, lag_rows


def unfold_contraction(lhs: torch.Tensor, rhs: torch.Tensor, w: int) -> torch.Tensor:
    """The valid convolution of ``lhs f64[N, R, width]`` with the filters
    ``rhs f64[O, R*W]`` (each an [R, W] filter, flattened) as one product
    over the unfolded windows: ``-> f64[N, width - W + 1, O]``."""
    n, r, width = lhs.shape
    q = width - w + 1
    rows = lhs.unfold(2, w, 1).permute(0, 2, 1, 3).reshape(n * q, r * w)  # [N*q, R*W]
    return (rows @ rhs.T).view(n, q, -1)


def make_lib_min_conv(sensor: SensorConfig, scan: ScanConfig, device=None):
    """Per-lag library minimum ``lib_min(s f32[B, R, A], lib, lag_sum,
    lag_sq, aux=None) -> M f32[B, L]`` at ``scan_lag_sets``' lags: the
    step's pooled panorama in, with NCC the step's lag statistics of it
    (f64[B, L] each); no prepare stage, ``aux`` unread."""
    if scan.metric not in ("ssd", "ncc"):
        raise ValueError(f"unknown familiarity metric {scan.metric!r}")
    dev = resolve_device(device)
    u, r, w = sensor.az_upsample, sensor.n_radial, sensor.n_azimuth
    a = sensor.n_fine
    p = float(sensor.n_pixels)
    _, _, qmin, qrange, lag_rows = conv_lag_geometry(sensor, scan)
    width = qrange - 1 + w
    # static gather building the extended planes:
    # text[j, r, w'] = S[r, ((w' + qmin) * u + j) mod A]
    wprime = np.arange(width)
    col_idx = ((wprime[None, :] + qmin) * u + np.arange(u)[:, None]) % a  # [u, width]
    col_idx = torch.as_tensor(col_idx.reshape(-1).astype(np.int64), device=dev)
    lag_rows = torch.as_tensor(lag_rows.astype(np.int64), device=dev)
    inv_u = 1.0 / u

    def at_lags(grid: torch.Tensor, b: int) -> torch.Tensor:
        """Grid f64[B*u, qrange, C] -> f64[B, C, L] in lag order."""
        c = grid.shape[2]
        return grid.view(b, u * qrange, c).index_select(1, lag_rows).transpose(1, 2)

    def lib_min(s: torch.Tensor, lib: LibraryPack, lag_sum, lag_sq, aux=None) -> torch.Tensor:
        b = s.shape[0]
        # fl32(S / u) first, as the kernel path's candidates, then fp64
        text = (s * inv_u).index_select(2, col_idx).view(b, r, u, width)
        lhs = text.permute(0, 2, 1, 3).reshape(b * u, r, width).double()
        pen = (1.0 - lib.valid.double()) * PAD_PENALTY
        if scan.metric == "ssd":
            cross = at_lags(unfold_contraction(lhs, lib.flat.double(), w), b)  # [B, Nl, L]
            sq = torch.sum(lhs * lhs, dim=1).unfold(1, w, 1).sum(dim=2)  # [B*u, qrange]
            csq = at_lags(sq.view(b * u, qrange, 1), b)  # [B, 1, L]
            d = -2.0 * cross + csq + (lib.sq.double() + pen)[None, :, None]
            m = torch.min(d, dim=1).values.clamp_min(0.0)
        else:
            z = lib.z.double()
            cross = at_lags(unfold_contraction(lhs, z, w), b)  # [B, Nl, L]
            mu = lag_sum / p
            sigma = torch.sqrt((lag_sq / p - mu * mu).clamp_min(0.0) + NCC_EPS)
            zsum = torch.sum(z, dim=1)  # [Nl]
            zdot = (cross - mu[:, None, :] * zsum[None, :, None]) / sigma[:, None, :]
            m = torch.min(1.0 - zdot / p + pen[None, :, None], dim=1).values
        return m.float()  # [B, L]

    return lib_min
