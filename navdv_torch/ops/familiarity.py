"""Fused distance + library minimum (kernel ``csrc/min_distance.cu``).

Replaces ``navdv_tpu/ops/familiarity_pallas.py::min_distance_rows`` and its
entries ``make_lib_min_pallas`` / ``make_familiarity_batched_pallas``. Both
metrics reduce to

    d[row, v] = alpha * <a_row, b_v> + beta[row] + gamma[v]

with  SSD:  a = cand,         b = lib.flat, alpha = -2,   beta = |a|^2, gamma = |l|^2
      NCC:  a = zscore(cand), b = lib.z,    alpha = -1/P, beta = 1,     gamma = 0

and the library-padding penalty folded into gamma, so one kernel serves
both. The kernel keeps a running minimum over the library and never writes
the [rows, Nl] distance matrix.

Two entries launch it. :func:`min_distance_rows` scores materialised rows
(the NCC path's z-scored candidates, the extended-shift entry).
:func:`min_distance_pooled` forms the step's SSD candidates inside the
kernel from the pooled panorama, so the [B, L, P] candidate tensor is never
built; its minima equal the materialised route's bit for bit.

Inputs are fp32; both versions form products and sums in fp64. The SSD
decomposition cancels (view norms ~300, gaps between the best headings
~1e-5 at BASELINE config 4), so fp32 sums would let rounding pick the
heading; in fp64 the result is the exact value of the decomposition to
~1e-10 and the kernel and its plain version decide alike.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from navdv_torch import _build
from navdv_torch.config import ScanConfig, SensorConfig
from navdv_torch.device import resolve_device
from navdv_torch.familiarity import PAD_PENALTY, LibraryPack, zscore
from navdv_torch.ops.lag import _inv_u
# the module, not its function: sensor imports the ops package, which
# imports this module, so sensor may still be loading here
from navdv_torch import sensor as _sensor


def min_distance_rows_plain(a: torch.Tensor, b: torch.Tensor, gamma: torch.Tensor,
                            alpha: float, with_rowsq: bool) -> torch.Tensor:
    """Plain PyTorch version: the full distance matrix in fp64, then its row
    min, rounded to fp32."""
    a, b = a.double(), b.double()
    beta = torch.sum(a * a, dim=1, keepdim=True) if with_rowsq else 1.0
    d = alpha * (a @ b.T) + beta + gamma.double()[None, :]
    return d.min(dim=1).values.float()


def _check(a, b, gamma):
    for name, t in (("a", a), ("b", b), ("gamma", gamma)):
        if t.dtype != torch.float32:
            raise ValueError(f"min_distance_rows: {name} must be float32")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[1]:
        raise ValueError("min_distance_rows: a must be f32[rows, P], b f32[Nl, P]")
    if gamma.shape != (b.shape[0],) or b.shape[0] == 0:
        raise ValueError("min_distance_rows: gamma must be f32[Nl] with Nl >= 1")
    devs = {a.device, b.device, gamma.device}
    if len(devs) != 1:
        raise ValueError(f"min_distance_rows: tensors on different devices {devs}")


def min_distance_rows(a: torch.Tensor, b: torch.Tensor, gamma: torch.Tensor,
                      alpha: float, with_rowsq: bool) -> torch.Tensor:
    """``min_v(alpha * (a @ b.T) + beta[:, None] + gamma[None, :])`` where
    beta = per-row |a|^2 (``with_rowsq``) or the constant 1.

    a: f32[rows, P], b: f32[Nl, P], gamma: f32[Nl] -> f32[rows].
    """
    _check(a, b, gamma)
    dev = a.device
    if dev.type == "cpu":
        return min_distance_rows_plain(a, b, gamma, alpha, with_rowsq)
    if dev.type != "cuda":
        raise ValueError(f"min_distance_rows: unsupported device {dev}")
    fn = _build.load_function("min_distance", "navdv_min_distance", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_int,
        ctypes.c_void_p,
    ])
    a = a.contiguous()
    b = b.contiguous()
    gamma = gamma.contiguous()
    rows, p = a.shape
    nl = b.shape[0]
    if rows > 2**31 - 1:
        raise ValueError("min_distance_rows: too many rows for one launch")
    out = torch.empty((rows,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(a.data_ptr(), b.data_ptr(), gamma.data_ptr(), out.data_ptr(),
                  rows, nl, p, float(alpha), int(bool(with_rowsq)), stream)
    min_distance_rows.launches += 1
    _build.check_launch("min_distance", code)
    return out


min_distance_rows.launches = 0


def min_distance_pooled_plain(s: torch.Tensor, lags: torch.Tensor, b: torch.Tensor,
                              gamma: torch.Tensor, sensor: SensorConfig, alpha: float,
                              with_rowsq: bool) -> torch.Tensor:
    """Plain PyTorch version: the candidates gathered from ``s`` as the
    step's materialised route gathers them
    (:func:`navdv_torch.sensor.make_views_from_pooled`), then
    :func:`min_distance_rows_plain`."""
    views = _sensor.make_views_from_pooled(sensor, lags.cpu().numpy(), s.device)(s)
    m = min_distance_rows_plain(views.reshape(-1, sensor.n_pixels), b, gamma, alpha, with_rowsq)
    return m.reshape(s.shape[0], lags.shape[0])


def _check_pooled(s, lags, b, gamma, sensor):
    for name, t in (("s", s), ("b", b), ("gamma", gamma)):
        if t.dtype != torch.float32:
            raise ValueError(f"min_distance_pooled: {name} must be float32")
    if s.dim() != 3 or s.shape[1:] != (sensor.n_radial, sensor.n_fine):
        raise ValueError(
            f"min_distance_pooled: s must be f32[B, {sensor.n_radial}, {sensor.n_fine}]")
    if lags.dim() != 1 or lags.dtype != torch.int32:
        raise ValueError("min_distance_pooled: lags must be int32[L]")
    if b.dim() != 2 or b.shape[1] != sensor.n_pixels or b.shape[0] == 0:
        raise ValueError(f"min_distance_pooled: b must be f32[Nl, {sensor.n_pixels}], Nl >= 1")
    if gamma.shape != (b.shape[0],):
        raise ValueError("min_distance_pooled: gamma must be f32[Nl]")
    devs = {s.device, lags.device, b.device, gamma.device}
    if len(devs) != 1:
        raise ValueError(f"min_distance_pooled: tensors on different devices {devs}")
    if max(s.numel(), s.shape[0] * lags.shape[0]) > 2**31 - 1:
        raise ValueError("min_distance_pooled: too many rows for one launch")
    if sensor.n_pixels + sensor.n_azimuth > 2**22:  # k / W by the fp32 reciprocal of W
        raise ValueError("min_distance_pooled: more pixels than the kernel indexes")


def min_distance_pooled(s: torch.Tensor, lags: torch.Tensor, b: torch.Tensor,
                        gamma: torch.Tensor, sensor: SensorConfig, alpha: float,
                        with_rowsq: bool) -> torch.Tensor:
    """:func:`min_distance_rows` of the candidate views of the pooled
    panorama, formed inside the kernel:
    ``(s f32[B, R, A], lags i32[L], b f32[Nl, P], gamma f32[Nl]) -> f32[B, L]``.

    Candidate ``l`` of agent ``i`` is ``S[i, r, (w*u + lags[l]) mod A] * (1/u)``
    at pixel ``r*W + w``, the fp32 product that
    :func:`navdv_torch.sensor.make_views_from_pooled` writes; lags take any
    sign. One launch scores every lag.
    """
    _check_pooled(s, lags, b, gamma, sensor)
    dev = s.device
    if dev.type == "cpu":
        return min_distance_pooled_plain(s, lags, b, gamma, sensor, alpha, with_rowsq)
    if dev.type != "cuda":
        raise ValueError(f"min_distance_pooled: unsupported device {dev}")
    fn = _build.load_function("min_distance", "navdv_min_distance_pooled", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_double, ctypes.c_int,
        ctypes.c_void_p,
    ])
    s = s.contiguous()
    lags = lags.contiguous()
    b = b.contiguous()
    gamma = gamma.contiguous()
    batch, n_lags = s.shape[0], lags.shape[0]
    out = torch.empty((batch, n_lags), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(s.data_ptr(), lags.data_ptr(), b.data_ptr(), gamma.data_ptr(), out.data_ptr(),
                  batch, n_lags, b.shape[0], sensor.n_radial, sensor.n_azimuth,
                  sensor.az_upsample, _inv_u(sensor), float(alpha), int(bool(with_rowsq)),
                  stream)
    min_distance_pooled.launches += 1
    _build.check_launch("min_distance", code)
    return out


min_distance_pooled.launches = 0


def _metric_min_rows(metric: str, rows: torch.Tensor, lib: LibraryPack, p: int):
    """The one place for the rows entry's metric -> kernel-parameter mapping
    and the SSD clamp at >= 0; :func:`make_lib_min_kernel` and
    :func:`make_familiarity_batched` dispatch through it
    (:func:`make_lib_min_pooled` maps SSD alike for the pooled entry)."""
    pen = (1.0 - lib.valid) * PAD_PENALTY
    if metric == "ssd":
        m = min_distance_rows(rows, lib.flat, lib.sq + pen, -2.0, True)
        return m.clamp_min(0.0)  # clamp fp cancellation (parity with the plain path)
    return min_distance_rows(zscore(rows), lib.z, pen, -1.0 / p, False)


def _check_metric(scan: ScanConfig):
    if scan.metric not in ("ssd", "ncc"):
        raise ValueError(f"unknown familiarity metric {scan.metric!r}")


def make_lib_min_kernel(sensor: SensorConfig, scan: ScanConfig):
    """Per-lag library minimum: ``(cand f32[B, L, P], lib) -> M f32[B, L]``."""
    _check_metric(scan)

    def lib_min(cand: torch.Tensor, lib: LibraryPack) -> torch.Tensor:
        b, n_lags, p = cand.shape
        m = _metric_min_rows(scan.metric, cand.reshape(b * n_lags, p), lib, p)
        return m.reshape(b, n_lags)

    return lib_min


def make_lib_min_pooled(sensor: SensorConfig, lags: np.ndarray, device=None):
    """Per-lag SSD library minimum straight from the pooled panorama:
    ``(s f32[B, R, A], lib, *_) -> M f32[B, L]`` at the scan lags ``lags``,
    clamped at >= 0 as :func:`make_lib_min_kernel`'s SSD minimum is, by one
    :func:`min_distance_pooled` launch. Further arguments (the lag statistics
    and aux of the step's other pooled-panorama paths) are ignored."""
    lags_dev = torch.as_tensor(np.asarray(lags).astype(np.int32), device=resolve_device(device))

    def lib_min(s: torch.Tensor, lib: LibraryPack, *_) -> torch.Tensor:
        pen = (1.0 - lib.valid) * PAD_PENALTY
        m = min_distance_pooled(s, lags_dev, lib.flat, lib.sq + pen, sensor, -2.0, True)
        return m.clamp_min(0.0)  # clamp fp cancellation (parity with the plain path)

    return lib_min


def make_familiarity_batched(sensor: SensorConfig, scan: ScanConfig):
    """Batched familiarity: ``(cand_ext f32[B, Ne, P], lib) -> f32[B, Nh]``
    over the extended shift set, RIDF min-pooled over the tolerance window."""
    _check_metric(scan)
    w = 2 * scan.tol_bins + 1
    nh = scan.n_headings

    def fam(cand_ext: torch.Tensor, lib: LibraryPack) -> torch.Tensor:
        b, ne, p = cand_ext.shape
        m = _metric_min_rows(scan.metric, cand_ext.reshape(b * ne, p), lib, p)
        return m.reshape(b, nh, w).min(dim=2).values

    return fam
