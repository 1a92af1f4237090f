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

Inputs are fp32; both versions form products and sums in fp64. The SSD
decomposition cancels (view norms ~300, gaps between the best headings
~1e-5 at BASELINE config 4), so fp32 sums would let rounding pick the
heading; in fp64 the result is the exact value of the decomposition to
~1e-10 and the kernel and its plain version decide alike.
"""

from __future__ import annotations

import ctypes

import torch

from navdv_torch import _build
from navdv_torch.config import ScanConfig, SensorConfig
from navdv_torch.familiarity import PAD_PENALTY, LibraryPack, zscore


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


def _metric_min_rows(metric: str, rows: torch.Tensor, lib: LibraryPack, p: int):
    """The one place for the metric -> kernel-parameter mapping and the SSD
    clamp at >= 0; both entry points dispatch through it."""
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
