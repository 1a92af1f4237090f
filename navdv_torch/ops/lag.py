"""Fused lag familiarity (kernel ``csrc/lag_fam.cu``).

Replaces ``navdv_tpu/ops/lag_pallas.py::make_lag_fam_pallas``: SSD
familiarity straight from the raw fine panorama. The panorama is pooled by
u-1 rolled adds in fp32 (whatever ``hat_dtype`` says: the JAX function never
runs the bf16 box filter), scaled by 1/u, and candidate ``l`` is read as
``S[r, (w*u + lags[l]) mod A]``; per lag, the library minimum of
``|row|^2 + gamma_v - 2 <row, lib_v>`` is clamped at >= 0; the RIDF pool over
``window_idx`` follows outside the kernel. The kernel pools and extracts the
lags inside each block, so the [B, L, P] candidate tensor is never built.

Products and sums are fp64, as in the min-distance kernel (ROADMAP C.1); the
JAX kernel sums in fp32.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from navdv_torch import _build
from navdv_torch.config import ScanConfig, SensorConfig
from navdv_torch.device import resolve_device
from navdv_torch.familiarity import PAD_PENALTY, LibraryPack
from navdv_torch.sensor import scan_lag_sets

# shared memory one block can use on the H100 (static + dynamic, after opt-in)
_BLOCK_SMEM_BYTES = 232_448


def lag_smem_bytes(sensor: SensorConfig) -> int:
    """Shared-memory bytes of one lag-kernel block, from the constants that
    ``csrc/min_tile.cuh`` and ``csrc/lag_fam.cu`` declare (the layout of
    ``lag_fam.cu``'s ``smem_bytes``): a front region that holds the raw
    panorama row, then the tile's ring (``STAGES`` chunks of fp32 rows
    and two of fp64 library entries, strides padded), whichever is larger;
    then the pooled row and the per-pixel offset table."""
    c = _build.source_constants("min_tile.cuh", "lag_fam.cu")
    tile_r = 16 * c["TILE_WARPS"] * c["LAG_M_TILES"]
    ld = c["TILE_K"] + c["PAD"]
    ring = c["STAGES"] * tile_r * ld * 4 + 2 * c["TILE_V"] * ld * 8
    ra = sensor.n_radial * sensor.n_fine
    return max(ring, -(-ra * 4 // 16) * 16) + (ra + sensor.n_pixels) * 4


def lag_grid_geometry(sensor: SensorConfig, scan: ScanConfig):
    """Static (qmin, nq, lag_rows, window_idx) of the JAX kernel's lag grid:
    it computes rows for the full (q, j) product grid, and ``lag_rows[i]``
    is the grid row of scan lag i. The CUDA kernel scores the scan lags
    only; the grid says how much work the JAX design spends."""
    u = sensor.az_upsample
    lags, window_idx = scan_lag_sets(scan)
    qs = lags // u
    js = lags - qs * u
    qmin, qmax = int(qs.min()), int(qs.max())
    nq = qmax - qmin + 1
    lag_rows = ((qs - qmin) * u + js).astype(np.int32)
    return qmin, nq, lag_rows, window_idx


def _inv_u(sensor: SensorConfig) -> float:
    """1/u as the fp32 value that scales the pooled panorama."""
    return float(np.float32(1.0 / sensor.az_upsample))


def lag_lib_min_plain(pano: torch.Tensor, lib_flat: torch.Tensor, gamma: torch.Tensor,
                      sensor: SensorConfig, lags: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: pool by rolled adds in fp32, extract the L
    lags, the distances in fp64, the min over the library clamped at >= 0,
    rounded to fp32. -> M f32[B, L]."""
    u, r, w, a = sensor.az_upsample, sensor.n_radial, sensor.n_azimuth, sensor.n_fine
    b, n_lags = pano.shape[0], lags.shape[0]
    s = pano
    for j in range(1, u):
        s = s + torch.roll(pano, -j, dims=2)
    cols = torch.remainder(
        torch.arange(w, device=pano.device)[None, :] * u + lags.long()[:, None], a)
    cand = (s * _inv_u(sensor)).index_select(2, cols.reshape(-1)).reshape(b, r, n_lags, w)
    c = cand.permute(0, 2, 1, 3).reshape(b, n_lags, r * w).double()
    d = (-2.0 * (c @ lib_flat.double().T) + torch.sum(c * c, dim=2, keepdim=True)
         + gamma.double()[None, None, :])
    return d.min(dim=2).values.clamp_min(0.0).float()


def _check(pano, lib_flat, gamma, sensor, lags):
    for name, t in (("pano", pano), ("lib_flat", lib_flat), ("gamma", gamma)):
        if t.dtype != torch.float32:
            raise ValueError(f"lag_lib_min: {name} must be float32")
    if pano.dim() != 3 or pano.shape[1:] != (sensor.n_radial, sensor.n_fine):
        raise ValueError(
            f"lag_lib_min: pano must be f32[B, {sensor.n_radial}, {sensor.n_fine}]")
    if lib_flat.dim() != 2 or lib_flat.shape[1] != sensor.n_pixels or lib_flat.shape[0] == 0:
        raise ValueError(f"lag_lib_min: lib_flat must be f32[Nl, {sensor.n_pixels}], Nl >= 1")
    if gamma.shape != (lib_flat.shape[0],):
        raise ValueError("lag_lib_min: gamma must be f32[Nl]")
    if lags.dim() != 1 or lags.dtype != torch.int32:
        raise ValueError("lag_lib_min: lags must be int32[L]")
    devs = {pano.device, lib_flat.device, gamma.device, lags.device}
    if len(devs) != 1:
        raise ValueError(f"lag_lib_min: tensors on different devices {devs}")
    if lag_smem_bytes(sensor) > _BLOCK_SMEM_BYTES:
        raise ValueError("lag_lib_min: the pooled panorama row does not fit in shared memory")


def lag_lib_min(pano: torch.Tensor, lib_flat: torch.Tensor, gamma: torch.Tensor,
                sensor: SensorConfig, lags: torch.Tensor) -> torch.Tensor:
    """Per-lag SSD library minimum from the raw panorama:
    ``(pano f32[B, R, A], lib_flat f32[Nl, P], gamma f32[Nl], lags i32[L])
    -> M f32[B, L]``, with gamma = |lib_v|^2 plus any padding penalty and
    lags in fine bins (any sign; taken mod A)."""
    _check(pano, lib_flat, gamma, sensor, lags)
    dev = pano.device
    if dev.type == "cpu":
        return lag_lib_min_plain(pano, lib_flat, gamma, sensor, lags)
    if dev.type != "cuda":
        raise ValueError(f"lag_lib_min: unsupported device {dev}")
    fn = _build.load_function("lag_fam", "navdv_lag_fam", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
    ])
    pano = pano.contiguous()
    lib_flat = lib_flat.contiguous()
    gamma = gamma.contiguous()
    lags = lags.contiguous()
    b, n_lags = pano.shape[0], lags.shape[0]
    out = torch.empty((b, n_lags), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(pano.data_ptr(), lib_flat.data_ptr(), gamma.data_ptr(), lags.data_ptr(),
                  out.data_ptr(), b, n_lags, lib_flat.shape[0], sensor.n_radial,
                  sensor.n_azimuth, sensor.az_upsample, _inv_u(sensor), stream)
    lag_lib_min.launches += 1
    _build.check_launch("lag_fam", code)
    return out


lag_lib_min.launches = 0


def make_lag_fam(sensor: SensorConfig, scan: ScanConfig, device=None):
    """Batched SSD familiarity ``(pano f32[B, R, A], lib) -> fam f32[B, Nh]``:
    the per-lag library minimum from the raw panorama, RIDF min-pooled over
    each heading's tolerance window. The JAX version's ``flat``,
    ``interpret`` and batch-of-8 tiling are Mosaic/TPU mechanics with no
    counterpart here: any B works."""
    if scan.metric != "ssd":
        raise ValueError("lag kernel implements SSD only; use the step's kernel path for NCC")
    dev = resolve_device(device)
    lags, window_idx = scan_lag_sets(scan)
    lags_dev = torch.as_tensor(lags.astype(np.int32), device=dev)
    window_idx_dev = torch.as_tensor(window_idx.astype(np.int64), device=dev)  # [Nh, 2t+1]

    def fam(pano: torch.Tensor, lib: LibraryPack) -> torch.Tensor:
        gamma = lib.sq + (1.0 - lib.valid) * PAD_PENALTY
        m = lag_lib_min(pano, lib.flat, gamma, sensor, lags_dev)  # [B, L]
        return torch.min(m[:, window_idx_dev], dim=2).values

    return fam
