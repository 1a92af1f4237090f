"""Polar-panorama renderer, pooled panorama and candidate views (the exact
subset of the JAX package's ``sensor.py``).

One fine-azimuth panorama is rendered per agent; every candidate-heading
view is a cyclic shift + mean-pool of it. The render is the window-gather
kernel followed by the render kernel (:mod:`navdv_torch.ops`). The JAX
renderer's TPU scaffolding is not carried over: the 8-row / 256-column
landscape padding exists for the TPU window kernel's aligned band reads, and
the agent-chunk policy guards an XLA fusion cliff; neither applies here.
"""

from __future__ import annotations

import numpy as np
import torch

from navdv_torch.config import ScanConfig, SensorConfig
from navdv_torch.device import resolve_device
from navdv_torch.ops.render import render_windows
from navdv_torch.ops.window import window_gather


def polar_offsets(cfg: SensorConfig) -> tuple[np.ndarray, np.ndarray]:
    """Static heading-relative sample offsets (dx0, dy0), each f32[R, A].

    Column a looks along relative azimuth alpha_a = (a + 0.5)*binw - pi; the
    world-frame sample point for heading theta is
    ``xy + Rot(theta) @ (dx0, dy0)``.
    """
    a = np.arange(cfg.n_fine)
    alpha = (a + 0.5) * cfg.bin_width - np.pi
    d = np.linspace(cfg.r_min, cfg.r_max, cfg.n_radial)
    dx0 = (d[:, None] * np.cos(alpha)[None, :]).astype(np.float32)
    dy0 = (d[:, None] * np.sin(alpha)[None, :]).astype(np.float32)
    return dx0, dy0


def window_size(sensor: SensorConfig) -> int:
    """Side of the square landscape window that covers the sensor footprint
    (radius r_max) plus bilinear/fractional margin."""
    return int(np.ceil(2 * sensor.r_max)) + 4


def window_geometry(sensor: SensorConfig) -> tuple[int, int]:
    """(wy, wx) window shape of the batched renderer."""
    wx = window_size(sensor)
    return wx, wx


def candidate_col_index(sensor: SensorConfig, shifts: np.ndarray) -> np.ndarray:
    """Static gather index i32[Ns, W] into the *pooled* panorama:
    row s, col w -> ``(w*u + shifts[s]) mod A``."""
    base = np.arange(sensor.n_azimuth) * sensor.az_upsample
    return ((base[None, :] + shifts[:, None]) % sensor.n_fine).astype(np.int32)


def bilinear_sample(landscape: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """Edge-clamped bilinear sample of landscape[y, x]; xs/ys any shape."""
    h, w = landscape.shape
    xs = xs.clamp(0.0, w - 1.0)
    ys = ys.clamp(0.0, h - 1.0)
    x0 = torch.floor(xs).long().clamp(0, w - 2)
    y0 = torch.floor(ys).long().clamp(0, h - 2)
    fx = xs - x0
    fy = ys - y0
    flat = landscape.reshape(-1)
    idx = y0 * w + x0
    v00 = flat[idx]
    v01 = flat[idx + 1]
    v10 = flat[idx + w]
    v11 = flat[idx + w + 1]
    return (
        v00 * (1 - fy) * (1 - fx)
        + v01 * (1 - fy) * fx
        + v10 * fy * (1 - fx)
        + v11 * fy * fx
    )


def _make_render(sensor: SensorConfig, hat_bf16: bool, device):
    dev = resolve_device(device)
    dx0_np, dy0_np = polar_offsets(sensor)
    dx0 = torch.from_numpy(dx0_np).to(dev)
    dy0 = torch.from_numpy(dy0_np).to(dev)
    wy_sz, wx_sz = window_geometry(sensor)
    half = wx_sz // 2

    def render_b(landscape: torch.Tensor, xy: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
        hl, wl = landscape.shape
        bx = (torch.floor(xy[:, 0]).to(torch.int32) - half).clamp(0, wl - wx_sz)
        by = (torch.floor(xy[:, 1]).to(torch.int32) - half).clamp(0, hl - wy_sz)
        wins = window_gather(landscape, by, bx, wy_sz, wx_sz)  # [B, wy, wx]
        fxy = torch.stack(
            [xy[:, 0] - bx.float(), xy[:, 1] - by.float(), torch.cos(theta), torch.sin(theta)],
            dim=1,
        )
        return render_windows(wins, fxy, dx0, dy0, hat_bf16)

    return render_b


def make_render_batch(sensor: SensorConfig, device=None):
    """Batched renderer ``(landscape f32[H, W], xy f32[B, 2], theta f32[B])
    -> pano f32[B, R, A]``: edge-clamped bilinear samples of the polar grid,
    in the rounding class ``sensor.hat_dtype`` names."""
    if sensor.hat_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"unknown hat_dtype {sensor.hat_dtype!r}")
    return _make_render(sensor, sensor.hat_dtype == "bfloat16", device)


def make_render_panorama(sensor: SensorConfig, device=None):
    """Training-capture renderer: ``make_render_batch`` always in f32,
    whatever ``hat_dtype`` says (the JAX capture renderer is f32 too)."""
    return _make_render(sensor, False, device)


def make_pooled_panorama(sensor: SensorConfig, device=None):
    """``pooled(pano f32[..., R, A]) -> S f32[..., R, A]`` with
    ``S[r, a] = sum_{j<u} pano[r, (a+j) mod A]``.

    Exact path: u-1 rolled adds. With ``hat_dtype="bfloat16"`` the JAX
    package runs the circular box filter as one matmul of the bf16-rounded
    panorama against a 0/1 banded-circulant matrix with f32 accumulation;
    the port does the same product in fp32 on the rounded panorama, which is
    that rounding class exactly (the 0/1 products are exact)."""
    u = sensor.az_upsample
    dev = resolve_device(device)

    if u > 1 and sensor.hat_dtype == "bfloat16":
        a = sensor.n_fine
        box = np.zeros((a, a), np.float32)
        for j in range(u):
            box[(np.arange(a) + j) % a, np.arange(a)] = 1.0
        box_t = torch.from_numpy(box).to(dev)

        def pooled(pano: torch.Tensor) -> torch.Tensor:
            lead = pano.shape[:-1]
            flat = pano.reshape(-1, a).to(torch.bfloat16).float()
            return (flat @ box_t).reshape(*lead, a)

        return pooled

    def pooled(pano: torch.Tensor) -> torch.Tensor:
        s = pano
        for j in range(1, u):
            s = s + torch.roll(pano, -j, dims=-1)
        return s

    return pooled


def make_views_from_pooled(sensor: SensorConfig, shifts: np.ndarray, device=None):
    """Candidate views from an already-pooled panorama S (batched):
    ``views(S f32[B, R, A]) -> f32[B, Ns, P]``."""
    dev = resolve_device(device)
    col_idx = torch.from_numpy(
        candidate_col_index(sensor, np.asarray(shifts)).reshape(-1).astype(np.int64)
    ).to(dev)
    r, w, u = sensor.n_radial, sensor.n_azimuth, sensor.az_upsample
    ns = len(shifts)
    inv_u = 1.0 / u

    def views(s: torch.Tensor) -> torch.Tensor:
        b = s.shape[0]
        # scale first: the same per-element product, on the 60x smaller tensor
        g = (s * inv_u).index_select(2, col_idx).reshape(b, r, ns, w)
        return g.permute(0, 2, 1, 3).reshape(b, ns, r * w)

    return views


def make_candidate_views(sensor: SensorConfig, shifts: np.ndarray, device=None):
    """``views(pano f32[B, R, A]) -> f32[B, Ns, P]``: the pooled sensor view
    at every shift in ``shifts`` (fine bins), flattened to P = R*W pixels.
    Rotation is a cyclic shift of the panorama, so this equals re-rendering
    at each candidate heading."""
    pooled = make_pooled_panorama(sensor, device)
    from_pooled = make_views_from_pooled(sensor, shifts, device)
    return lambda pano: from_pooled(pooled(pano))


def make_lag_stats(sensor: SensorConfig, shifts: np.ndarray, device=None):
    """Per-lag candidate statistics straight from the pooled panorama:
    ``stats(S f32[B, R, A]) -> (sum f32[B, Ns], sumsq f32[B, Ns])`` over the
    candidate's P pixels.

    Candidate ``l``'s pixels are the pooled columns ``(w*u + l) mod A``,
    exactly the columns congruent to ``l mod u``, so the per-lag stats take
    only ``u`` distinct values: sum the column stats per residue class and
    gather ``[B, u] -> [B, Ns]``."""
    dev = resolve_device(device)
    u = sensor.az_upsample
    w = sensor.n_azimuth
    inv_u = 1.0 / u
    residues = torch.from_numpy(np.mod(np.asarray(shifts), u).astype(np.int64)).to(dev)

    def stats(s: torch.Tensor):
        b = s.shape[0]
        colsum = torch.sum(s, dim=1) * inv_u  # [B, A]
        colsq = torch.sum(s * s, dim=1) * (inv_u * inv_u)  # [B, A]
        res_sum = torch.sum(colsum.reshape(b, w, u), dim=1)  # [B, u]
        res_sq = torch.sum(colsq.reshape(b, w, u), dim=1)  # [B, u]
        return res_sum[:, residues], res_sq[:, residues]

    return stats


def make_render_view(sensor: SensorConfig, device=None):
    """Training capture: ``(landscape, xy f32[B, 2], theta f32[B]) ->
    f32[B, R, W]``, the pooled view at each pose's own heading (shift 0),
    rendered in f32."""
    render = make_render_panorama(sensor, device)
    views = make_candidate_views(sensor, np.zeros(1, dtype=np.int64), device)

    def render_view(landscape, xy, theta):
        return views(render(landscape, xy, theta))[:, 0].reshape(
            -1, sensor.n_radial, sensor.n_azimuth
        )

    return render_view


def scan_shift_sets(scan: ScanConfig) -> tuple[np.ndarray, np.ndarray]:
    """(shifts[Nh], extended[Nh*(2t+1)]) — extended enumerates s_k + delta for
    the RIDF tolerance window; with tol_bins=0 it's shifts."""
    shifts = np.asarray(scan.shifts(), dtype=np.int64)
    deltas = np.arange(-scan.tol_bins, scan.tol_bins + 1, dtype=np.int64)
    extended = (shifts[:, None] + deltas[None, :]).reshape(-1)
    return shifts, extended


def scan_lag_sets(scan: ScanConfig) -> tuple[np.ndarray, np.ndarray]:
    """Deduplicated scan lags: (lags[L], window_idx[Nh, 2t+1]).

    ``lags`` is the sorted unique set of extended shifts; ``window_idx[k, d]``
    indexes the lag of heading k's d-th tolerance offset, so
    ``fam[k] = min_d M[window_idx[k, d]]`` where M is the per-lag library
    minimum.
    """
    shifts, extended = scan_shift_sets(scan)
    lags, inverse = np.unique(extended, return_inverse=True)
    window_idx = inverse.reshape(scan.n_headings, 2 * scan.tol_bins + 1)
    return lags, window_idx.astype(np.int32)
