"""Polar-panorama renderers, pooled panorama, candidate views and lag
statistics (counterpart of the JAX package's ``sensor.py``).

One fine-azimuth panorama is rendered per agent; every candidate-heading
view is a cyclic shift + mean-pool of it. The render is the window-gather
kernel followed by the render kernel (:mod:`navdv_torch.ops`), for the full
renderer and the sector renderer alike. The JAX renderers' TPU scaffolding
is not carried over: the 8-row / 256-column landscape padding exists for the
TPU window kernel's aligned band reads, and the agent-chunk policy guards an
XLA fusion cliff; neither applies here.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

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


def sector_bounds(
    sensor: SensorConfig, n_sectors: int, ring_blocks: int = 1
) -> list[tuple[int, int, int, int, int, int]]:
    """Static per-piece hat support:
    ``[(ring_lo, n_rings, row_lo, n_rows, col_lo, n_cols)]`` over
    ``ring_blocks x n_sectors`` pieces (ring-block-major order).

    With the heading decomposed as ``theta = k*bin_width + phi``
    (|phi| <= bin_width/2), the in-window sample position for azimuth column
    ``a`` is ``frac(xy) + half + Rot(phi) @ (dx0, dy0)[:, a]``, nearly
    static: for each contiguous block of (rings x azimuth columns) the
    reachable positions span a small static box, and every bilinear tap of
    every sample falls inside it. The JAX sector renderer contracts its hat
    weights over these boxes only; the port's renderer takes the two taps
    per axis directly and needs no box, so it calls this to validate
    ``n_sectors`` and ``ring_blocks`` as the JAX package does.
    """
    a = sensor.n_fine
    if a % n_sectors:
        raise ValueError(f"n_fine {a} not divisible by n_sectors {n_sectors}")
    dx0, dy0 = polar_offsets(sensor)
    wsz = window_size(sensor)
    half = wsz // 2
    binw = sensor.bin_width
    a_s = a // n_sectors
    # more blocks than rings would produce empty blocks (and zero-size
    # reductions below); clamp — the extra blocks could never help anyway
    blocks = np.array_split(
        np.arange(sensor.n_radial), min(ring_blocks, sensor.n_radial)
    )
    out = []
    for rb in blocks:
        for s in range(n_sectors):
            cols = np.arange(s * a_s, (s + 1) * a_s)
            txs, tys = [], []
            for phi in (-binw / 2, 0.0, binw / 2):
                c, si = np.cos(phi), np.sin(phi)
                dxb = dx0[np.ix_(rb, cols)]
                dyb = dy0[np.ix_(rb, cols)]
                txs.append(c * dxb - si * dyb)
                tys.append(si * dxb + c * dyb)
            tx = np.stack(txs)
            ty = np.stack(tys)

            def rng(t):
                # sample in [half + t.min, half + 1 + t.max); both hat taps
                # of every in-range sample land inside [lo, lo + n)
                lo = int(np.clip(np.floor(half + t.min() - 1e-3), 0, wsz - 2))
                hi = int(
                    np.clip(np.floor(half + 1 + t.max() + 1e-3) + 1, lo + 1, wsz - 1)
                )
                return lo, hi - lo + 1

            col_lo, n_cols = rng(tx)
            row_lo, n_rows = rng(ty)
            out.append((int(rb[0]), len(rb), row_lo, n_rows, col_lo, n_cols))
    return out


def make_render_batch_rolled(
    sensor: SensorConfig, max_drift: float = 2.0, contract: torch.Tensor | None = None,
    device=None,
):
    """Sector renderer: ``(landscape, xy f32[B, 2], theta f32[B]) ->
    (pano_phi f32[B, R, A], k i32[B])`` with the exact roll identity

        pano_theta[r, a] == pano_phi[r, (a + k) mod A],  theta = k*binw + phi,

    ``k = round(theta / binw) mod A`` and ``phi = theta - k*binw`` in f32
    (``torch.round`` rounds half to even, as ``jnp.round`` does).

    With ``contract`` (f64[A, C], the spectral path's ``forward_mats``) it
    returns ``(spec f64[B, R, C], k, rowsum f64[B, R], rowsq f64[B, R])``:
    ``spec = pano_phi @ contract`` and the row sums of ``pano_phi`` and of
    its square, all in fp64 (every product on the port's distance path is
    fp64, ROADMAP C.1 and C.10).

    Design. The landscape is edge-replicated on every side by
    ``pad = max(0, half - floor(r_max - max_drift) + 1)`` cells, so an agent
    inside the live envelope (at least ``r_max - max_drift`` from every edge)
    always sees its window unclipped, at in-window position
    ``frac(xy) + half``. The phi frame is then rendered by the kernels the
    full renderer uses: the window gather on the padded landscape, and the
    render kernel at ``fxy = (x + pad - bx, y + pad - by, cos phi, sin
    phi)``. That is the JAX sector renderer's sample point up to fp
    rounding. The JAX renderer splits the azimuth circle into
    ``n_sectors x ring_blocks`` static pieces (``sector_bounds``) so that its
    MXU hat contraction spans each piece's ~11x11 support; its clamp of each
    sample to its piece never binds inside the envelope, which the pad
    guarantees. The render kernel contracts no hat: it reads the two nonzero
    taps per axis directly, so the split would save it nothing, and the
    pieces are not carried over. ``n_sectors`` and ``ring_blocks`` are still
    validated through ``sector_bounds``; they change neither the port's
    output nor, beyond 2e-6, the JAX package's.

    ``sensor.phi_bins > 0`` is the JAX package's approximate variant (which
    it documents as refuted): phi rounds to the centre of its bin, the
    window is pre-shifted by the two-tap (fx, fy) blend with its edge column
    and row replicated, and the render runs at ``fxy = (half, half,
    cos phi_j, sin phi_j)``.

    The padded landscape depends only on the landscape: ``render.pad``
    builds it once, and ``render.padded(land_pad, xy, theta)`` renders from
    it (``render(landscape, ...)`` is the two in one call).
    """
    if sensor.hat_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"unknown hat_dtype {sensor.hat_dtype!r}")
    sector_bounds(sensor, sensor.n_sectors, sensor.ring_blocks)  # validates, as JAX does
    dev = resolve_device(device)
    dx0_np, dy0_np = polar_offsets(sensor)
    dx0 = torch.from_numpy(dx0_np).to(dev)
    dy0 = torch.from_numpy(dy0_np).to(dev)
    hat_bf16 = sensor.hat_dtype == "bfloat16"
    a_fine = sensor.n_fine
    binw = sensor.bin_width
    wy_sz, wx_sz = window_geometry(sensor)
    half = wx_sz // 2
    # active agents render at least r_max from the edge (the off-landscape
    # stop) and a done agent's frozen pose is at most one step past it, so
    # the pad covers the footprint overhang (half) minus the guaranteed
    # margin (r_max - drift); +1 for the bilinear tap past the floor
    pad = max(0, half - int(np.floor(sensor.r_max - max_drift)) + 1)
    nphi = sensor.phi_bins
    if nphi:
        centers = -binw / 2 + (np.arange(nphi) + 0.5) * (binw / nphi)
        cos_bin = torch.from_numpy(np.cos(centers).astype(np.float32)).to(dev)
        sin_bin = torch.from_numpy(np.sin(centers).astype(np.float32)).to(dev)
    if contract is not None:
        if contract.shape[0] != a_fine:
            raise ValueError(f"contract rows {contract.shape[0]} != n_fine {a_fine}")
        contract = contract.to(device=dev, dtype=torch.float64)

    def pad_landscape(landscape: torch.Tensor) -> torch.Tensor:
        return F.pad(landscape[None, None], (pad, pad, pad, pad), mode="replicate")[0, 0]

    def render_padded(land_pad: torch.Tensor, xy: torch.Tensor, theta: torch.Tensor):
        kf = torch.round(theta / binw)
        phi = theta - kf * binw
        k = kf.to(torch.int32) % a_fine  # floor-mod, as in JAX
        hp, wp = land_pad.shape
        bx = (torch.floor(xy[:, 0]).to(torch.int32) + (pad - half)).clamp(0, wp - wx_sz)
        by = (torch.floor(xy[:, 1]).to(torch.int32) + (pad - half)).clamp(0, hp - wy_sz)
        wins = window_gather(land_pad, by, bx, wy_sz, wx_sz)  # [B, wy, wx]
        fx = (xy[:, 0] + pad) - bx.float()
        fy = (xy[:, 1] + pad) - by.float()
        c, s = torch.cos(phi), torch.sin(phi)
        if nphi:
            jbin = torch.floor((phi + binw / 2) * (nphi / binw)).clamp(0, nphi - 1).long()
            c, s = cos_bin[jbin], sin_bin[jbin]
            frx = (fx - half)[:, None, None]
            fry = (fy - half)[:, None, None]
            wsx = torch.cat([wins[:, :, 1:], wins[:, :, -1:]], dim=2)
            wtmp = wins * (1 - frx) + wsx * frx
            wsy = torch.cat([wtmp[:, 1:, :], wtmp[:, -1:, :]], dim=1)
            wins = wtmp * (1 - fry) + wsy * fry
            fx = torch.full_like(fx, float(half))
            fy = torch.full_like(fy, float(half))
        fxy = torch.stack([fx, fy, c, s], dim=1)
        pano = render_windows(wins, fxy, dx0, dy0, hat_bf16)  # [B, R, A], phi frame
        if contract is None:
            return pano, k
        p64 = pano.double()
        return p64 @ contract, k, p64.sum(dim=2), (p64 * p64).sum(dim=2)

    def render_b(landscape: torch.Tensor, xy: torch.Tensor, theta: torch.Tensor):
        return render_padded(pad_landscape(landscape), xy, theta)

    render_b.pad = pad_landscape
    render_b.padded = render_padded
    return render_b


def unroll_panorama(pano_phi, k) -> np.ndarray:
    """The true-heading panorama from the sector renderer's output:
    ``pano_theta[b, r, a] = pano_phi[b, r, (a + k_b) % A]``, on the host.

    A check-side utility: the step absorbs the roll and never builds this."""
    if isinstance(pano_phi, torch.Tensor):
        pano_phi = pano_phi.detach().cpu().numpy()
    if isinstance(k, torch.Tensor):
        k = k.detach().cpu().numpy()
    pano_phi = np.asarray(pano_phi)
    k = np.asarray(k)
    a = pano_phi.shape[-1]
    idx = (np.arange(a)[None, :] + k[:, None]) % a  # [B, A]
    return np.take_along_axis(pano_phi, idx[:, None, :], axis=2)


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


def make_lag_stats(sensor: SensorConfig, shifts: np.ndarray, device=None,
                   dynamic_roll: bool = False):
    """Per-lag candidate statistics straight from the pooled panorama:
    ``stats(S f32[B, R, A]) -> (sum f32[B, Ns], sumsq f32[B, Ns])`` over the
    candidate's P pixels (in the dtype of S).

    Candidate ``l``'s pixels are the pooled columns ``(w*u + l) mod A``,
    exactly the columns congruent to ``l mod u``, so the per-lag stats take
    only ``u`` distinct values: sum the column stats per residue class and
    gather ``[B, u] -> [B, Ns]``.

    With ``dynamic_roll=True`` the returned fn takes ``(S, k i32[B])``, S the
    sector renderer's pooled phi-frame panorama: the true candidate at lag
    ``l`` occupies its columns ``w*u + l + k``, residue class
    ``(l + k) mod u``, taken per agent by an exact integer gather (the JAX
    package's one-hot contraction works around a slow TPU gather; at
    ``u == 1`` the gather picks the one class, the JAX no-op)."""
    dev = resolve_device(device)
    u = sensor.az_upsample
    w = sensor.n_azimuth
    inv_u = 1.0 / u
    residues = torch.from_numpy(np.mod(np.asarray(shifts), u).astype(np.int64)).to(dev)

    def per_residue(s: torch.Tensor):
        b = s.shape[0]
        colsum = torch.sum(s, dim=1) * inv_u  # [B, A]
        colsq = torch.sum(s * s, dim=1) * (inv_u * inv_u)  # [B, A]
        res_sum = torch.sum(colsum.reshape(b, w, u), dim=1)  # [B, u]
        res_sq = torch.sum(colsq.reshape(b, w, u), dim=1)  # [B, u]
        return res_sum, res_sq

    def stats(s: torch.Tensor):
        res_sum, res_sq = per_residue(s)
        return res_sum[:, residues], res_sq[:, residues]

    if not dynamic_roll:
        return stats

    def stats_rolled(s: torch.Tensor, k: torch.Tensor):
        res_sum, res_sq = per_residue(s)
        idx = (residues[None, :] + k.long()[:, None]) % u  # [B, Ns]
        return res_sum.gather(1, idx), res_sq.gather(1, idx)

    return stats_rolled


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
