"""Spectral familiarity: the whole lag scan as a circular cross-correlation,
with no [B, L, P] candidate tensor.

Counterpart of the JAX package's ``familiarity_fft.py``. Every candidate
view is a stride-u slice of the pooled panorama at offset ``lag``, and its
pixels tile the full azimuth circle (W·u == A), so the per-lag cross term

    cross[b, l, v] = sum_{r,w} S[b, r, (w·u + l) mod A] / u · lib[v, r, w]

is a circular correlation over azimuth between the panorama and the
zero-upsampled library row, for every lag at once. Both transforms are dense
DFT products, and the inverse transform synthesizes only the L lags the scan
needs:

    X    = S/u · (Wre | Wim)              [B·R, A] @ [A, 2F]   (DC bin masked)
    G    = sum_r X · Z                    one batched product over F bins,
                                          Z the library spectra, stacked so
                                          that it gives (Gre | Gim) at once
    cross = (Vre ; Vim) · G + mu · rowsum_z

F = A//2 + 1 bins, or the first ``spectral_cutoff`` (the approximation the
JAX package ships at configs 1 and 4); V folds the hermitian weights and the
1/A normalization. The DC bin is masked out of the product and its exact,
lag-independent value ``mu[b, r] · rowsum_z[v, r]`` added back.

Numerics (ROADMAP C.7): the signal is ``fl32(S / u)``, the fp32 tensor the
min-distance kernel scores; the DFT weights are built in fp64 and every
product runs in fp64 (ROADMAP C.1). SSD's candidate norm is ``|T_j|^2`` of
that tensor, summed in fp64 per residue class j = l mod u. At
``spectral_cutoff=0`` the path equals the kernel path up to fp64 rounding.
The JAX package's split into unstacked re/im products for tall sensors
(R = 64) was an MXU tile choice; here one stacked product serves every R.

``roll_k`` (i32[B], from the sector renderer) absorbs the exact azimuth roll
``S_theta[a] = S_phi[a + k]`` in the spectral domain:
``DFT(S_theta)[f] = e^{i 2π f k / A} DFT(S_phi)[f]``, a per-(b, f) rotation
of the spectra in fp64, with ``k·f mod A`` reduced in exact integers first.
The row means are roll-invariant; SSD's norms shift residue class by k.
"""

from __future__ import annotations

import numpy as np
import torch

from navdv_torch.config import ScanConfig, SensorConfig
from navdv_torch.device import resolve_device
from navdv_torch.familiarity import NCC_EPS, PAD_PENALTY, LibraryPack


def _forward_weights(a: int) -> tuple[np.ndarray, np.ndarray]:
    """DFT analysis weights: SF[k] = sum_a s[a] e^{-i 2π k a / A}.
    Returns (Wre, Wim) f64[A, F]."""
    f = a // 2 + 1
    k = np.arange(f)
    ang = -2.0 * np.pi * np.outer(np.arange(a), k) / a  # [A, F]
    return np.cos(ang), np.sin(ang)


def _library_weights(w: int, u: int, a: int) -> tuple[np.ndarray, np.ndarray]:
    """Analysis weights for the zero-upsampled library row (support at w·u):
    ZF[k] = sum_w z[w] e^{-i 2π k (w u) / A}. Returns (ZWre, ZWim) f64[W, F]."""
    f = a // 2 + 1
    k = np.arange(f)
    ang = -2.0 * np.pi * np.outer(np.arange(w) * u, k) / a  # [W, F]
    return np.cos(ang), np.sin(ang)


def _inverse_lag_weights(a: int, lags: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Real-IDFT synthesis weights evaluated only at ``lags``:
    c[l] = sum_k w_k (Gre[k] cos(2π k l / A) − Gim[k] sin(2π k l / A)) / A
    with w_k = 2 for the doubled hermitian bins, 1 for DC (and Nyquist when A
    is even). Returns (Vre, Vim) f64[F, L]."""
    f = a // 2 + 1
    k = np.arange(f)
    wk = np.full(f, 2.0)
    wk[0] = 1.0
    if a % 2 == 0:
        wk[-1] = 1.0
    ang = 2.0 * np.pi * np.outer(k, np.asarray(lags)) / a  # [F, L]
    return (wk[:, None] * np.cos(ang)) / a, -(wk[:, None] * np.sin(ang)) / a


def make_lib_min_fft(sensor: SensorConfig, scan: ScanConfig, lags: np.ndarray, device=None):
    """Per-lag library minimum via spectral correlation:
    ``lib_min(S f32[B, R, A], lib, lag_sum, lag_sq, aux=None) -> M f32[B, L]``
    from the pooled panorama S (no candidate extraction).

    ``lib_min.prepare(lib)`` builds the library spectra once per library.
    ``lib_min.spectral(spec, lib, lag_sum, lag_sq, aux=None, roll_k=None)``
    enters after the forward transform, with ``spec = (sre, sim, mu)``: the
    DC-masked spectra f[B, R, F] of the candidate signal S/u and its row
    means f[B, R] (the fused sector front end produces them, at u == 1,
    where S/u is S). ``lib_min.forward_mats`` is the analysis matrix
    f64[A, 2F] = (Wre with its DC column zeroed | Wim).

    ``lag_sum``/``lag_sq`` f64[B, L] (``sensor.make_lag_stats`` of the pooled
    panorama in fp64) serve NCC, and SSD in ``.spectral``; ``lib_min`` takes
    SSD's norms from S itself. ``roll_k`` i32[B] is the sector renderer's
    roll: S (or ``spec``) is then the phi-frame panorama, and the result is
    that of the true-heading panorama ``S[:, :, (a + k) mod A]``.
    """
    if scan.metric not in ("ssd", "ncc"):
        raise ValueError(f"unknown familiarity metric {scan.metric!r}")
    dev = resolve_device(device)
    a = sensor.n_fine
    r, w = sensor.n_radial, sensor.n_azimuth
    u = sensor.az_upsample
    p = float(sensor.n_pixels)
    lags = np.asarray(lags)

    f_full = a // 2 + 1
    fc = scan.spectral_cutoff or f_full
    if not 0 < fc <= f_full:
        raise ValueError(
            f"spectral_cutoff must be in (0, {f_full}], got {scan.spectral_cutoff}"
        )
    # truncated series (ScanConfig.spectral_cutoff): the tail bins leave
    # analysis AND synthesis; fc == f_full is exact
    wre, wim = _forward_weights(a)
    zwre, zwim = _library_weights(w, u, a)
    vre, vim = _inverse_lag_weights(a, lags)
    wre_dc = wre[:, :fc].copy()
    wre_dc[:, 0] = 0.0  # the DC bin leaves the product (exact correction below)

    def _t64(x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    forward_mats = _t64(np.concatenate([wre_dc, wim[:, :fc]], axis=1))  # [A, 2F]
    zw = _t64(np.concatenate([zwre[:, :fc], zwim[:, :fc]], axis=1))  # [W, 2F]
    synth = _t64(np.stack([vre[:fc], vim[:fc]], axis=1).reshape(2 * fc, len(lags)))  # [(f, c), L]
    residues = torch.as_tensor(np.mod(lags, u).astype(np.int64), device=dev)
    f_idx = torch.arange(fc, dtype=torch.int64, device=dev)
    inv_u = 1.0 / u

    def _rotate(sre: torch.Tensor, sim: torch.Tensor, roll_k: torch.Tensor):
        """Spectra f64[B, R, F] of the phi frame -> those of the true heading:
        times ``e^{i 2π f k / A}``, with ``k·f mod A`` exact in int64 (the raw
        angle would reach ~A·π rad)."""
        kf = (roll_k.long()[:, None] * f_idx[None, :]) % a  # [B, F]
        ang = (2.0 * np.pi / a) * kf.double()
        ck, sk = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
        return sre * ck - sim * sk, sre * sk + sim * ck

    def _prepare_rows(zrows: torch.Tensor):
        """Library spectra stacked for the batched product, and row sums:
        ``zmat f64[F, (c', v), (c, r)]`` with (c', c) the (re, im) parts, so
        that ``zmat[f] @ X[f]^T`` gives Gre (c' = 0) and Gim (c' = 1)."""
        z = zrows.double()
        nl = z.shape[0]
        rowsum_z = torch.sum(z.reshape(nl, r, w), dim=2)  # [Nl, R]
        zs = (z.reshape(nl * r, w) @ zw).view(nl, r, 2, fc)
        zre, zim = zs[:, :, 0], zs[:, :, 1]  # [Nl, R, F]
        # Gre = sum_r sre.zre + sim.zim;  Gim = sum_r sim.zre - sre.zim
        gre_rows = torch.cat([zre, zim], dim=1)  # [Nl, (c r), F]
        gim_rows = torch.cat([-zim, zre], dim=1)
        zmat = torch.stack([gre_rows, gim_rows]).permute(3, 0, 1, 2)  # [F, 2, Nl, 2R]
        return zmat.reshape(fc, 2 * nl, 2 * r).contiguous(), rowsum_z

    def _cross(x: torch.Tensor, mu: torch.Tensor, aux) -> torch.Tensor:
        """(X f64[F, B, (c r)], mu f64[B, R]) -> cross f64[L, Nl, B]."""
        zmat, rowsum_z = aux[0], aux[1]  # NCC's aux carries a third leaf (zsum)
        nl = rowsum_z.shape[0]
        b = x.shape[1]
        g = torch.bmm(zmat, x.transpose(1, 2))  # [F, (c', v), B]
        cross = (synth.T @ g.view(2 * fc, nl * b)).view(len(lags), nl, b)
        cross += (rowsum_z @ mu.T)[None]  # exact DC term, lag-independent
        return cross

    if scan.metric == "ssd":

        def prepare(lib: LibraryPack):
            return _prepare_rows(lib.flat)

        def _finish(cross, lib, lag_sum, nsq, aux):
            pen = (1.0 - lib.valid) * PAD_PENALTY
            gamma = (lib.sq + pen).double()  # the kernel's library term (f32 sum)
            cross.mul_(-2.0).add_(gamma[:, None]).add_(nsq.T.double()[:, None, :])
            return torch.amin(cross, dim=1).clamp_min(0.0).T.float()  # [B, L]

    else:

        def prepare(lib: LibraryPack):
            z = lib.z.double()
            return _prepare_rows(z) + (torch.sum(z, dim=1),)

        def _finish(cross, lib, lag_sum, lag_sq, aux):
            pen = (1.0 - lib.valid.double()) * PAD_PENALTY
            mu = (lag_sum.double() / p).T  # [L, B]
            var = ((lag_sq.double() / p).T - mu * mu).clamp_min(0.0)
            sigma = torch.sqrt(var + NCC_EPS)
            zdot = (cross - mu[:, None, :] * aux[2][None, :, None]) / sigma[:, None, :]
            d = 1.0 - zdot / p + pen[None, :, None]
            return torch.amin(d, dim=1).T.float()  # [B, L]

    def lib_min(s, lib: LibraryPack, lag_sum, lag_sq, aux=None, roll_k=None):
        if aux is None:
            aux = prepare(lib)
        b = s.shape[0]
        su = (s * inv_u).double()  # the kernel path's candidate values, widened
        spec = (su.reshape(b * r, a) @ forward_mats).view(b, r, 2, fc)
        if roll_k is not None:
            spec = torch.stack(_rotate(spec[:, :, 0], spec[:, :, 1], roll_k), dim=2)
        x = spec.permute(3, 0, 2, 1).reshape(fc, b, 2 * r)
        cross = _cross(x, torch.mean(su, dim=2), aux)
        if scan.metric == "ssd":
            # |cand(l)|^2 = |T_j|^2, j = l mod u, or (l + k) mod u in the phi frame
            csq = torch.sum((su * su).view(b, r, w, u), dim=(1, 2))  # [B, u]
            if roll_k is None:
                lag_sq = csq[:, residues]
            else:
                lag_sq = csq.gather(1, (residues[None, :] + roll_k.long()[:, None]) % u)
        return _finish(cross, lib, lag_sum, lag_sq, aux)

    def lib_min_spectral(spec, lib: LibraryPack, lag_sum, lag_sq, aux=None, roll_k=None):
        if aux is None:
            aux = prepare(lib)
        sre, sim, mu = (t.double() for t in spec)
        if roll_k is not None:
            sre, sim = _rotate(sre, sim, roll_k)
        b = sre.shape[0]
        x = torch.cat([sre, sim], dim=1).permute(2, 0, 1).reshape(fc, b, 2 * r)
        return _finish(_cross(x, mu, aux), lib, lag_sum, lag_sq, aux)

    lib_min.prepare = prepare
    lib_min.spectral = lib_min_spectral
    lib_min.forward_mats = forward_mats
    return lib_min
