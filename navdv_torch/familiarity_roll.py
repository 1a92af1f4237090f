"""Rolled-library familiarity: the lag scan's cross term as one product
against a pre-rolled library, with no [B, L, P] candidate tensor.

Counterpart of the JAX package's ``familiarity_roll.py``. Decompose lag
``l = q·u + j`` (j = l mod u). The candidate view is a cyclic W-roll of the
residue-j phase plane of the pooled panorama:

    cand(l)[r, w] = T_j[r, (w + q) mod W],   T_j[r, w] = S[r, w·u + j] / u

so the cross term against library view v is

    cross[l, v] = sum_{r,w} T_j[r, w] · lib[v, r, (w - q) mod W]

i.e. ONE product ``[B·u, R·W] @ [R·W, |Q|·Nl]`` against a library rolled
once per episode (``lib_min.prepare``). Distances and the minimum over the
library are taken in the product's grid layout ``[B, u, |Q|, Nl]``; only the
``[B, L]`` minima are gathered back to lag order.

Numerics (ROADMAP C.7): ``T_j`` is built from ``fl32(S / u)``, the fp32
tensor the min-distance kernel scores (``sensor.make_views_from_pooled``),
and only then widened to fp64; products and sums run in fp64 (ROADMAP C.1).
SSD's candidate norm is ``|T_j|^2``, since candidate ``l`` is a roll of
``T_j``, summed in fp64 per (b, j); the library term is ``lib.sq + pen`` as
the kernel takes it. The dense path then equals the kernel path up to fp64
summation order. NCC takes mean and spread from the lag statistics of the
pooled panorama in fp64, as the plain NCC path does.
"""

from __future__ import annotations

import numpy as np
import torch

from navdv_torch.config import ScanConfig, SensorConfig
from navdv_torch.device import resolve_device
from navdv_torch.familiarity import NCC_EPS, PAD_PENALTY, LibraryPack


def _lag_grid(lags: np.ndarray, u: int):
    """Static (j, q) decomposition. Returns (qs_unique, grid_rows, inv_rows):
    ``grid_rows[i] = j_i * |Q| + index(q_i)`` maps lag i into the flattened
    (j, q) grid; ``inv_rows[g]`` maps a grid cell back to SOME lag index with
    that (j, q) (0 for cells no lag uses: their values are never gathered)."""
    lags = np.asarray(lags)
    js = np.mod(lags, u)
    qs = (lags - js) // u
    qs_unique = np.unique(qs)
    q_index = {int(q): i for i, q in enumerate(qs_unique)}
    nq = len(qs_unique)
    grid_rows = np.array(
        [int(j) * nq + q_index[int(q)] for j, q in zip(js, qs)], dtype=np.int32
    )
    inv_rows = np.zeros(u * nq, dtype=np.int32)
    inv_rows[grid_rows] = np.arange(len(lags), dtype=np.int32)
    return qs_unique, grid_rows, inv_rows


def _ssd_lib_min(neg2cross: torch.Tensor, csq: torch.Tensor, lib: LibraryPack) -> torch.Tensor:
    """SSD minimum in the grid layout, in place on ``neg2cross f64[B, u, nq,
    Nl]`` = -2 cross: ``min_v(-2 cross + (|T_j|^2 + lib.sq[v] + pen[v]))``
    clamped at 0 -> f64[B, u, nq]. ``csq f64[B, u]`` is |T_j|^2. The -2
    rides in the prepared library (a power of two: exact), so the grid takes
    one pass before its minimum."""
    pen = (1.0 - lib.valid) * PAD_PENALTY
    gamma = (lib.sq + pen).double()  # the kernel's library term (f32 sum)
    neg2cross.add_((csq[:, :, None] + gamma)[:, :, None, :])
    return torch.amin(neg2cross, dim=3).clamp_min(0.0)


def _quant(x: torch.Tensor) -> torch.Tensor:
    """f32 views in [0, 1] -> centered int8 ``round(255 x) - 128``
    (round half to even, as ``jnp.round``)."""
    return (
        torch.clamp(torch.round(x * 255.0), 0.0, 255.0).to(torch.int32) - 128
    ).to(torch.int8)


def _pad_to(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """Zero-pad a 2-D tensor up to [rows, cols] (no copy when it fits)."""
    if x.shape == (rows, cols):
        return x
    out = x.new_zeros((rows, cols))
    out[: x.shape[0], : x.shape[1]] = x
    return out


def _ceil8(n: int) -> int:
    return -(-n // 8) * 8


def _int8_cross(qa: torch.Tensor, qb_pad: torch.Tensor, n: int) -> torch.Tensor:
    """Exact ``qa i8[M, K] . qb i8[N, K]^T -> i32[M, N]`` by ``torch._int_mm``.

    Its CUDA path takes M > 16 rows, K and N multiples of 8 and a
    column-major right operand. ``qb_pad`` is the library already padded
    with zero rows and columns to multiples of 8 (prepare stage); ``qa`` is
    padded here with zero rows and columns, and the padding is sliced off.
    Zero entries add nothing to the integer products."""
    m = qa.shape[0]
    qa_p = _pad_to(qa, max(_ceil8(m), 24), qb_pad.shape[1])
    return torch._int_mm(qa_p, qb_pad.t())[:m, :n]


def _make_ssd_lowrank(rank, _prepare_rows, _t_planes, grid_rows_dev, u, nq):
    """Exact low-rank split of the SSD cross term (``ScanConfig.roll_rank``).

    With m the mean library view and ``l_v - m = U y_v + r_v`` for any basis
    U f64[P, k] (r_v := the exact remainder),

        c.l_v = c.m + (c.U) y_v + c.r_v

    holds in real arithmetic whatever U is. U is the library's top-k
    principal directions (``eigh`` of the fp64 Gram matrix at prepare time,
    zero-variance directions zeroed), so |r_v| is small for a smooth route
    library. The k-wide pieces run in fp64; only the full-width residual
    product runs at one bf16 pass, as the JAX package runs it: both operands
    rounded to bf16 and multiplied in fp32 (bf16 x bf16 products are exact
    there). This is the one bf16 product on a distance path (ROADMAP C.6),
    and only on request. Eigenvector signs differ between LAPACK builds; the
    identity does not depend on them. The prepared pieces carry the SSD's
    -2 (exact), as the dense path's library does.
    """

    def prepare(lib: LibraryPack):
        flat = lib.flat.double()
        valid = lib.valid.double()
        nl = flat.shape[0]
        k = min(rank, nl)
        nv = torch.sum(valid).clamp_min(1.0)
        m = torch.sum(flat * valid[:, None], dim=0) / nv  # [P]
        zc = (flat - m[None, :]) * valid[:, None]  # [Nl, P]
        w, v = torch.linalg.eigh(zc @ zc.T)  # ascending
        w_top = w[-k:]
        v_top = v[:, -k:]  # [Nl, k]
        ok = w_top > 1e-6 * w[-1].clamp_min(1e-12)
        inv_sig = torch.where(ok, 1.0 / torch.sqrt(w_top.clamp_min(1e-12)), 0.0)
        basis = zc.T @ (v_top * inv_sig[None, :])  # [P, k]
        y = zc @ basis  # [Nl, k]
        resid = zc - y @ basis.T  # [Nl, P] exact remainder
        return (
            -2.0 * _prepare_rows(m[None, :]),  # [nq, P]
            _prepare_rows(basis.T),  # [nq*k, P]
            -2.0 * y,
            -2.0 * _prepare_rows(resid).to(torch.bfloat16).float(),  # [nq*Nl, P], bf16 values
        )

    def lib_min(s, lib: LibraryPack, lag_sum, lag_sq, aux=None):
        mrows, urows, y, rrows = prepare(lib) if aux is None else aux
        b = s.shape[0]
        nl = lib.flat.shape[0]
        k = urows.shape[0] // nq
        t = _t_planes(s)  # f32[B*u, P]
        t64 = t.double()
        neg2cross = torch.einsum("bjqk,vk->bjqv", (t64 @ urows.T).view(b, u, nq, k), y)
        neg2cross += (t64 @ mrows.T).view(b, u, nq, 1)
        neg2cross += (t.to(torch.bfloat16).float() @ rrows.T).view(b, u, nq, nl)
        csq = torch.sum(t64 * t64, dim=1).view(b, u)
        m_grid = _ssd_lib_min(neg2cross, csq, lib)  # [B, u, nq]
        return m_grid.reshape(b, u * nq)[:, grid_rows_dev].float()  # [B, L]

    lib_min.prepare = prepare
    return lib_min


def _make_ssd_fixed_point(_prepare_rows, _t_planes, grid_rows_dev, u, nq, n_pixels):
    """Exact fixed-point SSD (``ScanConfig.fixed_point_bits=8``).

    Candidate planes and the pre-rolled library are quantized to the 1/255
    grid as centered int8, ``q = round(255 v) - 128``; the common shift
    cancels in every difference, so

        d[l, v] = sum_p (qc_p - ql_p)^2 / 255^2

    is the EXACT SSD between the quantized images. The cross term is one
    int8 x int8 -> int32 product (``torch._int_mm``) and the squared norms
    are int32 sums of the same quantized tensors; the f32 conversion, the
    1/255^2 scale and then the padding penalty follow in the JAX package's
    order, so the result equals it bit for bit. The int32 envelope is
    checked when the path is built: the largest quantized SSD is P * 255^2.
    """
    inv_s2 = 1.0 / (255.0 * 255.0)
    max_d = int(n_pixels) * 255 * 255  # worst-case quantized SSD
    if max_d >= 2**31:
        raise ValueError(
            f"fixed_point_bits=8 exceeds the int32 budget: {n_pixels} px "
            f"gives max quantized SSD {max_d:.3g} >= 2^31 (silent wraparound);"
            f" use a float fam path for sensors this large"
        )

    def prepare(lib: LibraryPack):
        qz = _quant(_prepare_rows(lib.flat))  # [nq*Nl, P] int8
        qz_sq = torch.sum(qz.to(torch.int32) ** 2, dim=1)  # [nq*Nl], (q-major, v)
        return _pad_to(qz, _ceil8(qz.shape[0]), _ceil8(qz.shape[1])), qz_sq

    def lib_min(s, lib: LibraryPack, lag_sum, lag_sq, aux=None):
        qz_pad, qz_sq = prepare(lib) if aux is None else aux
        b = s.shape[0]
        nl = lib.valid.shape[0]
        qt = _quant(_t_planes(s))  # [B*u, P] int8
        qc_sq = torch.sum(qt.to(torch.int32) ** 2, dim=1)  # [B*u]
        cross = _int8_cross(qt, qz_pad, qz_sq.shape[0])  # [B*u, nq*Nl] int32, exact
        d = qc_sq[:, None] + qz_sq[None, :] - 2 * cross  # exact, in [0, max_d]
        pen = (1.0 - lib.valid) * PAD_PENALTY  # f32 [Nl]: always dominates
        df = d.view(b, u, nq, nl).float() * inv_s2 + pen
        m_grid = torch.amin(df, dim=3)  # [B, u, nq]
        return m_grid.reshape(b, u * nq)[:, grid_rows_dev]  # [B, L]

    lib_min.prepare = prepare
    return lib_min


def make_lib_min_roll(sensor: SensorConfig, scan: ScanConfig, lags: np.ndarray, device=None):
    """Per-lag library minimum via the rolled-library product:
    ``lib_min(S f32[B, R, A], lib, lag_sum, lag_sq, aux=None) -> M f32[B, L]``
    from the pooled panorama S (no candidate extraction).
    ``lib_min.prepare(lib)`` builds the pre-rolled library once per library.

    ``lag_sum``/``lag_sq`` (f64[B, L], ``sensor.make_lag_stats`` of the
    pooled panorama in fp64) serve NCC; the SSD paths take their norms from
    the phase planes themselves and ignore them."""
    if scan.metric not in ("ssd", "ncc"):
        raise ValueError(f"unknown familiarity metric {scan.metric!r}")
    if scan.roll_rank > 0 and scan.metric != "ssd":
        # the low-rank split is an SSD cross-term identity; silently ignoring
        # the knob on NCC would read as "low rank is free"
        raise ValueError(
            f"ScanConfig.roll_rank={scan.roll_rank} requires metric='ssd' "
            f"(got {scan.metric!r})"
        )
    if scan.fixed_point_bits and scan.metric != "ssd":
        raise ValueError(
            f"ScanConfig.fixed_point_bits={scan.fixed_point_bits} requires "
            f"metric='ssd' (got {scan.metric!r})"
        )
    dev = resolve_device(device)
    r, w, u = sensor.n_radial, sensor.n_azimuth, sensor.az_upsample
    p = float(sensor.n_pixels)

    qs_unique, grid_rows, inv_rows = _lag_grid(np.asarray(lags), u)
    nq = len(qs_unique)
    # static roll gather: rolled[qi, v, r, w] = zrows[v, r, (w - q) mod W]
    wmat = np.mod(np.arange(w)[None, :] - qs_unique[:, None], w)  # [nq, W]
    roll_idx = torch.as_tensor(wmat.astype(np.int64), device=dev)
    grid_rows_dev = torch.as_tensor(grid_rows.astype(np.int64), device=dev)
    inv_rows_dev = torch.as_tensor(inv_rows.astype(np.int64), device=dev)
    inv_u = 1.0 / u

    def _prepare_rows(zrows: torch.Tensor) -> torch.Tensor:
        """zrows [Nl, P] -> pre-rolled library [|Q|*Nl, P] (q-major rows: the
        product's output grid is then [(b, j), (q, v)])."""
        nl = zrows.shape[0]
        zrolled = zrows.reshape(nl, r, w)[:, :, roll_idx]  # [Nl, R, nq, W]
        return zrolled.permute(2, 0, 1, 3).reshape(nq * nl, r * w)

    def _t_planes(s: torch.Tensor) -> torch.Tensor:
        """S f32[B, R, A] -> residue phase planes f32[B*u, R*W]:
        T[b, j, r, w] = fl32(S[b, r, w*u + j] / u), the kernel path's
        candidate values."""
        b = s.shape[0]
        t = (s * inv_u).reshape(b, r, w, u).permute(0, 3, 1, 2)
        return t.reshape(b * u, r * w)

    def _to_grid(per_lag: torch.Tensor) -> torch.Tensor:
        """[B, L] per-lag values -> [B, u, nq] grid (unused cells carry a
        duplicate value that is never gathered back)."""
        return per_lag[:, inv_rows_dev].reshape(-1, u, nq)

    if scan.metric == "ssd":
        if scan.fixed_point_bits:
            if scan.fixed_point_bits != 8:
                raise ValueError(
                    f"fixed_point_bits must be 0 or 8, got {scan.fixed_point_bits}"
                )
            if scan.roll_rank > 0:
                raise ValueError("fixed_point_bits and roll_rank are exclusive")
            return _make_ssd_fixed_point(
                _prepare_rows, _t_planes, grid_rows_dev, u, nq, sensor.n_pixels
            )
        if scan.roll_rank > 0:
            return _make_ssd_lowrank(
                scan.roll_rank, _prepare_rows, _t_planes, grid_rows_dev, u, nq
            )

        def prepare(lib: LibraryPack):
            return -2.0 * _prepare_rows(lib.flat.double())  # exact scaling

        def lib_min(s, lib: LibraryPack, lag_sum, lag_sq, aux=None):
            rows = prepare(lib) if aux is None else aux
            b = s.shape[0]
            t64 = _t_planes(s).double()
            # the [B*u, nq*Nl] product is the step's one large tensor; the
            # distances are formed in it in place
            neg2cross = (t64 @ rows.T).view(b, u, nq, -1)
            csq = torch.sum(t64 * t64, dim=1).view(b, u)
            m_grid = _ssd_lib_min(neg2cross, csq, lib)  # [B, u, nq]
            return m_grid.reshape(b, u * nq)[:, grid_rows_dev].float()  # [B, L]

        lib_min.prepare = prepare
        return lib_min

    def prepare(lib: LibraryPack):
        z = lib.z.double()
        return _prepare_rows(z), torch.sum(z, dim=1)  # zsum: ~0 for z-scored views, kept exact

    def lib_min(s, lib: LibraryPack, lag_sum, lag_sq, aux=None):
        rows, zsum = prepare(lib) if aux is None else aux
        b = s.shape[0]
        cross = (_t_planes(s).double() @ rows.T).view(b, u, nq, -1)
        pen = (1.0 - lib.valid.double()) * PAD_PENALTY
        mu = _to_grid(lag_sum / p)  # [B, u, nq]
        var = (_to_grid(lag_sq / p) - mu * mu).clamp_min(0.0)
        sigma = torch.sqrt(var + NCC_EPS)
        zdot = (cross - mu[..., None] * zsum) / sigma[..., None]
        d = 1.0 - zdot / p + pen
        m_grid = torch.amin(d, dim=3)  # [B, u, nq]
        return m_grid.reshape(b, u * nq)[:, grid_rows_dev].float()  # [B, L]

    lib_min.prepare = prepare
    return lib_min
