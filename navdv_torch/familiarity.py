"""Familiarity library: packing and the per-metric preprocessing.

SSD over (candidates x library views) decomposes as ``|c|^2 + |l|^2 - 2 c.l``,
so the library keeps flattened views and their squared norms; NCC keeps
z-scored views. The scoring itself is the min-distance kernel
(:mod:`navdv_torch.ops.familiarity`) or the plain path in
:mod:`navdv_torch.agent`. The per-agent distance matrices and the
familiarity reduction (``ssd_matrix`` .. ``make_familiarity_jnp``) are the
JAX package's reference functions under its names, in plain PyTorch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from navdv_torch.config import ScanConfig, SensorConfig

NCC_EPS = 1e-8

PAD_PENALTY = 1e30  # added to padded library columns; they never win the min


class LibraryPack(NamedTuple):
    """Training library, preprocessed per metric.

    views: f32[Nl, R, W] raw views
    flat:  f32[Nl, P]    flattened views (SSD path)
    sq:    f32[Nl]       per-view squared norms (SSD path)
    z:     f32[Nl, P]    z-scored views (NCC path)
    valid: f32[Nl]       1.0 = real view, 0.0 = padding (invalid columns get
                         +PAD_PENALTY distance)
    """

    views: torch.Tensor
    flat: torch.Tensor
    sq: torch.Tensor
    z: torch.Tensor
    valid: torch.Tensor


def zscore(v: torch.Tensor, dim: int = -1) -> torch.Tensor:
    m = v.mean(dim=dim, keepdim=True)
    var = ((v - m) ** 2).mean(dim=dim, keepdim=True)
    return (v - m) / torch.sqrt(var + NCC_EPS)


def pack_library(views: torch.Tensor) -> LibraryPack:
    """views f32[Nl, R, W] -> LibraryPack (one-time, cold)."""
    flat = views.reshape(views.shape[0], -1)
    return LibraryPack(
        views=views,
        flat=flat,
        sq=torch.sum(flat * flat, dim=1),
        z=zscore(flat),
        valid=torch.ones(views.shape[0], dtype=torch.float32, device=views.device),
    )


def pad_library(lib: LibraryPack, multiple: int) -> LibraryPack:
    """Pad Nl up to a multiple with zero views marked invalid; the
    familiarity paths add +PAD_PENALTY to invalid columns so they never win
    the min (counterpart of the JAX package's ``parallel.mesh.pad_library``)."""
    nl = lib.views.shape[0]
    rem = (-nl) % multiple
    if rem == 0:
        return lib

    def pad(x):
        return torch.cat([x, x.new_zeros((rem,) + tuple(x.shape[1:]))], dim=0)

    return LibraryPack(*(pad(x) for x in lib))


# The JAX functions below take ``precision`` (MXU pass counts, JAX's
# ``matmul_precision``); the port's have none: their products and sums are
# fp64 on every device (ROADMAP C.1), so no pass count applies.


def _pad_penalty(lib: LibraryPack) -> torch.Tensor:
    return (1.0 - lib.valid.double()) * PAD_PENALTY


def ssd_matrix(cand: torch.Tensor, lib: LibraryPack) -> torch.Tensor:
    """``d[..., s, v] = sum((cand_s - lib_v)^2)`` via the matmul
    decomposition, f64 from ``cand`` f32[..., Ns, P]: one product for the
    cross term, clamped at 0 (cancellation noise), +PAD_PENALTY on invalid
    library columns. Leading dims batch agents, as a vmapped JAX call. The
    sums are in the order of the step's ``"plain"`` path (agent.py), so the
    two agree bit for bit on the same candidates."""
    c = cand.double()
    cross = torch.einsum("...sp,vp->...sv", c, lib.flat.double())
    csq = torch.sum(c * c, dim=-1)
    d = -2.0 * cross + csq[..., None] + lib.sq.double()
    return d.clamp_min(0.0) + _pad_penalty(lib)


def ncc_matrix(cand: torch.Tensor, lib: LibraryPack) -> torch.Tensor:
    """``d[..., s, v] = 1 - mean(z(cand_s) * z(lib_v))`` in f64, +PAD_PENALTY
    on invalid library columns."""
    p = cand.shape[-1]
    zc = zscore(cand.double())
    d = 1.0 - torch.einsum("...sp,vp->...sv", zc, lib.z.double()) / p
    return d + _pad_penalty(lib)


def distance_matrix(cand: torch.Tensor, lib: LibraryPack, metric: str) -> torch.Tensor:
    if metric == "ssd":
        return ssd_matrix(cand, lib)
    if metric == "ncc":
        return ncc_matrix(cand, lib)
    raise ValueError(metric)


def reduce_familiarity(d_ext: torch.Tensor, scan: ScanConfig) -> torch.Tensor:
    """``d_ext [..., Nh*(2t+1), Nl]`` over the extended shift set ->
    ``fam [..., Nh]``: the RIDF min-pool over each heading's tolerance
    window, then the minimum over the library (a plain minimum over Nl at
    ``tol_bins=0``)."""
    w = 2 * scan.tol_bins + 1
    d = d_ext.reshape(*d_ext.shape[:-2], scan.n_headings, w * d_ext.shape[-1])
    return torch.amin(d, dim=-1)


def make_familiarity_jnp(sensor: SensorConfig, scan: ScanConfig):
    """Reference ``fam(cand_ext f32[..., Ne, P], lib) -> f32[..., Nh]``:
    distance matrix, then :func:`reduce_familiarity`. The JAX name is kept
    so a reader finds the counterpart; it is the per-agent reference that
    the step's ``"plain"`` path batches over deduplicated lags."""
    if scan.metric not in ("ssd", "ncc"):
        raise ValueError(f"unknown familiarity metric {scan.metric!r}")

    def fam(cand_ext: torch.Tensor, lib: LibraryPack) -> torch.Tensor:
        return reduce_familiarity(distance_matrix(cand_ext, lib, scan.metric), scan).float()

    return fam
