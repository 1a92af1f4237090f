"""Familiarity library: packing and the per-metric preprocessing.

SSD over (candidates x library views) decomposes as ``|c|^2 + |l|^2 - 2 c.l``,
so the library keeps flattened views and their squared norms; NCC keeps
z-scored views. The scoring itself is the min-distance kernel
(:mod:`navdv_torch.ops.familiarity`) or the plain path in
:mod:`navdv_torch.agent`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

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
