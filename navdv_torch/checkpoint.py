"""Checkpoints: trained libraries and result tables as ``.npz`` files.

Counterpart of the JAX package's ``checkpoint.py``, which keeps libraries
with orbax. Here a library is one ``.npz`` of the ``LibraryPack`` fields;
every write goes to a temporary file beside the target and is renamed over
it (``os.replace``), so a reader never sees half a file.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from navdv_torch.device import resolve_device
from navdv_torch.familiarity import LibraryPack

_INFOMAX = "ROADMAP A.13 (infomax learned memory)"


def _write_npz(path: str, arrays: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:  # a file object: np.savez appends no suffix
        np.savez(f, **arrays)
    os.replace(tmp, path)


def save_library(path: str, lib: LibraryPack) -> None:
    """Write a trained library to ``path`` (exactly that name) atomically."""
    _write_npz(path, {k: v.detach().cpu().numpy() for k, v in lib._asdict().items()})


def load_library(path: str, device=None) -> LibraryPack:
    """A library written by :func:`save_library`, on ``device`` (None: the
    card)."""
    dev = resolve_device(device)
    with np.load(path, allow_pickle=False) as f:
        missing = set(LibraryPack._fields) - set(f.files)
        if missing:
            raise ValueError(f"{path}: not a library checkpoint (missing {sorted(missing)})")
        return LibraryPack(*(torch.from_numpy(f[k]).to(dev) for k in LibraryPack._fields))


def save_results(path: str, results: dict) -> None:
    """Atomic npz write (tmp + rename) for per-cell sweep results."""
    tmp = path + ".tmp.npz"
    np.savez(tmp, **results)
    os.replace(tmp, path)


def load_results(path: str) -> dict:
    with np.load(path, allow_pickle=False) as f:
        return {k: f[k] for k in f.files}


def save_infomax(path: str, pack) -> None:
    raise NotImplementedError(f"the infomax memory is not ported yet: {_INFOMAX}")


def load_infomax(path: str):
    raise NotImplementedError(f"the infomax memory is not ported yet: {_INFOMAX}")
