"""Carry state from the JAX package (or any NumPy source) into the port.

Nothing here imports JAX: every input is read through NumPy
(``device.as_tensor``), so a JAX array, a NumPy array or a tensor all
convert. With one library scored in both packages, a test can tell render
drift from familiarity drift.
"""

from __future__ import annotations

import dataclasses

import torch

from navdv_torch.agent import EpisodeStatics, make_statics
from navdv_torch.config import AgentConfig, ScanConfig, SensorConfig, SimConfig
from navdv_torch.device import as_tensor, resolve_device
from navdv_torch.familiarity import LibraryPack, pack_library


def config_from(cfg) -> SimConfig:
    """The port's SimConfig with every field of ``cfg`` (a SimConfig of
    either package)."""
    d = dataclasses.asdict(cfg)
    return SimConfig(
        sensor=SensorConfig(**d["sensor"]),
        scan=ScanConfig(**d["scan"]),
        agent=AgentConfig(**d["agent"]),
        capture_spacing=d["capture_spacing"],
    )


def library_from_numpy(lib, device=None) -> LibraryPack:
    """Views f32[Nl, R, W] -> packed library; or a LibraryPack of either
    package (fields views/flat/sq/z/valid) -> the same arrays as the port's
    LibraryPack, unchanged."""
    dev = resolve_device(device)
    if all(hasattr(lib, f) for f in LibraryPack._fields):
        return LibraryPack(
            *(as_tensor(getattr(lib, f), torch.float32, dev) for f in LibraryPack._fields)
        )
    return pack_library(as_tensor(lib, torch.float32, dev))


def statics_from_numpy(landscape, lib, route, device=None) -> EpisodeStatics:
    """Episode constants from a landscape, a library (as
    :func:`library_from_numpy` takes it) and a route polyline."""
    dev = resolve_device(device)
    return make_statics(landscape, library_from_numpy(lib, dev), route, dev)
