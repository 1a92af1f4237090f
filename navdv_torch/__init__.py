"""navdv_torch — scene-familiarity route navigation on an NVIDIA GPU.

The PyTorch/CUDA port of :mod:`navdv_tpu`. An agent renders a polar
panorama of a textured landscape, scores each candidate heading's view
against a library of views stored along a training route, and steps along
the most familiar heading. The render and the familiarity minimum run in
hand-written CUDA kernels (:mod:`navdv_torch.ops`); everything else is
PyTorch. Entry points run on the card unless the caller passes
``device="cpu"``.

Layer map:
  L0 landscape   -> :mod:`navdv_torch.landscape`, :mod:`navdv_torch.routes`
  L1 sensor      -> :mod:`navdv_torch.sensor` (+ ops.window, ops.render)
  L2 familiarity -> :mod:`navdv_torch.familiarity` (+ ops.familiarity)
  L3 agent loop  -> :mod:`navdv_torch.agent`
  L4 metrics     -> :mod:`navdv_torch.metrics`
"""

from __future__ import annotations

from navdv_torch.agent import init_state, make_navigate_batch, make_statics
from navdv_torch.config import (
    AgentConfig,
    ScanConfig,
    SensorConfig,
    SimConfig,
    baseline_config,
)
from navdv_torch.landscape import make_landscape
from navdv_torch.metrics import episode_metrics, success_rate
from navdv_torch.routes import make_route
from navdv_torch.training import train_library
from navdv_torch.trials import make_trials

__version__ = "0.1.0"

__all__ = [
    "AgentConfig",
    "ScanConfig",
    "SensorConfig",
    "SimConfig",
    "baseline_config",
    "episode_metrics",
    "init_state",
    "make_landscape",
    "make_navigate_batch",
    "make_route",
    "make_statics",
    "make_trials",
    "success_rate",
    "train_library",
]
