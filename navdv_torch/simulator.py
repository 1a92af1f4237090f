"""High-level facade: one object owns the landscape, the route, the trained
library and the episode function (counterpart of the JAX package's
``simulator.py``).

>>> sim = NavigationSimulator.from_config(baseline_config(1), landscape, route)
>>> sim.train()
>>> result = sim.navigate(n_trials=1024, seed=0)
>>> result.success_rate
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from navdv_torch.agent import init_state, make_navigate_batch, make_statics, resolve_fam_impl
from navdv_torch.config import SimConfig
from navdv_torch.device import as_tensor, resolve_device
from navdv_torch.metrics import episode_metrics, success_rate
from navdv_torch.oracle import resample_route
from navdv_torch.trials import make_trials


@dataclasses.dataclass
class NavigationResult:
    """Batched recall outcome with the trajectory record attached."""

    success_rate: float
    metrics: dict[str, Any]
    final_state: Any
    record: Any  # StepRecord [B, T, ...]

    def plot(self, landscape, route, out_path: str) -> str:
        raise NotImplementedError(
            "trajectory plots are not ported yet: ROADMAP A.16 (viz and CLI)"
        )


class NavigationSimulator:
    """Owns landscape + route + trained library + the episode function.

    ``fam_impl="auto"`` picks the familiarity path the JAX package picks for
    ``cfg`` (``agent.resolve_fam_impl``); ``self.fam_impl`` is the port's
    name for it. Every BASELINE config runs as the JAX package ships it:
    configs 1 and 4 on ``"fft"``, 2 on ``"roll"``, and 3 on ``"fft"``
    through the sector renderer's fused front end. ``device=None`` means
    the card."""

    def __init__(self, cfg: SimConfig, landscape, route, fam_impl: str = "auto", device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.landscape = as_tensor(landscape, torch.float32, self.device)
        self.route = np.asarray(route, np.float64)
        self.fam_impl = resolve_fam_impl(cfg, fam_impl)
        self._navigate = make_navigate_batch(cfg, fam_impl=self.fam_impl, device=self.device)
        self.library = None
        self._statics = None
        self._aux = None

    @classmethod
    def from_config(cls, cfg: SimConfig, landscape, route, **kw) -> "NavigationSimulator":
        return cls(cfg, landscape, route, **kw)

    def train(self) -> "NavigationSimulator":
        """Capture the training-view library along the route."""
        from navdv_torch.training import train_library

        return self._use_library(train_library(self.landscape, self.route, self.cfg,
                                               device=self.device))

    def _use_library(self, library) -> "NavigationSimulator":
        """Statics for ``library`` and its per-library constants (pre-rolled
        library, library spectra), built once and reused by every
        navigate() call."""
        self.library = library
        self._statics = make_statics(self.landscape, library, self.route, self.device)
        prepare = self._navigate.prepare
        self._aux = None if prepare is None else prepare(self._statics)
        return self

    def save_library(self, path: str) -> None:
        from navdv_torch.checkpoint import save_library

        save_library(path, self.library)

    def load_library(self, path: str) -> "NavigationSimulator":
        from navdv_torch.checkpoint import load_library

        return self._use_library(load_library(path, self.device))

    def navigate(
        self,
        n_trials: int = 1,
        seed: int = 0,
        pos_sigma: float = 1.5,
        heading_sigma: float = 0.15,
        starts=None,
        headings=None,
        start_anywhere: bool = False,
    ) -> NavigationResult:
        """Run batched recall episodes from randomized (or given) starts;
        ``start_anywhere`` samples starts uniformly along the route. When
        ``starts`` is given without ``headings``, each agent faces the route
        tangent at its nearest captured route point."""
        if self.library is None:
            raise RuntimeError("call train() or load_library() first")
        if starts is None:
            if headings is not None:
                raise ValueError("headings given without starts")
            starts, headings = make_trials(
                self.route, self.cfg, n_trials, seed=seed,
                pos_sigma=pos_sigma, heading_sigma=heading_sigma,
                start_anywhere=start_anywhere,
            )
        else:
            # both explicit-start call styles take an unbatched [2] start
            starts = np.atleast_2d(np.asarray(starts, np.float64))
            if headings is None:
                pts, hd = resample_route(self.route, self.cfg.capture_spacing)
                nearest = np.argmin(
                    ((starts[:, None, :] - pts[None, :, :]) ** 2).sum(-1),
                    axis=1,
                )
                headings = hd[nearest]
            else:
                headings = np.atleast_1d(np.asarray(headings, np.float64))
                if headings.shape[0] != starts.shape[0]:
                    raise ValueError(
                        f"headings batch {headings.shape[0]} != starts "
                        f"batch {starts.shape[0]}"
                    )
        final, rec = self._navigate(init_state(starts, headings, self.device),
                                    self._statics, self._aux)
        m = episode_metrics(final, rec)
        return NavigationResult(
            success_rate=float(success_rate(final)),  # waits for the episode
            metrics={k: v.cpu().numpy() for k, v in m.items()},
            final_state=final,
            record=rec,
        )

    def start_pose(self) -> tuple[np.ndarray, float]:
        """(route start point, initial tangent heading)."""
        pts, hd = resample_route(self.route, self.cfg.capture_spacing)
        return pts[0], float(hd[0])
