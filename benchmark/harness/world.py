"""The world and the trials of a run, made from ``--seed``.

The bench world: a square ``blobs`` landscape (Gaussian bumps of random
place, width and signed amplitude, normalized to [0, 1]) and a sine route.
The landscape is drawn on the run's device by one ``torch.Generator`` in a
few large calls; the same tensor goes to the program and to the reference.
Trials are drawn on the host, one batch per episode, from a NumPy generator
seeded by ``--seed``: episode i's trials depend on the seed and on i alone.
A traffic that states ``world_seed`` draws its landscape from that in place
of ``--seed`` (``drive.make_world``).
"""

from __future__ import annotations

import numpy as np
import torch

from reference.navref import resample_route


def make_landscape(seed: int, world: dict, device) -> torch.Tensor:
    """f32[size, size] in [0, 1]: ``n_features`` Gaussian bumps, centres
    uniform over the square, sigma uniform in [0.01, 0.05] x size, amplitude
    uniform in [0.3, 1] with a random sign. The image is a sum of separable
    bumps, so it is one product ``Gy^T diag(amp) Gx``."""
    if world["landscape"] != "blobs":
        raise ValueError(f"unknown landscape {world['landscape']!r}")
    n, size = int(world["n_features"]), int(world["size"])
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    u = torch.rand((5, n), generator=g, device=device, dtype=torch.float64)
    cx, cy = u[0] * size, u[1] * size
    sigma = size * (0.01 + 0.04 * u[2])
    amp = (0.3 + 0.7 * u[3]) * torch.where(u[4] < 0.5, -1.0, 1.0)
    t = torch.arange(size, device=device, dtype=torch.float64)
    gx = torch.exp(-((t[None, :] - cx[:, None]) ** 2) / (2 * sigma[:, None] ** 2))  # [n, W]
    gy = torch.exp(-((t[None, :] - cy[:, None]) ** 2) / (2 * sigma[:, None] ** 2))  # [n, H]
    img = gy.T @ (amp[:, None] * gx)
    lo, hi = img.min(), img.max()
    return ((img - lo) / (hi - lo)).float().contiguous()


def make_route(world: dict) -> np.ndarray:
    """The sine route f64[N, 2]: from x = margin over ``route_length`` world
    units at mid-height, amplitude ``route_length / 8``, 1.5 periods, about
    one point per unit."""
    size, margin, length = world["size"], world["margin"], world["route_length"]
    x0 = margin
    x1 = min(x0 + length, size - margin)
    n = max(32, int(np.ceil(x1 - x0)) + 1)
    xs = np.linspace(x0, x1, n)
    ys = size / 2.0 + (length / 8.0) * np.sin(2 * np.pi * 1.5 * (xs - x0) / (x1 - x0))
    return np.stack([xs, ys], axis=1)


def route_geometry(config: dict, route: np.ndarray) -> tuple[float, np.ndarray, np.ndarray]:
    """(capture spacing, route points, headings): the spacing that gives
    exactly the configuration's ``views`` stored views along the route's arc.
    The step budget, ``max_steps``, is ``step_budget`` times the arc in
    steps; a configuration whose stated budget disagrees raises."""
    arc = float(np.hypot(*np.diff(route, axis=0).T).sum())
    spacing = arc / (config["views"] - 0.5)
    agent = config["sim"]["agent"]
    budget = int(arc / agent["step_size"] * config["step_budget"])
    if budget != agent["max_steps"]:
        raise ValueError(f"max_steps {agent['max_steps']} is not {config['step_budget']} x "
                         f"the route's {arc:.3f} steps ({budget})")
    pts, headings = resample_route(route, spacing)
    if len(pts) != config["views"]:
        raise ValueError(f"{len(pts)} views along the route, not {config['views']}")
    return spacing, pts, headings


class Trials:
    """Start poses, one batch per call, from ``default_rng([seed, stream])``:
    ``pos_sigma`` world units and ``heading_sigma`` rad of Gaussian noise
    round a capture of the route. The traffic's ``starts`` says which:
    ``"route_start"`` (the default) the first capture; ``"anywhere"`` a
    capture drawn uniformly for each agent from ``[0, max(n - 2, 1))`` of
    the route's n, before the noise, as ``navdv_torch.trials.make_trials(
    start_anywhere=True)`` draws it. Batch i is the same whatever the number
    of batches drawn."""

    def __init__(self, seed: int, stream: int, pts: np.ndarray, headings: np.ndarray,
                 traffic: dict):
        starts = traffic.get("starts", "route_start")
        if starts not in ("route_start", "anywhere"):
            raise ValueError(f"unknown starts {starts!r}")
        self._rng = np.random.default_rng([int(seed), stream])
        self._pts, self._headings = pts, headings
        self._anywhere = starts == "anywhere"
        self._batch = int(traffic["batch"])
        self._pos = float(traffic["pos_sigma"])
        self._theta = float(traffic["heading_sigma"])

    def draw(self) -> tuple[np.ndarray, np.ndarray]:
        if self._anywhere:
            idx = self._rng.integers(0, max(len(self._pts) - 2, 1), size=self._batch)
            at, heading = self._pts[idx], self._headings[idx]
        else:
            at, heading = self._pts[0][None, :], self._headings[0]
        z = self._rng.standard_normal((self._batch, 3))
        starts = (at + self._pos * z[:, :2]).astype(np.float32)
        thetas = (heading + self._theta * z[:, 2]).astype(np.float32)
        return starts, thetas
