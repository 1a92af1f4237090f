"""Trial randomization: host NumPy, seeded (a copy of the JAX package's)."""

from __future__ import annotations

import numpy as np

from navdv_torch.config import SimConfig
from navdv_torch.oracle import resample_route


def make_trials(
    route: np.ndarray,
    cfg: SimConfig,
    n: int,
    seed: int = 0,
    pos_sigma: float = 1.5,
    heading_sigma: float = 0.15,
    start_anywhere: bool = False,
) -> tuple[np.ndarray, np.ndarray]:
    """n randomized (start_xy [n, 2], start_theta [n]) around the route start.

    ``start_anywhere`` samples the start point uniformly along the route
    instead.
    """
    rng = np.random.default_rng(seed)
    pts, headings = resample_route(np.asarray(route, np.float64), cfg.capture_spacing)
    if start_anywhere:
        idx = rng.integers(0, max(len(pts) - 2, 1), size=n)
    else:
        idx = np.zeros(n, dtype=int)
    starts = pts[idx] + rng.normal(0.0, pos_sigma, size=(n, 2))
    thetas = headings[idx] + rng.normal(0.0, heading_sigma, size=n)
    return starts.astype(np.float32), thetas.astype(np.float32)
