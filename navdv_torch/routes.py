"""Training-route generators: host NumPy, a copy of the JAX package's."""

from __future__ import annotations

import numpy as np


def make_route(
    kind: str = "line",
    size: tuple[int, int] = (512, 512),
    margin: float = 40.0,
    length: float | None = None,
    amplitude: float = 30.0,
    periods: float = 1.5,
    n_points: int | None = None,
) -> np.ndarray:
    """Build a route polyline f64[N, 2] across the landscape.

    kinds: ``line`` (straight horizontal sweep at mid-height) | ``sine``
    (sinusoidal sweep). ``length`` caps the horizontal extent (world units).
    ``n_points`` defaults to ~1 point per world unit.
    """
    h, w = size
    x0 = margin
    x1 = w - margin if length is None else min(x0 + length, w - margin)
    if n_points is None:
        n_points = max(32, int(np.ceil(x1 - x0)) + 1)
    xs = np.linspace(x0, x1, n_points)
    if kind == "line":
        ys = np.full_like(xs, h / 2.0)
    elif kind == "sine":
        ys = h / 2.0 + amplitude * np.sin(
            2 * np.pi * periods * (xs - x0) / max(x1 - x0, 1e-9)
        )
    else:
        raise ValueError(f"unknown route kind {kind!r}")
    return np.stack([xs, ys], axis=1)
