"""Host-side route resampling shared by training and trials (a copy of the
JAX package's ``oracle.resample_route``; the rest of that oracle is not
ported)."""

from __future__ import annotations

import numpy as np


def resample_route(route: np.ndarray, spacing: float) -> tuple[np.ndarray, np.ndarray]:
    """Arc-length resample polyline to ``spacing``; returns (points, tangents)."""
    seg = np.diff(route, axis=0)
    seglen = np.hypot(seg[:, 0], seg[:, 1])
    cum = np.concatenate([[0.0], np.cumsum(seglen)])
    total = cum[-1]
    n = max(int(np.floor(total / spacing)) + 1, 2)
    targets = np.arange(n) * spacing
    targets = targets[targets <= total + 1e-9]
    pts = np.empty((len(targets), 2))
    for i, t in enumerate(targets):
        j = min(np.searchsorted(cum, t, side="right") - 1, len(seglen) - 1)
        f = (t - cum[j]) / max(seglen[j], 1e-12)
        pts[i] = route[j] + f * seg[j]
    tan = np.diff(pts, axis=0)
    if len(tan) == 0:
        # a route shorter than one spacing: a single capture whose heading is
        # the route's own first-segment tangent
        tan = seg[:1]
    headings = np.arctan2(tan[:, 1], tan[:, 0])
    headings = np.concatenate([headings, headings[-1:]])  # last copies previous
    return pts, headings[: len(pts)]
