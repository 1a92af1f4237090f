"""Pure-NumPy float64 oracle of the full simulation semantics: the port's
own copy of the JAX package's ``oracle.py``, the frozen reference the
whole model is held to (SEMANTICS.md).

Deliberately simple and loop-heavy, never on the hot path. It reads only
the port's :class:`~navdv_torch.config.SimConfig` and NumPy; the route
geometry (:func:`resample_route`, :func:`point_to_polyline_dists`) also
serves training, trials and the analysis layer.
"""

from __future__ import annotations

import numpy as np

from navdv_torch.config import SimConfig


# --- L1: sensor (SEMANTICS.md §3) ------------------------------------------

def bilinear(landscape: np.ndarray, xs: np.ndarray, ys: np.ndarray) -> np.ndarray:
    """Edge-clamped bilinear sample of landscape[y, x] at float coords."""
    h, w = landscape.shape
    xs = np.clip(xs, 0.0, w - 1.0)
    ys = np.clip(ys, 0.0, h - 1.0)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, w - 2)
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, h - 2)
    fx = xs - x0
    fy = ys - y0
    v00 = landscape[y0, x0]
    v01 = landscape[y0, x0 + 1]
    v10 = landscape[y0 + 1, x0]
    v11 = landscape[y0 + 1, x0 + 1]
    return (
        v00 * (1 - fy) * (1 - fx)
        + v01 * (1 - fy) * fx
        + v10 * fy * (1 - fx)
        + v11 * fy * fx
    )


def render_panorama(
    landscape: np.ndarray, x: float, y: float, theta: float, cfg: SimConfig
) -> np.ndarray:
    """Fine polar panorama f64[n_radial, n_fine]; column a looks along
    ``theta + (a + 0.5) * binw - pi`` (SEMANTICS.md §3)."""
    s = cfg.sensor
    a = np.arange(s.n_fine)
    phi = theta + (a + 0.5) * s.bin_width - np.pi  # [A]
    d = np.linspace(s.r_min, s.r_max, s.n_radial)  # [R]
    xs = x + d[:, None] * np.cos(phi)[None, :]
    ys = y + d[:, None] * np.sin(phi)[None, :]
    return bilinear(landscape.astype(np.float64), xs, ys)


def pool_view(pano: np.ndarray, shift: int, cfg: SimConfig) -> np.ndarray:
    """Sensor view at heading ``theta + shift*binw``: roll fine panorama by
    ``shift`` then mean-pool groups of az_upsample (SEMANTICS.md §3)."""
    s = cfg.sensor
    rolled = np.roll(pano, -shift, axis=1)  # column w*u+j becomes pano[.., w*u+j+shift]
    return rolled.reshape(s.n_radial, s.n_azimuth, s.az_upsample).mean(axis=2)


def render_view(
    landscape: np.ndarray, x: float, y: float, theta: float, cfg: SimConfig
) -> np.ndarray:
    """Per-heading reference path (SURVEY.md §7 sensor.py note): view rendered
    directly at heading theta with no roll. Used for roll==render parity tests."""
    return pool_view(render_panorama(landscape, x, y, theta, cfg), 0, cfg)


# --- L2: familiarity (SEMANTICS.md §4) -------------------------------------

def ssd(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.sum((a - b) ** 2))


def ncc_distance(a: np.ndarray, b: np.ndarray, eps: float = 1e-8) -> float:
    za = (a - a.mean()) / np.sqrt(a.var() + eps)
    zb = (b - b.mean()) / np.sqrt(b.var() + eps)
    return float(1.0 - (za * zb).sum() / a.size)


def view_distance(a: np.ndarray, b: np.ndarray, metric: str) -> float:
    if metric == "ssd":
        return ssd(a, b)
    if metric == "ncc":
        return ncc_distance(a, b)
    raise ValueError(metric)


# --- L2/L4: training (SEMANTICS.md §6) -------------------------------------

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
        # degenerate route shorter than one spacing: a single capture whose
        # heading is the route's own first-segment tangent (diff-of-points
        # would return 0 headings for 1 point, crashing every consumer with
        # a confusing shape error far from the cause)
        tan = seg[:1]
    headings = np.arctan2(tan[:, 1], tan[:, 0])
    headings = np.concatenate([headings, headings[-1:]])  # last copies previous
    return pts, headings[: len(pts)]


def train_library(landscape: np.ndarray, route: np.ndarray, cfg: SimConfig) -> np.ndarray:
    """Capture one view per resampled route point -> f64[Nl, R, W]."""
    pts, headings = resample_route(route, cfg.capture_spacing)
    return np.stack(
        [
            render_view(landscape, p[0], p[1], h, cfg)
            for p, h in zip(pts, headings)
        ]
    )


# --- L3: navigation (SEMANTICS.md §5) --------------------------------------

_POLYLINE_CHUNK_ELEMS = 1 << 22  # max chunk*segments elements per temporary


def point_to_polyline_dists(pts: np.ndarray, route: np.ndarray) -> np.ndarray:
    """Min distance from each point [N, 2] to the route polyline -> [N].

    Chunked over points so the [chunk, S, 2] temporaries stay bounded —
    dense analysis grids (N ~ 10^5-10^6) against long routes would
    otherwise materialize multi-GB intermediates.
    """
    pts = np.asarray(pts, dtype=np.float64)
    a = route[:-1]
    b = route[1:]
    ab = b - a
    denom = np.maximum((ab**2).sum(axis=1), 1e-12)
    chunk = max(1, _POLYLINE_CHUNK_ELEMS // max(1, a.shape[0]))
    out = np.empty(pts.shape[0], dtype=np.float64)
    for lo in range(0, pts.shape[0], chunk):
        p = pts[lo : lo + chunk]
        t = np.clip(
            ((p[:, None, :] - a[None]) * ab[None]).sum(-1) / denom, 0.0, 1.0
        )
        proj = a[None] + t[..., None] * ab[None]
        out[lo : lo + chunk] = np.sqrt(
            ((p[:, None, :] - proj) ** 2).sum(-1).min(axis=1)
        )
    return out


def point_to_polyline_dist(p: np.ndarray, route: np.ndarray) -> float:
    """Min distance from point to route polyline (point-to-segment)."""
    return float(point_to_polyline_dists(np.asarray(p)[None, :], route)[0])


def scan_familiarity(
    pano: np.ndarray, library: np.ndarray, cfg: SimConfig
) -> np.ndarray:
    """fam[k] for each candidate shift: min over library of the (RIDF-pooled)
    view distance (SEMANTICS.md §4–§5)."""
    shifts = cfg.scan.shifts()
    tol = cfg.scan.tol_bins
    fam = np.empty(len(shifts))
    for k, s in enumerate(shifts):
        best = np.inf
        for v in library:
            dmin = min(
                view_distance(pool_view(pano, s + delta, cfg), v, cfg.scan.metric)
                for delta in range(-tol, tol + 1)
            )
            best = min(best, dmin)
        fam[k] = best
    return fam


def navigate(
    landscape: np.ndarray,
    library: np.ndarray,
    route: np.ndarray,
    start_xy: np.ndarray,
    start_theta: float,
    cfg: SimConfig,
):
    """Run one recall episode. Returns dict of trajectory + per-step records."""
    s, ac = cfg.sensor, cfg.agent
    h, w = landscape.shape
    shifts = np.array(cfg.scan.shifts())
    xy = np.array(start_xy, dtype=np.float64)
    theta = float(start_theta)
    goal = route[-1]

    xs, ys, thetas, fams, ks = [], [], [], [], []
    status = "budget"
    tie_order = np.array(cfg.scan.tie_order())
    for _ in range(ac.max_steps):
        pano = render_panorama(landscape, xy[0], xy[1], theta, cfg)
        fam = scan_familiarity(pano, library, cfg)
        # ties -> smallest |shift|, then lowest index (SEMANTICS.md §5)
        k = int(tie_order[np.argmin(fam[tie_order])])
        theta = theta + shifts[k] * s.bin_width
        xy = xy + ac.step_size * np.array([np.cos(theta), np.sin(theta)])
        xs.append(xy[0]); ys.append(xy[1]); thetas.append(theta)
        fams.append(fam[k]); ks.append(k)
        if np.hypot(*(xy - goal)) <= ac.goal_radius:
            status = "reached"; break
        if point_to_polyline_dist(xy, route) > ac.corridor:
            status = "diverged"; break
        if not (
            s.r_max <= xy[0] <= w - 1 - s.r_max
            and s.r_max <= xy[1] <= h - 1 - s.r_max
        ):
            status = "off_landscape"; break
    return {
        "xy": np.stack([xs, ys], axis=1),
        "theta": np.array(thetas),
        "fam": np.array(fams),
        "k": np.array(ks),
        "status": status,
        "success": status == "reached",
    }
