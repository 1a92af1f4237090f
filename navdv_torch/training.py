"""Training: route -> view library.

One view is captured per resampled route point (heading = tangent), by the
batched f32 capture renderer, in chunks of TRAIN_CHUNK_VIEWS poses so the
transients stay bounded at dense libraries.
"""

from __future__ import annotations

import numpy as np
import torch

from navdv_torch.config import SimConfig
from navdv_torch.device import as_tensor, resolve_device
from navdv_torch.familiarity import LibraryPack, pack_library
from navdv_torch.oracle import resample_route
from navdv_torch.sensor import make_render_view

TRAIN_CHUNK_VIEWS = 1024


def train_library(
    landscape,
    route: np.ndarray,
    cfg: SimConfig,
    pad_views_to: int = 0,
    heading_jitter: float = 0.0,
    jitter_seed: int = 0,
    device=None,
) -> LibraryPack:
    """Capture one view per resampled route point and pack the library.

    ``pad_views_to > 1`` renders at a pose count padded up to that multiple
    (repeating the final pose) and slices back to the true count: the
    returned library is identical. ``heading_jitter`` (radians) adds seeded
    uniform(-j, +j) noise to each capture heading; it exists for the learned
    memory's straight-route training recipe, not for perfect-memory
    libraries.
    """
    dev = resolve_device(device)
    pts, headings = resample_route(np.asarray(route, dtype=np.float64), cfg.capture_spacing)
    if heading_jitter:
        jr = np.random.default_rng(jitter_seed)
        headings = headings + jr.uniform(-heading_jitter, heading_jitter, size=len(headings))
    land = as_tensor(landscape, torch.float32, dev)
    pts_d = as_tensor(pts, torch.float32, dev)
    hd_d = as_tensor(headings, torch.float32, dev)
    n = pts_d.shape[0]
    if pad_views_to > 1 and n % pad_views_to:
        rem = (-n) % pad_views_to
        pts_d = torch.cat([pts_d, pts_d[-1:].expand(rem, 2)])
        hd_d = torch.cat([hd_d, hd_d[-1:].expand(rem)])
    render_many = make_render_view(cfg.sensor, dev)
    views = torch.cat(
        [
            render_many(land, pts_d[i : i + TRAIN_CHUNK_VIEWS], hd_d[i : i + TRAIN_CHUNK_VIEWS])
            for i in range(0, pts_d.shape[0], TRAIN_CHUNK_VIEWS)
        ],
        dim=0,
    )
    return pack_library(views[:n].contiguous())
