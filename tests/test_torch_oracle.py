"""The port's float64 oracle (``navdv_torch/oracle.py``) against the JAX
package's (``navdv_tpu/oracle.py``) and the frozen golden fixture.

Both oracles are NumPy float64 on the same inputs, so every function must
agree bit for bit; the port's reads the port's SimConfig (``config_from``).
"""

import os

import numpy as np
import pytest

from navdv_torch import oracle as t_oracle
from navdv_torch.convert import config_from
from navdv_tpu import oracle as j_oracle

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden_oracle_small.npz")


def _equal(got, want):
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _equal(got[k], want[k])
    elif isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        assert np.asarray(got).dtype == np.asarray(want).dtype


@pytest.fixture(scope="module")
def world(small_cfg, small_world):
    landscape, route = small_world
    lib = j_oracle.train_library(landscape, route, small_cfg)
    pts, hd = j_oracle.resample_route(route, small_cfg.capture_spacing)
    pano = j_oracle.render_panorama(landscape, pts[4][0], pts[4][1], hd[4] + 0.3, small_cfg)
    return landscape, route, lib, pts, hd, pano


def _cases(small_cfg, world):
    """(port call, JAX call) pairs, one per oracle function."""
    landscape, route, lib, pts, hd, pano = world
    tcfg = config_from(small_cfg)
    rng = np.random.default_rng(11)
    xs = rng.uniform(-3.0, landscape.shape[1] + 2.0, (5, 7))  # some outside: clamped
    ys = rng.uniform(-3.0, landscape.shape[0] + 2.0, (5, 7))
    a, b = lib[3], lib[9]
    grid = rng.uniform(0.0, 128.0, (33, 2))
    return {
        "bilinear": (lambda o, c: o.bilinear(landscape, xs, ys)),
        "render_panorama": (lambda o, c: o.render_panorama(landscape, 61.3, 58.7, 0.4, c)),
        "pool_view": (lambda o, c: tuple(o.pool_view(pano, s, c) for s in (-7, 0, 2, 13))),
        "render_view": (lambda o, c: o.render_view(landscape, 70.2, 64.9, -1.1, c)),
        "ssd": (lambda o, c: o.ssd(a, b)),
        "ncc_distance": (lambda o, c: (o.ncc_distance(a, b), o.ncc_distance(a, b, eps=1e-3))),
        "view_distance": (lambda o, c: (o.view_distance(a, b, "ssd"),
                                        o.view_distance(a, b, "ncc"))),
        "resample_route": (lambda o, c: (o.resample_route(route, 1.5),
                                         o.resample_route(route[:2] * 0.01, 5.0))),
        "train_library": (lambda o, c: o.train_library(landscape, route, c)),
        "point_to_polyline_dists": (lambda o, c: (o.point_to_polyline_dists(grid, route),
                                                  o.point_to_polyline_dist(grid[0], route))),
        "scan_familiarity": (lambda o, c: o.scan_familiarity(pano, lib, c)),
        "navigate": (lambda o, c: o.navigate(landscape, lib, route, pts[0] + 0.7, hd[0] - 0.2,
                                             c)),
    }, tcfg


ORACLE_FUNCTIONS = ["bilinear", "render_panorama", "pool_view", "render_view", "ssd",
                    "ncc_distance", "view_distance", "resample_route", "train_library",
                    "point_to_polyline_dists", "scan_familiarity", "navigate"]


@pytest.mark.parametrize("name", ORACLE_FUNCTIONS)
def test_oracle_function_matches_jax_oracle(small_cfg, world, name):
    """Each function of the port's oracle gives the JAX package's oracle's
    float64 result bit for bit."""
    cases, tcfg = _cases(small_cfg, world)
    call = cases[name]
    _equal(call(t_oracle, tcfg), call(j_oracle, small_cfg))


@pytest.mark.parametrize("metric", ["ssd", "ncc"])
def test_scan_familiarity_matches_jax_oracle_per_metric(small_cfg, world, metric):
    """The RIDF-pooled scan at both metrics and a tolerance window, bit for bit."""
    import dataclasses

    cfg = dataclasses.replace(small_cfg, scan=dataclasses.replace(small_cfg.scan, metric=metric,
                                                                  tol_bins=1))
    _, _, lib, _, _, pano = world
    _equal(t_oracle.scan_familiarity(pano, lib, config_from(cfg)),
           j_oracle.scan_familiarity(pano, lib, cfg))


def test_view_distance_rejects_unknown_metric():
    a = np.zeros((2, 3))
    with pytest.raises(ValueError):
        t_oracle.view_distance(a, a, "l1")


def test_oracle_navigate_reproduces_golden(small_cfg, small_world):
    """The port's oracle trains the golden library and navigates the golden
    episode: the frozen fixture's library, candidates, poses and outcome."""
    landscape, route = small_world
    with np.load(GOLDEN) as f:
        gold = {k: f[k] for k in f.files}
    cfg = config_from(small_cfg)
    lib = t_oracle.train_library(landscape, route, cfg)
    np.testing.assert_allclose(lib, gold["library"], atol=1e-12)
    pts, hd = t_oracle.resample_route(route, cfg.capture_spacing)
    out = t_oracle.navigate(landscape, lib, route, pts[0], hd[0], cfg)
    assert bool(out["success"]) == bool(gold["success"])
    np.testing.assert_array_equal(out["k"], gold["k"])
    np.testing.assert_allclose(out["xy"], gold["xy"], atol=1e-10)
    np.testing.assert_allclose(out["theta"], gold["theta"], atol=1e-10)
    np.testing.assert_allclose(out["fam"], gold["fam"], rtol=1e-10)
