"""The JAX package's reference functions in the port (ROADMAP A.20): the
per-agent distance matrices, the familiarity reduction, the reference
familiarity and the gather renderer, against their JAX functions on the
CPU, and against the port's own step and window renderer.

Tolerances: the JAX distances are f32 products at ``matmul_precision=
"high"``, the port's fp64, so SSD is held within 2e-5 of the library's
largest squared norm and NCC within 1e-5 absolute; the port's reference
familiarity equals its ``"plain"`` path's within rtol 1e-9 (both fp64,
rounded to f32 once; see the test for NCC's step); renderers within 1e-5.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navdv_torch import familiarity as tf
from navdv_torch.agent import _make_lib_min, init_state, make_statics, make_step_batched
from navdv_torch.convert import config_from, library_from_numpy
from navdv_torch.sensor import (
    make_pooled_panorama,
    make_render_batch,
    make_render_panorama,
    make_render_panorama_gather,
    make_views_from_pooled,
    scan_lag_sets,
    scan_shift_sets,
)
from navdv_torch.training import train_library
from navdv_tpu import familiarity as jf
from navdv_tpu import oracle
from navdv_tpu.parallel.mesh import pad_library as j_pad_library
from navdv_tpu.sensor import make_render_panorama_gather as j_make_render_panorama_gather

SSD_TOL = 2e-5  # of the library's largest squared norm
NCC_TOL = 1e-5  # absolute
PLAIN_RTOL = 1e-9
RENDER_TOL = 1e-5


def _padded_library(sensor, n_views=13, multiple=8, seed=0):
    """A JAX library of random views padded with invalid columns, and the
    port's copy of it."""
    rng = np.random.default_rng(seed)
    views = rng.uniform(size=(n_views, sensor.n_radial, sensor.n_azimuth)).astype(np.float32)
    jlib = j_pad_library(jf.pack_library(jnp.asarray(views)), multiple)
    assert float(jnp.min(jlib.valid)) == 0.0  # some columns are padding
    return jlib, library_from_numpy(jlib, device="cpu")


def _cand(n, p, seed=1):
    return np.random.default_rng(seed).uniform(size=(n, p)).astype(np.float32)


def _check_distances(got, want, valid, metric, scale):
    """Valid columns within the metric's tolerance, padded ones at +PAD_PENALTY."""
    on = valid > 0
    tol = SSD_TOL * scale if metric == "ssd" else NCC_TOL
    np.testing.assert_allclose(got[:, on], want[:, on], rtol=0, atol=tol)
    assert (got[:, ~on] >= tf.PAD_PENALTY).all() and (want[:, ~on] >= tf.PAD_PENALTY).all()


@pytest.mark.parametrize("name", ["ssd_matrix", "ncc_matrix", "distance_matrix-ssd",
                                  "distance_matrix-ncc"])
def test_distance_matrices_match_jax(small_cfg, name):
    """``d[s, v]`` over a padded library: the JAX function's values (its
    clamp at 0 and +PAD_PENALTY included), from one fp64 product."""
    fn, _, metric = name.partition("-")
    metric = metric or fn[:3]
    sensor = small_cfg.sensor
    jlib, lib = _padded_library(sensor)
    cand = _cand(10, sensor.n_pixels)
    args = () if fn != "distance_matrix" else (metric,)
    want = np.asarray(getattr(jf, fn)(jnp.asarray(cand), jlib, *args))
    got = getattr(tf, fn)(torch.from_numpy(cand), lib, *args)
    assert got.dtype == torch.float64 and got.shape == want.shape
    _check_distances(got.numpy(), want, np.asarray(jlib.valid), metric,
                     float(np.max(np.asarray(jlib.sq))))


def test_distance_matrix_batches_and_rejects_unknown_metric(small_cfg):
    """Leading dims batch agents (as a vmapped JAX call); an unknown metric
    raises as in JAX."""
    sensor = small_cfg.sensor
    jlib, lib = _padded_library(sensor)
    cand = torch.from_numpy(_cand(3 * 10, sensor.n_pixels).reshape(3, 10, -1))
    for metric in ("ssd", "ncc"):
        batched = tf.distance_matrix(cand, lib, metric)
        assert batched.shape == (3, 10, lib.views.shape[0])
        for i in range(3):
            assert torch.equal(batched[i], tf.distance_matrix(cand[i], lib, metric))
    with pytest.raises(ValueError):
        jf.distance_matrix(jnp.asarray(cand[0].numpy()), jlib, "l1")
    with pytest.raises(ValueError):
        tf.distance_matrix(cand[0], lib, "l1")


@pytest.mark.parametrize("tol_bins", [0, 2])
def test_reduce_familiarity_matches_jax(small_cfg, tol_bins):
    """The RIDF min-pool over each heading's tolerance window, then the
    minimum over the library: a minimum, so equal to JAX's exactly."""
    scan = dataclasses.replace(small_cfg.scan, tol_bins=tol_bins)
    pscan = config_from(dataclasses.replace(small_cfg, scan=scan)).scan
    ne = scan.n_headings * (2 * tol_bins + 1)
    d = np.random.default_rng(3).uniform(size=(4, ne, 9)).astype(np.float32)
    got = tf.reduce_familiarity(torch.from_numpy(d), pscan)
    assert got.shape == (4, scan.n_headings)
    for i in range(4):
        want = np.asarray(jf.reduce_familiarity(jnp.asarray(d[i]), scan))
        np.testing.assert_array_equal(got[i].numpy(), want)


@pytest.mark.parametrize("metric", ["ssd", "ncc"])
@pytest.mark.parametrize("tol_bins", [0, 1])
def test_make_familiarity_jnp_matches_jax(small_cfg, metric, tol_bins):
    """``fam(cand_ext, lib) -> f32[Nh]`` over a padded library against the
    JAX reference at its shipped ``matmul_precision``."""
    cfg = dataclasses.replace(small_cfg, scan=dataclasses.replace(
        small_cfg.scan, metric=metric, tol_bins=tol_bins))
    pcfg = config_from(cfg)
    jlib, lib = _padded_library(cfg.sensor)
    ne = cfg.scan.n_headings * (2 * tol_bins + 1)
    cand = _cand(ne, cfg.sensor.n_pixels, seed=4)
    want = np.asarray(jf.make_familiarity_jnp(cfg.sensor, cfg.scan)(jnp.asarray(cand), jlib))
    got = tf.make_familiarity_jnp(pcfg.sensor, pcfg.scan)(torch.from_numpy(cand), lib)
    assert got.dtype == torch.float32 and got.shape == (cfg.scan.n_headings,)
    tol = SSD_TOL * float(np.max(np.asarray(jlib.sq))) if metric == "ssd" else NCC_TOL
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


@pytest.mark.parametrize("metric", ["ssd", "ncc"])
@pytest.mark.parametrize("tol_bins", [0, 1])
def test_make_familiarity_jnp_equals_the_plain_step(small_cfg, small_world, metric, tol_bins):
    """On real poses, the reference over the extended shift set's candidate
    views against the ``"plain"`` path (deduplicated lags, then the window
    pool). SSD: the step's familiarity to rtol 1e-9. NCC: the plain path's
    per-lag minimum given the candidates' own mean and spread to rtol 1e-9;
    the step takes them from the pooled panorama before its f32 scaling by
    1/u (``sensor.make_lag_stats``), which moves its familiarity by a few
    f32 steps, so the step is held within 1e-6 there."""
    land, route = small_world
    cfg = config_from(dataclasses.replace(small_cfg, scan=dataclasses.replace(
        small_cfg.scan, metric=metric, tol_bins=tol_bins)))
    st = make_statics(land, train_library(land, route, cfg, device="cpu"), route, device="cpu")
    pts, hd = oracle.resample_route(route, cfg.capture_spacing)
    rng = np.random.default_rng(5)
    states = init_state(pts[:8] + rng.normal(0.0, 1.0, (8, 2)), hd[:8] + rng.normal(0.0, 0.2, 8),
                        device="cpu")
    step_fam = make_step_batched(cfg, "plain", device="cpu").fam(states, st)
    _, extended = scan_shift_sets(cfg.scan)
    lags, window_idx = scan_lag_sets(cfg.scan)
    s = make_pooled_panorama(cfg.sensor, "cpu")(
        make_render_batch(cfg.sensor, "cpu")(st.landscape, states.xy, states.theta))
    cand_ext = make_views_from_pooled(cfg.sensor, extended, "cpu")(s)
    got = tf.make_familiarity_jnp(cfg.sensor, cfg.scan)(cand_ext, st.lib)
    assert got.shape == step_fam.shape == (8, cfg.scan.n_headings)
    if metric == "ssd":
        np.testing.assert_allclose(got.numpy(), step_fam.numpy(), rtol=PLAIN_RTOL, atol=0)
        return
    cand = make_views_from_pooled(cfg.sensor, lags, "cpu")(s).double()
    m = _make_lib_min(cfg, "plain", "cpu")(cand.float(), st.lib, cand.sum(-1),
                                            (cand * cand).sum(-1))
    want = torch.amin(m[:, torch.from_numpy(window_idx.astype(np.int64))], dim=2)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=PLAIN_RTOL, atol=0)
    np.testing.assert_allclose(got.numpy(), step_fam.numpy(), rtol=0, atol=1e-6)


def test_make_familiarity_jnp_rejects_unknown_metric(small_cfg):
    cfg = dataclasses.replace(small_cfg, scan=dataclasses.replace(small_cfg.scan, metric="l1"))
    with pytest.raises(ValueError, match="unknown familiarity metric"):
        jf.make_familiarity_jnp(cfg.sensor, cfg.scan)
    pcfg = config_from(small_cfg)
    bad = dataclasses.replace(pcfg.scan, metric="l1")
    with pytest.raises(ValueError, match="unknown familiarity metric"):
        tf.make_familiarity_jnp(pcfg.sensor, bad)


def _poses(land, n=12, seed=6):
    """Poses over the whole landscape, a few near each edge (the clamp)."""
    h, w = land.shape
    rng = np.random.default_rng(seed)
    xy = np.stack([rng.uniform(0.0, w - 1.0, n), rng.uniform(0.0, h - 1.0, n)], axis=1)
    xy[:4] = [[1.5, 60.0], [w - 2.2, 30.0], [50.0, 0.7], [70.0, h - 1.3]]
    return xy.astype(np.float32), rng.uniform(-np.pi, np.pi, n).astype(np.float32)


def test_render_panorama_gather_matches_jax(small_cfg, small_world):
    """The gather renderer, one pose at a time as in JAX and batched."""
    land, _ = small_world
    xy, theta = _poses(land)
    j_render = j_make_render_panorama_gather(small_cfg.sensor)
    render = make_render_panorama_gather(config_from(small_cfg).sensor, device="cpu")
    land_t = torch.from_numpy(land)
    batched = render(land_t, torch.from_numpy(xy), torch.from_numpy(theta))
    assert batched.shape == (len(xy), small_cfg.sensor.n_radial, small_cfg.sensor.n_fine)
    for i in range(len(xy)):
        want = np.asarray(j_render(jnp.asarray(land), jnp.asarray(xy[i]), jnp.asarray(theta[i])))
        one = render(land_t, torch.from_numpy(xy[i]), torch.tensor(theta[i]))
        np.testing.assert_allclose(one.numpy(), want, rtol=0, atol=RENDER_TOL)
        np.testing.assert_array_equal(batched[i].numpy(), one.numpy())


def test_render_panorama_gather_matches_window_renderer(small_cfg, small_world):
    """The landscape read directly against the window gather + render
    kernels' path (f32 hat), edges included."""
    land, _ = small_world
    xy, theta = _poses(land, n=32, seed=7)
    sensor = config_from(small_cfg).sensor
    land_t, xy_t, th_t = torch.from_numpy(land), torch.from_numpy(xy), torch.from_numpy(theta)
    want = make_render_panorama(sensor, device="cpu")(land_t, xy_t, th_t)
    got = make_render_panorama_gather(sensor, device="cpu")(land_t, xy_t, th_t)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=RENDER_TOL)
