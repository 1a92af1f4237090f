"""The port's sensor stages against the JAX package on the CPU: pooled
panorama (roll-adds and bf16 box filter), per-lag statistics, candidate
views, bilinear sampling and the static scan geometry."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import navdv_torch.sensor as ts
import navdv_tpu.sensor as js
from navdv_torch.convert import config_from
from navdv_tpu.config import ScanConfig, SensorConfig, SimConfig

_SENSORS = {
    "small": SensorConfig(n_radial=4, n_azimuth=24, az_upsample=3, r_min=2.0, r_max=8.0),
    "config1": SensorConfig(),
}


def _port(sensor):
    return config_from(SimConfig(sensor=sensor)).sensor


@pytest.mark.parametrize("name", sorted(_SENSORS))
@pytest.mark.parametrize("hat_dtype", ["float32", "bfloat16"])
def test_pooled_views_and_lag_stats_match_jax(name, hat_dtype):
    """Both pooled-panorama branches, the per-lag statistics and the
    candidate views at the deduplicated scan lags."""
    sensor = dataclasses.replace(_SENSORS[name], hat_dtype=hat_dtype)
    psensor = _port(sensor)
    scan = ScanConfig(n_headings=12, scan_step_bins=2, tol_bins=1)
    lags, _ = js.scan_lag_sets(scan)
    rng = np.random.default_rng(4)
    pano = rng.uniform(size=(3, sensor.n_radial, sensor.n_fine)).astype(np.float32)
    pano_t = torch.from_numpy(pano)

    s_j = np.array(js.make_pooled_panorama(sensor)(jnp.asarray(pano)))
    s_t = ts.make_pooled_panorama(psensor, device="cpu")(pano_t)
    np.testing.assert_allclose(s_t.numpy(), s_j, atol=1e-5)

    sum_j, sq_j = js.make_lag_stats(sensor, lags)(jnp.asarray(s_j))
    sum_t, sq_t = ts.make_lag_stats(psensor, lags, device="cpu")(torch.from_numpy(s_j))
    np.testing.assert_allclose(sum_t.numpy(), np.asarray(sum_j), rtol=1e-5)
    np.testing.assert_allclose(sq_t.numpy(), np.asarray(sq_j), rtol=1e-5)

    v_j = np.asarray(js.make_views_from_pooled(sensor, lags)(jnp.asarray(s_j)))
    v_t = ts.make_views_from_pooled(psensor, lags, device="cpu")(torch.from_numpy(s_j))
    np.testing.assert_array_equal(v_t.numpy(), v_j)

    c_j = np.asarray(jax.vmap(js.make_candidate_views(sensor, lags))(jnp.asarray(pano)))
    c_t = ts.make_candidate_views(psensor, lags, device="cpu")(pano_t)
    np.testing.assert_allclose(c_t.numpy(), c_j, atol=1e-5)


def test_static_geometry_and_bilinear_match_jax(small_world):
    for sensor in _SENSORS.values():
        psensor = _port(sensor)
        for got, want in zip(ts.polar_offsets(psensor), js.polar_offsets(sensor)):
            np.testing.assert_array_equal(got, want)
        assert ts.window_size(psensor) == js.window_size(sensor)
        assert ts.window_geometry(psensor) == js.window_geometry(sensor)
        shifts = np.array([-7, 0, 3, 250])
        np.testing.assert_array_equal(ts.candidate_col_index(psensor, shifts),
                                      js.candidate_col_index(sensor, shifts))
    for scan in (ScanConfig(), ScanConfig(n_headings=60, tol_bins=3), ScanConfig(n_headings=7)):
        pscan = config_from(SimConfig(scan=scan)).scan
        for got, want in zip(ts.scan_shift_sets(pscan) + ts.scan_lag_sets(pscan),
                             js.scan_shift_sets(scan) + js.scan_lag_sets(scan)):
            np.testing.assert_array_equal(got, want)
    land, _ = small_world
    rng = np.random.default_rng(6)
    xs = rng.uniform(-5, 135, size=(40, 7)).astype(np.float32)
    ys = rng.uniform(-5, 135, size=(40, 7)).astype(np.float32)
    got = ts.bilinear_sample(torch.from_numpy(land), torch.from_numpy(xs), torch.from_numpy(ys))
    want = js.bilinear_sample(jnp.asarray(land), jnp.asarray(xs), jnp.asarray(ys))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
