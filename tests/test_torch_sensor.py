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


@pytest.mark.parametrize("az_upsample", [1, 3, 5])
@pytest.mark.parametrize("hat_dtype", ["float32", "bfloat16"])
def test_pooled_render_matches_pool_of_render_and_jax(small_world, hat_dtype, az_upsample):
    """The step's pooled render (``make_render_batch(..., pooled=True)``)
    equals ``make_pooled_panorama`` of the plain render bit for bit, and
    stays within 1e-5 of the JAX package's ``make_pooled_panorama`` of the
    same panorama (its bf16 class a product against the 0/1 matrix); at u =
    1 it is the plain render."""
    land, _ = small_world
    sensor = SensorConfig(n_radial=4, n_azimuth=24, az_upsample=az_upsample, r_min=2.0,
                          r_max=8.0, hat_dtype=hat_dtype)
    psensor = _port(sensor)
    rng = np.random.default_rng(az_upsample)
    xy = torch.from_numpy(rng.uniform(20, 100, size=(11, 2)).astype(np.float32))
    theta = torch.from_numpy(rng.uniform(-4, 4, size=11).astype(np.float32))
    args = (torch.from_numpy(land), xy, theta)
    pano = ts.make_render_batch(psensor, device="cpu")(*args)
    s = ts.make_render_batch(psensor, device="cpu", pooled=True)(*args)
    assert torch.equal(s, ts.make_pooled_panorama(psensor)(pano))
    if az_upsample == 1:
        assert torch.equal(s, pano)
    s_j = np.asarray(js.make_pooled_panorama(sensor)(jnp.asarray(pano.numpy())))
    np.testing.assert_allclose(s.numpy(), s_j, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bf16_pool_is_exact_where_its_partial_sums_are(seed):
    """The bf16 class's pool (round, then the left-to-right u-tap sum) is
    the exact sum of the rounded taps wherever each partial sum is a
    float32: the value any f32 accumulation that rounds nothing gives, the
    former 0/1 product's included. Panoramas with values from 1e-6 to 1
    reach elements of both kinds."""
    psensor = _port(SensorConfig(hat_dtype="bfloat16"))
    rng = np.random.default_rng(seed)
    shape = (5, psensor.n_radial, psensor.n_fine)
    pano = torch.from_numpy((10.0 ** rng.uniform(-6, 0, size=shape)).astype(np.float32))
    s = ts.make_pooled_panorama(psensor)(pano)
    p64 = pano.to(torch.bfloat16).double()
    exact = p64
    partial_exact = torch.ones(shape, dtype=torch.bool)
    for j in range(1, psensor.az_upsample):
        exact = exact + torch.roll(p64, -j, dims=-1)
        partial_exact &= exact.float().double() == exact
    assert 0.0 < float(partial_exact.double().mean()) < 1.0
    assert torch.equal(s.double()[partial_exact], exact[partial_exact])
