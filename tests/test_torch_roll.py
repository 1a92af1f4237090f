"""The port's rolled-library familiarity (navdv_torch.familiarity_roll)
against the JAX package's make_lib_min_roll and against the port's own plain
extract-then-score path, on the CPU, with seeded pooled panoramas and the
JAX library carried across."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navdv_torch import familiarity_roll as troll
from navdv_torch import sensor as tsensor
from navdv_torch.agent import _make_lib_min
from navdv_torch.convert import config_from, library_from_numpy
from navdv_tpu.config import ScanConfig, SensorConfig, SimConfig
from navdv_tpu.familiarity import pack_library
from navdv_tpu.familiarity_roll import make_lib_min_roll
from navdv_tpu.sensor import make_lag_stats, scan_lag_sets


def _cfg(metric: str, u: int, tol_bins: int = 0, **scan_kw) -> SimConfig:
    return SimConfig(
        sensor=SensorConfig(n_radial=4, n_azimuth=24, az_upsample=u, r_min=2.0, r_max=8.0),
        scan=ScanConfig(n_headings=12, scan_step_bins=2, metric=metric, tol_bins=tol_bins,
                        **scan_kw),
    )


def _inputs(cfg, seed, b, nl):
    """Pooled panorama and library from ``seed``, in both packages; the lag
    statistics as each package's step takes them (JAX f32, port f64)."""
    lags, _ = scan_lag_sets(cfg.scan)
    rng = np.random.default_rng(seed)
    r, a, w = cfg.sensor.n_radial, cfg.sensor.n_fine, cfg.sensor.n_azimuth
    s_np = rng.random((b, r, a)).astype(np.float32)
    views = rng.random((nl, r, w)).astype(np.float32)
    jlib = pack_library(jnp.asarray(views))
    j = (jnp.asarray(s_np), jlib) + tuple(make_lag_stats(cfg.sensor, lags)(jnp.asarray(s_np)))
    pcfg = config_from(cfg)
    s_t = torch.from_numpy(s_np)
    tl = (s_t, library_from_numpy(jlib, device="cpu")) + tuple(
        tsensor.make_lag_stats(pcfg.sensor, lags, "cpu")(s_t.double()))
    return lags, pcfg, j, tl


def _padded(lib_fields, n_valid):
    """The last views marked invalid with all-zero pixels (as pad_library
    leaves them)."""
    views, flat, sq, z, valid = lib_fields
    keep = torch.arange(valid.shape[0]) < n_valid
    return type(lib_fields)(views, flat * keep[:, None], sq * keep, z * keep[:, None],
                            keep.float())


@pytest.mark.parametrize("metric", ["ssd", "ncc"])
@pytest.mark.parametrize("u", [1, 3])
@pytest.mark.parametrize("tol_bins", [0, 2])
def test_roll_matches_jax(metric, u, tol_bins):
    """The JAX test's fp32 tolerance (tests/test_roll_fam.py)."""
    cfg = _cfg(metric, u, tol_bins)
    lags, pcfg, j, t = _inputs(cfg, 0, b=5, nl=7)
    want = np.asarray(make_lib_min_roll(cfg.sensor, cfg.scan, lags)(*j))
    got = troll.make_lib_min_roll(pcfg.sensor, pcfg.scan, lags, "cpu")(*t)
    assert got.dtype == torch.float32 and got.shape == want.shape
    scale = float(np.max(np.abs(want))) + 1e-6
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5 * scale, rtol=2e-5)


@pytest.mark.parametrize("metric", ["ssd", "ncc"])
@pytest.mark.parametrize("u", [1, 3])
@pytest.mark.parametrize("tol_bins", [0, 2])
def test_roll_matches_port_plain_path(metric, u, tol_bins):
    """Both score the same fp32 candidates in fp64: equal up to fp64
    summation order."""
    cfg = _cfg(metric, u, tol_bins)
    lags, pcfg, _, (s, lib, lag_sum, lag_sq) = _inputs(cfg, 1, b=4, nl=9)
    cand = tsensor.make_views_from_pooled(pcfg.sensor, lags, "cpu")(s)
    want = _make_lib_min(pcfg, "plain", "cpu")(cand, lib, lag_sum, lag_sq)
    got = troll.make_lib_min_roll(pcfg.sensor, pcfg.scan, lags, "cpu")(s, lib, lag_sum, lag_sq)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("u", [1, 3])
@pytest.mark.parametrize("rank", [2, 4, 16])
def test_roll_lowrank_matches_jax_and_dense(u, rank):
    """The low-rank split holds for any basis, so even rank 2 agrees with
    the JAX low-rank path and with the port's dense path within the bf16
    residual's bound (tests/test_roll_fam.py: 4e-3 of the largest |l|^2)."""
    cfg = _cfg("ssd", u, roll_rank=rank)
    lags, pcfg, j, t = _inputs(cfg, 3, b=5, nl=9)
    want_jax = np.asarray(make_lib_min_roll(cfg.sensor, cfg.scan, lags)(*j))
    dense_scan = dataclasses.replace(pcfg.scan, roll_rank=0)
    want_dense = troll.make_lib_min_roll(pcfg.sensor, dense_scan, lags, "cpu")(*t).numpy()
    lowrank = troll.make_lib_min_roll(pcfg.sensor, pcfg.scan, lags, "cpu")
    got = lowrank(*t).numpy()
    scale = float(t[1].sq.max()) + 1e-6
    np.testing.assert_allclose(got, want_jax, atol=4e-3 * scale, rtol=4e-3)
    np.testing.assert_allclose(got, want_dense, atol=4e-3 * scale, rtol=4e-3)
    # a prepared aux gives the same result as preparing per call
    np.testing.assert_array_equal(lowrank(*t, aux=lowrank.prepare(t[1])).numpy(), got)


@pytest.mark.parametrize("u", [1, 3])
def test_fixed_point_equals_jax_bit_for_bit(u):
    cfg = _cfg("ssd", u, fixed_point_bits=8)
    lags, pcfg, j, t = _inputs(cfg, 1, b=4, nl=6)
    want = np.asarray(make_lib_min_roll(cfg.sensor, cfg.scan, lags)(*j))
    got = troll.make_lib_min_roll(pcfg.sensor, pcfg.scan, lags, "cpu")(*t).numpy()
    np.testing.assert_array_equal(got, want)


def test_fixed_point_is_the_exact_quantized_ssd():
    """Equal to a float64 evaluation of the SSD between the 1/255-quantized
    images, within the final f32 rounding (the JAX contract)."""
    cfg = _cfg("ssd", 3, fixed_point_bits=8)
    lags, pcfg, _, (s, lib, lag_sum, lag_sq) = _inputs(cfg, 2, b=4, nl=6)
    got = troll.make_lib_min_roll(pcfg.sensor, pcfg.scan, lags, "cpu")(s, lib, lag_sum, lag_sq)
    cand = tsensor.make_views_from_pooled(pcfg.sensor, lags, "cpu")(s).double().numpy()
    qc = np.round(cand * 255.0).clip(0, 255)
    ql = np.round(lib.flat.double().numpy() * 255.0).clip(0, 255)
    d64 = ((qc[:, :, None, :] - ql[None, None, :, :]) ** 2).sum(-1).min(-1) / 255.0**2
    np.testing.assert_allclose(got.numpy(), d64, rtol=2e-7, atol=0)


def test_int8_cross_pads_to_the_kernel_shape_rules():
    """The int8 product pads rows to > 16 and widths to multiples of 8 and
    slices the padding off: equal to the int32 product at ragged sizes."""
    rng = np.random.default_rng(0)
    qa = torch.from_numpy(rng.integers(-128, 128, (5, 13)).astype(np.int8))
    qb = torch.from_numpy(rng.integers(-128, 128, (11, 13)).astype(np.int8))
    qb_pad = troll._pad_to(qb, 16, 16)
    got = troll._int8_cross(qa, qb_pad, 11)
    assert got.dtype == torch.int32 and got.shape == (5, 11)
    assert torch.equal(got, qa.int() @ qb.int().T)


@pytest.mark.parametrize("variant", [{}, {"roll_rank": 4}, {"fixed_point_bits": 8}],
                         ids=["dense", "lowrank", "fixed_point"])
def test_roll_respects_library_padding(variant):
    """Views marked invalid never win the minimum."""
    cfg = _cfg("ssd", 3, **variant)
    lags, pcfg, _, (s, lib, lag_sum, lag_sq) = _inputs(cfg, 4, b=3, nl=4)
    f = troll.make_lib_min_roll(pcfg.sensor, pcfg.scan, lags, "cpu")
    m_pad = f(s, _padded(lib, 2), lag_sum, lag_sq)
    m_valid = f(s, type(lib)(*(x[:2] for x in lib)), lag_sum, lag_sq)
    rtol = 4e-3 if variant.get("roll_rank") else 1e-6
    np.testing.assert_allclose(m_pad.numpy(), m_valid.numpy(), rtol=rtol, atol=rtol)


def test_roll_ncc_respects_library_padding():
    cfg = _cfg("ncc", 3)
    lags, pcfg, _, (s, lib, lag_sum, lag_sq) = _inputs(cfg, 4, b=3, nl=4)
    f = troll.make_lib_min_roll(pcfg.sensor, pcfg.scan, lags, "cpu")
    m_pad = f(s, _padded(lib, 2), lag_sum, lag_sq)
    m_valid = f(s, type(lib)(*(x[:2] for x in lib)), lag_sum, lag_sq)
    np.testing.assert_allclose(m_pad.numpy(), m_valid.numpy(), rtol=1e-9)


@pytest.mark.parametrize(
    "metric,scan_kw,sensor_kw,match",
    [
        ("ncc", dict(roll_rank=8), {}, "roll_rank"),
        ("ncc", dict(fixed_point_bits=8), {}, "fixed_point_bits"),
        ("ssd", dict(fixed_point_bits=16), {}, "fixed_point_bits must be 0 or 8"),
        ("ssd", dict(fixed_point_bits=8, roll_rank=4), {}, "exclusive"),
        ("ssd", dict(fixed_point_bits=8), dict(n_radial=64, n_azimuth=600), "int32 budget"),
        ("l1", {}, {}, "unknown familiarity metric"),
    ],
    ids=["rank_ncc", "bits_ncc", "bad_bits", "rank_and_bits", "int32_budget", "metric"],
)
def test_roll_rejects_what_jax_rejects(metric, scan_kw, sensor_kw, match):
    """Each ValueError of the JAX module, checked against JAX itself."""
    cfg = _cfg(metric, 3, **scan_kw)
    cfg = dataclasses.replace(cfg, sensor=dataclasses.replace(cfg.sensor, **sensor_kw))
    lags, _ = scan_lag_sets(cfg.scan)
    with pytest.raises(ValueError, match=match):
        make_lib_min_roll(cfg.sensor, cfg.scan, lags)
    pcfg = config_from(cfg)
    with pytest.raises(ValueError, match=match):
        troll.make_lib_min_roll(pcfg.sensor, pcfg.scan, lags, "cpu")


@pytest.mark.parametrize("u", [1, 3, 5])
def test_lag_grid_matches_jax(u):
    from navdv_tpu.familiarity_roll import _lag_grid

    lags, _ = scan_lag_sets(ScanConfig(n_headings=120, scan_step_bins=1, tol_bins=2))
    for got, want in zip(troll._lag_grid(lags, u), _lag_grid(lags, u)):
        np.testing.assert_array_equal(got, want)
