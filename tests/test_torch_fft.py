"""The port's spectral familiarity (navdv_torch.familiarity_fft) against the
JAX package's make_lib_min_fft and against the port's own plain
extract-then-score path, on the CPU, with seeded pooled panoramas and the
JAX library carried across."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navdv_torch import familiarity_fft as tfft
from navdv_torch import sensor as tsensor
from navdv_torch.agent import _make_lib_min
from navdv_torch.convert import config_from, library_from_numpy
from navdv_tpu.config import ScanConfig, SensorConfig, SimConfig
from navdv_tpu.familiarity import pack_library
from navdv_tpu.familiarity_fft import make_lib_min_fft
from navdv_tpu.sensor import make_lag_stats, scan_lag_sets


def _cfg(metric: str, u: int, tol_bins: int = 0, cutoff: int = 0, r: int = 4) -> SimConfig:
    return SimConfig(
        sensor=SensorConfig(n_radial=r, n_azimuth=24, az_upsample=u, r_min=2.0, r_max=8.0),
        scan=ScanConfig(n_headings=12, scan_step_bins=2, metric=metric, tol_bins=tol_bins,
                        spectral_cutoff=cutoff),
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


def _check_against_jax(cfg, seed, b, nl):
    lags, pcfg, j, t = _inputs(cfg, seed, b, nl)
    want = np.asarray(make_lib_min_fft(cfg.sensor, cfg.scan, lags)(*j))
    got = tfft.make_lib_min_fft(pcfg.sensor, pcfg.scan, lags, "cpu")(*t)
    assert got.dtype == torch.float32 and got.shape == want.shape
    scale = float(np.max(np.abs(want))) + 1e-6
    # the JAX test's tolerance (tests/test_fft_fam.py): its DFT runs in f32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4 * scale, rtol=2e-4)


@pytest.mark.parametrize("metric", ["ssd", "ncc"])
@pytest.mark.parametrize("u", [1, 3])
@pytest.mark.parametrize("tol_bins", [0, 2])
@pytest.mark.parametrize("cutoff", [0, 20])
def test_fft_matches_jax(metric, u, tol_bins, cutoff):
    """Exact (cutoff 0) and truncated below F: 20 of the 37 bins at A = 72,
    12 of the 13 at A = 24. The truncation is the same approximation in
    both packages."""
    cutoff = min(cutoff, (24 * u) // 2)
    _check_against_jax(_cfg(metric, u, tol_bins, cutoff), 0, b=5, nl=7)


@pytest.mark.parametrize("metric", ["ssd", "ncc"])
def test_fft_matches_jax_tall_sensor(metric):
    """R = 64, where the JAX path keeps re/im unstacked."""
    _check_against_jax(_cfg(metric, 1, 1, r=64), 5, b=4, nl=6)


@pytest.mark.parametrize("metric", ["ssd", "ncc"])
@pytest.mark.parametrize("u", [1, 3])
@pytest.mark.parametrize("tol_bins", [0, 2])
def test_fft_matches_port_plain_path(metric, u, tol_bins):
    """At cutoff 0 the spectral path scores the plain path's fp32
    candidates in fp64: equal up to fp64 rounding of the transforms."""
    cfg = _cfg(metric, u, tol_bins)
    lags, pcfg, _, (s, lib, lag_sum, lag_sq) = _inputs(cfg, 1, b=4, nl=9)
    cand = tsensor.make_views_from_pooled(pcfg.sensor, lags, "cpu")(s)
    want = _make_lib_min(pcfg, "plain", "cpu")(cand, lib, lag_sum, lag_sq)
    fft = tfft.make_lib_min_fft(pcfg.sensor, pcfg.scan, lags, "cpu")
    got = fft(s, lib, lag_sum, lag_sq)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-9, atol=1e-12)
    np.testing.assert_array_equal(fft(s, lib, lag_sum, lag_sq, aux=fft.prepare(lib)).numpy(),
                                  got.numpy())


@pytest.mark.parametrize("metric", ["ssd", "ncc"])
def test_fft_spectral_entry_equals_lib_min(metric):
    """``.spectral`` fed the forward transform of S/u (``forward_mats``)
    gives ``lib_min``'s result; ``roll_k`` of zeros is no roll."""
    cfg = _cfg(metric, 1, cutoff=9)
    lags, pcfg, _, (s, lib, lag_sum, lag_sq) = _inputs(cfg, 2, b=3, nl=5)
    fft = tfft.make_lib_min_fft(pcfg.sensor, pcfg.scan, lags, "cpu")
    fc = fft.forward_mats.shape[1] // 2
    assert fft.forward_mats.dtype == torch.float64 and fc == 9
    s64 = s.double()
    spec = (s64 @ fft.forward_mats)
    cand = tsensor.make_views_from_pooled(pcfg.sensor, lags, "cpu")(s).double()
    norms = torch.sum(cand * cand, dim=2)  # SSD takes the norms from the caller here
    sq = lag_sq if metric == "ncc" else norms
    got = fft.spectral((spec[..., :fc], spec[..., fc:], s64.mean(2)), lib, lag_sum, sq)
    np.testing.assert_allclose(got.numpy(), fft(s, lib, lag_sum, lag_sq).numpy(), rtol=1e-9)
    zeros = torch.zeros(3, dtype=torch.int32)
    np.testing.assert_allclose(fft(s, lib, lag_sum, lag_sq, roll_k=zeros).numpy(),
                               fft(s, lib, lag_sum, lag_sq).numpy(), rtol=1e-12)
    np.testing.assert_allclose(
        fft.spectral((spec[..., :fc], spec[..., fc:], s64.mean(2)), lib, lag_sum, sq,
                     roll_k=zeros).numpy(), got.numpy(), rtol=1e-12)


@pytest.mark.parametrize("metric", ["ssd", "ncc"])
def test_fft_respects_library_padding(metric):
    cfg = _cfg(metric, 3)
    lags, pcfg, _, (s, lib, lag_sum, lag_sq) = _inputs(cfg, 1, b=3, nl=4)
    keep = torch.arange(4) < 2
    pad = type(lib)(lib.views, lib.flat * keep[:, None], lib.sq * keep,
                    lib.z * keep[:, None], keep.float())
    fft = tfft.make_lib_min_fft(pcfg.sensor, pcfg.scan, lags, "cpu")
    m_pad = fft(s, pad, lag_sum, lag_sq)
    m_valid = fft(s, type(lib)(*(x[:2] for x in lib)), lag_sum, lag_sq)
    np.testing.assert_allclose(m_pad.numpy(), m_valid.numpy(), rtol=1e-9)


@pytest.mark.parametrize("cutoff", [10_000, 38, -1])
def test_fft_spectral_cutoff_validation(cutoff):
    """The JAX package's bounds (0, A//2 + 1], checked against JAX itself."""
    cfg = _cfg("ssd", 3, cutoff=cutoff)  # A = 72: 37 bins
    lags, _ = scan_lag_sets(cfg.scan)
    with pytest.raises(ValueError, match="spectral_cutoff"):
        make_lib_min_fft(cfg.sensor, cfg.scan, lags)
    pcfg = config_from(cfg)
    with pytest.raises(ValueError, match="spectral_cutoff"):
        tfft.make_lib_min_fft(pcfg.sensor, pcfg.scan, lags, "cpu")


def test_fft_weights_match_jax_in_float64():
    """The three DFT weight functions: JAX's f32 weights are the port's f64 ones
    rounded."""
    from navdv_tpu import familiarity_fft as jfft

    lags = np.array([-6, -1, 0, 3, 17])
    for name, args in (("_forward_weights", (72,)), ("_library_weights", (24, 3, 72)),
                       ("_inverse_lag_weights", (72, lags))):
        for got, want in zip(getattr(tfft, name)(*args), getattr(jfft, name)(*args)):
            assert got.dtype == np.float64
            np.testing.assert_array_equal(got.astype(np.float32), want)
