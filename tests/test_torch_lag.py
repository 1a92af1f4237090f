"""The port's fused lag familiarity against the JAX Pallas lag kernel
(interpret mode) and the port's own batched step, on the CPU, where the
wrapper runs its plain PyTorch version; the CUDA kernel itself runs only on
the card (tests/test_torch_cuda.py)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import navdv_torch as nt
from navdv_torch.agent import init_state, make_statics, make_step_batched
from navdv_torch.convert import config_from, library_from_numpy
from navdv_torch.familiarity import pack_library
from navdv_torch.ops.lag import (
    lag_grid_geometry,
    lag_lib_min,
    lag_lib_min_plain,
    make_lag_fam,
)
from navdv_torch.sensor import make_render_batch, scan_lag_sets
from navdv_tpu import oracle
from navdv_tpu.agent import init_state as j_init_state
from navdv_tpu.agent import make_statics as j_make_statics
from navdv_tpu.agent import make_step_batched as j_make_step_batched
from navdv_tpu.config import ScanConfig, baseline_config
from navdv_tpu.ops.lag_pallas import lag_grid_geometry as j_lag_grid_geometry
from navdv_tpu.ops.lag_pallas import make_lag_fam_pallas
from navdv_tpu.sensor import make_render_batch as j_make_render_batch
from navdv_tpu.training import train_library as j_train_library

SCANS = [(0, 2), (2, 2), (0, 3), (1, 1)]  # (tol_bins, step_bins) of tests/test_lag_pallas.py


def _scan_cfg(small_cfg, tol_bins, step_bins):
    return dataclasses.replace(
        small_cfg, scan=ScanConfig(n_headings=12, scan_step_bins=step_bins, tol_bins=tol_bins))


def _tie_k(fam: np.ndarray, scan) -> np.ndarray:
    order = np.asarray(scan.tie_order())
    return order[np.argmin(fam[:, order], axis=1)]


def _poses(route, cfg, idx, turns):
    pts, hd = oracle.resample_route(route, cfg.capture_spacing)
    xy = np.stack([pts[i] for i in idx]).astype(np.float32)
    th = np.asarray([hd[i] + t for i, t in zip(idx, turns)], np.float32)
    return xy, th


@pytest.mark.parametrize("which", ["small", 1, 2, 4])
def test_lag_grid_geometry_matches_jax(small_cfg, which):
    cfg = small_cfg if which == "small" else baseline_config(which)
    pcfg = config_from(cfg)
    got = lag_grid_geometry(pcfg.sensor, pcfg.scan)
    want = j_lag_grid_geometry(cfg.sensor, cfg.scan)
    assert got[:2] == want[:2]
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])


@pytest.mark.parametrize("tol_bins,step_bins", SCANS)
def test_lag_fam_matches_pallas(small_cfg, small_world, tol_bins, step_bins):
    """The JAX panorama and library through both lag kernels: familiarity
    within the JAX test's tolerance (JAX sums in fp32, the port in fp64),
    and the tie-ordered candidate of the JAX jnp step."""
    cfg = _scan_cfg(small_cfg, tol_bins, step_bins)
    land, route = small_world
    lib = j_train_library(jnp.asarray(land), route, cfg)
    st = j_make_statics(land, lib, route)
    xy, th = _poses(route, cfg, [0, 3, 6, 9] * 2, [0.0, 0.4, 0.0, -0.3] * 2)
    _, rec = j_make_step_batched(cfg, "jnp")(j_init_state(jnp.asarray(xy), jnp.asarray(th)), st)
    pano = j_make_render_batch(cfg.sensor, window_impl="xla")(
        st.landscape, jnp.asarray(xy), jnp.asarray(th))
    want = np.asarray(make_lag_fam_pallas(cfg.sensor, cfg.scan, interpret=True)(pano, lib))
    pcfg = config_from(cfg)
    got = make_lag_fam(pcfg.sensor, pcfg.scan, device="cpu")(
        torch.from_numpy(np.array(pano)), library_from_numpy(lib, device="cpu")).numpy()
    assert got.shape == (8, cfg.scan.n_headings)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(_tie_k(got, cfg.scan), np.asarray(rec.k))


@pytest.mark.parametrize("tol_bins,step_bins", SCANS)
def test_lag_fam_matches_port_step(small_cfg, small_world, tol_bins, step_bins):
    """B = 5 (no batch tiling): the lag familiarity equals the port's own
    plain step at hat_dtype="float32", where both pool by rolled adds."""
    cfg = config_from(_scan_cfg(small_cfg, tol_bins, step_bins))
    land, route = small_world
    lib = nt.train_library(land, route, cfg, device="cpu")
    st = make_statics(land, lib, route, device="cpu")
    xy, th = _poses(route, cfg, [0, 2, 5, 7, 11], [0.2, -0.5, 0.0, 0.9, -0.1])
    states = init_state(xy, th, device="cpu")
    step = make_step_batched(cfg, "plain", device="cpu")
    _, rec = step(states, st)
    pano = make_render_batch(cfg.sensor, device="cpu")(st.landscape, states.xy, states.theta)
    got = make_lag_fam(cfg.sensor, cfg.scan, device="cpu")(pano, st.lib)
    torch.testing.assert_close(got, step.fam(states, st), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(_tie_k(got.numpy(), cfg.scan), rec.k.numpy())


def test_lag_lib_min_matches_float64():
    """Ragged shapes (L > 64, Nl = 70, P = 75, negative lags) against a float64
    evaluation that pools in float64 too; the CPU wrapper is the plain version
    and launches nothing."""
    rng = np.random.default_rng(5)
    sensor = nt.SensorConfig(n_radial=3, n_azimuth=25, az_upsample=3)
    scan = nt.ScanConfig(n_headings=70, scan_step_bins=1, tol_bins=1)
    lags, _ = scan_lag_sets(scan)
    assert len(lags) > 64 and lags.min() < 0
    pano = rng.uniform(size=(4, sensor.n_radial, sensor.n_fine)).astype(np.float32)
    views = rng.uniform(size=(70, sensor.n_radial, sensor.n_azimuth)).astype(np.float32)
    lib = pack_library(torch.from_numpy(views))
    lags_t = torch.from_numpy(lags.astype(np.int32))
    before = lag_lib_min.launches
    got = lag_lib_min(torch.from_numpy(pano), lib.flat, lib.sq, sensor, lags_t)
    assert lag_lib_min.launches == before
    assert torch.equal(got, lag_lib_min_plain(torch.from_numpy(pano), lib.flat, lib.sq,
                                              sensor, lags_t))
    u, a = sensor.az_upsample, sensor.n_fine
    p64 = pano.astype(np.float64)
    s = sum(np.roll(p64, -j, axis=2) for j in range(u)) / u
    cols = (np.arange(sensor.n_azimuth)[None, :] * u + lags[:, None]) % a  # [L, W]
    cand = s[:, :, cols].transpose(0, 2, 1, 3).reshape(4, len(lags), -1)
    flat = views.reshape(70, -1).astype(np.float64)
    d = ((cand[:, :, None, :] - flat[None, None]) ** 2).sum(axis=3)
    np.testing.assert_allclose(got.numpy(), d.min(axis=2), rtol=2e-4, atol=2e-3)


def test_lag_lib_min_checks_its_inputs():
    sensor = nt.SensorConfig(n_radial=2, n_azimuth=6, az_upsample=2)
    pano = torch.zeros(3, 2, 12)
    flat = torch.zeros(4, 12)
    lags = torch.zeros(5, dtype=torch.int32)
    with pytest.raises(ValueError, match="pano must be"):
        lag_lib_min(torch.zeros(3, 2, 11), flat, torch.zeros(4), sensor, lags)
    with pytest.raises(ValueError, match="lags must be int32"):
        lag_lib_min(pano, flat, torch.zeros(4), sensor, lags.long())
    with pytest.raises(ValueError, match="gamma must be"):
        lag_lib_min(pano, flat, torch.zeros(3), sensor, lags)
    meta = torch.empty(3, 2, 12, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        lag_lib_min(meta, flat.to("meta"), torch.empty(4, device="meta"), sensor,
                    lags.to("meta"))


def test_lag_fam_rejects_ncc(small_cfg):
    cfg = config_from(small_cfg)
    with pytest.raises(ValueError, match="SSD only"):
        make_lag_fam(cfg.sensor, nt.ScanConfig(n_headings=12, metric="ncc"), device="cpu")


def test_lag_smem_budget_follows_the_kernel(monkeypatch):
    """The shared-memory budget comes from the tile constants in the CUDA
    sources: config 4 fits, and a panorama whose raw and pooled rows fit
    but not beside the offset table is refused with ValueError before
    anything is built or launched."""
    from navdv_torch import _build
    from navdv_torch.ops import lag as lag_ops

    c = _build.source_constants("min_tile.cuh", "lag_fam.cu")
    ld = c["TILE_K"] + c["PAD"]
    ring = c["STAGES"] * 16 * c["TILE_WARPS"] * c["LAG_M_TILES"] * ld * 4 + 2 * c["TILE_V"] * ld * 8
    row, table = 16 * 360 * 4, 16 * 72 * 4  # config 4: raw or pooled row, offset table
    need = lag_ops.lag_smem_bytes(config_from(baseline_config(4)).sensor)
    assert need == max(ring, row) + row + table <= lag_ops._BLOCK_SMEM_BYTES

    def no_build(*args, **kwargs):
        raise AssertionError("built or launched a kernel")

    monkeypatch.setattr(_build, "load_function", no_build)
    big = nt.SensorConfig(n_radial=20, n_azimuth=288, az_upsample=5)  # pooled row 115 KB
    assert 2 * big.n_radial * big.n_fine * 4 <= lag_ops._BLOCK_SMEM_BYTES  # raw + pooled fit,
    assert lag_ops.lag_smem_bytes(big) > lag_ops._BLOCK_SMEM_BYTES  # not beside the table
    pano = torch.zeros(1, big.n_radial, big.n_fine)
    flat = torch.zeros(2, big.n_pixels)
    with pytest.raises(ValueError, match="does not fit in shared memory"):
        lag_lib_min(pano, flat, torch.zeros(2), big, torch.zeros(3, dtype=torch.int32))
