"""The port's sector renderer, its roll absorption and the two sector
branches of the spectral step, against the JAX package (tests/
test_sector_render.py, tests/test_sector_bounds_property.py) and against
the port's own full renderer and unfused paths, on the CPU."""

import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import navdv_torch as nt
from navdv_torch import familiarity_fft as tfft
from navdv_torch import sensor as ts
from navdv_torch.agent import init_state, make_navigate_batch, make_statics, make_step_batched
from navdv_torch.convert import config_from, library_from_numpy, statics_from_numpy
from navdv_tpu import sensor as js
from navdv_tpu.agent import init_state as j_init_state
from navdv_tpu.agent import make_navigate_batch as j_make_navigate_batch
from navdv_tpu.agent import make_statics as j_make_statics
from navdv_tpu.agent import make_step_batched as j_make_step_batched
from navdv_tpu.config import ScanConfig, SensorConfig, SimConfig
from navdv_tpu.familiarity import pack_library
from navdv_tpu.familiarity_fft import make_lib_min_fft
from navdv_tpu.metrics import success_rate as j_success_rate
from navdv_tpu.oracle import resample_route
from navdv_tpu.training import train_library as j_train_library

# sensor geometries of tests/test_sector_bounds_property.py's strategy:
# (n_radial, n_azimuth, az_upsample, r_min, r_span, n_sectors, ring_blocks)
_BOUNDS_CASES = [
    (4, 24, 3, 2.0, 6.0, 8, 1),  # the small parity sensor (test_sector_render.py:32)
    (2, 24, 1, 1.0, 1.0, 4, 3),
    (12, 16, 2, 4.0, 8.0, 8, 2),
    (7, 40, 1, 2.5, 3.3, 4, 3),
    (9, 8, 5, 1.7, 5.1, 4, 1),
    (64, 360, 1, 2.0, 8.0, 8, 1),  # the BASELINE config-3 sensor
]


@pytest.mark.parametrize("case", _BOUNDS_CASES)
def test_sector_bounds_match_jax(case):
    r, w, u, r_min, r_span, n_sectors, ring_blocks = case
    sensor = SensorConfig(n_radial=r, n_azimuth=w, az_upsample=u, r_min=r_min,
                          r_max=r_min + r_span)
    want = js.sector_bounds(sensor, n_sectors, ring_blocks)
    got = ts.sector_bounds(config_from(SimConfig(sensor=sensor)).sensor, n_sectors, ring_blocks)
    assert got == want


def test_indivisible_sector_count_raises_like_jax():
    sensor = SensorConfig(n_azimuth=24, az_upsample=1)
    with pytest.raises(ValueError, match="divisible"):
        js.sector_bounds(sensor, 7)
    psensor = config_from(SimConfig(sensor=sensor)).sensor
    with pytest.raises(ValueError, match="divisible"):
        ts.sector_bounds(psensor, 7)
    with pytest.raises(ValueError, match="divisible"):
        ts.make_render_batch_rolled(dataclasses.replace(psensor, n_sectors=7), device="cpu")


def _poses(n, seed):
    """Poses inside the live-agent envelope of the 128^2 world (>= r_max - 2
    from every edge), headings over several turns (test_sector_render.py)."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(12, 116, size=(n, 2)).astype(np.float32),
            rng.uniform(-7, 7, size=(n,)).astype(np.float32))


def _render_both(sensor, landscape, poses, thetas):
    want = js.make_render_batch_rolled(sensor)(
        jnp.asarray(landscape), jnp.asarray(poses), jnp.asarray(thetas))
    render = ts.make_render_batch_rolled(config_from(SimConfig(sensor=sensor)).sensor,
                                         device="cpu")
    got = render(torch.from_numpy(landscape), torch.from_numpy(poses), torch.from_numpy(thetas))
    return [np.asarray(x) for x in want], [x.numpy() for x in got]


@pytest.mark.parametrize("hat_dtype,atol", [("float32", 2e-4), ("bfloat16", 2e-2)])
def test_rolled_render_matches_jax_and_full(small_cfg, small_world, hat_dtype, atol):
    """The same k exactly; the phi-frame panorama within the JAX test's
    tolerance of JAX's; unrolled, within it of the port's full renderer."""
    landscape, _ = small_world
    sensor = dataclasses.replace(small_cfg.sensor, hat_dtype=hat_dtype)
    poses, thetas = _poses(16, 0)
    (pj, kj), (pt, kt) = _render_both(sensor, landscape, poses, thetas)
    assert kt.dtype == np.int32
    np.testing.assert_array_equal(kt, kj)
    assert np.all(kt >= 0) and np.all(kt < sensor.n_fine)
    np.testing.assert_allclose(pt, pj, atol=atol)
    full = ts.make_render_batch(config_from(SimConfig(sensor=sensor)).sensor, device="cpu")(
        torch.from_numpy(landscape), torch.from_numpy(poses), torch.from_numpy(thetas))
    np.testing.assert_allclose(ts.unroll_panorama(torch.from_numpy(pt), torch.from_numpy(kt)),
                               full.numpy(), atol=atol)
    np.testing.assert_array_equal(ts.unroll_panorama(pt, kt), js.unroll_panorama(pt, kt))


@pytest.mark.parametrize("ring_blocks", [2, 3])
def test_rolled_render_ring_blocks(small_cfg, small_world, ring_blocks):
    """Ring blocks change nothing in the port's render, and JAX's
    ring-blocked render is within 2e-4 of it (f32)."""
    landscape, _ = small_world
    sensor = dataclasses.replace(small_cfg.sensor, ring_blocks=ring_blocks)
    poses, thetas = _poses(8, 1)
    (pj, kj), (pt, kt) = _render_both(sensor, landscape, poses, thetas)
    _, (p1, k1) = _render_both(small_cfg.sensor, landscape, poses, thetas)
    np.testing.assert_array_equal(kt, kj)
    np.testing.assert_array_equal(pt, p1)
    np.testing.assert_array_equal(kt, k1)
    np.testing.assert_allclose(pt, pj, atol=2e-4)


@pytest.mark.parametrize("hat_dtype", ["float32", "bfloat16"])
def test_phi_bins_render_matches_jax(small_cfg, small_world, hat_dtype):
    """phi_bins=8: the same k as JAX's phi-bins render and as the exact
    render, and within JAX's own envelope of JAX's phi-bins render
    (test_sector_render.py: max < 0.05, mean < 2e-3)."""
    landscape, _ = small_world
    sensor = dataclasses.replace(small_cfg.sensor, hat_dtype=hat_dtype, phi_bins=8)
    poses, thetas = _poses(16, 2)
    (pj, kj), (pt, kt) = _render_both(sensor, landscape, poses, thetas)
    _, (_, k_exact) = _render_both(dataclasses.replace(sensor, phi_bins=0), landscape, poses,
                                   thetas)
    np.testing.assert_array_equal(kt, kj)
    np.testing.assert_array_equal(kt, k_exact)
    err = np.abs(pt - pj)
    assert err.max() < 0.05 and err.mean() < 2e-3, (err.max(), err.mean())


def test_rolled_render_contract_is_the_fp64_product(small_cfg, small_world):
    """``contract=``: the fp64 product of the phi-frame panorama and its fp64
    row sums, beside the same k."""
    landscape, _ = small_world
    sensor = config_from(small_cfg).sensor
    poses, thetas = (torch.from_numpy(x) for x in _poses(5, 3))
    land = torch.from_numpy(landscape)
    contract = torch.from_numpy(np.random.default_rng(4).normal(size=(sensor.n_fine, 7)))
    pano, k = ts.make_render_batch_rolled(sensor, device="cpu")(land, poses, thetas)
    spec, k2, rowsum, rowsq = ts.make_render_batch_rolled(
        sensor, contract=contract, device="cpu")(land, poses, thetas)
    assert spec.dtype == rowsum.dtype == rowsq.dtype == torch.float64
    assert torch.equal(k, k2)
    p64 = pano.double()
    assert torch.equal(spec, p64 @ contract)
    assert torch.equal(rowsum, p64.sum(2)) and torch.equal(rowsq, (p64 * p64).sum(2))
    with pytest.raises(ValueError, match="contract rows"):
        ts.make_render_batch_rolled(sensor, contract=contract[1:], device="cpu")


@pytest.mark.parametrize("u", [1, 3])
def test_lag_stats_dynamic_roll_matches_jax(u):
    sensor = SensorConfig(n_radial=4, n_azimuth=24, az_upsample=u, r_min=2.0, r_max=8.0)
    scan = ScanConfig(n_headings=12, scan_step_bins=2, tol_bins=1)
    lags, _ = js.scan_lag_sets(scan)
    rng = np.random.default_rng(2)
    s_phi = rng.random((6, sensor.n_radial, sensor.n_fine)).astype(np.float32)
    k = rng.integers(0, sensor.n_fine, size=6).astype(np.int32)
    want = js.make_lag_stats(sensor, lags, dynamic_roll=True)(jnp.asarray(s_phi), jnp.asarray(k))
    psensor = config_from(SimConfig(sensor=sensor)).sensor
    got = ts.make_lag_stats(psensor, lags, "cpu", dynamic_roll=True)(
        torch.from_numpy(s_phi), torch.from_numpy(k))
    direct = ts.make_lag_stats(psensor, lags, "cpu")(
        torch.from_numpy(ts.unroll_panorama(s_phi, k)))
    for g, w, d in zip(got, want, direct):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5)
        np.testing.assert_allclose(g.numpy(), d.numpy(), rtol=1e-5)


def _roll_inputs(metric, u):
    """test_sector_render.py's phase-rotation inputs, in both packages."""
    sensor = SensorConfig(n_radial=4, n_azimuth=24, az_upsample=u, r_min=2.0, r_max=8.0)
    scan = ScanConfig(n_headings=12, scan_step_bins=2, metric=metric, tol_bins=1)
    lags, _ = js.scan_lag_sets(scan)
    rng = np.random.default_rng(2)
    b, nl, a = 6, 5, sensor.n_fine
    s_phi = rng.random((b, sensor.n_radial, a)).astype(np.float32)
    k = rng.integers(0, a, size=(b,)).astype(np.int32)
    views = rng.random((nl, sensor.n_radial, sensor.n_azimuth)).astype(np.float32)
    return sensor, scan, lags, s_phi, k, pack_library(jnp.asarray(views))


@pytest.mark.parametrize("metric", ["ssd", "ncc"])
@pytest.mark.parametrize("u", [1, 3])
def test_roll_absorption(metric, u):
    """``lib_min(s_phi, roll_k=k)`` equals ``lib_min(roll(s_phi, k))`` in the
    port to rtol 1e-9, and JAX's rolled result to its test's 3e-4 of
    scale; ``.spectral`` with ``roll_k`` equals it too."""
    sensor, scan, lags, s_phi, k, jlib = _roll_inputs(metric, u)
    s_theta = ts.unroll_panorama(s_phi, k)
    psensor = config_from(SimConfig(sensor=sensor, scan=scan))
    lib = library_from_numpy(jlib, device="cpu")
    fft = tfft.make_lib_min_fft(psensor.sensor, psensor.scan, lags, "cpu")
    stats = ts.make_lag_stats(psensor.sensor, lags, "cpu", dynamic_roll=True)
    st_phi, st_k = torch.from_numpy(s_phi), torch.from_numpy(k)
    lag_sum, lag_sq = stats(st_phi.double(), st_k)
    got = fft(st_phi, lib, lag_sum, lag_sq, roll_k=st_k)
    plain_sum, plain_sq = ts.make_lag_stats(psensor.sensor, lags, "cpu")(
        torch.from_numpy(s_theta).double())
    direct = fft(torch.from_numpy(s_theta), lib, plain_sum, plain_sq)
    np.testing.assert_allclose(got.numpy(), direct.numpy(), rtol=1e-9, atol=1e-12)

    j_stats = js.make_lag_stats(sensor, lags)(jnp.asarray(s_theta))
    want = np.asarray(make_lib_min_fft(sensor, scan, lags)(jnp.asarray(s_theta), jlib, *j_stats))
    scale = float(np.max(np.abs(want))) + 1e-6
    np.testing.assert_allclose(got.numpy(), want, atol=3e-4 * scale, rtol=3e-4)

    if u == 1:  # the fused front end's entry: spectra of S, norms from the caller
        fc = fft.forward_mats.shape[1] // 2
        s64 = st_phi.double()
        spec = s64 @ fft.forward_mats
        sq = lag_sq if metric == "ncc" else (s64 * s64).sum((1, 2))[:, None].expand_as(got)
        entered = fft.spectral((spec[..., :fc], spec[..., fc:], s64.mean(2)), lib, lag_sum, sq,
                               roll_k=st_k)
        np.testing.assert_allclose(entered.numpy(), direct.numpy(), rtol=1e-9, atol=1e-12)


def _fused_cfg(metric, fused_dft_precision):
    """tests/test_sector_render.py's fused-parity workload (u = 1)."""
    sensor = SensorConfig(n_radial=4, n_azimuth=24, az_upsample=1, r_min=2.0, r_max=8.0)
    return SimConfig(
        sensor=dataclasses.replace(sensor, render_mode="sector"),
        scan=ScanConfig(n_headings=12, scan_step_bins=2, metric=metric, tol_bins=2,
                        fused_dft_precision=fused_dft_precision),
        capture_spacing=2.0,
    )


@pytest.mark.parametrize("metric", ["ssd", "ncc"])
@pytest.mark.parametrize("fused", ["inherit", "off"])
def test_sector_step_matches_jax(small_world, metric, fused):
    """One fused and one unfused sector step against JAX's on the same
    library: equal k, fam within 2e-3 (JAX's fused-parity tolerance), and
    neither warns."""
    landscape, route = small_world
    cfg = _fused_cfg(metric, fused)
    lib = j_train_library(jnp.asarray(landscape), route, cfg)
    pts, headings = resample_route(route, cfg.capture_spacing)
    rng = np.random.default_rng(5)
    starts = (pts[0][None, :] + rng.normal(0, 1.0, size=(8, 2))).astype(np.float32)
    thetas = (headings[0] + rng.normal(0, 0.5, size=(8,))).astype(np.float32)
    j_step = j_make_step_batched(cfg, fam_impl="fft")
    j_st = j_make_statics(landscape, lib, route)
    _, rec_j = j_step(j_init_state(starts, thetas), j_st, j_step.lib_prepare(j_st))
    st = statics_from_numpy(landscape, lib, route, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        step = make_step_batched(config_from(cfg), "fft", device="cpu")
    _, rec_t = step(init_state(starts, thetas, device="cpu"), st, step.lib_prepare(st))
    np.testing.assert_array_equal(rec_t.k.numpy(), np.asarray(rec_j.k))
    np.testing.assert_allclose(rec_t.fam.numpy(), np.asarray(rec_j.fam), atol=2e-3)
    np.testing.assert_allclose(rec_t.xy.numpy(), np.asarray(rec_j.xy), atol=1e-5)


@pytest.mark.parametrize("metric", ["ssd", "ncc"])
def test_fused_equals_unfused_and_full(small_world, metric):
    """In fp64 the fused front end, the unfused sector branch and the full
    renderer's fft path score the same fp32 panorama: familiarity within
    rtol 1e-6 (render rounding of the rotation), and the same candidates."""
    landscape, route = small_world
    cfg = config_from(_fused_cfg(metric, "default"))
    lib = nt.train_library(landscape, route, cfg, device="cpu")
    st = make_statics(landscape, lib, route, device="cpu")
    starts, thetas = nt.make_trials(route, cfg, 16, seed=2, heading_sigma=0.5)
    states = init_state(starts, thetas, device="cpu")
    fams = []
    for c in (cfg, dataclasses.replace(cfg, scan=dataclasses.replace(
            cfg.scan, fused_dft_precision="off"))):
        step = make_step_batched(c, "fft", device="cpu")
        assert step.fam.fused == (c.scan.fused_dft_precision != "off")
        fams.append(step.fam(states, st, step.lib_prepare(st)))
        assert torch.equal(step.fam(states, st), fams[-1])  # aux built per call
    full = dataclasses.replace(cfg, sensor=dataclasses.replace(cfg.sensor, render_mode="full"),
                               scan=dataclasses.replace(cfg.scan, fused_dft_precision="off"))
    fams.append(make_step_batched(full, "fft", device="cpu").fam(states, st))
    np.testing.assert_allclose(fams[0].numpy(), fams[1].numpy(), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(fams[0].numpy(), fams[2].numpy(), rtol=1e-6, atol=1e-6)
    order = torch.as_tensor(cfg.scan.tie_order())
    ks = [order[torch.argmin(f[:, order], dim=1)] for f in fams]
    assert torch.equal(ks[0], ks[1]) and torch.equal(ks[0], ks[2])


@pytest.mark.parametrize("metric,tol_bins", [("ssd", 0), ("ncc", 2)])
def test_sector_closed_loop_recall(small_cfg, small_world, metric, tol_bins):
    """Episodes through the port's sector + fft step recall like JAX's exact
    full step, in the JAX test's band (test_sector_render.py:94-123), and
    the port's unfused sector episode (u = 3) agrees."""
    cfg = dataclasses.replace(
        small_cfg, scan=dataclasses.replace(small_cfg.scan, metric=metric, tol_bins=tol_bins))
    cfg_sector = dataclasses.replace(
        cfg, sensor=dataclasses.replace(cfg.sensor, render_mode="sector"))
    landscape, route = small_world
    lib = j_train_library(jnp.asarray(landscape), route, cfg)
    pts, headings = resample_route(route, cfg.capture_spacing)
    rng = np.random.default_rng(0)
    starts = (pts[0][None, :] + rng.normal(0, 1.0, size=(8, 2))).astype(np.float32)
    thetas = (headings[0] + rng.normal(0, 0.1, size=(8,))).astype(np.float32)
    f_jnp, _ = j_make_navigate_batch(cfg, fam_impl="jnp")(
        j_init_state(starts, thetas), j_make_statics(landscape, lib, route))
    st = statics_from_numpy(landscape, lib, route, device="cpu")
    run = make_navigate_batch(config_from(cfg_sector), "fft", early_exit=True, device="cpu")
    f_sec, _ = run(init_state(starts, thetas, device="cpu"), st)
    r_jnp, r_sec = float(j_success_rate(f_jnp)), float(nt.success_rate(f_sec))
    assert r_sec >= 0.75, (r_sec, r_jnp)
    assert abs(r_sec - r_jnp) <= 0.25, (r_sec, r_jnp)


def test_sector_falls_back_for_non_fft(small_cfg, small_world):
    """Paths other than fft ignore the sector hint: the same record as
    render_mode="full" (test_sector_render.py:126-141)."""
    landscape, route = small_world
    cfg = config_from(small_cfg)
    sector = dataclasses.replace(cfg, sensor=dataclasses.replace(cfg.sensor,
                                                                  render_mode="sector"))
    lib = nt.train_library(landscape, route, cfg, device="cpu")
    st = make_statics(landscape, lib, route, device="cpu")
    pts, hd = resample_route(route, cfg.capture_spacing)
    states0 = init_state(pts[:2], hd[:2], device="cpu")
    for impl in ("kernel", "roll"):
        _, rec_full = make_navigate_batch(cfg, impl, device="cpu")(states0, st)
        _, rec_sec = make_navigate_batch(sector, impl, device="cpu")(states0, st)
        for a, b in zip(rec_full, rec_sec):
            assert torch.equal(a, b)


@pytest.mark.parametrize(
    "knob,value,render_mode,fam_impl,warns",
    [("phi_bins", 8, "full", "fft", True), ("phi_bins", 8, "sector", "kernel", True),
     ("phi_bins", 8, "sector", "fft", False), ("n_sectors", 4, "full", "roll", True),
     ("ring_blocks", 2, "sector", "fft", False), ("fused_dft_precision", "high", "full", "fft",
                                                  True)],
)
def test_sector_knob_warnings(small_cfg, knob, value, render_mode, fam_impl, warns):
    """The sector renderer's knobs warn outside sector + fft in the JAX
    package's words (navdv_tpu/agent.py:303-312) and are honoured on it."""
    cfg = config_from(small_cfg)
    cfg = dataclasses.replace(cfg, sensor=dataclasses.replace(
        cfg.sensor, n_radial=8, n_azimuth=72, render_mode=render_mode))
    part = "scan" if knob == "fused_dft_precision" else "sensor"
    cfg = dataclasses.replace(cfg, **{part: dataclasses.replace(getattr(cfg, part),
                                                               **{knob: value})})
    if warns:
        match = (f"{knob}={value!r} has no effect outside render_mode='sector' with "
                 f"fam_impl='fft' \\(got render_mode='{render_mode}', fam_impl='{fam_impl}'\\)")
        with pytest.warns(UserWarning, match=match):
            make_step_batched(cfg, fam_impl, device="cpu")
    else:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            make_step_batched(cfg, fam_impl, device="cpu")


def test_config3_width_fused_step():
    """One step at BASELINE config 3's full width (64 x 360 px, NCC,
    tol_bins 3, 125 lags) on a handful of agents: the fused front end, the
    unfused sector branch and the kernel path's full render (all at cutoff
    0) choose the same candidates, and the fused and unfused branches agree
    to rtol 1e-9."""
    cfg = nt.baseline_config(3)
    cfg = dataclasses.replace(cfg, scan=dataclasses.replace(cfg.scan, spectral_cutoff=0),
                              capture_spacing=4.0)
    landscape = nt.make_landscape("blobs", size=(96, 96), seed=7, n_features=40)
    route = nt.make_route("line", size=(96, 96), margin=30.0, length=20.0)
    lib = nt.train_library(landscape, route, cfg, device="cpu")
    st = make_statics(landscape, lib, route, device="cpu")
    starts, thetas = nt.make_trials(route, cfg, 3, seed=0)
    states = init_state(starts, thetas, device="cpu")
    fused = make_step_batched(cfg, "fft", device="cpu").fam(states, st)
    unfused_cfg = dataclasses.replace(cfg, scan=dataclasses.replace(cfg.scan,
                                                                    fused_dft_precision="off"))
    unfused = make_step_batched(unfused_cfg, "fft", device="cpu").fam(states, st)
    with pytest.warns(UserWarning, match="fused_dft_precision"):
        kernel = make_step_batched(cfg, "kernel", device="cpu").fam(states, st)
    assert fused.shape == (3, 60)
    np.testing.assert_allclose(fused.numpy(), unfused.numpy(), rtol=1e-9, atol=1e-12)
    order = torch.as_tensor(cfg.scan.tie_order())
    ks = [order[torch.argmin(f[:, order], dim=1)] for f in (fused, unfused, kernel)]
    assert torch.equal(ks[0], ks[1]) and torch.equal(ks[0], ks[2])
