"""The port's analysis layer (navdv_torch.analysis: probes, RIDF curves,
familiarity maps, catchment areas) against the JAX package's analysis.py
and its tests (tests/test_analysis.py), on the CPU, with the JAX library
carried across where the two are compared."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import navdv_tpu.analysis as janalysis
from navdv_torch import analysis
from navdv_torch.agent import make_statics
from navdv_torch.analysis import (
    catchment,
    familiarity_map,
    full_circle_scan,
    heading_error,
    make_familiarity_probe,
    ridf,
)
from navdv_torch.convert import config_from, library_from_numpy, statics_from_numpy
from navdv_torch.training import train_library
from navdv_tpu import oracle
from navdv_tpu.agent import make_statics as j_make_statics
from navdv_tpu.training import train_library as j_train_library

CPU = "cpu"


@pytest.fixture(scope="module")
def world(request):
    """The small parity world with the port's own library (as the JAX test
    uses its own)."""
    jcfg = request.getfixturevalue("small_cfg")
    landscape, route = request.getfixturevalue("small_world")
    cfg = config_from(jcfg)
    lib = train_library(landscape, route, cfg, device=CPU)
    st = make_statics(landscape, lib, route, device=CPU)
    return cfg, landscape, route, lib, st


@pytest.fixture(scope="module")
def jworld(request):
    """The small parity world with the JAX library, in both packages."""
    jcfg = request.getfixturevalue("small_cfg")
    landscape, route = request.getfixturevalue("small_world")
    jlib = j_train_library(jnp.asarray(landscape), route, jcfg)
    return jcfg, landscape, route, jlib, library_from_numpy(jlib, device=CPU)


def _scale(jlib, metric: str) -> float:
    """The scale of the terms that cancel (tests/test_torch_simulator.py):
    the largest |l|^2 for SSD, 1 for NCC."""
    return float(np.asarray(jlib.sq).max()) if metric == "ssd" else 1.0


def test_full_circle_scan_covers_the_circle(world, small_cfg):
    cfg, *_ = world
    fc = full_circle_scan(cfg)
    assert fc.scan.n_headings == cfg.sensor.n_fine
    assert fc.scan.scan_step_bins == 1 and fc.scan.tol_bins == 0
    angles = make_familiarity_probe(fc, "kernel", device=CPU).angles
    assert angles.shape == (cfg.sensor.n_fine,)
    assert np.all(np.diff(angles) > 0)
    assert np.isclose(angles[1] - angles[0], cfg.sensor.bin_width)
    assert np.isclose(angles[-1] - angles[0], 2 * np.pi - cfg.sensor.bin_width, atol=1e-6)
    # the JAX package's scan and angles, exactly
    jfc = janalysis.full_circle_scan(small_cfg)
    assert config_from(jfc) == fc
    np.testing.assert_array_equal(angles, janalysis.make_familiarity_probe(jfc, "jnp").angles)


def test_probe_matches_oracle_scan(world, small_cfg):
    """probe == oracle.scan_familiarity at the agent's own scan config (the
    JAX test's tolerances)."""
    cfg, landscape, route, lib, st = world
    olib = oracle.train_library(landscape, route, small_cfg)
    pts, headings = oracle.resample_route(route, cfg.capture_spacing)
    probe = make_familiarity_probe(cfg, "kernel", device=CPU)
    idx = [0, len(pts) // 2, len(pts) - 1]
    xy = np.asarray(pts)[idx] + np.array([0.7, -0.4])  # off-capture poses
    th = np.asarray(headings)[idx] + 0.1
    fam = probe(xy, th, st).numpy()
    for i, (p, t) in enumerate(zip(xy, th)):
        pano = oracle.render_panorama(landscape, p[0], p[1], t, small_cfg)
        want = oracle.scan_familiarity(pano, olib, small_cfg)
        np.testing.assert_allclose(fam[i], want, atol=5e-2, rtol=1e-3)


@pytest.mark.parametrize("fam_impl,jax_impl", [("kernel", "jnp"), ("plain", "jnp"),
                                               ("roll", "roll"), ("fft", "fft"),
                                               ("conv", "conv")])
@pytest.mark.parametrize("metric", ["ssd", "ncc"])
@pytest.mark.parametrize("full_circle", [False, True])
def test_probe_matches_jax_probe(jworld, fam_impl, jax_impl, metric, full_circle):
    """The port's probe against the JAX probe on the same library and poses:
    familiarity within 1e-4 of the scale of the terms that cancel, and the
    same tie-ordered candidate wherever the JAX gap between the best two
    headings exceeds that."""
    jcfg, landscape, route, jlib, lib = jworld
    jcfg = dataclasses.replace(jcfg, scan=dataclasses.replace(jcfg.scan, metric=metric))
    if full_circle:
        jcfg = janalysis.full_circle_scan(jcfg)
    cfg = config_from(jcfg)
    pts, headings = oracle.resample_route(route, jcfg.capture_spacing)
    idx = [0, 3, 6, 9, 12]
    xy = (np.asarray(pts)[idx] + np.array([0.4, -0.3])).astype(np.float32)
    th = (np.asarray(headings)[idx] + 0.07).astype(np.float32)

    jprobe = janalysis.make_familiarity_probe(jcfg, jax_impl)
    jst = j_make_statics(landscape, jlib, route)
    jaux = jprobe.prepare(jst) if jprobe.prepare is not None else None
    want = np.asarray(jprobe(jnp.asarray(xy), jnp.asarray(th), jst, jaux))
    _, want_k = jprobe.best(jnp.asarray(xy), jnp.asarray(th), jst, jaux)

    probe = make_familiarity_probe(cfg, fam_impl, device=CPU)
    st = statics_from_numpy(landscape, lib, route, device=CPU)
    aux = probe.prepare(st) if probe.prepare is not None else None
    got = probe(xy, th, st, aux)
    _, k = probe.best(xy, th, st, aux)
    assert got.dtype == torch.float32 and got.shape == want.shape
    tol = 1e-4 * _scale(jlib, metric)
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=1e-4)
    part = np.sort(want, axis=1)
    clear = part[:, 1] - part[:, 0] > tol
    np.testing.assert_array_equal(k.numpy()[clear], np.asarray(want_k)[clear])


def test_probe_impl_consistency(world):
    """The port's paths agree through the probe: roll, fft (cutoff 0) and
    conv score the kernel path's fp32 candidates in fp64 (ROADMAP C.7), so
    they equal it to fp64 summation order."""
    cfg, landscape, route, lib, st = world
    pts, headings = oracle.resample_route(route, cfg.capture_spacing)
    xy = np.asarray(pts)[[1, 3]]
    th = np.asarray(headings)[[1, 3]] + 0.05

    def run(impl):
        probe = make_familiarity_probe(cfg, impl, device=CPU)
        aux = probe.prepare(st) if probe.prepare is not None else None
        return probe(xy, th, st, aux).numpy()

    base = run("kernel")
    for impl in ("plain", "roll", "fft", "conv"):
        np.testing.assert_allclose(run(impl), base, rtol=1e-6, atol=1e-6, err_msg=impl)


def test_ridf_minimum_at_capture_pose(world):
    """At an exact capture pose the RIDF valley bottoms at rotation 0 with
    ~zero distance; the batched form equals the single-pose form."""
    cfg, landscape, route, lib, st = world
    pts, headings = oracle.resample_route(route, cfg.capture_spacing)
    i = len(pts) // 2
    angles, fam = ridf(landscape, lib, pts[i], headings[i], cfg, fam_impl="kernel", device=CPU)
    assert fam.shape == angles.shape
    k = int(np.argmin(fam))
    assert abs(angles[k]) < 1e-6, f"valley at {angles[k]:.3f} rad, not 0"
    assert fam[k] < 1e-3 * float(np.max(fam))
    angles_b, fam_b = ridf(landscape, lib, np.stack([pts[i], pts[i]]),
                           np.array([headings[i], headings[i]]), cfg, fam_impl="kernel",
                           device=CPU)
    np.testing.assert_allclose(fam_b[0], fam, rtol=1e-6)
    np.testing.assert_allclose(angles_b, angles)


def test_familiarity_map_catchment(world):
    """The map's familiar region hugs the route, and the padded last batch
    gives the values of one unpadded pass."""
    cfg, landscape, route, lib, st = world
    fmap = familiarity_map(landscape, lib, cfg, stride=12.0, batch=32, device=CPU)
    ny, nx = len(fmap["y"]), len(fmap["x"])
    assert fmap["fam"].shape == fmap["best_heading"].shape == (ny, nx)
    assert np.all(np.isfinite(fmap["fam"]))
    gx, gy = np.meshgrid(fmap["x"], fmap["y"])
    d = oracle.point_to_polyline_dists(np.stack([gx.ravel(), gy.ravel()], axis=1),
                                       route).reshape(ny, nx)
    near, far = fmap["fam"][d < 8.0], fmap["fam"][d > 40.0]
    assert near.size > 0 and far.size > 0
    assert float(near.mean()) < float(far.mean())
    fmap2 = familiarity_map(landscape, lib, cfg, stride=12.0, batch=ny * nx, device=CPU)
    np.testing.assert_allclose(fmap2["fam"], fmap["fam"], rtol=1e-6)


@pytest.mark.parametrize("fam_impl,jax_impl", [("kernel", "jnp"), ("fft", "fft")])
def test_familiarity_map_matches_jax(jworld, fam_impl, jax_impl):
    """The port's map against the JAX map on the same library: grid equal,
    familiarity within 1e-4 of scale, the same best heading wherever the JAX
    map's choice is clear."""
    jcfg, landscape, route, jlib, lib = jworld
    want = janalysis.familiarity_map(jnp.asarray(landscape), jlib, jcfg, stride=16.0,
                                     fam_impl=jax_impl, batch=64)
    got = familiarity_map(landscape, lib, config_from(jcfg), stride=16.0, fam_impl=fam_impl,
                          batch=64, device=CPU)
    for key in ("x", "y", "angles"):
        np.testing.assert_array_equal(got[key], want[key])
    tol = 1e-4 * _scale(jlib, "ssd")
    np.testing.assert_allclose(got["fam"], want["fam"], atol=tol, rtol=1e-4)
    assert np.mean(got["best_heading"] == want["best_heading"]) >= 0.95


def test_plots_smoke(world, tmp_path):
    from navdv_torch import viz

    cfg, landscape, route, lib, st = world
    pts, headings = oracle.resample_route(route, cfg.capture_spacing)
    angles, fam = ridf(landscape, lib, pts[0], headings[0], cfg, fam_impl="kernel", device=CPU)
    p1 = viz.plot_ridf(angles, fam, str(tmp_path / "ridf.png"))
    fmap = familiarity_map(landscape, lib, cfg, stride=16.0, batch=64, device=CPU)
    c = catchment(fmap, route, corridor=10.0)
    p2 = viz.plot_familiarity_map(landscape, route, fmap, str(tmp_path / "fmap.png"),
                                  captured=c["captured"])
    assert os.path.getsize(p1) > 0 and os.path.getsize(p2) > 0


def test_probe_sector_branches(small_world):
    """The probe covers the sector renderer's branches: the unfused sector
    path and the fused front end (u=1) agree with the full-window fft probe,
    and ``probe.fused`` reads which front end the step took."""
    from navdv_torch.config import ScanConfig, SensorConfig, SimConfig

    landscape, route = small_world
    sensor = SensorConfig(n_radial=4, n_azimuth=24, az_upsample=1, r_min=2.0, r_max=8.0)
    cfg = SimConfig(sensor=sensor, scan=ScanConfig(n_headings=12, scan_step_bins=2, tol_bins=2),
                    capture_spacing=2.0)
    cfg_sector = dataclasses.replace(cfg, sensor=dataclasses.replace(sensor, render_mode="sector"))
    cfg_fused = dataclasses.replace(
        cfg_sector, scan=dataclasses.replace(cfg.scan, fused_dft_precision="inherit"))
    lib = train_library(landscape, route, cfg, device=CPU)
    st = make_statics(landscape, lib, route, device=CPU)
    pts, headings = oracle.resample_route(route, cfg.capture_spacing)
    xy = np.asarray(pts)[[2, 5]]
    th = np.asarray(headings)[[2, 5]] + 0.3

    def run(c, fused):
        probe = make_familiarity_probe(c, "fft", device=CPU)
        assert probe.fused is fused
        return probe(xy, th, st, probe.prepare(st)).numpy()

    base = run(cfg, False)
    np.testing.assert_allclose(run(cfg_sector, False), base, atol=5e-3)
    np.testing.assert_allclose(run(cfg_fused, True), base, atol=5e-3)


def _bowl_grid():
    x = np.arange(0.0, 100.0, 4.0, dtype=np.float32)
    y = np.arange(0.0, 100.0, 4.0, dtype=np.float32)
    gx, gy = np.meshgrid(x, y)

    def bowl(cx, cy):
        return {"x": x, "y": y, "fam": ((gx - cx) ** 2 + (gy - cy) ** 2).astype(np.float32)}

    return x, y, bowl


def test_catchment_synthetic():
    """Descent on a synthetic bowl: a bowl centred on the route captures
    every cell, one far away none; route_dist is the exact point-to-polyline
    distance; every output equals the JAX catchment's bit for bit."""
    x, y, bowl = _bowl_grid()
    route = np.array([[46.0, 46.0], [50.0, 50.0]])
    full = catchment(bowl(48.0, 48.0), route, corridor=6.0)
    assert full["fraction"] == 1.0 and full["captured"].all()
    away = catchment(bowl(90.0, 10.0), route, corridor=6.0)
    assert away["fraction"] == 0.0
    i, j = 3, 7
    want = oracle.point_to_polyline_dist(np.array([x[j], y[i]]), route)
    np.testing.assert_allclose(full["route_dist"][i, j], want, rtol=1e-5)
    for fmap in (bowl(48.0, 48.0), bowl(90.0, 10.0), bowl(20.0, 70.0)):
        got, ref = catchment(fmap, route, corridor=6.0), janalysis.catchment(fmap, route, 6.0)
        assert got["fraction"] == ref["fraction"]
        np.testing.assert_array_equal(got["captured"], ref["captured"])
        np.testing.assert_array_equal(got["route_dist"], ref["route_dist"])


def test_catchment_on_world(world):
    """On the test world the captured region is route-proximal, and the
    catchment of the port's map equals the JAX catchment of the same map
    bit for bit."""
    cfg, landscape, route, lib, st = world
    fmap = familiarity_map(landscape, lib, cfg, stride=8.0, batch=64, device=CPU)
    c = catchment(fmap, route, corridor=10.0)
    assert 0.0 < c["fraction"] <= 1.0
    cap, uncap = c["route_dist"][c["captured"]], c["route_dist"][~c["captured"]]
    assert cap.size > 0
    if uncap.size:  # tiny worlds can be fully captured
        assert float(cap.mean()) < float(uncap.mean())
    ref = janalysis.catchment(fmap, route, corridor=10.0)
    assert c["fraction"] == ref["fraction"]
    for key in ("captured", "route_dist"):
        np.testing.assert_array_equal(c[key], ref[key])


def test_probe_cache_and_best(world):
    """Probes are cached on (cfg, impl, device), call styles share one key,
    and probe.best is the tie-ordered argmin of the probe's familiarity."""
    cfg, landscape, route, lib, st = world
    p1 = make_familiarity_probe(cfg, "kernel", device=CPU)
    assert p1 is make_familiarity_probe(cfg, "kernel", device=CPU)
    assert p1 is make_familiarity_probe(cfg, fam_impl="kernel", lib_axis=None,
                                        device=torch.device("cpu"))
    assert p1 is not make_familiarity_probe(cfg, "roll", device=CPU)
    pts, headings = oracle.resample_route(route, cfg.capture_spacing)
    xy = np.asarray(pts)[[0, 3]]
    th = np.asarray(headings)[[0, 3]] + 0.2
    fam = p1(xy, th, st).numpy()
    best, k = p1.best(xy, th, st)
    np.testing.assert_array_equal(k.numpy(), fam.argmin(axis=1))
    np.testing.assert_allclose(best.numpy(), fam.min(axis=1), rtol=1e-6)


def test_probe_lib_axis_raises_naming_a17(world):
    """A lib-axis probe in one process, over a group of one rank, equals the
    plain probe (the multi-rank probe is in tests/test_torch_parallel.py),
    and is cached apart from it."""
    import torch.distributed as dist

    from navdv_torch.parallel import init_distributed, make_mesh, shard_statics

    cfg, landscape, route, lib, st = world
    pts, headings = oracle.resample_route(route, cfg.capture_spacing)
    xy = np.asarray(pts)[[1, 2]]
    th = np.asarray(headings)[[1, 2]] + 0.05
    init_distributed(device=CPU)
    try:
        mesh = make_mesh(1, 1, device=CPU)
        probe = make_familiarity_probe(cfg, "kernel", lib_axis=mesh.lib_group, device=CPU)
        ref = make_familiarity_probe(cfg, "kernel", device=CPU)
        assert probe is not ref
        got = probe(xy, th, shard_statics(st, mesh))
    finally:
        dist.destroy_process_group()
    assert torch.equal(got, ref(xy, th, st))


def test_probe_best_production_tie_break(small_cfg):
    """On a flat world every rotation ties; the step's tie-break (smallest
    |shift| first) picks rotation 0, where a bare argmin would pick the most
    negative one."""
    from navdv_torch.landscape import make_landscape
    from navdv_torch.routes import make_route

    cfg = config_from(small_cfg)
    landscape = make_landscape("flat", size=(128, 128), seed=0)
    route = make_route("line", size=(128, 128), margin=32.0, length=40.0)
    lib = train_library(landscape, route, cfg, device=CPU)
    st = make_statics(landscape, lib, route, device=CPU)
    pts, headings = oracle.resample_route(route, cfg.capture_spacing)
    probe = make_familiarity_probe(full_circle_scan(cfg), "kernel", device=CPU)
    fam = probe(pts[[2]], headings[[2]], st).numpy()
    assert float(fam.max() - fam.min()) == 0.0, "flat world must tie"
    _, k = probe.best(pts[[2]], headings[[2]], st)
    assert float(probe.angles[int(k[0])]) == pytest.approx(0.0, abs=1e-7)


@pytest.mark.parametrize("fam_impl", ["fft", "infomax"])
def test_aux_cache_reuses_prepare(world, monkeypatch, fam_impl):
    """Repeated ridf calls against one library run probe.prepare once (on
    infomax, prepare trains the network) and share one statics upload."""
    cfg, landscape, route, lib, st = world
    pts, headings = oracle.resample_route(route, cfg.capture_spacing)
    probe = make_familiarity_probe(full_circle_scan(cfg), fam_impl, device=CPU)
    calls = []
    orig = probe.prepare
    assert orig is not None
    monkeypatch.setattr(probe, "prepare", lambda s: (calls.append(1), orig(s))[1])
    analysis._AUX_CACHE.clear()
    analysis._STATICS_CACHE.clear()
    _, f1 = ridf(landscape, lib, pts[1], headings[1], cfg, fam_impl=fam_impl, device=CPU)
    _, f2 = ridf(landscape, lib, pts[2], headings[2], cfg, fam_impl=fam_impl, device=CPU)
    assert len(calls) == 1
    assert np.isfinite(f1).all() and np.isfinite(f2).all()
    assert len(analysis._STATICS_CACHE) == 1


def test_batch_mismatch_raises(world):
    cfg, landscape, route, lib, st = world
    with pytest.raises(ValueError, match="theta batch"):
        ridf(landscape, lib, np.zeros((3, 2)), np.zeros(2), cfg, device=CPU)
    with pytest.raises(ValueError, match="heading batches"):
        heading_error(landscape, lib, cfg, np.zeros((3, 2)), np.zeros(2), device=CPU)


def test_heading_error(world, small_cfg):
    """At capture poses the scan's heading matches the capture heading within
    one fine bin, also facing 90 deg away (the full circle), and equals the
    JAX heading_error on the same library."""
    cfg, landscape, route, lib, st = world
    pts, headings = oracle.resample_route(route, cfg.capture_spacing)
    xy = np.asarray(pts)[[0, 4, 8]]
    th = np.asarray(headings)[[0, 4, 8]]
    binw = cfg.sensor.bin_width
    err = heading_error(landscape, lib, cfg, xy, th, fam_impl="kernel", device=CPU)
    assert err.shape == (3,) and err.dtype == np.float32
    assert np.all(np.abs(err) <= binw + 1e-6), err
    err_rot = heading_error(landscape, lib, cfg, xy, th, theta_probe=th + np.pi / 2,
                            fam_impl="kernel", device=CPU)
    assert np.all(np.abs(err_rot) <= binw + 1e-6), err_rot
    jlib = j_train_library(jnp.asarray(landscape), route, small_cfg)
    want = janalysis.heading_error(jnp.asarray(landscape), jlib, small_cfg, xy, th,
                                   fam_impl="jnp")
    got = heading_error(landscape, library_from_numpy(jlib, device=CPU), cfg, xy, th,
                        fam_impl="kernel", device=CPU)
    np.testing.assert_allclose(got, want, atol=1e-6)
