"""The port's fam_impl="auto", its fft/roll steps and episodes, the
NavigationSimulator facade and the checkpoint files, on the CPU, against the
JAX package and the frozen float64 golden fixture."""

import dataclasses
import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import navdv_torch as nt
import navdv_torch.config as tc
import navdv_tpu.config as jc
from navdv_torch import checkpoint
from navdv_torch.agent import (
    STATUS_REACHED,
    init_state,
    make_statics,
    make_step_batched,
    resolve_fam_impl,
)
from navdv_torch.convert import config_from, statics_from_numpy
from navdv_tpu import oracle
from navdv_tpu.agent import init_state as j_init_state
from navdv_tpu.agent import make_statics as j_make_statics
from navdv_tpu.agent import make_step_batched as j_make_step_batched
from navdv_tpu.training import train_library as j_train_library

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden_oracle_small.npz")


def _wide(cfg, metric="ssd"):
    """The small parity config with a 576-px sensor (8 x 72, u = 3): "auto"
    takes the extraction-free paths only from 512 px."""
    return dataclasses.replace(
        cfg,
        sensor=dataclasses.replace(cfg.sensor, n_radial=8, n_azimuth=72),
        scan=dataclasses.replace(cfg.scan, metric=metric),
    )


def _auto_cases():
    cfgs = [jc.baseline_config(n) for n in range(1, 6)]
    small = jc.SimConfig(sensor=jc.SensorConfig(n_radial=4, n_azimuth=24, az_upsample=3))
    cfgs += [small, dataclasses.replace(small, scan=jc.ScanConfig(metric="ncc"))]
    return cfgs


@pytest.mark.parametrize("i", range(len(_auto_cases())))
def test_auto_resolves_like_jax(i):
    """``"auto"`` picks the JAX package's path, its "jnp" becoming the
    port's "kernel"; every config builds its step warning-free (the shipped
    knobs are the chosen path's own), config 3 through the sector renderer,
    and its simulator too."""
    jcfg = _auto_cases()[i]
    want = jc.choose_fam_impl(jcfg)
    pcfg = config_from(jcfg)
    assert resolve_fam_impl(pcfg, "auto") == {"jnp": "kernel"}.get(want, want)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        make_step_batched(pcfg, "auto", device="cpu")
        if jcfg.sensor.render_mode == "sector":
            sim = nt.NavigationSimulator(pcfg, np.zeros((64, 64)), np.zeros((2, 2)),
                                         device="cpu")
            assert sim.fam_impl == "fft"


@pytest.mark.parametrize("fam_impl", ["fft", "roll"])
@pytest.mark.parametrize("metric", ["ssd", "ncc"])
def test_step_matches_jax(small_cfg, small_world, fam_impl, metric):
    """One batched step on the small world with the JAX library carried
    across: JAX's candidates, and its familiarity over every heading within
    the JAX path tests' tolerances (fft 2e-4, roll 2e-5) of the scale of the
    terms that cancel: near the route the familiarity is ~1e-2, while JAX
    forms SSD as |c|^2 + |l|^2 - 2 c.l (scale: the largest |l|^2, as in the
    JAX low-rank test) and NCC as 1 - z_c.z_l / P (scale 1), in f32."""
    land, route = small_world
    cfg = _wide(small_cfg, metric)
    lib = j_train_library(jnp.asarray(land), route, cfg)
    pts, headings = oracle.resample_route(route, cfg.capture_spacing)
    idx = [0, 2, 3, 5, 7, 11]
    xy = (pts[idx] + np.array([0.3, -0.2])).astype(np.float32)
    th = (headings[idx] + 0.05).astype(np.float32)
    j_step = j_make_step_batched(cfg, fam_impl)
    j_states, j_st = j_init_state(jnp.asarray(xy), jnp.asarray(th)), j_make_statics(land, lib, route)
    out_j, rec_j = j_step(j_states, j_st)
    fam_j = np.asarray(j_step.fam(j_states, j_st, None))  # [B, Nh]
    st = statics_from_numpy(land, lib, route, device="cpu")
    step = make_step_batched(config_from(cfg), fam_impl, device="cpu")
    states, aux = init_state(xy, th, device="cpu"), step.lib_prepare(st)
    out_t, rec_t = step(states, st, aux)
    np.testing.assert_array_equal(rec_t.k.numpy(), np.asarray(rec_j.k))
    scale = max(float(np.abs(fam_j).max()),
                float(np.asarray(lib.sq).max()) if metric == "ssd" else 1.0)
    tol = (2e-4 if fam_impl == "fft" else 2e-5) * scale
    np.testing.assert_allclose(step.fam(states, st, aux).numpy(), fam_j, atol=tol, rtol=tol)
    np.testing.assert_allclose(rec_t.fam.numpy(), np.asarray(rec_j.fam), atol=tol, rtol=tol)
    np.testing.assert_allclose(out_t.xy.numpy(), np.asarray(out_j.xy), atol=1e-5)
    np.testing.assert_array_equal(out_t.status.numpy(), np.asarray(out_j.status))


@pytest.mark.parametrize("fam_impl", ["roll", "fft"])
def test_extraction_free_paths_match_golden(small_cfg, small_world, fam_impl):
    """The whole slice through "roll" (and "fft" at cutoff 0), the port's
    own training included, against the frozen float64 oracle trajectory:
    the first 6 decisions, poses and familiarity at the JAX golden
    tolerances, and the goal within 5 steps."""
    land, route = small_world
    with np.load(GOLDEN) as f:
        golden = {k: f[k] for k in f.files}
    cfg = config_from(small_cfg)
    lib = nt.train_library(land, route, cfg, device="cpu")
    st = make_statics(land, lib, route, device="cpu")
    pts, hd = oracle.resample_route(route, small_cfg.capture_spacing)
    final, rec = nt.make_navigate_batch(cfg, fam_impl, device="cpu")(
        init_state(pts[:1], hd[:1], device="cpu"), st)
    k = 6
    np.testing.assert_array_equal(rec.k[0, :k].numpy(), golden["k"][:k])
    np.testing.assert_allclose(rec.xy[0, :k].numpy(), golden["xy"][:k], atol=1e-4)
    np.testing.assert_allclose(rec.fam[0, :k].numpy(), golden["fam"][:k], atol=5e-4, rtol=1e-3)
    assert int(final.status[0]) == STATUS_REACHED
    assert abs(int((~rec.done[0]).sum()) - len(golden["xy"])) <= 5


@pytest.mark.parametrize("fam_impl,early_exit", [("roll", False), ("fft", True)])
def test_prepared_aux_equals_preparing_per_call(small_cfg, small_world, fam_impl, early_exit):
    land, route = small_world
    cfg = config_from(_wide(small_cfg))
    lib = nt.train_library(land, route, cfg, device="cpu")
    st = make_statics(land, lib, route, device="cpu")
    starts, thetas = nt.make_trials(route, cfg, 4, seed=1, pos_sigma=0.5, heading_sigma=0.05)
    run = nt.make_navigate_batch(cfg, fam_impl, early_exit=early_exit, device="cpu")
    states0 = init_state(starts, thetas, device="cpu")
    f1, r1 = run(states0, st)
    f2, r2 = run(states0, st, aux=run.prepare(st))
    for a, b in zip(f1 + r1, f2 + r2):
        assert torch.equal(a, b)
    assert nt.make_navigate_batch(cfg, "kernel", device="cpu").prepare is None


@pytest.mark.parametrize(
    "fam_impl,knob,value,warns",
    [("kernel", "roll_rank", 8, True), ("kernel", "fixed_point_bits", 8, True),
     ("fft", "roll_rank", 8, True), ("roll", "spectral_cutoff", 10, True),
     ("roll", "roll_rank", 8, False), ("fft", "spectral_cutoff", 10, False),
     ("fft", "matmul_precision", "highest", True),
     ("roll", "fft_product_precision", "default", True)],
)
def test_knob_warnings(small_cfg, fam_impl, knob, value, warns):
    """As the JAX package's step warns (tests/test_roll_fam.py): an
    impl-specific knob set for another path warns naming itself; the
    matmul pass counts warn on every path (the port's distances are fp64)."""
    cfg = config_from(_wide(small_cfg))
    cfg = dataclasses.replace(cfg, scan=dataclasses.replace(cfg.scan, **{knob: value}))
    if warns:
        with pytest.warns(UserWarning, match=knob):
            make_step_batched(cfg, fam_impl, device="cpu")
    else:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            make_step_batched(cfg, fam_impl, device="cpu")


@pytest.mark.parametrize("fam_impl", ["auto", "roll"])
def test_simulator_end_to_end(small_cfg, small_world, tmp_path, fam_impl):
    """tests/test_simulator.py's round trip: train, navigate, save the
    library, load it into a fresh simulator, navigate to the same result."""
    landscape, route = small_world
    cfg = config_from(small_cfg)
    sim = nt.NavigationSimulator.from_config(cfg, landscape, route, fam_impl=fam_impl,
                                             device="cpu").train()
    assert sim.fam_impl == ("kernel" if fam_impl == "auto" else fam_impl)
    res = sim.navigate(n_trials=8, seed=0, pos_sigma=0.5, heading_sigma=0.05)
    assert res.success_rate >= 0.5
    assert res.record.xy.shape[0] == 8
    assert set(res.metrics) >= {"success", "n_steps", "final_fam"}
    with pytest.raises(NotImplementedError, match="A.16"):
        res.plot(landscape, route, str(tmp_path / "sim.png"))

    sim.save_library(str(tmp_path / "lib"))
    sim2 = nt.NavigationSimulator.from_config(cfg, landscape, route, fam_impl=fam_impl,
                                              device="cpu").load_library(str(tmp_path / "lib"))
    res2 = sim2.navigate(n_trials=8, seed=0, pos_sigma=0.5, heading_sigma=0.05)
    assert res2.success_rate == res.success_rate
    for a, b in zip(res.final_state, res2.final_state):
        assert torch.equal(a, b)


def test_simulator_starts_without_headings(small_cfg, small_world):
    """tests/test_simulator.py: headings from the route tangent at the
    nearest captured point; both explicit-start call styles take one pose."""
    landscape, route = small_world
    sim = nt.NavigationSimulator(config_from(small_cfg), landscape, route, device="cpu")
    with pytest.raises(RuntimeError, match="train"):
        sim.navigate()
    sim.train()
    pts, hd = oracle.resample_route(route, small_cfg.capture_spacing)
    res = sim.navigate(starts=pts[:4] + 0.25)
    assert res.record.xy.shape[0] == 4
    assert res.success_rate > 0.0
    with pytest.raises(ValueError, match="headings given without starts"):
        sim.navigate(headings=np.zeros(4))
    assert sim.navigate(starts=pts[0] + 0.25).record.xy.shape[0] == 1
    assert sim.navigate(starts=pts[0] + 0.25, headings=float(hd[0])).record.xy.shape[0] == 1
    with pytest.raises(ValueError, match="headings batch"):
        sim.navigate(starts=pts[:4], headings=np.zeros(3))
    start, heading = sim.start_pose()
    np.testing.assert_array_equal(start, pts[0])
    assert heading == float(hd[0])


def test_simulator_matches_jax_simulator(small_cfg, small_world):
    """The port's facade and the JAX package's, both on "roll" with the
    same trials: the same decisions at every step of every agent."""
    from navdv_tpu.simulator import NavigationSimulator as JSim

    landscape, route = small_world
    kw = dict(n_trials=6, seed=3, pos_sigma=0.5, heading_sigma=0.05)
    want = JSim(small_cfg, landscape, route, fam_impl="roll").train().navigate(**kw)
    got = nt.NavigationSimulator(config_from(small_cfg), landscape, route, fam_impl="roll",
                                 device="cpu").train().navigate(**kw)
    active = ~np.asarray(want.record.done)
    np.testing.assert_array_equal(~got.record.done.numpy(), active)
    np.testing.assert_array_equal(got.record.k.numpy()[active], np.asarray(want.record.k)[active])
    assert got.success_rate == want.success_rate


def test_checkpoint_npz_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    lib = nt.familiarity.pack_library(torch.from_numpy(rng.random((5, 4, 24)).astype(np.float32)))
    path = str(tmp_path / "lib.ckpt")
    checkpoint.save_library(path, lib)
    assert os.listdir(tmp_path) == ["lib.ckpt"]  # written under its name, no temporary left
    got = checkpoint.load_library(path, device="cpu")
    for a, b in zip(lib, got):
        assert b.dtype == a.dtype and torch.equal(a, b)
    checkpoint.save_library(path, lib._replace(valid=torch.zeros(5)))  # overwrite
    assert float(checkpoint.load_library(path, device="cpu").valid.sum()) == 0.0

    results = {"success": np.array([True, False]), "fam": np.arange(3.0)}
    rpath = str(tmp_path / "cell.npz")
    checkpoint.save_results(rpath, results)
    back = checkpoint.load_results(rpath)
    assert set(back) == set(results)
    for k in results:
        np.testing.assert_array_equal(back[k], results[k])
    with pytest.raises(ValueError, match="not a library checkpoint"):
        checkpoint.load_library(rpath, device="cpu")
    with pytest.raises(NotImplementedError, match="A.13"):
        checkpoint.save_infomax(str(tmp_path / "im"), None)
    with pytest.raises(NotImplementedError, match="A.13"):
        checkpoint.load_infomax(str(tmp_path / "im"))


def test_baseline_fam_impls_resolve_in_the_port():
    """The JAX package's shipped paths for configs 1-4 are the port's own
    names, and "auto" resolves to them."""
    for n in (1, 2, 3, 4):
        cfg = tc.baseline_config(n)
        assert resolve_fam_impl(cfg, tc.baseline_fam_impl(n)) == tc.baseline_fam_impl(n)
        assert resolve_fam_impl(cfg, "auto") == tc.baseline_fam_impl(n)
