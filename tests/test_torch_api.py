"""The port's one-agent API (``make_step``, ``make_navigate``, ``navigate``,
``step``) and ``load_landscape`` against the JAX package's, on the CPU, on
the golden world with the JAX library carried across."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import navdv_torch as nt
import navdv_tpu as nj
from navdv_torch.agent import AgentState, StepRecord, init_state, make_navigate, make_step
from navdv_torch.convert import config_from, library_from_numpy, statics_from_numpy
from navdv_tpu import oracle
from navdv_tpu.agent import init_state as j_init_state
from navdv_tpu.agent import make_navigate as j_make_navigate
from navdv_tpu.agent import make_statics as j_make_statics
from navdv_tpu.landscape import load_landscape as j_load_landscape
from navdv_tpu.training import train_library as j_train_library

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden_oracle_small.npz")
K = 6  # the golden tests' early steps, before fp32-vs-fp64 argmin flips compound


@pytest.fixture(scope="module")
def golden_run(small_cfg, small_world):
    """JAX's one-agent episode from the golden start, its library, and the
    golden fixture."""
    landscape, route = small_world
    lib = j_train_library(jnp.asarray(landscape), route, small_cfg)
    pts, hd = oracle.resample_route(route, small_cfg.capture_spacing)
    want = nj.navigate(jnp.asarray(landscape), lib, route, pts[0], hd[0], small_cfg)
    with np.load(GOLDEN) as f:
        golden = {k: f[k] for k in f.files}
    return lib, pts[0], hd[0], want, golden


def _check_early_steps(rec_k, rec_xy, want, golden):
    _, rec_j = want
    np.testing.assert_array_equal(rec_k[:K], np.asarray(rec_j.k)[:K])
    np.testing.assert_array_equal(rec_k[:K], golden["k"][:K])
    np.testing.assert_allclose(rec_xy[:K], np.asarray(rec_j.xy)[:K], atol=1e-4)
    np.testing.assert_allclose(rec_xy[:K], golden["xy"][:K], atol=1e-4)


@pytest.mark.parametrize("entry", ["navigate", "make_navigate"])
def test_one_agent_episode_matches_jax(small_cfg, small_world, golden_run, entry):
    """``navigate`` and ``make_navigate`` on the default ("kernel") path:
    JAX's time-major record, its first 6 candidates and poses within 1e-4,
    and the same final status."""
    landscape, route = small_world
    lib, xy0, th0, want, golden = golden_run
    cfg = config_from(small_cfg)
    if entry == "navigate":
        final, rec = nt.navigate(landscape, library_from_numpy(lib, device="cpu"), route, xy0,
                                 th0, cfg, device="cpu")
    else:
        st = statics_from_numpy(landscape, lib, route, device="cpu")
        final, rec = make_navigate(cfg, device="cpu")(init_state(xy0, th0, device="cpu"), st)
    t = small_cfg.agent.max_steps
    assert isinstance(rec, StepRecord) and isinstance(final, AgentState)
    assert rec.xy.shape == (t, 2) and rec.k.shape == (t,) and final.xy.shape == (2,)
    _check_early_steps(rec.k.numpy(), rec.xy.numpy(), want, golden)
    assert int(final.status) == int(want[0].status) == nt.agent.STATUS_REACHED


def test_one_agent_step_matches_jax(small_cfg, small_world, golden_run):
    """``step`` (and ``make_step``) advance one agent: the first 6 steps
    taken one by one give JAX's episode's candidates and poses."""
    landscape, route = small_world
    lib, xy0, th0, want, golden = golden_run
    cfg = config_from(small_cfg)
    st = statics_from_numpy(landscape, lib, route, device="cpu")
    state = init_state(xy0, th0, device="cpu")
    step1 = make_step(cfg, device="cpu")
    assert step1.lib_prepare is None
    ks, xys = [], []
    for _ in range(K):
        state2, rec = nt.step(state, st, cfg, device="cpu")
        state_m, rec_m = step1(state, st)
        for a, b in zip(rec + state2, rec_m + state_m):
            assert torch.equal(a, b)
        assert rec.k.shape == () and state2.xy.shape == (2,)
        ks.append(int(rec.k))
        xys.append(rec.xy.numpy())
        state = state2
    _check_early_steps(np.array(ks), np.stack(xys), want, golden)


@pytest.mark.parametrize("fam_impl", ["fft", "roll"])
def test_one_agent_wrappers_take_prepared_paths(small_cfg, small_world, golden_run, fam_impl):
    """On the paths with a prepare stage, ``make_step`` exposes it and
    ``make_navigate`` prepares once per episode: its record equals the
    batched one-agent episode's, and JAX's on the same path in k."""
    landscape, route = small_world
    lib, xy0, th0, _, _ = golden_run
    cfg = dataclasses.replace(small_cfg, sensor=dataclasses.replace(
        small_cfg.sensor, n_radial=8, n_azimuth=72))
    jlib = j_train_library(jnp.asarray(landscape), route, cfg)
    pcfg = config_from(cfg)
    st = statics_from_numpy(landscape, jlib, route, device="cpu")
    assert make_step(pcfg, fam_impl, device="cpu").lib_prepare is not None
    final, rec = make_navigate(pcfg, fam_impl, device="cpu")(init_state(xy0, th0, device="cpu"),
                                                             st)
    fb, rb = nt.make_navigate_batch(pcfg, fam_impl, device="cpu")(
        init_state(xy0[None], np.array([th0]), device="cpu"), st)
    for a, b in zip(rec + final, rb + fb):
        assert torch.equal(a, b[0])
    _, rec_j = j_make_navigate(cfg, fam_impl)(j_init_state(xy0, th0),
                                              j_make_statics(landscape, jlib, route))
    np.testing.assert_array_equal(rec.k.numpy()[:K], np.asarray(rec_j.k)[:K])


def test_public_api_matches_jax_exports():
    """The port exports every top-level entry point of the JAX package under
    the same name, the analysis module's aside (ROADMAP A.15), and
    ``load_landscape`` beside them."""
    analysis = {n for n in nj.__all__ if nj._EXPORTS[n] == "navdv_tpu.analysis"}
    assert set(nj.__all__) - analysis <= set(nt.__all__)
    for name in ("make_navigate", "navigate", "step", "load_landscape"):
        assert name in nt.__all__ and callable(getattr(nt, name)), name


def test_load_landscape_matches_jax(tmp_path):
    """tests/test_sweep.py's ``.npy``/``.png`` round trip, against the JAX
    package's loader on the same files: equal arrays."""
    from PIL import Image

    land = nt.make_landscape("blobs", size=(64, 64), seed=1)
    np.save(tmp_path / "l.npy", land)
    got = nt.load_landscape(str(tmp_path / "l.npy"))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, land, atol=1e-6)
    np.testing.assert_array_equal(got, j_load_landscape(str(tmp_path / "l.npy")))

    Image.fromarray((land * 255).astype(np.uint8)).save(tmp_path / "l.png")
    got_png = nt.load_landscape(str(tmp_path / "l.png"))
    assert got_png.shape == (64, 64)
    np.testing.assert_allclose(got_png, land, atol=0.01)  # 8-bit quantization
    np.testing.assert_array_equal(got_png, j_load_landscape(str(tmp_path / "l.png")))
