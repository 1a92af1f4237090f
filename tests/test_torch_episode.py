"""The port's training, batched step and episode loop against the JAX
package and the frozen float64 golden fixture, on the CPU."""

import dataclasses
import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import navdv_torch as nt
from navdv_torch.agent import STATUS_REACHED, init_state, make_statics, make_step_batched
from navdv_torch.convert import config_from, statics_from_numpy
from navdv_torch.metrics import episode_metrics
from navdv_tpu import oracle
from navdv_tpu.agent import init_state as j_init_state
from navdv_tpu.agent import make_statics as j_make_statics
from navdv_tpu.agent import make_step_batched as j_make_step_batched
from navdv_tpu.training import train_library as j_train_library

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden_oracle_small.npz")


@pytest.mark.parametrize(
    "variant,kw",
    [("f32", {}), ("bf16", {}), ("pad8", dict(pad_views_to=8)),
     ("jitter", dict(heading_jitter=0.3, jitter_seed=2))],
)
def test_train_library_matches_jax(small_cfg, small_world, variant, kw):
    """The f32 capture render (and, for a bf16 sensor, the bf16 box-filter
    pooling) give the JAX package's library to 1e-5."""
    land, route = small_world
    cfg = small_cfg
    if variant == "bf16":
        cfg = dataclasses.replace(cfg, sensor=dataclasses.replace(cfg.sensor, hat_dtype="bfloat16"))
    want = j_train_library(jnp.asarray(land), route, cfg, **kw)
    got = nt.train_library(land, route, config_from(cfg), device="cpu", **kw)
    for name in ("views", "flat", "valid"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   atol=1e-5, err_msg=name)
    np.testing.assert_allclose(got.sq.numpy(), np.asarray(want.sq), rtol=1e-5)
    # z = (v - mean) / std magnifies view differences by 1/std: compare it
    # scaled back by each view's std, i.e. as v - mean
    std = np.asarray(want.flat).std(axis=1, keepdims=True)
    np.testing.assert_allclose(got.z.numpy() * std, np.asarray(want.z) * std, atol=1e-5)


@pytest.mark.parametrize("fam_impl", ["kernel", "plain"])
@pytest.mark.parametrize("metric", ["ssd", "ncc"])
def test_step_matches_jax(small_cfg, small_world, fam_impl, metric):
    """One batched step on the three states of the JAX Pallas-vs-jnp step
    test, with the JAX library carried across: the same candidate, the same
    familiarity and pose."""
    land, route = small_world
    cfg = dataclasses.replace(small_cfg, scan=dataclasses.replace(small_cfg.scan, metric=metric))
    lib = j_train_library(jnp.asarray(land), route, cfg)
    pts, headings = oracle.resample_route(route, cfg.capture_spacing)
    xy = np.stack([pts[0], pts[3], pts[5]]).astype(np.float32)
    th = np.asarray([headings[0], headings[3], headings[5]], np.float32)
    out_j, rec_j = j_make_step_batched(cfg, "jnp")(
        j_init_state(jnp.asarray(xy), jnp.asarray(th)), j_make_statics(land, lib, route))
    st = statics_from_numpy(land, lib, route, device="cpu")
    out_t, rec_t = make_step_batched(config_from(cfg), fam_impl, device="cpu")(
        init_state(xy, th, device="cpu"), st)
    np.testing.assert_array_equal(rec_t.k.numpy(), np.asarray(rec_j.k))
    np.testing.assert_allclose(rec_t.fam.numpy(), np.asarray(rec_j.fam), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out_t.xy.numpy(), np.asarray(out_j.xy), atol=1e-5)
    np.testing.assert_array_equal(out_t.status.numpy(), np.asarray(out_j.status))


@pytest.mark.parametrize("fam_impl", ["kernel", "plain"])
def test_slice_matches_golden(small_cfg, small_world, fam_impl):
    """The whole slice, the port's own training included, against the frozen
    float64 oracle trajectory: the same first 6 decisions, poses and
    familiarity at the JAX golden tolerances, and the goal within 5 steps."""
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


def test_early_exit_matches_full_loop(small_cfg, small_world):
    land, route = small_world
    cfg = config_from(small_cfg)
    lib = nt.train_library(land, route, cfg, device="cpu")
    st = make_statics(land, lib, route, device="cpu")
    pts, hd = oracle.resample_route(route, small_cfg.capture_spacing)
    states0 = init_state(pts[:4], hd[:4], device="cpu")
    f1, r1 = nt.make_navigate_batch(cfg, device="cpu")(states0, st)
    f2, r2 = nt.make_navigate_batch(cfg, early_exit=True, device="cpu")(states0, st)
    assert r2.k.shape == r1.k.shape == (4, cfg.agent.max_steps)
    assert bool(r2.done[:, -1].all())  # the loop stopped early: an untouched tail
    np.testing.assert_array_equal(f1.status.numpy(), f2.status.numpy())
    np.testing.assert_allclose(f1.xy.numpy(), f2.xy.numpy(), atol=1e-6)
    act1, act2 = ~r1.done, ~r2.done
    assert torch.equal(act1, act2)
    np.testing.assert_allclose(r1.xy[act1].numpy(), r2.xy[act2].numpy(), atol=1e-6)
    assert torch.equal(r1.k[act1], r2.k[act2])
    m1, m2 = episode_metrics(f1, r1), episode_metrics(f2, r2)
    np.testing.assert_allclose(m1["final_fam"].numpy(), m2["final_fam"].numpy(), atol=1e-6)
    assert torch.equal(m1["n_steps"], m2["n_steps"])
    assert float(nt.success_rate(f1)) == float(nt.success_rate(f2)) == 1.0


@pytest.mark.parametrize(
    "fam_impl,error,match",
    [("fft-sector", None, None), ("auto-sector", None, None),
     ("conv", NotImplementedError, "A.12"), ("infomax", NotImplementedError, "A.13"),
     ("roll-l1", ValueError, "unknown familiarity metric"), ("jnp", ValueError, "'plain'"),
     ("pallas", ValueError, "'kernel'"), ("bogus", ValueError, "unknown fam_impl")],
)
def test_unported_fam_impls_raise(small_cfg, small_world, fam_impl, error, match):
    """Paths not ported raise naming their ROADMAP item, JAX names raise
    naming the port's. The spectral path through the sector renderer is
    ported: "fft" and "auto" build it and run one step."""
    cfg = config_from(small_cfg)
    fam_impl, _, variant = fam_impl.partition("-")
    if variant == "sector":  # with a 576-px sensor, "auto" resolves to "fft" too
        cfg = dataclasses.replace(cfg, sensor=dataclasses.replace(
            cfg.sensor, n_radial=8, n_azimuth=72, render_mode="sector"))
        land, route = small_world
        st = make_statics(land, nt.train_library(land, route, cfg, device="cpu"), route,
                          device="cpu")
        pts, hd = oracle.resample_route(route, cfg.capture_spacing)
        step = make_step_batched(cfg, fam_impl, device="cpu")
        out, rec = step(init_state(pts[:2], hd[:2], device="cpu"), st, step.lib_prepare(st))
        assert rec.k.shape == (2,) and bool(torch.isfinite(rec.fam).all())
        assert not bool(out.done.any())
        return
    if variant:
        cfg = dataclasses.replace(cfg, scan=dataclasses.replace(cfg.scan, metric=variant))
    with pytest.raises(error, match=match):
        make_step_batched(cfg, fam_impl, device="cpu")


def test_knobs_of_unported_paths_warn(small_cfg):
    """A set knob that the chosen path does not read warns; the slice's own
    settings do not."""
    cfg = config_from(small_cfg)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        make_step_batched(cfg, "kernel", device="cpu")
    knobbed = dataclasses.replace(
        cfg, scan=dataclasses.replace(cfg.scan, spectral_cutoff=72, matmul_precision="highest"))
    with pytest.warns(UserWarning, match="ScanConfig.matmul_precision, ScanConfig.spectral_cutoff"):
        make_step_batched(knobbed, "plain", device="cpu")
