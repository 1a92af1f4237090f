"""The plain reference against the port's plain versions on the CPU, on a
small world, and against the port's float64 oracle."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from fixture import TINY
from harness import drive, world
from harness.cells import find_cell
from navdv_torch import oracle
from navdv_torch.agent import AgentState, make_statics, make_step_batched
from navdv_torch.sensor import make_pooled_panorama, make_render_batch
from navdv_torch.training import train_library
from reference import navref

CONFIGS = {
    "fft": find_cell("fft_lib50_b1024").config,
    "exact": find_cell("roll_lib500_b512").config,
}
# the sweep's float32 hat on each of its paths: the 72x16 sensor at u = 5 on
# "fft", the 36x8 one at u = 10 on "kernel"
_SWEEP = find_cell("sweep_default").config
F32 = {f"{p['fam_impl']}_f32": dict(p, world=_SWEEP["world"], step_budget=_SWEEP["step_budget"])
       for p in (_SWEEP["points"][0], _SWEEP["points"][4])}
CONFIGS.update(F32)


def _setup(config, seed=3):
    land = world.make_landscape(seed, config["world"], "cpu")
    route = world.make_route(config["world"])
    spacing, pts, headings = world.route_geometry(config, route)
    return land, route, spacing, pts, headings


def _poses(pts, headings, n=24, seed=0):
    rng = np.random.default_rng(seed)
    xy = pts[rng.integers(0, len(pts), n)] + rng.normal(0, 2.0, (n, 2))
    th = headings[0] + rng.normal(0, 0.5, n)
    return torch.from_numpy(xy.astype(np.float32)), torch.from_numpy(th.astype(np.float32))


def test_world_is_made_from_the_seed():
    w = CONFIGS["fft"]["world"]
    a, b, c = (world.make_landscape(s, w, "cpu") for s in (5, 5, 6))
    assert a.shape == (512, 512) and a.dtype == torch.float32
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert float(a.min()) == 0.0 and float(a.max()) == 1.0
    big = world.make_landscape(2**31 + 7, w, "cpu")
    assert torch.isfinite(big).all()
    t1 = world.Trials(2**32 + 1, 0, np.zeros((2, 2)), np.zeros(2), {"batch": 3, "pos_sigma": 1.5,
                                                                     "heading_sigma": 0.15})
    t2 = world.Trials(2**32 + 1, 0, np.zeros((2, 2)), np.zeros(2), {"batch": 3, "pos_sigma": 1.5,
                                                                     "heading_sigma": 0.15})
    first = t1.draw()
    assert np.array_equal(first[0], t2.draw()[0]) and not np.array_equal(first[0], t1.draw()[0])


@pytest.mark.parametrize("kind", ["fft", "exact", *F32])
def test_sensor_pooling_and_library_equal_the_port(kind):
    config = CONFIGS[kind]
    land, route, spacing, pts, headings = _setup(config)
    cfg = drive.sim_config(config, spacing)
    spec = navref.spec_from_config(config)
    xy, th = _poses(pts, headings)
    pano_port = make_render_batch(cfg.sensor, "cpu")(land, xy, th)
    pano_ref = navref.render_sensor(land, xy, th, spec)
    assert torch.equal(pano_port, pano_ref)
    s_port = make_pooled_panorama(cfg.sensor, "cpu")(pano_port)
    assert torch.equal(s_port.double(), navref.pooled(pano_ref, spec))
    lib_port = train_library(land, route, cfg, device="cpu")
    lib_ref = navref.train_library(land, route, spacing, spec)
    assert torch.equal(lib_port.views.double(), lib_ref)


@pytest.mark.parametrize("kind", ["fft", "exact", *F32])
def test_familiarity_and_decision_equal_the_port(kind):
    config = CONFIGS[kind]
    land, route, spacing, pts, headings = _setup(config, seed=11)
    cfg = drive.sim_config(config, spacing)
    spec = navref.spec_from_config(config)
    xy, th = _poses(pts, headings, n=6 if kind == "exact" else 24, seed=1)
    lib = train_library(land, route, cfg, device="cpu")
    st = make_statics(land, lib, route, "cpu")
    step = make_step_batched(cfg, config["fam_impl"], "cpu")
    aux = None if step.lib_prepare is None else step.lib_prepare(st)
    n = xy.shape[0]
    state = AgentState(xy, th, torch.zeros(n, dtype=torch.bool),
                       torch.zeros(n, dtype=torch.int32))
    fam_port = step.fam(state, st, aux).double()
    s = navref.pooled(navref.render_sensor(land, xy, th, spec), spec)
    fam_ref = navref.familiarity(s, navref.train_library(land, route, spacing, spec), spec)
    e = ((s.float() / spec.az_upsample).double() ** 2).sum(dim=(1, 2)) / spec.az_upsample
    # the port's f32 output of an fp64 sum, against fp64: rounding only
    assert float(((fam_port - fam_ref).abs() / e[:, None]).max()) < 1e-9
    new, rec = step(state, st, aux)
    k = navref.choose(fam_ref, spec)
    assert torch.equal(rec.k.long(), k)
    xy_new, th_new = navref.advance(xy, th, k, spec)
    assert torch.allclose(new.xy.double(), xy_new, atol=1e-4)
    assert torch.allclose(new.theta.double(), th_new, atol=1e-6)


@pytest.mark.parametrize("kind", ["fft", "exact"])
def test_the_scale_bounds_the_rounding_of_a_familiarity(kind):
    """The scale of ``fam_err`` is the magnitude of an SSD's terms: a
    familiarity rounded once to float32 reads about 2^-24 of it at most,
    also for a dark candidate against the bright stored views, where the
    candidate's own norm is a small part of the SSD."""
    config = CONFIGS[kind]
    land, route, spacing, pts, headings = _setup(config)
    spec = navref.spec_from_config(config)
    lib = navref.train_library(land, route, spacing, spec)
    xy, th = _poses(pts, headings)
    s = navref.candidate_panorama(land, xy, th, spec)
    for dim in (1.0, 0.05):
        sd = s * dim
        fam = navref.familiarity(sd, lib, spec)
        e = navref.scale(sd, lib, spec)[:, None]
        assert (fam >= 0).all() and (fam <= 1.01 * e).all()
        assert float(((fam.float().double() - fam).abs() / e).max()) <= 1.01 * 2.0 ** -24
    x = (sd.float() * (1.0 / spec.az_upsample)).double()
    own = (x * x).sum(dim=(1, 2)) / spec.az_upsample
    assert float((fam.min(dim=1).values / own).min()) > 2.0


def test_exact_familiarity_equals_the_float64_oracle():
    # the oracle's own semantics: f32 hat, no bf16 rounding, exact SSD in fp64
    config = dict(TINY, sim={**TINY["sim"], "sensor": {**TINY["sim"]["sensor"],
                                                       "hat_dtype": "float32"}})
    land, route, spacing, pts, headings = _setup(config, seed=4)
    spec = navref.spec_from_config(config)
    cfg = drive.sim_config(config, spacing)
    lib = navref.train_library(land, route, spacing, spec)
    lib_oracle = oracle.train_library(land.numpy(), route, cfg)
    assert np.abs(lib.numpy() - lib_oracle).max() < 1e-6
    xy, th = _poses(pts, headings, n=3, seed=2)
    s = navref.pooled(navref.render_sensor(land, xy, th, spec), spec)
    fam = navref.familiarity(s, lib, spec)
    e = ((s / spec.az_upsample) ** 2).sum(dim=(1, 2)) / spec.az_upsample
    for i in range(3):
        pano = oracle.render_panorama(land.numpy(), float(xy[i, 0]), float(xy[i, 1]),
                                      float(th[i]), cfg)
        want = oracle.scan_familiarity(pano, lib_oracle, cfg)
        # float32 pixels and library norms against float64 throughout: within
        # float32 rounding of a view's squared norm
        assert np.abs(fam[i].numpy() - want).max() < 1e-6 * float(e[i])


def test_stop_rules_and_priority():
    spec = navref.spec_from_config(CONFIGS["fft"])
    route = torch.from_numpy(world.make_route(CONFIGS["fft"]["world"]))
    goal = route[-1]
    pts = torch.stack([goal + torch.tensor([1.0, 0.0], dtype=torch.float64),  # reached
                       route[0] + torch.tensor([0.0, 30.0], dtype=torch.float64),  # diverged
                       torch.tensor([5.0, 256.0], dtype=torch.float64),  # off and diverged
                       route[10]])  # running
    status, amb = navref.stop_status(pts, route, (512, 512), spec, 1e-3)
    assert status.tolist() == [1, 2, 2, 0] and not amb.any()
