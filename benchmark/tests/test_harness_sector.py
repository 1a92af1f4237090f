"""The plain reference of config 3 (``reference/sector_ncc.py``) against the
port's sector step on the CPU, a run of config 3's shape judged by it, and
a configuration that names its reference module or the path it asks for."""

from __future__ import annotations

import dataclasses
import sys
import types

import numpy as np
import pytest
import torch

from fixture import SECTOR_TINY, TINY, make_checkout
from harness import check, drive, world
from harness.cells import find_cell
from navdv_torch.agent import AgentState, make_statics, make_step_batched
from navdv_torch.sensor import make_render_batch_rolled, unroll_panorama
from navdv_torch.training import train_library
from reference import navref, sector_ncc

CONFIGS = {"tiny": SECTOR_TINY, "config3": find_cell("sector_lib50_b256").config}
# one ulp of a float32 in [1, 2): NCC distances lie in [0, 2], and the port
# reports the float32 of its float64 sum
F32_ULP_AT_2 = 2.0 ** -23


def _setup(config, seed):
    land = world.make_landscape(seed, config["world"], "cpu")
    route = world.make_route(config["world"])
    spacing, pts, headings = world.route_geometry(config, route)
    return land, route, spacing, pts, headings


def _poses(pts, headings, n, seed):
    rng = np.random.default_rng(seed)
    xy = pts[rng.integers(0, len(pts), n)] + rng.normal(0, 2.0, (n, 2))
    th = headings[0] + rng.normal(0, 0.5, n)
    return torch.from_numpy(xy.astype(np.float32)), torch.from_numpy(th.astype(np.float32))


@pytest.mark.parametrize("size", sorted(CONFIGS))
def test_panorama_and_library_equal_the_port(size):
    config = CONFIGS[size]
    land, route, spacing, pts, headings = _setup(config, seed=5)
    cfg = drive.sim_config(config, spacing)
    spec = sector_ncc.spec_from_config(config)
    xy, th = _poses(pts, headings, 24, seed=2)
    pano_phi, k = make_render_batch_rolled(cfg.sensor, max(2.0, cfg.agent.step_size),
                                           device="cpu")(land, xy, th)
    # the same sample points and the same bf16-class arithmetic: bit for bit
    assert torch.equal(sector_ncc.render_sensor(land, xy, th, spec),
                       torch.from_numpy(unroll_panorama(pano_phi, k)))
    lib = train_library(land, route, cfg, device="cpu")
    lib_ref = sector_ncc.train_library(land, route, spacing, spec)
    assert torch.equal(lib.views.double(), lib_ref)
    assert torch.equal(lib.z, sector_ncc.zscored(lib_ref))


@pytest.mark.parametrize("fused", ["default", "off"])
@pytest.mark.parametrize("size", sorted(CONFIGS))
def test_familiarity_and_decision_equal_the_sector_step(size, fused):
    config = CONFIGS[size]
    land, route, spacing, pts, headings = _setup(config, seed=11)
    cfg = drive.sim_config(config, spacing)
    cfg = dataclasses.replace(cfg, scan=dataclasses.replace(cfg.scan, fused_dft_precision=fused))
    spec = sector_ncc.spec_from_config(config)
    xy, th = _poses(pts, headings, 24, seed=1)
    lib = train_library(land, route, cfg, device="cpu")
    st = make_statics(land, lib, route, "cpu")
    step = make_step_batched(cfg, "fft", "cpu")
    assert step.fam.fused is (fused != "off")
    aux = step.lib_prepare(st)
    n = xy.shape[0]
    state = AgentState(xy, th, torch.zeros(n, dtype=torch.bool), torch.zeros(n, dtype=torch.int32))
    fam_port = step.fam(state, st, aux).double()
    s = sector_ncc.candidate_panorama(land, xy, th, spec)
    fam_ref = sector_ncc.familiarity(s, sector_ncc.train_library(land, route, spacing, spec),
                                     spec)
    # the port's float32 output of a float64 sum, against float64: rounding only
    assert float((fam_port - fam_ref).abs().max()) <= F32_ULP_AT_2
    new, rec = step(state, st, aux)
    k = sector_ncc.choose(fam_ref, spec)
    assert torch.equal(rec.k.long(), k)
    xy_new, th_new = sector_ncc.advance(xy, th, k, spec)
    assert torch.allclose(new.xy.double(), xy_new, atol=1e-4)
    assert torch.allclose(new.theta.double(), th_new, atol=1e-6)


def test_the_control_reads_above_the_program_at_config3():
    config = CONFIGS["config3"]
    land, route, spacing, pts, headings = _setup(config, seed=7)
    spec = sector_ncc.spec_from_config(config)
    xy, th = _poses(pts, headings, 32, seed=3)
    s = sector_ncc.candidate_panorama(land, xy, th, spec)
    lib = sector_ncc.train_library(land, route, spacing, spec)
    f64 = sector_ncc.familiarity(s, lib, spec)
    f32 = sector_ncc.familiarity(s, lib, spec, torch.float32).double()
    # float32 familiarity errs by several ulps of a distance; the port's
    # float64 sum rounded once to float32 by half of one at most
    assert float((f32 - f64).abs().max()) > 2 * F32_ULP_AT_2
    lib8 = sector_ncc.train_library(land, route, spacing, spec, torch.float8_e4m3fn)
    assert float((lib8 - lib).abs().max()) / float(lib.abs().max()) > config["limits"]["lib_err"]


def test_a_run_of_config3s_shape_is_correct(tmp_path):
    cell = find_cell("fixture_cell", make_checkout(tmp_path, config=SECTOR_TINY))
    result = drive.run_single(cell, 2**31 + 41, 0.3, False, "cpu", 0.0, lambda: None,
                              control=True)
    assert result["correct"], result["checks"]
    n = result["numbers"]
    assert n["poses_compared"] > 0 and n["pose_mismatch"] == 0 and n["status_mismatch"] == 0
    assert n["lib_err_control"] > cell.config["limits"]["lib_err"]


def _counting(module, name):
    """A reference module ``reference.<name>``: ``module`` with each call of
    its ``familiarity_blocked`` counted."""
    fake = types.ModuleType(f"reference.{name}")
    fake.__dict__.update({k: v for k, v in vars(module).items() if not k.startswith("__")})
    fake.calls = 0

    def familiarity_blocked(*args, **kw):
        fake.calls += 1
        return module.familiarity_blocked(*args, **kw)

    fake.familiarity_blocked = familiarity_blocked
    return fake


def test_a_configuration_is_judged_by_the_reference_it_names(tmp_path, monkeypatch):
    fake = _counting(navref, "fixture_ref")
    monkeypatch.setitem(sys.modules, "reference.fixture_ref", fake)
    assert check.reference_of(TINY) is navref
    assert check.reference_of(dict(TINY, reference="fixture_ref")) is fake
    cell = find_cell("fixture_cell", make_checkout(tmp_path, config=dict(
        TINY, reference="fixture_ref")))
    result = drive.run_single(cell, 23, 0.3, False, "cpu", 0.0, lambda: None)
    assert result["correct"], result["checks"]
    assert fake.calls == 1
    # a reference whose familiarity is negated reads every choice as the worst
    fake.familiarity_blocked = lambda *args, **kw: -navref.familiarity_blocked(*args, **kw)
    result = drive.run_single(cell, 23, 0.3, False, "cpu", 0.0, lambda: None)
    assert not result["correct"]
    assert result["checks"]["decision_gap"]["value"] > result["checks"]["decision_gap"]["limit"]
    with pytest.raises(ValueError):
        check.reference_of(dict(TINY, reference="../navref"))
