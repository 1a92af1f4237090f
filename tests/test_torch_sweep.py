"""The port's sweeps (BASELINE config 5) against the JAX package's
``sweep.py`` and its tests (tests/test_sweep.py), on tiny grids on the CPU."""

import dataclasses
import json
import os

import numpy as np
import pytest

import navdv_tpu.sweep as jsweep
from navdv_torch import sweep
from navdv_torch.agent import resolve_fam_impl
from navdv_torch.checkpoint import load_results, save_results
from navdv_torch.config import SensorConfig
from navdv_torch.convert import config_from
from navdv_tpu.config import choose_fam_impl


def _tiny_spec(module=sweep, **kw):
    return module.SweepSpec(
        sensor_px=((24, 4, 3),),
        scan_granularity=((12, 2), (8, 3)),
        capture_spacing=(1.5,),
        n_trials=4,
        max_steps=16,
        **kw,
    )


def test_sweep_runs_and_resumes(small_world, tmp_path):
    """Two cells run, land on disk with summary.json, and a second run
    resumes them from disk (a tampered result file is kept)."""
    landscape, route = small_world
    spec = _tiny_spec()
    out = str(tmp_path / "sweep")
    r1 = sweep.run_sweep(landscape, route, spec, out, verbose=False, tensorboard=False,
                         device="cpu")
    assert len(r1) == 2
    assert os.path.exists(os.path.join(out, "summary.json"))
    key = next(iter(r1))
    path = os.path.join(out, f"cell_{key}.npz")
    tampered = dict(load_results(path))
    tampered["success_rate"] = np.asarray(0.123)
    save_results(path, tampered)
    r2 = sweep.run_sweep(landscape, route, spec, out, verbose=False, tensorboard=False,
                         device="cpu")
    assert float(r2[key]["success_rate"]) == 0.123


def test_sweep_matches_jax_sweep(small_world, tmp_path):
    """The same tiny grid through both packages: the same cells, the same
    result keys (``success_rate_jnp`` included, ROADMAP C.9) and summary
    layout, the path under the port's name, and the same recall per cell
    (both run the exact path at this sensor)."""
    landscape, route = small_world
    want = jsweep.run_sweep(landscape, route, _tiny_spec(jsweep), str(tmp_path / "jax"),
                            verbose=False, tensorboard=False)
    got = sweep.run_sweep(landscape, route, _tiny_spec(), str(tmp_path / "port"),
                          verbose=False, tensorboard=False, device="cpu")
    assert set(got) == set(want)
    for key in want:
        assert set(got[key]) == set(want[key]), key
        assert str(want[key]["fam_impl"]) == "jnp" and str(got[key]["fam_impl"]) == "kernel"
        for name in ("success_rate", "status_counts", "n_library_views", "ax_px", "ax_scan",
                     "ax_spacing"):
            np.testing.assert_array_equal(got[key][name], want[key][name], err_msg=name)
        np.testing.assert_allclose(got[key]["mean_path_error"], want[key]["mean_path_error"],
                                   atol=1e-4)
    with open(tmp_path / "jax" / "summary.json") as f_j, open(
            tmp_path / "port" / "summary.json") as f_t:
        sj, st = json.load(f_j), json.load(f_t)
    assert set(st) == set(sj) and all(set(st[k]) == set(sj[k]) for k in sj)


def test_sweep_sharding_unions_to_full_grid(small_world, tmp_path):
    """Two shards against one directory make the full grid, and summary.json
    is the union of the cells on disk, not the last writer's slice."""
    landscape, route = small_world
    spec = _tiny_spec()
    out = str(tmp_path / "sweep_shard")
    r0 = sweep.run_sweep(landscape, route, spec, out, verbose=False, shard=(0, 2),
                         tensorboard=False, device="cpu")
    r1 = sweep.run_sweep(landscape, route, spec, out, verbose=False, shard=(1, 2),
                         tensorboard=False, device="cpu")
    assert len(r0) == 1 and len(r1) == 1
    assert set(r0) | set(r1) == {k for k, _, _ in spec.cells()}
    with open(os.path.join(out, "summary.json")) as f:
        assert set(json.load(f)) == set(r0) | set(r1)


def test_spec_from_json_rejects_unknown_keys(tmp_path):
    good = {"n_trials": 8, "max_steps": 16, "sensor_px": [[24, 4, 3]]}
    p = tmp_path / "spec.json"
    p.write_text(json.dumps(good))
    spec = sweep.SweepSpec.from_json(str(p))
    assert dataclasses.asdict(spec) == dataclasses.asdict(jsweep.SweepSpec.from_json(str(p)))
    assert spec.n_trials == 8 and spec.sensor_px == ((24, 4, 3),)
    p.write_text(json.dumps({**good, "n_trails": 4096}))
    with pytest.raises(ValueError, match="n_trails"):
        sweep.SweepSpec.from_json(str(p))


def test_tensorboard_logging(small_world, tmp_path):
    """Per-cell scalars land as tensorboard event files."""
    landscape, route = small_world
    out = str(tmp_path / "tbsweep")
    res = sweep.run_sweep(landscape, route, _tiny_spec(), out, verbose=False, device="cpu")
    for key in res:
        cell_dir = os.path.join(out, "tb", key)
        events = [f for f in os.listdir(cell_dir) if "tfevents" in f]
        assert events, f"no event file in {cell_dir}"
        assert os.path.getsize(os.path.join(cell_dir, events[0])) > 0


def test_lib_bucket_equivalence(small_cfg, small_world):
    """A library padded to a bucketed shape changes no cell result."""
    landscape, route = small_world
    cfg = config_from(small_cfg)
    base = sweep.run_cell(landscape, route, cfg, n_trials=8, seed=0, device="cpu")
    bucketed = sweep.run_cell(landscape, route, cfg, n_trials=8, seed=0, lib_bucket=64,
                              device="cpu")
    assert int(bucketed["n_library_padded"]) % 64 == 0
    assert int(bucketed["n_library_views"]) == int(base["n_library_views"])
    assert int(bucketed["n_library_padded"]) > int(bucketed["n_library_views"])
    for k in ("success_rate", "mean_steps", "mean_path_error", "max_path_error",
              "status_counts"):
        np.testing.assert_array_equal(base[k], bucketed[k], err_msg=k)
    assert float(base["executed_steps"]) <= 8 * cfg.agent.max_steps
    assert float(base["agent_steps_per_s"]) > 0


def test_lib_bucket_shares_one_navigate_fn(small_cfg, small_world):
    """Cells differing only in capture_spacing share one navigate function."""
    landscape, route = small_world
    cache: dict = {}
    nl_seen = set()
    spacings = (1.0, 1.5, 2.0)
    for sp in spacings:
        cfg = config_from(dataclasses.replace(small_cfg, capture_spacing=sp))
        res = sweep.run_cell(landscape, route, cfg, n_trials=4, seed=0, lib_bucket=64,
                             nav_cache=cache, device="cpu")
        nl_seen.add(int(res["n_library_views"]))
        assert int(res["n_library_padded"]) == 64
    assert len(nl_seen) == len(spacings)
    assert len(cache) == 1, list(cache)


def test_run_cell_auto_with_recall_check(small_cfg, small_world):
    """A >= 512-px NCC cell resolves "auto" to "fft" and, with
    recall_check_trials, records the exact path's recall on the subset under
    the JAX package's key names."""
    landscape, route = small_world
    cfg = config_from(dataclasses.replace(
        small_cfg,
        sensor=dataclasses.replace(small_cfg.sensor, n_radial=8, n_azimuth=64, az_upsample=2),
        scan=dataclasses.replace(small_cfg.scan, metric="ncc"),
    ))
    cache: dict = {}
    res = sweep.run_cell(landscape, route, cfg, n_trials=8, seed=0, fam_impl="auto",
                         recall_check_trials=4, nav_cache=cache, device="cpu")
    assert str(res["fam_impl"]) == "fft"
    assert int(res["recall_check_trials"]) == 4
    assert abs(float(res["success_rate_jnp"]) - float(res["success_rate_subset"])) <= 0.5
    assert {key[2] for key in cache} == {"fft", "kernel"}


def test_auto_impl_resolution():
    """Every cell of the default grid, and of a small-sensor and an NCC
    grid, resolves "auto" as the JAX package's rule does (its "jnp" being
    the port's "kernel")."""
    specs = [sweep.SweepSpec(), sweep.SweepSpec(metric="ncc"),
             sweep.SweepSpec(sensor_px=((18, 4, 20),), capture_spacing=(0.2, 2.0))]
    seen = set()
    for spec in specs:
        jspec = jsweep.SweepSpec(**dataclasses.asdict(spec))
        for (key, cfg, params), (jkey, jcfg, jparams) in zip(spec.cells(), jspec.cells()):
            assert key == jkey and params == jparams
            assert config_from(jcfg) == cfg
            want = choose_fam_impl(jcfg)
            got = resolve_fam_impl(cfg, "auto")
            assert got == {"jnp": "kernel"}.get(want, want), key
            seen.add(got)
    assert seen == {"kernel", "fft"}
    px = {k: resolve_fam_impl(c, "auto") for k, c, _ in sweep.SweepSpec().cells()}
    assert all(v == ("kernel" if "36x8" in k else "fft") for k, v in px.items())
    assert isinstance(next(sweep.SweepSpec().cells())[1].sensor, SensorConfig)


@pytest.mark.parametrize("kw", ["mesh", "cells_mesh"])
def test_mesh_sweeps_raise_naming_a17(small_world, small_cfg, tmp_path, kw):
    landscape, route = small_world
    with pytest.raises(NotImplementedError, match="A.17"):
        sweep.run_sweep(landscape, route, _tiny_spec(), str(tmp_path), device="cpu",
                        **{kw: object()})
    if kw == "mesh":
        with pytest.raises(NotImplementedError, match="A.17"):
            sweep.run_cell(landscape, route, config_from(small_cfg), 4, 0, mesh=object(),
                           device="cpu")


def test_infomax_cells_raise_naming_a13(small_cfg, small_world):
    landscape, route = small_world
    cfg = config_from(small_cfg)
    with pytest.raises(NotImplementedError, match="A.13"):
        sweep.run_cell(landscape, route, cfg, 4, 0, fam_impl="infomax", device="cpu")
    with pytest.raises(NotImplementedError, match="A.13"):
        sweep.resolve_infomax_epochs(cfg, 40)
