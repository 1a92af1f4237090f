"""Port (navdv_torch) host-side base against the JAX package: configs field
by field, bitwise-equal landscapes, routes and trials, import isolation, and
entry points that refuse to fall back to the CPU."""

import ast
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import navdv_torch.config as tc
import navdv_tpu.config as jc
from navdv_torch import landscape as tland
from navdv_torch import oracle as toracle
from navdv_torch import routes as troutes
from navdv_torch import trials as ttrials
from navdv_torch.convert import config_from
from navdv_tpu import landscape as jland
from navdv_tpu import oracle as joracle
from navdv_tpu import routes as jroutes
from navdv_tpu import trials as jtrials

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_cfgs():
    cfgs = [jc.baseline_config(n) for n in range(1, 6)]
    base = jc.baseline_config(1)
    cfgs.append(dataclasses.replace(base, capture_spacing=0.2))
    cfgs.append(dataclasses.replace(base, scan=dataclasses.replace(base.scan, metric="ncc")))
    cfgs.append(jc.SimConfig(sensor=jc.SensorConfig(n_radial=4, n_azimuth=24, az_upsample=3)))
    return cfgs


@pytest.mark.parametrize("i", range(len(_jax_cfgs())))
def test_configs_match_field_by_field(i):
    jcfg = _jax_cfgs()[i]
    pcfg = config_from(jcfg)
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)
    assert tc.choose_fam_impl(pcfg) == jc.choose_fam_impl(jcfg)
    assert pcfg.scan.shifts() == jcfg.scan.shifts()
    assert pcfg.scan.tie_order() == jcfg.scan.tie_order()
    assert (pcfg.sensor.n_fine, pcfg.sensor.n_pixels) == (jcfg.sensor.n_fine, jcfg.sensor.n_pixels)
    assert pcfg.sensor.bin_width == jcfg.sensor.bin_width
    if i < 5:
        n = i + 1
        assert dataclasses.asdict(tc.baseline_config(n)) == dataclasses.asdict(jcfg)
        assert tc.baseline_fam_impl(n) == jc.baseline_fam_impl(n)
    # defaults agree too
    assert dataclasses.asdict(tc.SimConfig()) == dataclasses.asdict(jc.SimConfig())


@pytest.mark.parametrize(
    "kind,seed,kw",
    [
        ("blobs", 3, dict(n_features=60)),
        ("blobs", 7, dict(n_features=40, feature_scale=64.0)),
        ("noise", 1, {}),
        ("fractal", 2, {}),
        ("checker", 0, dict(cell=8)),
        ("flat", 0, {}),
    ],
)
def test_landscapes_routes_trials_bitwise(kind, seed, kw):
    size = (96, 128)
    np.testing.assert_array_equal(
        tland.make_landscape(kind, size=size, seed=seed, **kw),
        jland.make_landscape(kind, size=size, seed=seed, **kw),
    )
    for rk in ("line", "sine"):
        for length in (None, 40.0):
            rt = troutes.make_route(rk, size=size, margin=20.0 + seed, length=length)
            np.testing.assert_array_equal(
                rt, jroutes.make_route(rk, size=size, margin=20.0 + seed, length=length)
            )
    route = jroutes.make_route("sine", size=size, margin=20.0, length=50.0, amplitude=6.0)
    for spacing in (0.7, 1.5):
        for got, want in zip(toracle.resample_route(route, spacing),
                             joracle.resample_route(route, spacing)):
            np.testing.assert_array_equal(got, want)
    jcfg = jc.SimConfig(capture_spacing=1.3)
    for anywhere in (False, True):
        got = ttrials.make_trials(route, config_from(jcfg), 17, seed=seed, start_anywhere=anywhere)
        want = jtrials.make_trials(route, jcfg, 17, seed=seed, start_anywhere=anywhere)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def _port_sources():
    scripts = ("chip_smoke.py", "chip_profile.py", "decision_precision.py")
    files = [os.path.join(REPO, f) for f in scripts]
    for root, _, names in os.walk(os.path.join(REPO, "navdv_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return files


def test_port_imports_no_jax():
    """Neither the package nor the chip scripts import JAX or navdv_tpu: not
    at import time (checked in a fresh interpreter) and not anywhere in
    their source (checked on the syntax tree, which sees lazy imports)."""
    banned = ("jax", "jaxlib", "navdv_tpu")
    for path in _port_sources():
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            assert not [n for n in names if n.split(".")[0] in banned], (path, names)
    code = (
        "import sys, navdv_torch, navdv_torch.convert\n"
        "import chip_smoke, chip_profile, decision_precision\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {banned!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize(
    "entry",
    ["train_library", "make_statics", "init_state", "make_navigate_batch",
     "make_render_batch", "library_from_numpy", "make_lag_fam", "NavigationSimulator",
     "load_library"],
)
def test_entry_points_need_a_card_by_default(entry, monkeypatch, small_cfg, small_world):
    """``device=None`` means the card; without one every entry point raises
    instead of carrying on on the CPU."""
    from navdv_torch import agent, checkpoint, convert, sensor, simulator, training
    from navdv_torch.ops import lag

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    land, route = small_world
    cfg = config_from(small_cfg)
    views = np.zeros((3, cfg.sensor.n_radial, cfg.sensor.n_azimuth), np.float32)
    calls = {
        "train_library": lambda: training.train_library(land, route, cfg),
        "make_statics": lambda: agent.make_statics(
            land, convert.library_from_numpy(views, device="cpu"), route),
        "init_state": lambda: agent.init_state(np.zeros((2, 2)), np.zeros(2)),
        "make_navigate_batch": lambda: agent.make_navigate_batch(cfg),
        "make_render_batch": lambda: sensor.make_render_batch(cfg.sensor),
        "library_from_numpy": lambda: convert.library_from_numpy(views),
        "make_lag_fam": lambda: lag.make_lag_fam(cfg.sensor, cfg.scan),
        "NavigationSimulator": lambda: simulator.NavigationSimulator(cfg, land, route),
        "load_library": lambda: checkpoint.load_library("never-read.npz"),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
