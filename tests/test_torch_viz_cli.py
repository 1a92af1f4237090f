"""The port's plots (navdv_torch.viz, NavigationResult.plot) and its
command line (``python -m navdv_torch.cli``), mirroring tests/test_viz.py
and tests/test_cli.py, on the CPU with ``--device cpu``."""

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import navdv_torch as nt
from navdv_torch import viz
from navdv_torch.agent import init_state, make_navigate, make_navigate_batch, make_statics
from navdv_torch.cli import _cli_route, main
from navdv_torch.convert import config_from
from navdv_torch.oracle import resample_route

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def episode(request):
    cfg = config_from(request.getfixturevalue("small_cfg"))
    landscape, route = request.getfixturevalue("small_world")
    lib = nt.train_library(landscape, route, cfg, device="cpu")
    st = make_statics(landscape, lib, route, device="cpu")
    pts, headings = resample_route(route, cfg.capture_spacing)
    _, rec = make_navigate(cfg, device="cpu")(init_state(pts[0], headings[0], device="cpu"), st)
    states0 = init_state(np.tile(pts[0], (4, 1)), np.full(4, headings[0]), device="cpu")
    _, brec = make_navigate_batch(cfg, device="cpu")(states0, st)
    return landscape, route, rec, brec


def test_plot_trajectory_single(episode, tmp_path):
    landscape, route, rec, _ = episode
    viz.plot_trajectory(landscape, route, rec, str(tmp_path / "t.png"))
    assert (tmp_path / "t.png").stat().st_size > 1000


def test_plot_trajectory_batch(episode, tmp_path):
    """A batched record on a tensor landscape: every field reaches NumPy
    through the host copy, whatever device it lies on."""
    landscape, route, _, brec = episode
    viz.plot_trajectory(torch.as_tensor(landscape), route, brec, str(tmp_path / "tb.png"))
    assert (tmp_path / "tb.png").stat().st_size > 1000


def test_plot_familiarity(episode, tmp_path):
    _, _, rec, brec = episode
    viz.plot_familiarity_trace(rec, str(tmp_path / "f.png"))
    viz.plot_familiarity_trace(brec, str(tmp_path / "fb.png"))
    assert (tmp_path / "f.png").exists() and (tmp_path / "fb.png").exists()


def test_animate_episode(episode, tmp_path):
    landscape, route, rec, _ = episode
    out = viz.animate_episode(landscape, route, rec, str(tmp_path / "e.mp4"), fps=10)
    assert os.path.getsize(out) > 1000  # mp4 or the gif fallback


def test_animate_episode_rejects_batched_record(episode, tmp_path):
    landscape, route, _, brec = episode
    with pytest.raises(ValueError, match="ONE episode"):
        viz.animate_episode(landscape, route, brec, str(tmp_path / "x.mp4"))


def test_axis_sort_key_orders_numerically():
    from navdv_tpu import viz as jviz

    vals = ["10.0", "0.5", "2.0"]
    assert sorted(vals, key=viz._axis_sort_key) == ["0.5", "2.0", "10.0"]
    px = ["360x64u1", "18x4u20", "72x16u5"]
    assert sorted(px, key=viz._axis_sort_key) == ["18x4u20", "72x16u5", "360x64u1"]
    for v in vals + px + ["60x2", "-1.5"]:
        assert viz._axis_sort_key(v) == jviz._axis_sort_key(v)


def test_simulator_result_plot(small_cfg, small_world, tmp_path):
    """NavigationResult.plot writes the trials' trajectories."""
    landscape, route = small_world
    sim = nt.NavigationSimulator(config_from(small_cfg), landscape, route, device="cpu").train()
    res = sim.navigate(n_trials=4, seed=0)
    out = res.plot(landscape, route, str(tmp_path / "sim.png"))
    assert out == str(tmp_path / "sim.png") and os.path.getsize(out) > 1000


def test_numeric_path_needs_no_matplotlib():
    """Importing the package and building a step imports no matplotlib: only
    what plots imports viz."""
    code = ("import sys, navdv_torch, navdv_torch.cli, navdv_torch.analysis\n"
            "from navdv_torch.agent import make_step_batched\n"
            "make_step_batched(navdv_torch.SimConfig(), 'conv', device='cpu')\n"
            "sys.exit(1 if any(m.split('.')[0] == 'matplotlib' for m in sys.modules) else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=REPO), timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_cli_demo(tmp_path):
    out = str(tmp_path / "demo")
    main(["demo", "--size", "128", "--route", "line", "--route-length", "40",
          "--trials", "4", "--steps", "12", "--out", out, "--device", "cpu"])
    assert os.path.exists(os.path.join(out, "trajectories.png"))
    assert os.path.exists(os.path.join(out, "familiarity.png"))
    with open(os.path.join(out, "metrics.json")) as f:
        m = json.load(f)
    assert 0.0 <= m["success_rate"] <= 1.0


def test_cli_sweep_with_spec(tmp_path):
    out = str(tmp_path / "sweep")
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps({
        "sensor_px": [[24, 4, 3]],
        "scan_granularity": [[12, 2]],
        "capture_spacing": [2.0],
        "n_trials": 4,
        "max_steps": 12,
    }))
    main(["sweep", "--size", "128", "--route", "line", "--route-length", "40",
          "--spec", str(spec), "--out", out, "--trial-seed", "1", "--device", "cpu"])
    assert os.path.exists(os.path.join(out, "summary.json"))
    assert os.path.exists(os.path.join(out, "success_heatmap.png"))


def test_cli_analyze(tmp_path):
    out = str(tmp_path / "analysis")
    main(["analyze", "--size", "128", "--route", "line", "--route-length", "40",
          "--stride", "24", "--batch", "16", "--impl", "kernel", "--out", out,
          "--device", "cpu"])
    assert os.path.exists(os.path.join(out, "ridf.png"))
    assert os.path.exists(os.path.join(out, "familiarity_map.png"))
    with open(os.path.join(out, "analysis.json")) as f:
        a = json.load(f)
    assert abs(a["ridf_valley_deg"]) <= 1.5
    assert a["ridf_depth"] < 0.05
    assert a["map_grid"][0] >= 2 and a["map_grid"][1] >= 2


def test_cli_route_margin_scales_and_warns(capsys):
    """As the JAX CLI: the edge margin scales down on small worlds, and a
    truncated --route-length warns; the route equals the JAX CLI's."""
    from navdv_tpu.cli import _cli_route as j_cli_route

    args = argparse.Namespace(route="line", route_length=40.0)
    r = _cli_route(args, (128, 128))
    assert float(np.hypot(*np.diff(r, axis=0).T).sum()) == pytest.approx(40.0, abs=1e-6)
    assert capsys.readouterr().err == ""
    np.testing.assert_array_equal(r, j_cli_route(args, (128, 128)))
    args = argparse.Namespace(route="line", route_length=200.0)
    r = _cli_route(args, (128, 128))
    assert "truncated" in capsys.readouterr().err
    assert float(np.hypot(*np.diff(r, axis=0).T).sum()) == pytest.approx(64.0)


@pytest.mark.parametrize("argv,code,match", [
    (["bench", "--impl", "jnp"], 2, "invalid choice"),
    (["demo", "--impl", "jnp"], 2, "invalid choice"),
])
def test_cli_refuses_what_is_not_ported(argv, code, match, capsys):
    """The JAX path names are not the port's ``--impl`` choices, in ``bench``
    as in ``demo``."""
    with pytest.raises(SystemExit) as e:
        main(argv)
    assert e.value.code == code
    assert match in capsys.readouterr().err


def test_cli_cells_mesh_raises_naming_a17(tmp_path, capsys):
    """``--cells-mesh 2`` in a world of one rank exits naming the torchrun
    line that starts two, runs no cell and leaves no process group."""
    import torch.distributed as dist

    with pytest.raises(SystemExit) as e:
        main(["sweep", "--size", "128", "--cells-mesh", "2", "--out", str(tmp_path),
              "--device", "cpu"])
    assert e.value.code == 2
    assert "torchrun --nproc-per-node 2" in capsys.readouterr().err
    assert not dist.is_initialized()
    assert not os.listdir(tmp_path)


def test_cli_cells_mesh_passes_its_backend(tmp_path):
    """``--backend`` reaches ``init_distributed``: NCCL on the CPU is
    refused there, before any group forms or any cell runs."""
    import torch.distributed as dist

    with pytest.raises(ValueError, match="use gloo"):
        main(["sweep", "--size", "128", "--cells-mesh", "2", "--out", str(tmp_path),
              "--device", "cpu", "--backend", "nccl"])
    assert not dist.is_initialized()
    assert not os.listdir(tmp_path)
