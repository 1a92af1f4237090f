"""The cell ``fft_lib50_b1024_anywhere``: trials drawn from anywhere on the
route, the program's early-exit run, and the check of the early-exit
record, on the fixture cell at CPU size; the trials of the other traffic
pinned to what they were before starts could be drawn elsewhere."""

from __future__ import annotations

import hashlib

import numpy as np
import pytest
import torch

from fixture import ANYWHERE, EXIT_TINY, ROOT, make_checkout
from harness import drive, world
from harness.cells import find_cell, load_benchmark
from navdv_torch.simulator import NavigationResult, NavigationSimulator

CELL = "fft_lib50_b1024_anywhere"
SEED = 5  # every batch of the fixture cell stops before its 66 steps

# sha256 (first 16 hex digits) of the first batch's starts and headings at
# seeds 0 and 2**31 + 7, on the route of the first cell under each traffic
PINNED = {
    "batch1024": ("fft_lib50_b1024", ["be75714330239665", "91b790a9c30a0e1a"]),
    "batch512": ("roll_lib500_b512", ["90482ef4a5ded9a2", "eb82699c2661d4fb"]),
    "batch256": ("sector_lib50_b256", ["9a26a4898d7417e5", "6af6c5d833e8c2f8"]),
    "single": ("fft_lib50_b1", ["810780df39245001", "aeb84d2318fa881a"]),
}


def _route(cell):
    _, pts, headings = world.route_geometry(cell.config, world.make_route(cell.config["world"]))
    return pts, headings


@pytest.mark.parametrize("traffic", sorted(PINNED))
def test_the_route_start_trials_are_pinned(traffic):
    name, digests = PINNED[traffic]
    cell = find_cell(name)
    assert cell.traffic_name == traffic and "starts" not in cell.traffic
    pts, headings = _route(cell)
    for seed, digest in zip((0, 2**31 + 7), digests):
        starts, thetas = world.Trials(seed, 0, pts, headings, cell.traffic).draw()
        assert hashlib.sha256(starts.tobytes() + thetas.tobytes()).hexdigest()[:16] == digest
        stated = dict(cell.traffic, starts="route_start")
        again = world.Trials(seed, 0, pts, headings, stated).draw()
        assert all(np.array_equal(a, b) for a, b in zip((starts, thetas), again))


def test_anywhere_starts_cover_the_routes_captures():
    cell = find_cell(CELL)
    assert cell.traffic["starts"] == "anywhere" and cell.traffic["early_exit"] is True
    assert cell.config_name == "baseline1_fft_lib50"
    pts, headings = _route(cell)
    starts, thetas = world.Trials(2**31 + 11, 0, pts, headings, cell.traffic).draw()
    assert starts.shape == (1024, 2) and starts.dtype == np.float32
    nearest = np.argmin(((starts[:, None, :] - pts[None]) ** 2).sum(-1), axis=1)
    # the start captures are [0, n - 2); noise of 1.5 units moves a start at
    # most a few captures (about a unit apart) off its own
    assert nearest.min() <= 1 and nearest.max() >= len(pts) - 5
    assert len(np.unique(nearest)) >= len(pts) - 4
    gap = np.angle(np.exp(1j * (thetas - headings[nearest])))
    assert np.abs(gap).max() < 1.5
    with pytest.raises(ValueError, match="unknown starts"):
        world.Trials(0, 0, pts, headings, dict(cell.traffic, starts="goal"))


def test_the_traffic_may_fix_the_world():
    anywhere, fft = find_cell(CELL), find_cell("fft_lib50_b1024")
    assert isinstance(anywhere.traffic["world_seed"], int) and "world_seed" not in fft.traffic
    a, b = (drive.make_world(anywhere, s, "cpu")[0] for s in (3, 2**31 + 4))
    c, d = (drive.make_world(fft, s, "cpu")[0] for s in (3, 2**31 + 4))
    assert torch.equal(a, b) and not torch.equal(c, d)
    assert torch.equal(a, world.make_landscape(anywhere.traffic["world_seed"],
                                               anywhere.config["world"], "cpu"))
    assert torch.equal(c, world.make_landscape(3, fft.config["world"], "cpu"))


def _first_batch(root):
    cell = find_cell("fixture_cell", root)
    s = drive.setup_single(cell, SEED, "cpu")
    trials = world.Trials(SEED, 0, s.pts, s.headings, cell.traffic)
    _, final, rec, steps = s.call(*trials.draw())
    s.release()
    return final, rec, int(steps.max())


def test_the_early_exit_run_leaves_its_padding(tmp_path):
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    final, rec, e = _first_batch(make_checkout(tmp_path / "a", config=EXIT_TINY,
                                               traffic=ANYWHERE))
    assert e < EXIT_TINY["sim"]["agent"]["max_steps"]
    assert all((f[:, e:] == 0).all() for f in rec[:5]) and rec[5][:, e:].all()
    assert not rec[5][:, e - 1].all() and final[2].all()
    # the full loop on the same trials: the tail repeats the last pose
    full_final, full_rec, full_e = _first_batch(
        make_checkout(tmp_path / "b", config=EXIT_TINY, traffic=dict(ANYWHERE, early_exit=False)))
    assert full_e == e
    assert torch.equal(full_rec[0][:, :e], rec[0][:, :e])
    assert (full_rec[0][:, e:] == full_rec[0][:, e - 1:e]).all()
    assert all(torch.equal(a, b) for a, b in zip(full_final, final))


def _pose_in_padding(monkeypatch):
    """The first padding column of each episode gets a pose: the last one
    moved by a unit."""
    real = NavigationSimulator.navigate

    def navigate(self, **kw):
        r = real(self, **kw)
        e = int(r.metrics["n_steps"].max())
        if e < r.record.xy.shape[1]:
            r.record.xy[:, e] = r.record.xy[:, e - 1] + 1.0
        return NavigationResult(r.success_rate, r.metrics, r.final_state, r.record)

    monkeypatch.setattr(NavigationSimulator, "navigate", navigate)


@pytest.mark.parametrize("early_exit, fault", [(True, _pose_in_padding), (False, None)])
def test_the_check_of_the_early_exit_record(early_exit, fault, tmp_path, monkeypatch):
    traffic = dict(ANYWHERE, early_exit=early_exit)
    cell = find_cell("fixture_cell", make_checkout(tmp_path, config=EXIT_TINY, traffic=traffic))
    if fault is not None:
        fault(monkeypatch)
    result = drive.run_single(cell, SEED, 0.3, False, "cpu", 0.0, lambda: None)
    if early_exit:
        assert max(result["exit_columns"]) < EXIT_TINY["sim"]["agent"]["max_steps"]
    else:  # only the early-exit loop has exit columns to report
        assert "exit_columns" not in result
    assert result["correct"] is (fault is None), result["checks"]
    if fault is not None:
        assert result["checks"]["pose_mismatch"]["value"] > 0


def test_the_cell_reports_the_early_exit_metrics():
    cell = find_cell(CELL)
    assert {m["name"] for m in cell.end_to_end} == {"agent_steps_per_s", "batch_ms_p95",
                                                    "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "device_idle_share.batch", "device_ms_per_step.batch", "render_roofline",
        "fp64_ms_per_step.fft", "graph_launches_per_episode.anywhere",
        "exit_wait_ms_per_episode.anywhere"}
    # the configuration is cell fft_lib50_b1024's; only the traffic differs
    fft = find_cell("fft_lib50_b1024")
    assert cell.config == fft.config
    assert {k: v for k, v in cell.traffic.items()
            if k not in ("why", "starts", "early_exit", "world_seed")} == {
        k: v for k, v in fft.traffic.items() if k != "why"}
    names = [m["name"] for m in load_benchmark(ROOT)["per_layer"]]
    assert "candidate_ms_per_step.exact" not in names


def _renamed(monkeypatch):
    """The facade keeps its episode run under another name."""
    real = NavigationSimulator.__init__

    def __init__(self, *a, **kw):
        real(self, *a, **kw)
        self._run = self.__dict__.pop("_navigate")

    monkeypatch.setattr(NavigationSimulator, "__init__", __init__)


def _whole_episode(monkeypatch):
    """The program's runner ignores ``early_exit``."""
    import navdv_torch.agent as agent

    real = agent.make_navigate_batch
    monkeypatch.setattr(agent, "make_navigate_batch",
                        lambda *a, early_exit=False, **kw: real(*a, **kw))


@pytest.mark.parametrize("fault", [_renamed, _whole_episode])
def test_set_up_refuses_a_facade_that_would_not_exit_early(fault, tmp_path, monkeypatch):
    cell = find_cell("fixture_cell", make_checkout(tmp_path, config=EXIT_TINY, traffic=ANYWHERE))
    fault(monkeypatch)
    with pytest.raises(RuntimeError, match="_navigate|early-exit loop"):
        drive.setup_single(cell, SEED, "cpu")
