"""Cells found as data, ``BENCHMARK.json`` against the benchmark's contract,
and a cell added with new files only."""

from __future__ import annotations

import json
import re

import pytest

import navdv_torch.simulator as simulator
from fixture import BENCH, ROOT, TINY, make_checkout
from harness import drive
from harness.cells import find_cell, load_benchmark, load_reader

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
            "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
BENCHMARK = load_benchmark(ROOT)
CELLS = [w["name"] for w in BENCHMARK["workloads"]]


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_benchmark_json_keeps_the_contract():
    b = BENCHMARK
    assert set(b) == KEYS["top"]
    assert b["command"] == ["python3", "benchmark/run.py"] and b["paths"] == ["benchmark"]
    assert 1 <= b["run_seconds"] <= 51
    names = [x["name"] for part in ("configs", "workloads", "end_to_end", "per_layer")
             for x in b[part]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == KEYS["config"] and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
        assert c["reduced"] == []
    assert len({c["file"] for c in b["configs"]}) == len(b["configs"])
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in b["workloads"]:
        assert set(w) == KEYS["workload"] and w["chips"] in (1, 4) and _line(w["why"])
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(1, len(b["workloads"]) // 4)
    assert {w["config"] for w in b["workloads"]} == {c["name"] for c in b["configs"]}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == KEYS["end_to_end"] and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in ("host_clock",
                                                                       "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == KEYS["per_layer"] and UNIT.match(m["unit"])
        assert _line(m["layer"]) and m["moves"] in e2e
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for cell in CELLS:
        reported = [m for m in b["end_to_end"] if "workloads" not in m or cell in m["workloads"]]
        assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
        layers = [m for m in b["per_layer"] if cell in m.get("workloads", [cell])]
        assert layers and all(m["moves"] in {r["name"] for r in reported} for m in layers)
    assert len(json.dumps(b)) <= 64 * 1024


# the cells so far, in order: a later cell is added after them as data
KNOWN_CELLS = [("fft_lib50_b1024", 1), ("roll_lib500_b512", 1), ("fft_lib50_b1", 1),
               ("roll_lib500_b512_mesh1x4", 4), ("sector_lib50_b256", 1),
               ("exact_lib50_b1024", 1), ("fft_lib50_b1024_anywhere", 1)]


def test_the_cells_in_their_order():
    cells = [(w["name"], w["chips"]) for w in BENCHMARK["workloads"]]
    assert cells[:len(KNOWN_CELLS)] == KNOWN_CELLS


@pytest.mark.parametrize("name", CELLS)
def test_each_cell_is_found_as_data(name):
    cell = find_cell(name, ROOT)
    assert cell.config["name"] == cell.config_name
    batch = cell.traffic["batch"]
    assert isinstance(batch, int) and not isinstance(batch, bool) and batch > 0
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    for m in cell.per_layer:
        assert callable(load_reader(ROOT, m["name"]))
    # the configuration runs as shipped: nothing is cut (a sweep's, at each
    # grid point)
    assert cell.config["world"]["size"] == 512
    for config in cell.config.get("points", [cell.config]):
        assert config["sim"]["agent"]["max_steps"] == 66
        assert list(config["limits"])[:5] == ["lib_err", "pose_mismatch", "status_mismatch",
                                              "fam_err", "decision_gap"]


def test_a_cell_of_new_files_only_runs(tmp_path):
    root = make_checkout(tmp_path)
    cell = find_cell("fixture_cell", root)
    assert [m["name"] for m in cell.per_layer] == ["fixture_steps"]
    assert {m["name"] for m in cell.end_to_end} == {"agent_steps_per_s", "batch_ms_p95",
                                                    "setup_s"}
    result = drive.run_single(cell, 2**31 + 12345, 0.5, False, "cpu", 0.0, lambda: None)
    assert result["correct"] and result["attempted"] >= 1
    assert set(result["metrics"]) == {"agent_steps_per_s", "batch_ms_p95", "setup_s"}
    traced = drive.run_single(cell, 99, 0.5, True, "cpu", 0.0, lambda: None)
    assert traced["correct"] and traced["metrics"]["fixture_steps"]["value"] == 2 * 15
    # the repository's own cells are untouched by the fixture's
    assert find_cell("fft_lib50_b1024", root).config == find_cell("fft_lib50_b1024").config


@pytest.mark.parametrize("arg", [None, "plain", "fft"])
def test_a_configuration_states_the_path_it_asks_for(arg, tmp_path, monkeypatch):
    config = dict(TINY) if arg is None else dict(TINY, fam_impl="plain", fam_impl_arg=arg)
    cell = find_cell("fixture_cell", make_checkout(tmp_path, config=config))
    given = []
    real = simulator.NavigationSimulator.__init__

    def init(self, cfg, landscape, route, fam_impl="auto", device=None):
        given.append(fam_impl)
        real(self, cfg, landscape, route, fam_impl=fam_impl, device=device)

    monkeypatch.setattr(simulator.NavigationSimulator, "__init__", init)
    if arg == "fft":  # the path the program resolves is not the one the file states
        with pytest.raises(RuntimeError, match="resolved to 'fft'"):
            drive.run_single(cell, 5, 0.2, False, "cpu", 0.0, lambda: None)
        assert given == []
        return
    result = drive.run_single(cell, 5, 0.2, False, "cpu", 0.0, lambda: None)
    assert result["correct"], result["checks"]
    assert given == ["auto" if arg is None else arg]
