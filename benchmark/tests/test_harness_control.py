"""The control fails where the program passes, at a size a test run holds:
the configurations as shipped, a few agents, on the CPU. The control is the
reference computed in float32 in the program's place (and the library
trained from an fp8 panorama); at the cells' own size it is read on the
card by ``benchmark/calibrate.py``. Each configuration of a one-card cell
states its CPU size under ``cpu_check``: agents a call, episodes and poses
compared; a sweep's, trials a grid point, passes kept and poses a point."""

from __future__ import annotations

import dataclasses

import pytest

import fixture  # noqa: F401  (puts the harness and the program on the path)

from harness import drive, sweep
from harness.cells import find_cell, load_benchmark

# the first one-card cell of each configuration
FIRST = {}
for w in load_benchmark()["workloads"]:
    if w["chips"] == 1:
        FIRST.setdefault(w["config"], w["name"])


@pytest.mark.parametrize("name", list(FIRST.values()))
def test_the_control_reads_above_the_limits(name):
    cell = find_cell(name)
    small = cell.config.get("cpu_check")
    assert small is not None, f"{cell.config_name} states no cpu_check size"
    traffic = dict(cell.traffic, batch=small["batch"],
                   check={"episodes": small["episodes"], "poses": small["poses"]})
    cell = dataclasses.replace(cell, traffic=traffic)
    run = sweep.run if sweep.is_sweep(cell) else drive.run_single
    result = run(cell, 2**31 + 99, 0.1, False, "cpu", 0.0, lambda: None, control=True)
    assert result["correct"], result["checks"]
    # a sweep's numbers are each grid point's, under "<point>/<number>"
    for point in cell.config.get("points", [cell.config]):
        prefix = f"{point['key']}/" if "key" in point else ""
        n = {k[len(prefix):]: v for k, v in result["numbers"].items() if k.startswith(prefix)}
        limits = point["limits"]
        assert n["lib_err_control"] > limits["lib_err"]
        assert (n["fam_err_control"] > limits["fam_err"]
                or n["decision_gap_control"] > limits["decision_gap"])
