"""A checkout with one more cell made of new files only, for the CPU tests.

:func:`make_checkout` copies ``BENCHMARK.json`` and ``benchmark/`` into a
temporary directory and adds a configuration file, a traffic file and a
per-layer metric's reader, with their entries in that copy's
``BENCHMARK.json``. The harness's code is the repository's own, unedited.
The fixture is small enough for the CPU: a 4x24 sensor at az_upsample 3, 12
headings, 12 stored views, 15 steps, 4 agents, on the exact ``"kernel"``
path (``fam_impl="auto"`` picks it for sensors under 512 pixels).
:data:`SECTOR_TINY` is config 3's shape at that size: a 4x48 sensor at
az_upsample 1 on the sector renderer's fused front end, NCC at a 3-bin
tolerance, the spectral series cut at 8 bins, judged by ``sector_ncc``; it
states ``fam_impl_arg`` "fft", which "auto" would not pick at 192 pixels.
:data:`EXIT_TINY` gives :data:`TINY` the real cells' step budget (66 steps,
1.3 times the route), so that agents started anywhere on the route all
finish before it, and :data:`ANYWHERE` is the traffic that starts them
there and stops each batch once every agent is done.
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
sys.path[:0] = [str(BENCH), str(ROOT)]

TINY = {
    "name": "fixture_tiny",
    "what": "a CPU-sized sensor on the exact kernel path",
    "fam_impl": "kernel",
    "familiarity": "exact",
    "views": 12,
    "step_budget": 0.3,
    "world": {"landscape": "blobs", "size": 512, "n_features": 150, "margin": 60.0,
              "route_length": 40.0},
    "sim": {
        "sensor": {"n_radial": 4, "n_azimuth": 24, "az_upsample": 3, "r_min": 2.0,
                   "r_max": 10.0, "hat_dtype": "bfloat16"},
        "scan": {"n_headings": 12, "scan_step_bins": 2, "metric": "ssd", "tol_bins": 0,
                 "spectral_cutoff": 0},
        "agent": {"step_size": 1.0, "goal_radius": 2.0, "corridor": 20.0, "max_steps": 15},
    },
    "limits": {"lib_err": 1e-3, "pose_mismatch": 0, "status_mismatch": 0, "fam_err": 1e-8,
               "decision_gap": 1e-8},
}
SECTOR_TINY = dict(
    TINY, what="config 3's shape at a CPU size", fam_impl="fft", fam_impl_arg="fft",
    familiarity="fft", reference="sector_ncc",
    sim={"sensor": {"n_radial": 4, "n_azimuth": 48, "az_upsample": 1, "r_min": 2.0,
                    "r_max": 10.0, "hat_dtype": "bfloat16", "render_mode": "sector",
                    "n_sectors": 8},
         "scan": {"n_headings": 12, "scan_step_bins": 2, "metric": "ncc", "tol_bins": 3,
                  "fused_dft_precision": "default", "spectral_cutoff": 8},
         "agent": TINY["sim"]["agent"]},
    limits={"lib_err": 1e-3, "pose_mismatch": 0, "status_mismatch": 0, "fam_err": 1.5e-7,
            "decision_gap": 1.2e-7})
EXIT_TINY = dict(TINY, step_budget=1.3,
                 sim=dict(TINY["sim"], agent=dict(TINY["sim"]["agent"], max_steps=66)))
FEW = {"why": "4 agents a call", "batch": 4, "pos_sigma": 1.5, "heading_sigma": 0.15,
       "trace_episodes": 2, "check": {"episodes": 2, "poses": 48}}
ANYWHERE = dict(FEW, why="4 agents a call from anywhere on the route, early exit",
                starts="anywhere", early_exit=True)
READER = '''"""Steps in the traced slice (a fixture's metric)."""


def read(trace):
    return float(trace.steps)
'''


def make_checkout(tmp: Path, mesh: list | None = None, config: dict | None = None,
                  traffic: dict | None = None) -> Path:
    """A checkout in ``tmp`` with the fixture cell ``fixture_cell`` of the
    configuration ``config`` (:data:`TINY` by default) under the traffic
    ``traffic`` (:data:`FEW` by default), and, with ``mesh``, the cell
    ``fixture_mesh`` of the same configuration on that (data, lib) mesh of
    CPU ranks."""
    tmp = Path(tmp)
    config = dict(config or TINY, name="fixture_tiny")
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp / "benchmark",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    bench = json.loads((tmp / "BENCHMARK.json").read_text())
    (tmp / "benchmark" / "configs" / "fixture_tiny.json").write_text(json.dumps(config))
    (tmp / "benchmark" / "traffic" / "fixture_few.json").write_text(json.dumps(traffic or FEW))
    (tmp / "benchmark" / "metrics" / "fixture_steps.py").write_text(READER)
    bench["configs"].append({"name": "fixture_tiny", "source": "a test fixture",
                             "file": "benchmark/configs/fixture_tiny.json", "reduced": [],
                             "why": "CPU-sized"})
    bench["workloads"].append({"name": "fixture_cell", "config": "fixture_tiny",
                               "traffic": "fixture_few", "chips": 1, "why": "CPU-sized"})
    cells = ["fixture_cell"]
    if mesh is not None:
        meshed = dict(config, name="fixture_tiny_mesh", mesh=mesh,
                      limits=dict(config["limits"], min_calls_off=0, rank_mismatch=0))
        (tmp / "benchmark" / "configs" / "fixture_tiny_mesh.json").write_text(json.dumps(meshed))
        bench["configs"].append({"name": "fixture_tiny_mesh", "source": "a test fixture",
                                 "file": "benchmark/configs/fixture_tiny_mesh.json",
                                 "reduced": [], "why": "CPU-sized, on ranks"})
        bench["workloads"].append({"name": "fixture_mesh", "config": "fixture_tiny_mesh",
                                   "traffic": "fixture_few", "chips": 4, "why": "CPU ranks"})
        cells.append("fixture_mesh")
    for m in bench["end_to_end"]:
        if "workloads" in m and m["name"] == "agent_steps_per_s":
            m["workloads"] += cells
        if "workloads" in m and m["name"] == "batch_ms_p95":
            m["workloads"] += cells
    bench["per_layer"].append({"name": "fixture_steps", "unit": "steps", "better": "higher",
                               "source": "device_trace", "layer": "device",
                               "moves": "agent_steps_per_s", "workloads": cells})
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
