"""A cell of ``BENCHMARK.json`` found as data.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric sits in a file of its own, found by the name that
``BENCHMARK.json`` gives it: the configuration's ``file``,
``benchmark/traffic/<traffic>.json`` and ``benchmark/metrics/<metric>.py``.
A cell, a configuration, a traffic mix or a metric is added by adding files
and entries, never by editing code.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


@dataclasses.dataclass(frozen=True)
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    root: Path
    name: str
    chips: int
    config_name: str
    config: dict  # the configuration file
    traffic_name: str
    traffic: dict  # the traffic file
    end_to_end: list  # the end-to-end metric entries this cell reports
    per_layer: list  # the per-layer metric entries this cell reports


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json``; KeyError naming
    the known cells when there is none."""
    root = Path(root)
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; known: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    entry = configs[w["config"]]
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads((root / "benchmark" / "traffic" / f"{w['traffic']}.json").read_text())
    end_to_end = [m for m in bench["end_to_end"] if _applies(m, name)]
    reported = {m["name"] for m in end_to_end}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return Cell(root=root, name=name, chips=int(w["chips"]), config_name=w["config"],
                config=config, traffic_name=w["traffic"], traffic=traffic,
                end_to_end=end_to_end, per_layer=per_layer)


def load_reader(root: Path, metric: str):
    """The ``read(trace)`` function of ``benchmark/metrics/<metric>.py``."""
    path = Path(root) / "benchmark" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location("metric_" + metric.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
