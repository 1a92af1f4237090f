"""The result line, the refusals without a card, and the import guard."""

from __future__ import annotations

import importlib.util
import json
import os
import shutil
import subprocess
import sys
import types

import pytest
import torch

from fixture import BENCH, ROOT, make_checkout
from harness import drive
from harness.cells import find_cell


def _run_py():
    spec = importlib.util.spec_from_file_location("navbench_run", BENCH / "run.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_the_line_has_the_contract_keys_and_checks_last(tmp_path, capsys, monkeypatch):
    run = _run_py()
    monkeypatch.setattr(run, "card", lambda n: "a card, 700.00 W")
    cell = find_cell("fixture_cell", make_checkout(tmp_path))
    result = drive.run_single(cell, 7, 0.3, False, "cpu", 0.0, lambda: None)
    run.emit(result, cell, "a card")
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["device"] == {"platform": "gpu", "kind": "a card", "count": 1,
                              "memory_peak_bytes": 0}
    assert all(set(m) == {"value", "unit"} for m in line["metrics"].values())
    assert set(line["checks"]) == {"lib_err", "pose_mismatch", "status_mismatch", "fam_err",
                                   "decision_gap"}
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())
    tail = err.strip().splitlines()
    assert tail[0].startswith("window: episodes ") and tail[1].startswith("set-up s: start ")
    assert tail[2].startswith("check lib_err ") and tail[-1] == "check correct True"


def _cli(cwd, *extra):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", "fft_lib50_b1",
                           "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0", *extra],
                          cwd=cwd, capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, BENCH_RUN="x"))


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal shows only without one")
    p = _cli(ROOT)
    assert p.returncode != 0 and p.stdout == ""
    assert "no CUDA device" in p.stderr


def test_a_checkout_of_only_the_benchmark_gives_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    p = _cli(tmp_path)
    assert p.returncode != 0 and p.stdout == ""


def test_the_guard_compares_whole_top_level_names(monkeypatch):
    run = _run_py()
    run.guard()  # navdv_torch, jaxtyping and the harness are not JAX
    for name in ("jax", "jaxlib.xla_client", "flax", "navdv_tpu.agent"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
        with pytest.raises(SystemExit) as e:
            run.guard()
        assert e.value.code != 0
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "jaxtyping", types.ModuleType("jaxtyping"))
    monkeypatch.setitem(sys.modules, "navdv_tpux", types.ModuleType("navdv_tpux"))
    run.guard()


def test_nothing_the_harness_imports_loads_jax():
    code = ("import sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]\n"
            "import harness.drive, harness.mesh, harness.check, harness.trace\n"
            "import reference.navref, reference.sector_ncc\n"
            "import navdv_torch.simulator, navdv_torch.parallel, navdv_torch.training\n"
            "bad = {'jax', 'jaxlib', 'flax', 'navdv_tpu'}\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & bad))")
    p = subprocess.run([sys.executable, "-c", code, str(BENCH), str(ROOT)], capture_output=True,
                       text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"


@pytest.mark.parametrize("name", sorted(p.stem for p in (BENCH / "reference").glob("*.py")))
def test_the_reference_imports_neither_the_program_nor_jax(name):
    text = (BENCH / "reference" / f"{name}.py").read_text()
    assert "import jax" not in text and "navdv_tpu" not in text
    assert "from navdv" not in text and "import navdv" not in text
