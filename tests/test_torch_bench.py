"""The port's bench (``navdv_torch.bench``, ``python -m navdv_torch.cli
bench``) against the repo-root JAX ``bench.py`` on the CPU: the same world,
config and trial draws, the same success rate and exact-path reference on
the same arguments (within 1/B: the exact paths are JAX ``"jnp"`` in fp32
sums and the port's ``"kernel"`` in fp64, ROADMAP C.1), the same line
contract, markers, gate metric names and keys, and the same ``--all``
sequence through the CLI."""

import ast
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench as jbench  # noqa: E402
import navdv_tpu.agent as jagent  # noqa: E402
import navdv_tpu.cli as jcli  # noqa: E402
from navdv_tpu.config import baseline_fam_impl as j_baseline_fam_impl  # noqa: E402
from navdv_tpu.ops.window_pallas import VMEM_LAND_MAX_ELEMS  # noqa: E402

from navdv_torch import bench as tbench  # noqa: E402
from navdv_torch import cli as tcli  # noqa: E402
from navdv_torch.config import baseline_fam_impl as t_baseline_fam_impl  # noqa: E402
from navdv_torch.convert import config_from  # noqa: E402

CPU = torch.device("cpu")
# bench.py's test size, and a little larger for success rates away from 0
TINY = dict(batch=4, steps=6, views=8, route_length=20.0, min_window_s=0.02, repeats=1)
SMALL = dict(batch=16, steps=None, views=8, route_length=20.0, min_window_s=0.02, repeats=1)
ACCEPTANCE = ["--config", "1", "--batch", "4", "--steps", "6", "--views", "8",
              "--route-length", "20", "--repeats", "1"]


def _jax_return_keys(fn_name: str) -> set[str]:
    """Keys of the dict literal that ``bench.py``'s ``fn_name`` builds its
    line from (its return value, or the ``result`` it returns)."""
    tree = ast.parse(open(os.path.join(REPO, "bench.py")).read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == fn_name)
    keys: set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Dict) and any(
                isinstance(k, ast.Constant) and k.value == "metric" for k in node.keys):
            keys |= {k.value for k in node.keys if isinstance(k, ast.Constant)}
        elif (isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Store)
              and isinstance(node.value, ast.Name) and node.value.id == "result"):
            keys.add(node.slice.value)
    return keys


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs: a CPU episode is
    thousands of small ops, and on a host whose cores the suite's other
    workers keep busy, an op that forks a team of threads waits for all of
    them (a bench line there took minutes instead of seconds)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clear_caches():
    for mod in (jbench, tbench):
        mod._SETUP_CACHE.clear()
        mod._RECALL_REF_CACHE.clear()


# --- world, config, trials --------------------------------------------------

@pytest.mark.parametrize("config_n,kw", [
    (1, {}), (2, {}), (3, {}), (4, {}), (1, dict(views=8, route_length=20.0, steps=6)),
])
def test_setup_equals_jax(config_n, kw):
    """The landscape bit for bit, the route and every cfg field equal, the
    capture points and headings within 1e-6."""
    jcfg, jland, jroute, jpts, jhd = jbench._setup(config_n, **kw)
    tcfg, tland, troute, tpts, thd = tbench._setup(config_n, **kw)
    assert np.array_equal(np.asarray(jland), tland)
    np.testing.assert_array_equal(jroute, troute)
    assert config_from(jcfg) == tcfg
    np.testing.assert_allclose(tpts, jpts, rtol=0, atol=1e-6)
    np.testing.assert_allclose(thd, jhd, rtol=0, atol=1e-6)


def test_big_landscape_world_equals_jax():
    """``run_big_landscape``'s world rule at 1536^2 (past the TPU kernel's
    VMEM budget, whose size the port's copy of the floor equals)."""
    assert tbench.TPU_VMEM_LAND_MAX_ELEMS == VMEM_LAND_MAX_ELEMS
    kw = dict(size=1536, land_kind="fractal", n_features=max(150, int(150 * 3 ** 2)))
    jland = jbench._setup(1, **kw)[1]
    tland = tbench._setup(1, **kw)[1]
    assert np.array_equal(np.asarray(jland), tland)
    with pytest.raises(ValueError, match="fits the TPU window kernel's VMEM"):
        tbench.run_big_landscape(size=1024, device="cpu")


@pytest.fixture(scope="module")
def runs():
    """``run_bench`` of both packages on the same arguments (configs 1 and
    2), with every trial draw each passes to its ``init_state`` recorded."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        draws = {"jax": [], "torch": []}
        j_init, t_init = jagent.init_state, tbench.init_state

        def rec(tag, fn):
            def init_state(xy, theta, *a):
                draws[tag].append((np.array(xy), np.array(theta)))
                return fn(xy, theta, *a)
            return init_state

        mp.setattr(jagent, "init_state", rec("jax", j_init))
        mp.setattr(tbench, "init_state", rec("torch", t_init))
        for n in (1, 2):
            _clear_caches()
            draws["jax"].clear()
            draws["torch"].clear()
            j = jbench.run_bench(n, **SMALL)
            t = tbench.run_bench(n, device="cpu", **SMALL)
            out[n] = (j, t, list(draws["jax"]), list(draws["torch"]))
    _clear_caches()
    return out


@pytest.mark.parametrize("config_n", [1, 2])
def test_trial_draws_equal_jax(runs, config_n):
    """The headline trials and the exact gate's, draw for draw."""
    _, _, jd, td = runs[config_n]
    assert len(jd) == len(td) == 2
    for (jxy, jth), (txy, tth) in zip(jd, td):
        np.testing.assert_array_equal(txy, jxy)
        np.testing.assert_array_equal(tth, jth)


@pytest.mark.parametrize("config_n", [1, 2])
@pytest.mark.parametrize("field", ["success_rate", "exact_recall_ref", "max_steps",
                                   "library_views"])
def test_run_bench_matches_jax(runs, config_n, field):
    """Success rate and exact reference within 1/B (one agent), step budget
    and library size equal. (The verdicts are not compared: config 2's band,
    0.010, is less than one agent in 16.)"""
    j, t, _, _ = runs[config_n]
    if isinstance(j[field], int):
        assert t[field] == j[field]
    else:
        assert abs(t[field] - j[field]) <= 1.0 / SMALL["batch"] + 1e-9


def test_headline_line_keys(runs):
    """The port's line holds every key of the JAX line, and its own: the
    card, the first call, the launch counts; ``vs_baseline`` null."""
    j, t, _, _ = runs[1]
    assert set(j) <= set(t)
    # bench.py adds "gate" and "land_kind" only to some lines
    assert _jax_return_keys("run_bench") - {"gate", "land_kind"} <= set(t)
    assert t["device"] == "cpu" and t["card"] is None and t["vs_baseline"] is None
    assert t["first_call_s"] > 0 and t["chain"] >= 1
    assert set(t["launches"]) == {"window_gather", "render", "render_pooled", "min_distance",
                                  "min_distance_pooled", "lag_fam", "decide"}
    assert isinstance(t["ok"], bool)
    json.dumps(t)


# --- the line contract ------------------------------------------------------

@pytest.mark.parametrize("line,valid", [
    ({"metric": "m", "value": 1.0}, False),
    ({"metric": "m", "ok": True, "gate": "x"}, False),
    ({"ok": False}, True),
    ({"gate": "skipped: reason"}, True),
])
def test_line_invariant(line, valid):
    """Exactly one of ``ok`` or ``gate``, in both packages alike."""
    if valid:
        assert tbench.check_line_invariant(line) == jbench.check_line_invariant(line) == line
    else:
        for mod in (tbench, jbench):
            with pytest.raises(ValueError, match="exactly one of ok/gate"):
                mod.check_line_invariant(line)


@pytest.mark.parametrize("config_n,kw,marker", [
    (1, dict(gated=False), "skipped: recall gating needs a population (B < 64)"),
    (5, {}, "skipped: no accuracy band for config 5"),
    (1, dict(impl="infomax"), "skipped: infomax is a different memory model"),
])
def test_gate_markers(config_n, kw, marker):
    """The ungated latency line, config 5 and infomax carry the JAX markers
    and no verdict; infomax keeps its exact reference and floor."""
    line = tbench.run_bench(config_n, device="cpu", **TINY, **kw)
    assert "ok" not in line
    assert line["gate"] == marker
    assert ("exact_recall_ref" in line) == (kw.get("impl") == "infomax")
    json.dumps(line)


def test_error_line_and_nonzero_exit(capsys):
    """An exception becomes one parseable error line on stdout and exit 1."""
    with pytest.raises(SystemExit) as e:
        tbench.main(ACCEPTANCE + ["--land-kind", "nonsense", "--device", "cpu"])
    assert e.value.code == 1
    out = capsys.readouterr()
    lines = out.out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["ok"] is False and rec["value"] is None
    assert rec["metric"] == "agent-steps/sec/chip"
    assert rec["error"].startswith("exception: ValueError")
    assert "Traceback" in out.err
    tbench.check_line_invariant(rec)
    assert set(json.loads(jbench._error_line("x"))) <= set(rec)


def test_watchdog_prints_error_line_and_exits_nonzero():
    code = ("import time\nfrom navdv_torch import bench\n"
            "bench._arm_watchdog(0.5, 'test')\ntime.sleep(60)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env=dict(os.environ, PYTHONPATH=REPO,
                                                          OMP_NUM_THREADS="1"))
    assert out.returncode == 1
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["error"] == "bench_budget_exceeded" and rec["ok"] is False
    assert rec["context"] == "test"


@pytest.mark.parametrize("device_args,ok_lines", [(["--device", "cpu"], 1), ([], 0)])
def test_cli_bench_command(device_args, ok_lines):
    """With ``--device cpu``: rc 0 and exactly one line, with ``ok`` or
    ``gate``. Without it on a host with no visible CUDA device: non-zero,
    and no line at all (the device is resolved before any line)."""
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", "navdv_torch.cli", "bench", *ACCEPTANCE,
                          *device_args], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    lines = out.stdout.strip().splitlines()
    if ok_lines:
        assert out.returncode == 0, out.stderr
        assert len(lines) == 1
        rec = json.loads(lines[0])
        assert ("ok" in rec) != ("gate" in rec)
    else:
        assert out.returncode != 0
        assert not [ln for ln in lines if '"ok"' in ln]
        assert "no CUDA device" in out.stderr


def test_setup_cache_dedups_identical_workloads():
    """Config 4 is config 1's workload: the same trained world and statics."""
    tbench._SETUP_CACHE.clear()
    k1, v1 = tbench._setup_trained(1, 8, 20.0, 6, "blobs", "cpu")
    k4, v4 = tbench._setup_trained(4, 8, 20.0, 6, "blobs", "cpu")
    assert k1 == k4 and v1 is v4
    assert len(tbench._SETUP_CACHE) == 1
    k2, v2 = tbench._setup_trained(2, 8, 20.0, 6, "blobs", "cpu")
    assert k2 != k1 and v2 is not v1
    tbench._SETUP_CACHE.clear()


@pytest.mark.parametrize("name", ["SPEC_VIEWS", "SPEC_BATCH", "SPEC_IMPL", "ACCURACY_BAND",
                                  "GATE_BATCH"])
def test_constants_equal_jax(name):
    assert getattr(tbench, name) == getattr(jbench, name)


def test_spec_impl_mirrors_both_baseline_fam_impl():
    for n, impl in tbench.SPEC_IMPL.items():
        assert impl == t_baseline_fam_impl(n) == j_baseline_fam_impl(n), n


# --- the --all gates ----------------------------------------------------------

GATES = {
    "pallas_ssd": ("run_pallas_gate", "pallas_parity_gate",
                   lambda: tbench.run_pallas_gate(batch=8, n_sample=4, device="cpu")),
    "pallas_ncc": ("run_pallas_gate", "pallas_parity_gate",
                   lambda: tbench.run_pallas_gate(config_n=3, batch=4, n_sample=2,
                                                  device="cpu")),
    "sector": ("run_sector_gate", "sector_parity_gate",
               lambda: tbench.run_sector_gate(device="cpu")),
    "fft": ("run_fam_precision_gate", "fft_precision_gate",
            lambda: tbench.run_fam_precision_gate("fft", batch=8, n_sample=4, device="cpu")),
    "roll": ("run_fam_precision_gate", "roll_precision_gate",
             lambda: tbench.run_fam_precision_gate("roll", batch=4, n_sample=2, device="cpu")),
    "big_landscape": ("run_big_landscape", "big_landscape_dma",
                      lambda: tbench.run_big_landscape(size=1536, batch=8, repeats=1,
                                                       min_window_s=0.01, device="cpu")),
}


@pytest.mark.parametrize("gate", list(GATES))
def test_all_gate_line(gate):
    """Each gate at a small size on the CPU: the JAX metric name, every key
    of the JAX line, and ``ok`` true."""
    jax_fn, metric, run = GATES[gate]
    line = run()
    assert line["metric"] == metric
    assert _jax_return_keys(jax_fn) <= set(line), _jax_return_keys(jax_fn) - set(line)
    assert line["ok"] is True, line
    assert line["device"] == "cpu" and "card" in line and "launches" in line
    json.dumps(tbench.check_line_invariant(line))


# --- the command line -----------------------------------------------------------

def _stub_bench(monkeypatch, mod, calls):
    monkeypatch.setattr(mod, "run_bench",
                        lambda n, **kw: calls.append(("bench", n, kw)) or {"n": n, "ok": True})
    monkeypatch.setattr(mod, "run_pallas_gate",
                        lambda **kw: calls.append(("pallas", kw)) or {"g": 1, "ok": True})
    monkeypatch.setattr(mod, "run_sector_gate",
                        lambda **kw: calls.append(("sector",)) or {"g": 2, "ok": True})
    monkeypatch.setattr(mod, "run_fam_precision_gate",
                        lambda impl, **kw: calls.append(("fam_prec", impl)) or {"g": impl,
                                                                                 "ok": True})


def test_cli_bench_arg_parity(monkeypatch, capsys):
    """``cli bench`` forwards every knob, and ``--all`` runs the JAX CLI's
    sequence with the same arguments, the device added."""
    calls, jcalls = [], []
    _stub_bench(monkeypatch, tbench, calls)
    _stub_bench(monkeypatch, jbench, jcalls)
    tcli.main(["bench", "--config", "2", "--batch", "64", "--steps", "7", "--views", "21",
               "--route-length", "55", "--repeats", "2", "--impl", "roll", "--device", "cpu"])
    kind, n, kw = calls[0]
    assert (kind, n) == ("bench", 2)
    assert kw == dict(batch=64, steps=7, impl="roll", repeats=2, views=21, route_length=55.0,
                      land_kind="blobs", device=CPU)
    capsys.readouterr()

    calls.clear()
    tcli.main(["bench", "--all", "--device", "cpu"])
    jcli.main(["bench", "--all"])
    assert [c[0] for c in calls] == [c[0] for c in jcalls] == (
        ["bench"] * 7 + ["pallas", "pallas", "sector", "fam_prec", "fam_prec"])
    for c, jc in zip(calls, jcalls):
        if c[0] == "bench":
            assert c[1] == jc[1]
            assert {k: v for k, v in c[2].items() if k != "device"} == jc[2]
            assert c[2]["device"] == CPU
        elif c[0] == "pallas":
            assert {k: v for k, v in c[1].items() if k != "device"} == jc[1]
        else:
            assert c[1:] == jc[1:]
    assert [json.loads(ln)["ok"] for ln in capsys.readouterr().out.split("\n") if ln] == (
        [True] * 12 + [True] * 12)


def test_cli_bench_all_refuses_a_config(capsys):
    with pytest.raises(SystemExit) as e:
        tcli.main(["bench", "--all", "--config", "2", "--device", "cpu"])
    assert e.value.code == 2
    assert "--all runs configs 1-4" in capsys.readouterr().err


def test_bench_imports_neither_jax_nor_the_jax_bench():
    """``navdv_torch.bench`` and the CLI import no JAX, no ``navdv_tpu`` and
    not the repo-root ``bench``: in their source, and in a fresh
    interpreter."""
    for name in ("bench.py", "cli.py"):
        tree = ast.parse(open(os.path.join(REPO, "navdv_torch", name)).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                assert not [a.name for a in node.names if a.name.split(".")[0] in (
                    "bench", "jax", "navdv_tpu")], name
            elif isinstance(node, ast.ImportFrom):
                assert (node.module or "").split(".")[0] not in ("bench", "jax", "navdv_tpu")
    code = ("import sys, navdv_torch.bench, navdv_torch.cli\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'navdv_tpu', 'bench'))\nprint(bad)\nsys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stdout + out.stderr


def test_exact_reference_is_the_kernel_path(monkeypatch):
    """The gate's reference runs ``"kernel"`` with the approximation knobs
    cleared, on ``min(batch, GATE_BATCH)`` trials, and releases its run."""
    seen, released = [], []
    real_run, real_init = tbench.make_navigate_batch, tbench.init_state

    def spy_run(cfg, fam_impl="kernel", **kw):
        seen.append((cfg, fam_impl))
        run = real_run(cfg, fam_impl, **kw)
        run.release = lambda: released.append(True)
        return run

    def spy_init(xy, theta, *a):
        seen.append(len(xy))
        return real_init(xy, theta, *a)

    monkeypatch.setattr(tbench, "make_navigate_batch", spy_run)
    monkeypatch.setattr(tbench, "init_state", spy_init)
    cfg, land, route, pts, hd = tbench._setup(1, 8, 20.0, 6)
    st = tbench.make_statics(land, tbench.train_library(land, route, cfg, device="cpu"), route,
                             "cpu")
    tbench._exact_recall_ref(cfg, st, pts, hd, 300, "cpu")
    (ref_cfg, impl), b = seen
    assert impl == "kernel" and b == tbench.GATE_BATCH and released == [True]
    assert cfg.scan.spectral_cutoff != 0
    assert ref_cfg == dataclasses.replace(cfg, scan=dataclasses.replace(
        cfg.scan, spectral_cutoff=0, fused_dft_precision="off", roll_rank=0,
        fixed_point_bits=0))
