"""The port's graft entry points (``navdv_torch/graft_entry.py``) against
the repo-root ``__graft_entry__.py``.

- ``_tiny_setup``: the same world, configuration and route as JAX's, and
  its library at the tolerance of ``test_train_library_matches_jax``
  (ROADMAP C.2);
- ``entry(device="cpu")``: the same starts as JAX ``entry()``, and one step
  from them on the JAX statics carried across gives the same chosen
  heading for all 8 agents, ``xy`` and ``theta`` within 1e-5 and the
  record's familiarity within rtol 1e-4; ``fn`` equals the eager step;
- ``dryrun_multichip(n, device="cpu")`` at n = 2 and 4: gloo ranks started
  as processes, every mesh passing the gate, the ok line with its meshes,
  and the rates of JAX ``dryrun_multichip(n)`` on the 8-device CPU mesh of
  ``tests/conftest.py``;
- the mesh list, the budget, a failed rank, no card, no JAX import.

Each test that starts ranks runs under its own budget
(``NAVDV_MULTICHIP_BUDGET_S``, RANK_BUDGET_S), which stops every rank and
raises when it runs out.
"""

import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import __graft_entry__ as jge
from navdv_torch import graft_entry as ge

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_BUDGET_S = 180  # a CPU gate takes ~5-10 s; this is each test's timeout
OK_MESH = re.compile(r"\(data=(\d+),lib=(\d+)\):rate=([\d.]+),fam_err=([\d.e+-]+)")


@pytest.fixture
def budget(monkeypatch):
    monkeypatch.setenv(ge.BUDGET_ENV, str(RANK_BUDGET_S))


@pytest.fixture(scope="module")
def jax_setup():
    return jge._tiny_setup()


def _carried_statics(jst):
    """The JAX entry's statics in the port (landscape and library as JAX
    built them), on the CPU."""
    from navdv_torch.convert import statics_from_numpy
    from navdv_tpu.routes import make_route

    route = make_route("line", size=(96, 96), margin=24.0, length=30.0)
    return statics_from_numpy(np.asarray(jst.landscape), jst.lib, route, "cpu")


def test_tiny_setup_matches_jax(jax_setup):
    from navdv_torch.convert import config_from

    jcfg, jst, jpts, jheadings = jax_setup
    cfg, st, pts, headings = ge._tiny_setup(device="cpu")
    assert cfg == config_from(jcfg)
    np.testing.assert_array_equal(pts, jpts)
    np.testing.assert_array_equal(headings, jheadings)
    np.testing.assert_array_equal(st.landscape.numpy(), np.asarray(jst.landscape))
    for name in ("route_a", "route_ab", "route_denom", "goal"):
        np.testing.assert_allclose(getattr(st, name).numpy(), np.asarray(getattr(jst, name)),
                                   rtol=1e-6, err_msg=name)
    got, want = st.lib, jst.lib
    assert got.views.shape == want.views.shape
    for name in ("views", "flat", "valid"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   atol=1e-5, err_msg=name)
    np.testing.assert_allclose(got.sq.numpy(), np.asarray(want.sq), rtol=1e-5)
    # C.2: z magnifies view differences by 1/std; compare it as v - mean
    std = np.asarray(want.flat).std(axis=1, keepdims=True)
    np.testing.assert_allclose(got.z.numpy() * std, np.asarray(want.z) * std, atol=1e-5)


def test_entry_step_matches_jax(jax_setup):
    import jax

    from navdv_tpu.agent import make_step

    jcfg, jst, _, _ = jax_setup
    jfn, (js0, _) = jge.entry()
    jnew = jax.jit(jfn)(js0, jst)
    _, jrec = jax.vmap(make_step(jcfg), in_axes=(0, None))(js0, jst)

    fn, (s0, _) = ge.entry(device="cpu")
    for name in ("xy", "theta", "done", "status"):
        np.testing.assert_array_equal(getattr(s0, name).numpy(), np.asarray(getattr(js0, name)),
                                      err_msg=f"states0.{name}")
    st = _carried_statics(jst)
    new = fn(s0, st)
    _, rec = fn.step(s0, st)

    k, jk = rec.k.numpy(), np.asarray(jrec.k)
    differ = np.flatnonzero(k != jk)
    # a tie that C.1's fp64 sums break otherwise than JAX's fp32 shows here
    assert differ.size == 0, (
        f"agents {differ.tolist()} chose heading {k[differ].tolist()} in the port, "
        f"{jk[differ].tolist()} in JAX (fam {rec.fam.numpy()[differ].tolist()} vs "
        f"{np.asarray(jrec.fam)[differ].tolist()})")
    np.testing.assert_allclose(new.xy.numpy(), np.asarray(jnew.xy), atol=1e-5)
    np.testing.assert_allclose(new.theta.numpy(), np.asarray(jnew.theta), atol=1e-5)
    # JAX sums |c|^2 - 2 c.l + |l|^2 in f32 and the port in fp64 (C.1): at
    # fam ~0.01 against |l|^2 ~20 the f32 sums' rounding steps, not rtol,
    # set the gap (2.6e-6 here), so 4 of them at the largest |l|^2 join rtol
    atol = 4 * np.finfo(np.float32).eps * float(np.asarray(jst.lib.sq).max())
    np.testing.assert_allclose(rec.fam.numpy(), np.asarray(jrec.fam), rtol=1e-4, atol=atol)
    np.testing.assert_array_equal(new.status.numpy(), np.asarray(jnew.status))


def test_entry_fn_is_the_eager_step():
    fn, (s0, st) = ge.entry(device="cpu")
    assert not fn.captured  # no graph on the CPU: a direct call
    assert s0.xy.shape == (ge.BATCH, 2)
    new = fn(s0, st)
    for got, eager, stepped in zip(new, fn.eager(s0, st), fn.step(s0, st)[0]):
        assert torch.equal(got, eager) and torch.equal(got, stepped)
    assert not torch.equal(new.xy, s0.xy)  # the agents moved
    again = fn(s0, st)
    assert all(torch.equal(a, b) for a, b in zip(new, again))
    fn.release()


@pytest.mark.parametrize("n", [1, 2, 6, 8])
def test_mesh_shapes_match_jax(n):
    want = [(n // n_lib, n_lib) for n_lib in (1, 2, 4) if n % n_lib == 0 and n >= n_lib]
    assert ge.mesh_shapes(n) == want


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_on_cpu(n, budget, capsys):
    summary = ge.dryrun_multichip(n, device="cpu")
    out = capsys.readouterr().out
    lines = out.splitlines()
    assert lines[-1].startswith("dryrun_multichip ok: impl=fft ")
    shapes = ge.mesh_shapes(n)
    b = 2 * max(d for d, _ in shapes)
    assert f"batch={b} steps={ge.DRYRUN_STEPS} " in lines[-1]
    assert [(int(d), int(l)) for d, l, _, _ in OK_MESH.findall(lines[-1])] == shapes
    assert lines[-1].count("device=cpu,backend=gloo,captured=False") == len(shapes)
    for (d, l) in shapes:
        assert f"mesh (data={d}, lib={l}): capture + episode" in out
    assert [ln for ln in lines if ln.startswith(ge.PREFIX)][-1].endswith("ranks finished ok")

    assert summary["ranks"] == n and summary["backend"] == "gloo"
    assert summary["rank_devices"] == ["cpu"] * n
    for m, (d, l) in zip(summary["meshes"], shapes):
        assert (m["n_data"], m["n_lib"]) == (d, l)
        assert m["rate"] >= summary["unsharded_rate"] - 1.0 / b
        assert m["fam_err"] <= 1e-4  # each rank held rtol 1e-4 / atol 1e-5
        # two episodes per mesh, one MIN a step on lib meshes
        assert m["lib_pmin"] == [2 * ge.DRYRUN_STEPS if l > 1 else 0] * n
        assert m["captured"] == [False] * n


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_rates_match_jax(n, budget, capsys):
    """The port's gate against JAX ``dryrun_multichip(n)`` on the same
    world and starts: the unsharded and every mesh's recall within 1/B."""
    jge.dryrun_multichip(n)
    jline = capsys.readouterr().out.splitlines()[-1]
    summary = ge.dryrun_multichip(n, device="cpu")
    b = summary["batch"]
    assert f"batch={b} steps={summary['steps']}" in jline
    jrate = float(re.search(r"unsharded_rate=([\d.]+)", jline).group(1))
    assert abs(summary["unsharded_rate"] - jrate) <= 1.0 / b + 0.005  # the line's 2 decimals
    jmeshes = OK_MESH.findall(jline)
    assert [(int(d), int(l)) for d, l, _, _ in jmeshes] == ge.mesh_shapes(n)
    for m, (_, _, rate, _) in zip(summary["meshes"], jmeshes):
        assert abs(m["rate"] - float(rate)) <= 1.0 / b + 0.005


def test_budget_raises_naming_it(monkeypatch):
    monkeypatch.setenv(ge.BUDGET_ENV, "2")
    with pytest.raises(RuntimeError, match=rf"{ge.BUDGET_ENV}=2\): the 2 ranks exceeded their "
                       r"2s budget; last seen: "):
        ge.dryrun_multichip(2, device="cpu")


def test_a_failed_rank_raises_naming_it(tmp_path):
    # no spec.json in the run directory: every rank fails at once
    with pytest.raises(RuntimeError, match=r"rank \d of 2 exited 1(.|\n)*FileNotFoundError"):
        ge._launch(tmp_path, 2, RANK_BUDGET_S)


def test_no_card_raises_before_any_rank(monkeypatch):
    def no_rank(*args, **kwargs):
        raise AssertionError("a rank was started")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(ge, "launch_ranks", no_rank)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ge.entry()
    for backend in (None, "gloo", "nccl"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ge.dryrun_multichip(2, backend=backend)
    with pytest.raises(ValueError, match="use gloo"):
        ge.dryrun_multichip(2, device="cpu", backend="nccl")


@pytest.mark.parametrize("args", [["step"], ["dryrun", "2"]])
def test_cli_without_a_card_exits_non_zero(args):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-m", "navdv_torch.graft_entry", *args], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert "ok" not in proc.stdout and "entry" not in proc.stdout


def test_cli_step_on_cpu():
    proc = subprocess.run([sys.executable, "-m", "navdv_torch.graft_entry", "step", "--device",
                           "cpu"], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    import json

    line = json.loads(proc.stdout.splitlines()[-1])
    fn, (s0, st) = ge.entry(device="cpu")
    new = fn(s0, st)
    assert line["batch"] == ge.BATCH and line["device"] == "cpu" and not line["captured"]
    np.testing.assert_array_equal(np.asarray(line["xy"], np.float32), new.xy.numpy())


def test_module_imports_no_jax():
    code = ("import sys, navdv_torch.graft_entry; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'navdv_tpu', "
            "'__graft_entry__'))]; print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_tiny_setup_takes_a_config_and_budget():
    cfg, _, _, _ = ge._tiny_setup(max_steps=ge.DRYRUN_STEPS, device="cpu")
    assert cfg.agent.max_steps == ge.DRYRUN_STEPS
    other = dataclasses.replace(cfg, capture_spacing=3.0)
    assert ge._tiny_setup(other, device="cpu")[0] is other
