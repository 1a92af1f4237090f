"""A run with the timed path broken underneath comes out not correct: once
for each fault the cells can have. The faults of early exit run on the
fixture cell under :data:`fixture.ANYWHERE` traffic (agents started along
the whole route, each batch stopped once every agent is done)."""

from __future__ import annotations

import json
import subprocess
import sys
import time

import pytest
import torch

import navdv_torch.agent as agent
from fixture import ANYWHERE, BENCH, EXIT_TINY, ROOT, make_checkout
from harness import drive
from harness.cells import find_cell
from navdv_torch.agent import EXIT_CHUNK, STATUS_REACHED, STATUS_RUNNING
from navdv_torch.simulator import NavigationResult, NavigationSimulator


def _state_unchanged(monkeypatch):
    real = agent._make_decide

    def make(cfg, device):
        decide = real(cfg, device)

        def broken(state, fam, st):
            _, rec = decide(state, fam, st)
            return state, rec._replace(xy=state.xy, theta=state.theta)

        return broken

    monkeypatch.setattr(agent, "_make_decide", make)


def _answer_altered(monkeypatch):
    real = agent._make_decide

    def make(cfg, device):
        decide = real(cfg, device)

        def broken(state, fam, st):
            fam = fam.clone()
            fam[0] = -fam[0]  # agent 0 heads for its least familiar view
            return decide(state, fam, st)

        return broken

    monkeypatch.setattr(agent, "_make_decide", make)


def _half_batch(monkeypatch):
    real = NavigationSimulator.navigate

    def navigate(self, starts=None, headings=None, **kw):
        half = len(starts) // 2
        r = real(self, starts=starts[:half], headings=headings[:half])
        final = type(r.final_state)(*(torch.cat([x, x]) for x in r.final_state))
        rec = type(r.record)(*(torch.cat([x, x]) for x in r.record))
        return NavigationResult(r.success_rate, r.metrics, final, rec)

    monkeypatch.setattr(NavigationSimulator, "navigate", navigate)


def _early_exit(monkeypatch):
    """No fault: the program's early exit as it is."""


def _one_chunk_early(monkeypatch):
    """The early-exit loop stops one chunk of steps before every agent is
    done: the columns of that chunk left as padding, the final state the
    one after the last step run."""
    real = NavigationSimulator.navigate

    def navigate(self, **kw):
        r = real(self, **kw)
        rec, final = r.record, r.final_state
        ran = EXIT_CHUNK * ((int(r.metrics["n_steps"].max()) - 1) // EXIT_CHUNK)
        done = rec.done[:, ran].clone()
        for f in rec:
            f[:, ran:] = True if f.dtype == torch.bool else 0
        status = torch.where(done, final.status, torch.full_like(final.status, STATUS_RUNNING))
        final = final._replace(xy=rec.xy[:, ran - 1].clone(), theta=rec.theta[:, ran - 1].clone(),
                               done=done, status=status)
        rate = float((status == STATUS_REACHED).float().mean())
        return NavigationResult(rate, r.metrics, final, rec)

    monkeypatch.setattr(NavigationSimulator, "navigate", navigate)


EARLY_EXIT = (_early_exit, _one_chunk_early)


@pytest.mark.parametrize("fault", [None, _state_unchanged, _answer_altered, _half_batch,
                                   _early_exit, _one_chunk_early])
def test_a_broken_program_is_not_correct(fault, tmp_path, monkeypatch):
    if fault in EARLY_EXIT:
        root = make_checkout(tmp_path, config=EXIT_TINY, traffic=ANYWHERE)
    else:
        root = make_checkout(tmp_path)
    cell = find_cell("fixture_cell", root)
    if fault is not None:
        fault(monkeypatch)
    result = drive.run_single(cell, 31, 0.3, False, "cpu", 0.0, lambda: None)
    assert result["correct"] is (fault in (None, _early_exit)), result["checks"]
    if fault in EARLY_EXIT:  # the batches stopped before the step budget
        assert min(result["exit_columns"]) < cell.config["sim"]["agent"]["max_steps"]


def _mesh(root, fault: str, traced: int = 0) -> dict:
    argv = [sys.executable, str(BENCH / "tests" / "rank_child.py"), str(root), "fixture_mesh",
            "17", "0.3", str(traced), fault]
    code = ("import sys, time; sys.path[:0] = [sys.argv[1]]\n"
            "from harness import mesh\n"
            "sys.exit(mesh.launch(sys.argv[3:], 4, time.time(), budget_s=240, cwd=sys.argv[2]))")
    p = subprocess.run([sys.executable, "-c", code, str(BENCH), str(BENCH / "tests"), *argv],
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def test_the_mesh_run_and_the_exchange_left_out(tmp_path):
    root = make_checkout(tmp_path, mesh=[1, 4])
    sound = _mesh(root, "none")
    assert sound["correct"], sound["checks"]
    assert sound["checks"]["min_calls_off"]["value"] == 0
    assert sound["checks"]["rank_mismatch"]["value"] == 0
    traced = _mesh(root, "none", traced=1)
    assert traced["correct"], traced["checks"]
    assert "fixture_steps" in traced["metrics"]
    broken = _mesh(root, "no_exchange")
    assert not broken["correct"]
    assert broken["checks"]["min_calls_off"]["value"] > 0
    # each rank decides from its own shard's minima alone
    assert broken["checks"]["rank_mismatch"]["value"] > 0
