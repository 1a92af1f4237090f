"""``navdv_torch.utils.profiling`` (counterpart of the JAX package's
``utils/profiling.py``) on a small episode on the CPU: ``trace`` writes a
Chrome trace, ``top_ops`` ranks operations by self time from the profile
and from the trace's directory."""

import os

import numpy as np
import pytest

from navdv_torch import make_navigate_batch, train_library
from navdv_torch.agent import init_state, make_statics
from navdv_torch.convert import config_from
from navdv_torch.utils.profiling import top_ops, trace


@pytest.fixture(scope="module")
def traced(small_cfg, small_world, tmp_path_factory):
    land, route = small_world
    cfg = config_from(small_cfg)
    st = make_statics(land, train_library(land, route, cfg, device="cpu"), route, device="cpu")
    states = init_state(np.full((4, 2), 64.0), np.zeros(4), device="cpu")
    run = make_navigate_batch(cfg, "kernel", device="cpu")
    log_dir = str(tmp_path_factory.mktemp("trace"))
    with trace(log_dir) as prof:
        run(states, st)
    return prof, log_dir, cfg.agent.max_steps


@pytest.mark.parametrize("source", ["profile", "directory"])
def test_top_ops_sorted_by_self_time(traced, source):
    prof, log_dir, _ = traced
    rows = top_ops(prof if source == "profile" else log_dir, n=10, device="cpu")
    assert len(rows) == 10
    times = [r["self_us"] for r in rows]
    assert times == sorted(times, reverse=True) and times[-1] >= 0.0
    assert all(set(r) == {"self_us", "op", "count"} and r["count"] >= 1 for r in rows)
    assert any(r["op"].startswith("aten::") for r in rows)


def test_profile_and_trace_agree(traced):
    """The Chrome trace holds the operators the profile does, with the same
    self time on the ones the episode spends most in."""
    prof, log_dir, _ = traced
    from_prof = {r["op"]: r["self_us"] for r in top_ops(prof, n=None, device="cpu")}
    from_dir = {r["op"]: r["self_us"] for r in top_ops(log_dir, n=None, device="cpu")}
    for r in top_ops(prof, n=5, device="cpu"):
        assert from_dir[r["op"]] == pytest.approx(from_prof[r["op"]], rel=0.05, abs=50.0)


def test_divisor_and_the_full_table(traced):
    prof, _, steps = traced
    rows = top_ops(prof, n=None, device="cpu")
    per_step = top_ops(prof, n=None, divisor=steps, device="cpu")
    assert len(rows) > 10
    np.testing.assert_allclose([r["self_us"] / steps for r in rows],
                               [r["self_us"] for r in per_step])


def test_top_ops_refuses_what_the_profile_lacks(traced, tmp_path):
    prof, _, _ = traced
    with pytest.raises(ValueError, match="no cuda time"):
        top_ops(prof)  # a CPU run has no device time to rank
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        top_ops(prof, device="tpu")
    with pytest.raises(FileNotFoundError):
        top_ops(str(tmp_path), device="cpu")
    assert os.listdir(traced[1])[0].endswith(".json")
