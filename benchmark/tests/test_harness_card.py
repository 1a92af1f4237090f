"""On the card: one short run of a one-card cell through the command,
untraced and traced (``python -m pytest benchmark/tests -m cuda``)."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from fixture import ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("traced", [0, 1])
def test_a_short_run_on_the_card(traced):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "fft_lib50_b1",
                        "--seed", str(2**33 + traced), "--seconds", "2", "--trace", str(traced)],
                       cwd=ROOT, capture_output=True, text=True, timeout=360)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    names = {"device_idle_share.trial", "kernels_per_step.trial"} if traced else {
        "trial_ms_p95", "setup_s"}
    assert set(line["metrics"]) == names
    if traced:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
