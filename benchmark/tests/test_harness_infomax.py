"""The Infomax learned memory judged by its plain reference
(``reference/infomax.py``): a CPU-sized infomax cell made of new files runs
through ``drive.run_single`` and is correct, with its control read above it,
a program whose network is rounded to bfloat16 is not, and the cell's two
readers read the product and the rest of the step from a trace."""

from __future__ import annotations

import pytest

from fixture import ROOT, TINY, make_checkout  # puts the harness and the program on the path

import navdv_torch.familiarity_infomax as familiarity_infomax
from harness import drive
from harness.cells import find_cell, load_reader
from harness.trace import Trace
from test_harness_trace import synthetic

INFOMAX_TINY = dict(
    TINY, what="the infomax cell's shape at a CPU size", fam_impl="infomax",
    fam_impl_arg="infomax", familiarity="infomax", reference="infomax",
    sim=dict(TINY["sim"], scan=dict(TINY["sim"]["scan"], infomax_units=0, infomax_eta=0.1,
                                    infomax_epochs=0, infomax_seed=0)),
    limits=find_cell("infomax_lib50_b1024").config["limits"])
CONFIG = find_cell("infomax_lib50_b1024").config["sim"]


def _bf16_network(monkeypatch):
    real = familiarity_infomax.train_infomax

    def train(*args, **kw):
        pack = real(*args, **kw)
        w = pack.w.bfloat16().float()
        return familiarity_infomax.InfomaxPack(w=w, wsum=w.sum(dim=1))

    monkeypatch.setattr(familiarity_infomax, "train_infomax", train)


@pytest.mark.parametrize("fault", [None, _bf16_network])
def test_an_infomax_run_is_judged_by_its_reference(fault, tmp_path, monkeypatch):
    cell = find_cell("fixture_cell", make_checkout(tmp_path, config=INFOMAX_TINY))
    if fault is not None:
        fault(monkeypatch)
    result = drive.run_single(cell, 2**31 + 57, 0.3, False, "cpu", 0.0, lambda: None,
                              control=fault is None)
    n, limits = result["numbers"], cell.config["limits"]
    assert n["lib_err"] == 0 and n["pose_mismatch"] == 0 and n["status_mismatch"] == 0
    if fault is None:
        assert result["correct"], result["checks"]
        # the control, the reference's own W with the product's inputs rounded
        # to TF32, reads above the program; that it fails the limits is held
        # at the configuration's own width by test_harness_control.py (at this
        # sensor's 96 pixels a TF32 product rounds less)
        assert n["fam_err_control"] > n["fam_err"]
    else:
        assert not result["correct"]
        assert n["fam_err"] > limits["fam_err"]


def test_the_infomax_readers_on_a_synthetic_trace():
    ctx = {"batch": 1024, "sensor": CONFIG["sensor"], "scan": CONFIG["scan"],
           "views_per_rank": 50}
    t = synthetic(ctx)  # one 10 us fp64 gemm, 85 us busy, 4 steps

    def read(name, trace=t):
        return load_reader(ROOT, name)(trace)

    # 2 B L P M: 1024 agents, 60 lags, P = M = 1152
    flops = 4 * 2.0 * 1024 * 60 * 1152 * 1152
    assert read("infomax_product_roofline") == pytest.approx(100 * flops / 67e12 / 10e-6)
    assert read("nonproduct_ms_per_step.infomax") == pytest.approx((85 - 10) * 1e-3 / 4)
    no_gemm = Trace(device=[d for d in t.device if "gemm" not in d[0]], spans=t.spans,
                    host_ops=t.host_ops, steps=t.steps, context=ctx)
    assert read("infomax_product_roofline", no_gemm) is None
    assert read("nonproduct_ms_per_step.infomax", no_gemm) is None
