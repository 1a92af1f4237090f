"""The trace's arithmetic and the per-layer readers on a synthetic event
list, and the work counts against the kernel table's bounds."""

from __future__ import annotations

import math

import pytest

from fixture import ROOT
from harness import work
from harness.cells import find_cell, load_reader
from harness.trace import SPAN, Trace

CONFIG4 = find_cell("fft_lib50_b1024").config["sim"]
CONFIG2 = find_cell("roll_lib500_b512").config["sim"]


def synthetic(context=None) -> Trace:
    """Two 100 us spans; kernels at 10-30 (render), 20-40 (overlapping, a
    double kernel), 50-60 (a dgemm), 120-150 (an NCCL all-reduce), a copy at
    160-170 and a set at 185-190, all in us; the host in cudaGraphLaunch at
    82-118, inside the 60-120 gap."""
    device = [
        ("render_kernel", "kernel", 10.0, 30.0),
        ("void at::native::reduce_kernel<MinOps<double> >", "kernel", 20.0, 40.0),
        ("sm90_xmma_dgemm_f64f64_nn", "kernel", 50.0, 60.0),
        ("ncclDevKernel_AllReduce_Min_f32_RING_LL", "kernel", 120.0, 150.0),
        ("Memcpy DtoD", "gpu_memcpy", 160.0, 170.0),
        ("Memset", "gpu_memset", 185.0, 190.0),
    ]
    host = [("aten::copy_", 70.0, 80.0), ("cudaGraphLaunch", 82.0, 118.0),
            ("aten::item", 171.0, 184.0)]
    ctx = context or {"batch": 1024, "sensor": CONFIG4["sensor"], "scan": CONFIG4["scan"],
                      "views_per_rank": 50}
    return Trace(device=device, spans=[(0.0, 100.0), (100.0, 200.0)], host_ops=host,
                 steps=4, context=ctx)


def test_busy_idle_and_counts():
    t = synthetic()
    assert t.window_s == pytest.approx(200e-6)
    # union: 10-40, 50-60, 120-150, 160-170, 185-190 -> 85 us
    assert t.busy_s() == pytest.approx(85e-6)
    assert t.time_s("render_kernel") == pytest.approx(20e-6)
    assert t.count() == 4 and t.count(kinds=("kernel", "gpu_memcpy", "gpu_memset")) == 6
    assert [name for name, _ in t.top_ops(3)] == [
        "ncclDevKernel_AllReduce_Min_f32_RING_LL", "render_kernel",
        "void at::native::reduce_kernel<MinOps<double> >"]


def test_idle_gaps_are_named_by_the_host():
    t = synthetic()
    assert t.launch_stall_s() == pytest.approx(36e-6)
    gaps = t.idle_gaps(3)  # the 60 us gap sits in the profiler's launch stall
    assert [round(s * 1e6, 6) for _, s in gaps] == [15.0, 10.0, 10.0]
    assert gaps[0][0] == f"{SPAN}/aten::item" and gaps[1][0] == SPAN


def test_readers_on_the_synthetic_trace():
    t = synthetic()

    def read(name):
        return load_reader(ROOT, name)(t)

    assert read("device_idle_share.batch") == pytest.approx(1 - 85 / (200 - 36))
    assert read("device_idle_share.trial") == pytest.approx(1 - 85 / (200 - 36))
    assert read("device_ms_per_step.batch") == pytest.approx(85e-3 / 4)
    assert read("kernels_per_step.trial") == pytest.approx(4 / 4)
    assert read("fp64_ms_per_step.fft") == pytest.approx((20 + 10) * 1e-3 / 4)
    assert read("lib_min_allreduce_ms_per_step") == pytest.approx(30e-3 / 4)
    least = work.render_bytes(1024, CONFIG4["sensor"]) / work.HBM_BYTES_PER_S
    assert read("render_roofline") == pytest.approx(100 * least / 20e-6)
    t2 = synthetic({"batch": 512, "sensor": CONFIG2["sensor"], "scan": CONFIG2["scan"],
                    "views_per_rank": 500})
    flops = 4 * work.roll_product_flops(512, CONFIG2["sensor"], CONFIG2["scan"], 500)
    assert load_reader(ROOT, "roll_product_roofline")(t2) == pytest.approx(
        100 * flops / work.FP64_FLOP_PER_S / 10e-6)


def test_a_reader_with_nothing_to_read_returns_nothing():
    empty = Trace(device=[], spans=[(0.0, 10.0)], host_ops=[], steps=1, context={})
    for name in ("render_roofline", "roll_product_roofline", "fp64_ms_per_step.fft",
                 "lib_min_allreduce_ms_per_step"):
        assert load_reader(ROOT, name)(empty) is None


def test_work_counts_match_the_kernel_table():
    # render's bound at config 4 (B=1024): 0.00777 ms of bytes (PERF.md kernel table)
    ms = work.render_bytes(1024, CONFIG4["sensor"]) / work.HBM_BYTES_PER_S * 1e3
    assert round(ms, 5) == 0.00777
    # the rolled-library product at config 2: 70.8 GFLOP a step
    gflop = work.roll_product_flops(512, CONFIG2["sensor"], CONFIG2["scan"], 500) / 1e9
    assert math.isclose(gflop, 70.78, rel_tol=1e-3)
