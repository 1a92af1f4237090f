"""The trace's arithmetic and the per-layer readers on a synthetic event
list, and the work counts against the kernel table's bounds."""

from __future__ import annotations

import math
import random

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


def test_the_sweeps_give_the_pairwise_readings():
    """``launch_stall_s`` and ``idle_gaps`` against their definitions, pair
    by pair, bit for bit, on a random trace with nested and overlapping
    host operators."""
    rng = random.Random(7)
    device, host, t = [], [], 0.0
    for _ in range(400):
        t += rng.choice([0.0, 0.5, 3.0, 40.0])
        d = rng.uniform(0.5, 30.0)
        device.append(("k", "kernel", t, t + d))
        t += d * rng.choice([0.3, 1.0])
    for _ in range(300):
        x = rng.uniform(0.0, t)
        host.append((rng.choice(["cudaGraphLaunch", "aten::item", "aten::copy_"]), x,
                     x + rng.uniform(0.1, 80.0)))
    tr = Trace(device=sorted(device, key=lambda d: d[2]), spans=[(0.0, t / 2), (t / 2, t)],
               host_ops=host, steps=1, context={})
    launches = [(x, y) for name, x, y in host if name == "cudaGraphLaunch"]
    assert tr.launch_stall_s() == sum(max(0.0, min(e, y) - max(s, x)) for s, e in tr._gaps()
                                      for x, y in launches) * 1e-6 > 0
    gaps = []
    for s, e in tr._gaps():
        mid = 0.5 * (s + e)
        ops = [(y - x, name) for name, x, y in host if x <= mid <= y]
        if ops and min(ops)[1] == "cudaGraphLaunch":
            continue
        gaps.append([SPAN + ("/" + min(ops)[1] if ops else ""), (e - s) * 1e-6])
    assert tr.idle_gaps(400) == sorted(gaps, key=lambda g: -g[1])


def early_exit_trace() -> Trace:
    """Two 300 us spans. The first, an early-exit episode: a copy in at
    5-10, then four chunks launched from the host at 15-19, 80-88, 160-165
    and 190-194, each chunk's kernels followed by the 1 us copy of its flag
    (20-61, 90-131, 170-201, 202-207), and a copy out at 210-220. The host
    reads the first two flags in syncs that return at 62 and 133, and
    launches the fourth chunk without a read; after the second read it is
    in the profiler's buffer flush at 135-150 and buffer request at
    140-145, and in another request at 170-180, after the third launch.
    The second, a whole-episode graph launched at 305-310 that runs
    310-400, read at 300-401."""
    device = [
        ("Memcpy HtoD", "gpu_memcpy", 5.0, 10.0),
        ("render_kernel", "kernel", 20.0, 40.0),
        ("decide_kernel", "kernel", 41.0, 60.0),
        ("Memcpy DtoH", "gpu_memcpy", 60.0, 61.0),
        ("render_kernel", "kernel", 90.0, 130.0),
        ("Memcpy DtoH", "gpu_memcpy", 130.0, 131.0),
        ("render_kernel", "kernel", 170.0, 200.0),
        ("Memcpy DtoH", "gpu_memcpy", 200.0, 201.0),
        ("render_kernel", "kernel", 202.0, 206.0),
        ("Memcpy DtoH", "gpu_memcpy", 206.0, 207.0),
        ("Memcpy DtoH", "gpu_memcpy", 210.0, 220.0),
        ("render_kernel", "kernel", 310.0, 400.0),
    ]
    host = [("cudaMemcpyAsync", 3.0, 4.0), ("cudaGraphLaunch", 15.0, 19.0),
            ("aten::item", 50.0, 79.0), ("cudaMemcpyAsync", 50.0, 51.0),
            ("cudaStreamSynchronize", 51.0, 62.0), ("cudaGraphLaunch", 80.0, 88.0),
            ("cudaStreamSynchronize", 100.0, 133.0), ("Buffer Flush", 135.0, 150.0),
            ("Activity Buffer Request", 140.0, 145.0), ("cudaGraphLaunch", 160.0, 165.0),
            ("Activity Buffer Request", 170.0, 180.0), ("cudaGraphLaunch", 190.0, 194.0),
            ("cudaGraphLaunch", 305.0, 310.0), ("cudaStreamSynchronize", 311.0, 401.0)]
    return Trace(device=device, spans=[(0.0, 300.0), (300.0, 600.0)], host_ops=host,
                 steps=2 * 66, context={})


def test_graph_launches_per_episode():
    read = load_reader(ROOT, "graph_launches_per_episode.anywhere")
    assert read(early_exit_trace()) == pytest.approx(5 / 2)
    # one launch in the first of two spans; none outside them counts
    assert read(synthetic()) == pytest.approx(1 / 2)
    outside = early_exit_trace()
    outside.host_ops.append(("cudaGraphLaunch", 700.0, 705.0))
    assert read(outside) == pytest.approx(5 / 2)
    assert [len(s) for s in outside.span_launches()] == [4, 1]


def test_exit_wait_ms_per_episode():
    read = load_reader(ROOT, "exit_wait_ms_per_episode.anywhere")
    # the second launch turns round from the sync's return at 62 (18 us),
    # the third from 133 less the profiler's 135-150 (12 us), the fourth
    # read nothing: the median of 18, 12 and 0 us times 3 reads over 2
    # episodes; the first launch and the second span's one are no reads
    assert read(early_exit_trace()) == pytest.approx(12 * 3 / 2 * 1e-3)
    # without the profiler's work the third read turns round in 27 us
    quiet = early_exit_trace()
    quiet.host_ops = [h for h in quiet.host_ops if h[0] not in ("Buffer Flush",
                                                               "Activity Buffer Request")]
    assert read(quiet) == pytest.approx(18 * 3 / 2 * 1e-3)
    # host times only: the device's clock shifted against the host's, by
    # a constant or a drift, leaves the reading as it was
    for shift in (lambda t: t + 500.0, lambda t: t - 40.0, lambda t: 1.001 * t - 30.0):
        skewed = early_exit_trace()
        skewed.device = [(n, k, shift(a), shift(b)) for n, k, a, b in skewed.device]
        assert read(skewed) == pytest.approx(12 * 3 / 2 * 1e-3)
    # one read held up for 2 ms among four of 20 us leaves it at 20 us a read
    device, host, t = [], [], 0.0
    for wait in (20.0, 20.0, 2000.0, 20.0, 20.0):
        host += [("cudaGraphLaunch", t + wait, t + wait + 5.0),
                 ("cudaStreamSynchronize", t + wait + 6.0, t + wait + 101.0)]
        device.append(("render_kernel", "kernel", t + wait + 6.0, t + wait + 100.0))
        t += wait + 101.0
    held = Trace(device=device, spans=[(0.0, t + 10.0)], host_ops=host, steps=66, context={})
    assert read(held) == pytest.approx(20 * 4 * 1e-3)
    # one launch an episode: a whole-episode graph has no read to wait on
    assert read(synthetic()) is None
    whole = early_exit_trace()
    whole.host_ops = [h for h in whole.host_ops
                      if h[0] != "cudaGraphLaunch" or h[1] in (15.0, 305.0)]
    assert read(whole) is None


def test_a_reader_with_nothing_to_read_returns_nothing():
    empty = Trace(device=[], spans=[(0.0, 10.0)], host_ops=[], steps=1, context={})
    for name in ("render_roofline", "roll_product_roofline", "fp64_ms_per_step.fft",
                 "lib_min_allreduce_ms_per_step", "graph_launches_per_episode.anywhere",
                 "exit_wait_ms_per_episode.anywhere"):
        assert load_reader(ROOT, name)(empty) is None


def test_work_counts_match_the_kernel_table():
    # render's bound at config 4 (B=1024): 0.00777 ms of bytes (PERF.md kernel table)
    ms = work.render_bytes(1024, CONFIG4["sensor"]) / work.HBM_BYTES_PER_S * 1e3
    assert round(ms, 5) == 0.00777
    # the rolled-library product at config 2: 70.8 GFLOP a step
    gflop = work.roll_product_flops(512, CONFIG2["sensor"], CONFIG2["scan"], 500) / 1e9
    assert math.isclose(gflop, 70.78, rel_tol=1e-3)
