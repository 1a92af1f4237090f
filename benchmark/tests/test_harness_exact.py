"""The cell ``exact_lib50_b1024``: BASELINE config 4 on the exact
``"kernel"`` path. Its roofline's reader on a synthetic event list, the
configuration against the program and the reference it names, and the cell
judged correct at its CPU size."""

from __future__ import annotations

import dataclasses

import pytest

from fixture import ROOT
from harness import check, drive, work
from harness.cells import find_cell, load_reader
from harness.trace import Trace

CELL = "exact_lib50_b1024"
SIM = find_cell(CELL).config["sim"]
CONTEXT = {"batch": 1024, "sensor": SIM["sensor"], "scan": SIM["scan"], "views_per_rank": 50}
# the tile's name as the traced slice of the cell on an H100 gives it
TILE = ("(anonymous namespace)::min_distance_kernel(float const*, float const*, float const*, "
        "float*, int, int, int, double, int, int)")


def synthetic(device) -> Trace:
    return Trace(device=device, spans=[(0.0, 1000.0)], host_ops=[], steps=2,
                 context=CONTEXT)


def step_events(t0: float) -> list:
    """One step's kernels from ``t0`` (us): render, the pooling sgemm, the
    tile (230 us), a copy and the decision."""
    return [
        ("void (anonymous namespace)::render_kernel<true>(float const*)", "kernel", t0, t0 + 17),
        ("sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x128x8_stage3", "kernel",
         t0 + 20, t0 + 120),
        (TILE, "kernel", t0 + 550, t0 + 780),
        ("Memcpy DtoD (Device -> Device)", "gpu_memcpy", t0 + 790, t0 + 795),
        ("(anonymous namespace)::decide_kernel(float const*)", "kernel", t0 + 800, t0 + 805),
    ]


def test_min_distance_roofline_on_a_synthetic_trace():
    t = synthetic(step_events(0.0) + step_events(0.0))
    flops = 2 * 2.0 * 1024 * 1152 * 50 * 60
    assert flops == 2 * work.roll_product_flops(1024, SIM["sensor"], SIM["scan"], 50)
    got = load_reader(ROOT, "min_distance_roofline")(t)
    assert got == pytest.approx(100 * flops / work.FP64_FLOP_PER_S / 460e-6)
    # 7.08 GFLOP a step at 67 TFLOP/s is 0.1056 ms: 45.9% at the kernel table's 0.2300 ms
    one = synthetic([(TILE, "kernel", 0.0, 230.0)] * 2)
    assert load_reader(ROOT, "min_distance_roofline")(one) == pytest.approx(45.9, abs=0.05)


@pytest.mark.parametrize("name", ["min_distance_roofline"])
def test_the_readers_find_nothing_where_the_kernels_are_absent(name):
    fft_step = [e for e in step_events(0.0) if e[0] != TILE]
    assert load_reader(ROOT, name)(synthetic(fft_step)) is None
    assert load_reader(ROOT, name)(synthetic([])) is None


def test_the_configuration_states_the_kernel_path_and_the_exact_reference():
    cell = find_cell(CELL)
    config = cell.config
    cfg = drive.sim_config(config, 1.0)
    assert drive.fam_impl_arg(config, cfg) == "kernel" == config["fam_impl"]
    with pytest.raises(RuntimeError, match="resolved to 'fft'"):
        drive.fam_impl_arg(dict(config, fam_impl_arg="auto"), cfg)
    ref = check.reference_of(config)
    assert ref.__name__ == "reference.navref"
    spec = ref.spec_from_config(config)
    assert spec.familiarity == "exact" and spec.spectral_cutoff == 0
    # config 4 as shipped, with the same world, sensor and traffic as fft_lib50_b1024
    fft = find_cell("fft_lib50_b1024")
    assert cell.traffic == fft.traffic and config["world"] == fft.config["world"]
    assert config["sim"]["sensor"] == fft.config["sim"]["sensor"]
    assert {k: v for k, v in config["sim"]["scan"].items() if k != "spectral_cutoff"} == {
        k: v for k, v in fft.config["sim"]["scan"].items() if k != "spectral_cutoff"}
    assert {m["name"] for m in cell.per_layer} == {
        "device_idle_share.batch", "device_ms_per_step.batch", "render_roofline",
        "min_distance_roofline"}


def test_the_cell_at_its_cpu_size_is_judged_correct():
    cell = find_cell(CELL)
    small = cell.config["cpu_check"]
    traffic = dict(cell.traffic, batch=small["batch"],
                   check={"episodes": small["episodes"], "poses": small["poses"]})
    cell = dataclasses.replace(cell, traffic=traffic)
    result = drive.run_single(cell, 2**31 + 2021, 0.1, False, "cpu", 0.0, lambda: None)
    assert result["correct"], result["checks"]
    assert result["numbers"]["poses_compared"] == small["poses"]
    assert set(result["metrics"]) == {"agent_steps_per_s", "batch_ms_p95", "setup_s"}
