"""Drive the port (navdv_torch) on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, one JSON line each:

1. card   — the card's name and power limit (nvidia-smi);
2. build  — every CUDA kernel of the main path, built from ``navdv_torch/csrc``
            (one nvcc per source, all started together); ptxas must report no
            spills in any of the four libraries, and ``cuobjdump -sass`` must
            find fp64 tensor-core instructions (DMMA) in the two distance
            kernels;
3. kernels — each kernel against its plain PyTorch version at the main
            path's shapes (BASELINE config 4: 1024 agents, 72x16 sensor with
            a 360-bin fine panorama, 60 lags, 50 library views), with inputs
            from ``numpy.random.default_rng(0)``; median times from CUDA events,
            one call per event pair (``ms``) and, beside it, per call in a run
            of 20 back-to-back calls (``ms_in_run``); both also for a kernel
            that does nothing (``empty_kernel``), the floor of each timer.
            The window gather and the render kernel (both modes) must equal
            their plain versions bit for bit. The window gather's yardstick
            is one PyTorch indexing call on a strided view of the landscape
            (``unfold``), the render kernel's ``grid_sample``; the port calls
            neither.
            The fused lag kernel is also timed against the port's unfused
            route for the same familiarity (pooled panorama -> candidate
            views -> min-distance kernel -> window pool). ``dgemm_ms`` is the
            time of the fp64 cuBLAS product ``a64 @ b64.T`` at the
            min-distance shape: what DMMA reaches there through cuBLAS, not a
            computation of the kernel's function;
4. main   — config 4 with the exact familiarity path (``spectral_cutoff=0``):
            train a 50-view library on the 512^2 blobs world, then a batched
            episode of 1024 agents with ``fam_impl="kernel"``; the launch
            count of each of its three kernels over that run must be > 0;
5. reference — the same episode with ``fam_impl="plain"``: success rates
            within 0.025, >= 99% of agents choose the same first candidate;
6. lag    — the fused lag familiarity (``ops.lag.make_lag_fam``) on the
            main episode's library and statics, at the agents' poses at the
            start and after steps 16, 32 and 48: at ``hat_dtype="float32"``
            >= 99.9% of tie-ordered candidates equal and familiarity within
            rtol/atol 1e-5 of the main path's ``step.fam``; at the shipped
            ``hat_dtype="bfloat16"`` the agreement is reported only (the JAX
            lag prep pools without the bf16 box filter); the lag kernel's
            launch count over the phase must be > 0;
7. spectral — config 4 as shipped (``spectral_cutoff=72``) through
            ``NavigationSimulator`` with its default ``fam_impl="auto"``, which
            must resolve to ``"fft"``: the main phase's 1024 trials, success
            within 0.025 of the main phase's; the episode must launch the
            window and render kernels and neither distance kernel. At
            ``spectral_cutoff=0``, on the lag phase's 4 x 1024 poses, >= 99.9%
            of tie-ordered candidates must equal the kernel path's
            ``step.fam`` (the shipped cutoff's agreement is reported only);
8. sector — config 3 as shipped (64x360 sensor, NCC, tol_bins 3, the fused
            sector front end, ``bench_config(3, 50)``, 256 agents): on 256
            trial poses the sector render, unrolled, within 2e-4 (f32) and
            3e-2 (bf16) of the full render, and the render kernel timed at
            config 3's shapes; ``NavigationSimulator``'s "auto" must resolve
            to ``"fft"`` and take the fused branch, its episode must launch
            window and render and no distance kernel, and its success must be
            within 0.010 (``bench.py`` ACCURACY_BAND[3]) of the kernel path's
            on the same trials. At ``spectral_cutoff=0`` and f32, on the
            kernel episode's poses at steps 0/16/32/48, >= 99.9% of
            tie-ordered candidates of the fused step must equal the kernel
            path's and the unfused step's (shipped cutoff and bf16 reported
            only). At config 4's shapes (u = 5) the spectral minimum with
            ``roll_k`` equals that of the unrolled panorama to rtol 1e-9 or
            one f32 rounding step;
9. roll   — config 2 as shipped (500 views, 120 headings, 512 trials)
            through ``NavigationSimulator``, whose ``"auto"`` must resolve to
            ``"roll"``, against the kernel path on the same trials: success
            within 0.010 (``bench.py`` ACCURACY_BAND[2]), >= 99.9% of agents
            with the same first candidate, window and render launched, no
            distance kernel;
10. roll_knobs — one config-2 library minimum on the roll phase's poses:
            ``fixed_point_bits=8`` equals a float64 evaluation of the
            quantized SSD to rtol 2e-7, ``roll_rank=16`` is within 4e-3 of the
            largest |l|^2 of the dense roll path; one episode with each knob,
            its success rate reported only;
11. checkpoint — the spectral phase's library saved and loaded into a fresh
            simulator, whose episode must give the same final states;
12. sweep — the default ``SweepSpec`` (config 5: 8 cells, 256 trials, 256
            steps, early exit) on the bench world with a 128-trial recall
            check: each cell runs the path "auto" resolves to (``kernel`` at
            36x8, ``fft`` at 72x16), each fft cell's recall within 0.025 of
            the kernel path's on its subset; a second run resumes all 8 cells
            from disk and launches no kernel; ``summary.json`` lists 8 cells;
13. golden — the port's own training plus a one-agent episode on the small
            parity world against ``tests/golden_oracle_small.npz``; the
            one-agent ``navigate()`` must give the batched episode's record.

Every phase line carries its ``seconds``. Then the card line, the kernels
line and, last, ``{"ok": true, "device": ...}``. Any failed check raises and
the script exits non-zero. Without a CUDA device it exits 2 and prints no
result.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from navdv_torch import _build, ops
from navdv_torch.agent import (
    STATUS_REACHED,
    init_state,
    make_navigate_batch,
    make_statics,
    make_step_batched,
    navigate,
    resolve_fam_impl,
)
from navdv_torch.config import (
    AgentConfig,
    ScanConfig,
    SensorConfig,
    SimConfig,
    baseline_config,
)
from navdv_torch.device import resolve_device
from navdv_torch.familiarity import pack_library, zscore
from navdv_torch.familiarity_fft import make_lib_min_fft
from navdv_torch.familiarity_roll import make_lib_min_roll
from navdv_torch.landscape import make_landscape
from navdv_torch.metrics import episode_metrics, success_rate
from navdv_torch.ops.familiarity import (
    make_lib_min_kernel,
    min_distance_rows,
    min_distance_rows_plain,
)
from navdv_torch.ops.lag import (
    lag_grid_geometry,
    lag_lib_min,
    lag_lib_min_plain,
    lag_smem_bytes,
    make_lag_fam,
)
from navdv_torch.ops.render import render_smem_bytes, render_windows, render_windows_plain
from navdv_torch.ops.window import window_gather, window_gather_plain
from navdv_torch.oracle import resample_route
from navdv_torch.routes import make_route
from navdv_torch.sensor import (
    make_pooled_panorama,
    make_render_batch,
    make_render_batch_rolled,
    make_views_from_pooled,
    polar_offsets,
    scan_lag_sets,
    unroll_panorama,
    window_geometry,
)
from navdv_torch.simulator import NavigationSimulator
from navdv_torch.sweep import SweepSpec, run_sweep
from navdv_torch.training import train_library
from navdv_torch.trials import make_trials

# NVIDIA H100 SXM data sheet: HBM3 bandwidth, and the peak that is both the
# fp32 rate outside the tensor cores and the fp64 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = 67e12

BATCH = 1024
VIEWS = 50
CONFIG2_BATCH = 512  # bench.py SPEC_BATCH[2]
CONFIG2_VIEWS = 500  # bench.py SPEC_VIEWS[2]
MAIN_KERNELS = ("window_gather", "render", "min_distance")
RENDER_KERNELS = ("window_gather", "render")
DISTANCE_KERNELS = ("min_distance", "lag_fam")
DMMA_KERNELS = ("min_distance", "lag_fam")  # built for the fp64 tensor cores
LAG_POSE_STEPS = (0, 16, 32, 48)  # lag phase: poses at the start and after these steps
ROUTE_LENGTH = 40.0
ACCURACY_BAND = 0.025  # config 4's success-rate band (bench.py ACCURACY_BAND[4])
ACCURACY_BAND_2 = 0.010  # config 2's (bench.py ACCURACY_BAND[2])
ACCURACY_BAND_3 = 0.010  # config 3's (bench.py ACCURACY_BAND[3])
SECTOR_BATCH = 256  # bench.py SPEC_BATCH[3]
# the sector render unrolled vs the full render: fp rounding of the rotation
# at f32, the bf16 weights' pixel noise at bf16 (bench.py's sector gate)
SECTOR_RENDER_TOL = {"float32": 2e-4, "bfloat16": 3e-2}
SWEEP_RECALL_TRIALS = 128
SLEEP_CYCLES = 50_000_000  # ~25 ms at the H100's clock: outlasts enqueuing one run
GOLDEN = Path(__file__).resolve().parent / "tests" / "golden_oracle_small.npz"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def held_ms(enqueue) -> float:
    """Device time in ms of the work ``enqueue()`` queues. A sleep kernel
    holds the device while the host enqueues, so the work runs back to back
    and the events measure the device, not the host's time to prepare the
    launches. A run whose sleep ended before the host finished enqueuing (a
    slow or shared host) is repeated with a sleep twice as long."""
    cycles = SLEEP_CYCLES
    for _ in range(4):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        start.record()
        enqueue()
        end.record()
        if not start.query():
            torch.cuda.synchronize()
            return start.elapsed_time(end)
        cycles *= 2
    raise AssertionError("timing: the device sleep ended before the run was queued, 4 times")


def time_ms(fn, runs: int = 25, warmup: int = 3) -> float:
    """Median device time of ``fn()`` in ms, one CUDA-event pair per run."""
    for _ in range(warmup):
        fn()
    return float(np.median([held_ms(fn) for _ in range(runs)]))


def time_ms_in_run(fn, calls: int = 20, runs: int = 5) -> float:
    """Median device time per call of ``fn()`` over ``calls`` calls enqueued
    back to back between one CUDA-event pair: the event overhead that
    ``time_ms`` pays once per call is spread over the run, and the gap
    between launches is kept."""
    for _ in range(3):
        fn()

    def run():
        for _ in range(calls):
            fn()

    return float(np.median([held_ms(run) / calls for _ in range(runs)]))


def sass_dmma_counts() -> dict[str, int | None]:
    """DMMA instructions in each distance kernel's library, from
    ``cuobjdump -sass``; None where the toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return {name: None for name in DMMA_KERNELS}
    counts = {}
    for name in DMMA_KERNELS:
        sass = subprocess.run([tool, "-sass", str(_build.library_path(name))],
                              capture_output=True, text=True, check=True, timeout=120).stdout
        counts[name] = sum(1 for ln in sass.splitlines() if re.search(r"\bDMMA\b", ln))
    return counts


def check_build(logs: dict[str, str]) -> dict:
    """ptxas lines of every kernel; no spills anywhere, DMMA in the distance kernels."""
    ptxas = {name: [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
             for name, log in logs.items()}
    for name in logs:
        spills = [int(n) for ln in ptxas[name] for n in re.findall(r"(\d+) bytes spill", ln)]
        require(logs[name] == "cached" or (spills and not any(spills)),
                f"{name}: ptxas reports spills or no spill line: {ptxas[name]}")
    dmma = sass_dmma_counts()
    for name in DMMA_KERNELS:
        require(dmma[name] is None or dmma[name] > 0, f"{name}: no DMMA instruction in its SASS")
    return {"ptxas": ptxas, "sass_dmma": dmma}


def bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    """Least time the card could take: max(bytes / HBM rate, flops / peak)."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bench_config(n: int, views: int) -> tuple[SimConfig, np.ndarray, np.ndarray]:
    """BASELINE config ``n`` as shipped, on the bench world of ``bench.py``
    ``_setup``: 512^2 blobs (seed 7, 150 features), sine route of length 40,
    ``views`` stored views, a step budget of 1.3x the route's arc."""
    cfg = baseline_config(n)
    land = make_landscape("blobs", size=(512, 512), seed=7, n_features=150)
    route = make_route("sine", size=(512, 512), margin=60.0, length=ROUTE_LENGTH,
                       amplitude=ROUTE_LENGTH / 8.0)
    arc = float(np.hypot(*np.diff(route, axis=0).T).sum())
    cfg = dataclasses.replace(
        cfg,
        capture_spacing=arc / (views - 0.5),
        agent=dataclasses.replace(cfg.agent, max_steps=int(arc / cfg.agent.step_size * 1.3)),
    )
    return cfg, land, route


def slice_config() -> tuple[SimConfig, np.ndarray, np.ndarray]:
    """The main path: config 4 with 50 stored views on the bench world, with
    ``spectral_cutoff`` (which belongs to the spectral path) cleared for the
    exact path."""
    cfg, land, route = bench_config(4, VIEWS)
    return dataclasses.replace(cfg, scan=dataclasses.replace(cfg.scan, spectral_cutoff=0)), land, route


def check_kernels(cfg: SimConfig, dev: torch.device) -> dict[str, dict]:
    """Each kernel vs its plain version at the main path's shapes."""
    rng = np.random.default_rng(0)
    sensor = cfg.sensor
    wy, wx = window_geometry(sensor)
    results = {}

    # window gather: exact copy
    land_np = rng.uniform(size=(512, 512)).astype(np.float32)
    by_np = rng.integers(0, 512 - wy + 1, size=BATCH).astype(np.int32)
    bx_np = rng.integers(0, 512 - wx + 1, size=BATCH).astype(np.int32)
    land = torch.from_numpy(land_np).to(dev)
    by = torch.from_numpy(by_np).to(dev)
    bx = torch.from_numpy(bx_np).to(dev)
    got = window_gather(land, by, bx, wy, wx)
    want = window_gather_plain(land, by, bx, wy, wx)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    require(torch.equal(got, want), "window gather differs from its plain version")
    covered = np.zeros(land_np.shape, bool)  # landscape cells the windows need
    for y, x in zip(by_np, bx_np):
        covered[y : y + wy, x : x + wx] = True
    b_ms, b_by = bound(int(covered.sum()) * 4 + nbytes(by, bx, got), 0)
    # yardstick: one indexing kernel on the [H-wy+1, W-wx+1, wy, wx] view of
    # every window, corners clamped beforehand
    views = land.unfold(0, wy, 1).unfold(1, wx, 1)
    by_c = by.long().clamp(0, land.shape[0] - wy)
    bx_c = bx.long().clamp(0, land.shape[1] - wx)
    require(torch.equal(views[by_c, bx_c], want), "unfold yardstick differs from the window gather")
    results["window_gather"] = dict(
        route="cuda", source="navdv_torch/csrc/window.cu",
        replaces="navdv_tpu/ops/window_pallas.py:88",
        max_abs_err=err, tolerance="exact",
        ms=time_ms(lambda: window_gather(land, by, bx, wy, wx)),
        ms_in_run=time_ms_in_run(lambda: window_gather(land, by, bx, wy, wx)),
        library_ms_in_run=time_ms_in_run(lambda: views[by_c, bx_c]),
        plain_ms=time_ms(lambda: window_gather_plain(land, by, bx, wy, wx)),
        bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(lambda: views[by_c, bx_c]),
    )

    results["render"] = check_render(got, sensor, dev, rng)

    # min distance + running min: both metrics against float64 on the card
    n_lags = 60
    rows_n, p, nl = BATCH * n_lags, sensor.n_pixels, VIEWS
    a = torch.from_numpy(rng.uniform(size=(rows_n, p)).astype(np.float32)).to(dev)
    b = torch.from_numpy(rng.uniform(size=(nl, p)).astype(np.float32)).to(dev)
    metrics = {}
    for metric in ("ssd", "ncc"):
        if metric == "ssd":
            aa, bb, alpha, with_rowsq = a, b, -2.0, True
            gamma = torch.sum(b * b, dim=1)
        else:
            aa, bb, alpha, with_rowsq = zscore(a), zscore(b), -1.0 / p, False
            gamma = torch.zeros(nl, device=dev)
        got = min_distance_rows(aa, bb, gamma, alpha, with_rowsq)
        a64, b64 = aa.double(), bb.double()
        beta = (a64 * a64).sum(1, keepdim=True) if with_rowsq else 1.0
        want = (alpha * (a64 @ b64.T) + beta + gamma.double()[None, :]).min(dim=1).values
        torch.cuda.synchronize()
        diff = (got.double() - want).abs()
        err = float(diff.max())
        require(bool((diff <= 2e-3 + 2e-4 * want.abs()).all()),
                f"min distance {metric}: max abs err {err} beyond rtol 2e-4 / atol 2e-3")
        metrics[metric] = dict(
            max_abs_err=err, tolerance="rtol 2e-4, atol 2e-3 vs float64",
            ms=time_ms(lambda: min_distance_rows(aa, bb, gamma, alpha, with_rowsq)),
            ms_in_run=time_ms_in_run(lambda: min_distance_rows(aa, bb, gamma, alpha, with_rowsq)),
            plain_ms=time_ms(lambda: min_distance_rows_plain(aa, bb, gamma, alpha, with_rowsq)),
        )
        del a64, b64, want, diff
    a64, b64 = a.double(), b.double()
    dgemm_ms = time_ms(lambda: a64 @ b64.T)
    del a64, b64
    flops = 2.0 * rows_n * nl * p + 2.0 * rows_n * p  # cross term + |a|^2
    b_ms, b_by = bound(nbytes(a, b) + nl * 4 + rows_n * 4, flops)
    results["min_distance"] = dict(
        route="cuda", source="navdv_torch/csrc/min_distance.cu",
        replaces="navdv_tpu/ops/familiarity_pallas.py:103",
        max_abs_err=metrics["ssd"]["max_abs_err"], tolerance=metrics["ssd"]["tolerance"],
        ms=metrics["ssd"]["ms"], ms_in_run=metrics["ssd"]["ms_in_run"],
        plain_ms=metrics["ssd"]["plain_ms"],
        ncc=metrics["ncc"], dgemm_ms=dgemm_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
    )
    results["lag_fam"] = check_lag_kernel(cfg, dev, rng)
    return results


def check_render(win: torch.Tensor, sensor: SensorConfig, dev: torch.device, rng) -> dict:
    """The render kernel against its plain version (bit for bit, both
    modes) on windows ``win`` f32[B, W, W], at poses as the renderers make
    them, timed beside ``grid_sample``."""
    batch, wx = win.shape[0], win.shape[2]
    dx0_np, dy0_np = polar_offsets(sensor)
    dx0 = torch.from_numpy(dx0_np).to(dev)
    dy0 = torch.from_numpy(dy0_np).to(dev)
    half = wx // 2
    theta = rng.uniform(-math.pi, math.pi, size=batch)
    fxy_np = np.stack([
        rng.uniform(half, half + 1, size=batch), rng.uniform(half, half + 1, size=batch),
        np.cos(theta), np.sin(theta)], axis=1).astype(np.float32)
    fxy = torch.from_numpy(fxy_np).to(dev)
    render = {}
    for mode, hat_bf16 in (("f32", False), ("bf16", True)):
        got = render_windows(win, fxy, dx0, dy0, hat_bf16)
        want = render_windows_plain(win, fxy, dx0, dy0, hat_bf16)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        require(torch.equal(got, want), f"render {mode}: differs from its plain version ({err})")
        render[mode] = dict(
            max_abs_err=err, tolerance="exact",
            ms=time_ms(lambda: render_windows(win, fxy, dx0, dy0, hat_bf16)),
            ms_in_run=time_ms_in_run(lambda: render_windows(win, fxy, dx0, dy0, hat_bf16)),
            plain_ms=time_ms(lambda: render_windows_plain(win, fxy, dx0, dy0, hat_bf16)),
        )
    # yardstick: grid_sample computes the f32 function (bilinear, border clamp)
    fx, fy, c, s = (fxy[:, i, None, None] for i in range(4))
    xs = ((fx + c * dx0) - s * dy0).clamp(0.0, wx - 1.0)
    ys = ((fy + s * dx0) + c * dy0).clamp(0.0, wx - 1.0)
    grid = torch.stack([xs / (wx - 1) * 2 - 1, ys / (wx - 1) * 2 - 1], dim=-1)
    win4 = win[:, None]

    def grid_sample():
        return torch.nn.functional.grid_sample(
            win4, grid, mode="bilinear", padding_mode="border", align_corners=True)

    lib_err = float((grid_sample()[:, 0] - render_windows_plain(win, fxy, dx0, dy0, False))
                    .abs().max())
    require(lib_err <= 1e-4, f"grid_sample yardstick: max abs err {lib_err} > 1e-4")
    render["f32"]["library_max_abs_err"] = lib_err
    samples = batch * dx0.numel()
    b_ms, b_by = bound(nbytes(win, fxy, dx0, dy0) + samples * 4, samples * 29)
    smem = _build.load_function("render", "navdv_render_smem_bytes", [ctypes.c_int])(wx)
    require(smem == render_smem_bytes(wx),
            f"render kernel asks for {smem} bytes of shared memory, the wrapper's budget "
            f"assumes {render_smem_bytes(wx)}")
    return dict(
        route="cuda", source="navdv_torch/csrc/render.cu",
        replaces="navdv_tpu/ops/render_pallas.py:61",
        max_abs_err=render["bf16"]["max_abs_err"], tolerance="exact (both modes)",
        ms=render["bf16"]["ms"], ms_in_run=render["bf16"]["ms_in_run"],
        plain_ms=render["bf16"]["plain_ms"],
        f32_mode=render["f32"], smem_bytes=smem, shape=[batch, *dx0.shape, wx],
        bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(grid_sample),
    )


def check_lag_kernel(cfg: SimConfig, dev: torch.device, rng) -> dict:
    """The fused lag kernel on raw config-4 panoramas and a random library:
    against its plain version, against float64 (pooled in float64 too), and
    timed beside the port's unfused route for the same familiarity."""
    sensor, scan = cfg.sensor, cfg.scan
    r, w, u, a_fine = sensor.n_radial, sensor.n_azimuth, sensor.az_upsample, sensor.n_fine
    lags_np, window_idx = scan_lag_sets(scan)
    n_lags, p = len(lags_np), sensor.n_pixels
    pano = torch.from_numpy(rng.uniform(size=(BATCH, r, a_fine)).astype(np.float32)).to(dev)
    lib = pack_library(torch.from_numpy(
        rng.uniform(size=(VIEWS, r, w)).astype(np.float32)).to(dev))
    lags = torch.from_numpy(lags_np.astype(np.int32)).to(dev)
    args = (pano, lib.flat, lib.sq, sensor, lags)
    got = lag_lib_min(*args)
    plain = lag_lib_min_plain(*args)
    p64 = pano.double()
    s64 = sum(torch.roll(p64, -j, dims=2) for j in range(u)) / u
    cols = torch.remainder(torch.arange(w, device=dev)[None, :] * u + lags.long()[:, None], a_fine)
    c64 = s64.index_select(2, cols.reshape(-1)).reshape(BATCH, r, n_lags, w)
    c64 = c64.permute(0, 2, 1, 3).reshape(BATCH, n_lags, p)
    want = (-2.0 * (c64 @ lib.flat.double().T) + (c64 * c64).sum(2, keepdim=True)
            + lib.sq.double()[None, None, :]).min(dim=2).values.clamp_min(0.0)
    torch.cuda.synchronize()
    plain_err = float((got - plain).abs().max())
    require(torch.allclose(got, plain, rtol=1e-6, atol=1e-6),
            f"lag kernel vs its plain version: max abs err {plain_err} beyond 1e-6")
    diff = (got.double() - want).abs()
    err = float(diff.max())
    require(bool((diff <= 2e-3 + 2e-4 * want.abs()).all()),
            f"lag kernel: max abs err {err} beyond rtol 2e-4 / atol 2e-3 vs float64")
    del p64, s64, c64, want, diff
    smem = _build.load_function("lag_fam", "navdv_lag_fam_smem_bytes",
                                [ctypes.c_int, ctypes.c_int, ctypes.c_int])(r, w, u)
    require(smem == lag_smem_bytes(sensor),
            f"lag kernel asks for {smem} bytes of shared memory, the wrapper's budget "
            f"assumes {lag_smem_bytes(sensor)}")

    # the same familiarity f32[B, Nh], fused and through the unfused route
    fused = make_lag_fam(sensor, scan, dev)
    sensor_f32 = dataclasses.replace(sensor, hat_dtype="float32")  # rolled-add pooling
    pooled = make_pooled_panorama(sensor_f32, dev)
    views = make_views_from_pooled(sensor_f32, lags_np, dev)
    lib_min = make_lib_min_kernel(sensor_f32, scan)
    widx = torch.as_tensor(window_idx.astype(np.int64), device=dev)

    def unfused():
        return torch.min(lib_min(views(pooled(pano)), lib)[:, widx], dim=2).values

    unfused_err = float((fused(pano, lib) - unfused()).abs().max())
    require(unfused_err <= 1e-5, f"lag familiarity vs the unfused route: {unfused_err} > 1e-5")
    _, nq, _, _ = lag_grid_geometry(sensor, scan)
    flops = 2.0 * BATCH * n_lags * p * (VIEWS + 1) + BATCH * r * a_fine * u  # + pooling
    b_ms, b_by = bound(nbytes(pano, lib.flat, lib.sq, lags) + BATCH * n_lags * 4, flops)
    return dict(
        route="cuda", source="navdv_torch/csrc/lag_fam.cu",
        replaces="navdv_tpu/ops/lag_pallas.py:84",
        max_abs_err=err, tolerance="rtol 2e-4, atol 2e-3 vs float64",
        plain_max_abs_err=plain_err, unfused_max_abs_err=unfused_err,
        ms=time_ms(lambda: lag_lib_min(*args)),
        ms_in_run=time_ms_in_run(lambda: lag_lib_min(*args)),
        plain_ms=time_ms(lambda: lag_lib_min_plain(*args)),
        fam_ms=time_ms(lambda: fused(pano, lib)),
        unfused_ms=time_ms(unfused),
        lags=n_lags, tpu_grid_rows=nq * u, smem_bytes=smem,
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
    )


def run_main_path(cfg, land, route):
    """Training + one batched episode through the kernels; returns what the
    reference phase compares against."""
    t_phase = time.perf_counter()
    starts, thetas = make_trials(route, cfg, BATCH, seed=0)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    lib = train_library(land, route, cfg)
    st = make_statics(land, lib, route)
    run = make_navigate_batch(cfg, fam_impl="kernel")
    states0 = init_state(starts, thetas)
    final, rec = run(states0, st)
    rate = float(success_rate(final))  # waits for the episode
    wall = time.perf_counter() - t0
    counts = {name: ops.launch_counts()[name] for name in MAIN_KERNELS}
    for name, n in counts.items():
        require(n > 0, f"kernel {name} was not launched on the main path")

    t_max = cfg.agent.max_steps
    require(lib.views.shape == (VIEWS, cfg.sensor.n_radial, cfg.sensor.n_azimuth),
            f"library shape {tuple(lib.views.shape)}")
    for field in ("xy", "theta", "fam", "k", "dist_route", "done"):
        require(getattr(rec, field).shape[:2] == (BATCH, t_max), f"record {field} shape")
    active = ~rec.done
    require(bool(torch.isfinite(rec.fam[active]).all()), "non-finite familiarity")
    require(bool(torch.isfinite(rec.xy).all()), "non-finite positions")
    m = episode_metrics(final, rec)

    # steady-state episode time (library and statics reused)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    final2, _ = run(states0, st)
    rate2 = float(success_rate(final2))
    episode_s = time.perf_counter() - t0
    require(rate2 == rate, "a repeated episode gave another success rate")
    emit({
        "phase": "main", "fam_impl": "kernel", "batch": BATCH, "max_steps": t_max,
        "library_views": VIEWS, "success_rate": rate,
        "mean_steps": float(m["n_steps"].float().mean()),
        "train_and_episode_s": wall, "episode_s": episode_s,
        "agent_steps_per_s": BATCH * t_max / episode_s, "launches": counts,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "seconds": time.perf_counter() - t_phase,
    })
    return st, states0, final, rec, counts


def run_reference(cfg, st, states0, final, rec) -> None:
    run = make_navigate_batch(cfg, fam_impl="plain")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    final_p, rec_p = run(states0, st)
    rate_p = float(success_rate(final_p))
    episode_s = time.perf_counter() - t0
    rate_k = float(success_rate(final))
    same_k0 = float((rec.k[:, 0] == rec_p.k[:, 0]).float().mean())
    emit({
        "phase": "reference", "fam_impl": "plain", "success_rate": rate_p,
        "kernel_success_rate": rate_k, "same_first_k": same_k0,
        "episode_s": episode_s, "agent_steps_per_s": BATCH * cfg.agent.max_steps / episode_s,
        "seconds": time.perf_counter() - t0,
    })
    require(abs(rate_k - rate_p) <= ACCURACY_BAND,
            f"success rates differ: kernel {rate_k} vs plain {rate_p}")
    require(same_k0 >= 0.99, f"only {same_k0:.4f} of agents chose the same first candidate")


def tie_k(fam: torch.Tensor, scan: ScanConfig) -> torch.Tensor:
    """The step's candidate choice: argmin in tie order (agent.py decide)."""
    order = torch.as_tensor(scan.tie_order(), device=fam.device)
    return order[torch.argmin(fam[:, order], dim=1)]


def episode_poses(cfg, states0, rec) -> list:
    """The main episode's agents at the start and after LAG_POSE_STEPS."""
    require(cfg.agent.max_steps >= max(LAG_POSE_STEPS), "episode shorter than the lag poses")
    return [init_state(states0.xy, states0.theta) if t == 0
            else init_state(rec.xy[:, t - 1], rec.theta[:, t - 1]) for t in LAG_POSE_STEPS]


def run_lag(cfg, st, poses) -> int:
    """The fused lag familiarity on the main episode's library at 4 x 1024
    real poses, against the main path's ``step.fam`` on the same poses;
    returns the lag kernel's launch count over the phase."""
    cfg_f32 = dataclasses.replace(
        cfg, sensor=dataclasses.replace(cfg.sensor, hat_dtype="float32"))
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = {}
    for hat, c in (("float32", cfg_f32), ("bfloat16", cfg)):
        render = make_render_batch(c.sensor)
        fused = make_lag_fam(c.sensor, c.scan)
        step_fam = make_step_batched(c, "kernel").fam
        same = n = 0
        max_d, fam_ok = 0.0, True
        for s in poses:
            got = fused(render(st.landscape, s.xy, s.theta), st.lib)
            want = step_fam(s, st)
            same += int((tie_k(got, c.scan) == tie_k(want, c.scan)).sum())
            n += got.shape[0]
            diff = (got - want).abs()
            max_d = max(max_d, float(diff.max()))
            fam_ok &= bool((diff <= 1e-5 + 1e-5 * want.abs()).all())
        out[hat] = {"same_k": same / n, "max_abs_dfam": max_d, "fam_within_1e-5": fam_ok}
    launches = ops.launch_counts()["lag_fam"]
    emit({"phase": "lag", "poses": len(poses) * BATCH, "pose_steps": list(LAG_POSE_STEPS),
          **out, "lag_fam_launches": launches, "seconds": time.perf_counter() - t0})
    require(launches > 0, "the lag kernel was not launched in the lag phase")
    require(out["float32"]["same_k"] >= 0.999,
            f"lag vs step at float32: only {out['float32']['same_k']:.5f} equal candidates")
    require(out["float32"]["fam_within_1e-5"],
            f"lag vs step at float32: familiarity off by {out['float32']['max_abs_dfam']}")
    return launches


def phase_memory_start() -> int:
    """Zero the peak-memory counter; returns the bytes the earlier phases
    still hold, which a phase's ``peak_mem_gb`` leaves out."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def timed_navigate(sim: NavigationSimulator, **kw):
    """One counted episode (launch counts zeroed just before it and read just
    after), then the same episode again, timed; both must agree."""
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    res = sim.navigate(**kw)  # waits for the episode
    counts = ops.launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = sim.navigate(**kw)
    episode_s = time.perf_counter() - t0
    require(again.success_rate == res.success_rate, "a repeated episode gave another success rate")
    return res, counts, episode_s


def require_render_only(counts: dict, phase: str) -> None:
    """The extraction-free paths render through the window and render
    kernels and launch no distance kernel."""
    for name in RENDER_KERNELS:
        require(counts[name] > 0, f"{phase}: kernel {name} was not launched")
    for name in DISTANCE_KERNELS:
        require(counts[name] == 0, f"{phase}: kernel {name} was launched ({counts[name]})")


def compare_fam(fam_a, fam_b, poses, st, scan) -> dict:
    """Two familiarity functions on the same poses: the share of equal
    tie-ordered candidates, the largest familiarity difference, and where
    the candidates differ, the largest gap in ``fam_b`` between the two
    choices (a gap within the familiarity difference is a near-tie)."""
    same = n = 0
    max_d = max_gap = 0.0
    for s in poses:
        a, b = fam_a(s, st), fam_b(s, st)
        ka, kb = tie_k(a, scan), tie_k(b, scan)
        same += int((ka == kb).sum())
        n += a.shape[0]
        max_d = max(max_d, float((a - b).abs().max()))
        gap = (b.gather(1, ka[:, None]) - b.gather(1, kb[:, None]))[ka != kb]
        if gap.numel():
            max_gap = max(max_gap, float(gap.abs().max()))
    return {"same_k": same / n, "max_abs_dfam": max_d, "max_gap_where_differ": max_gap}


def run_spectral(cfg_main, st, poses, kernel_rate: float) -> NavigationSimulator:
    """Config 4 as shipped through the simulator's default "auto" (the JAX
    package's "fft" with spectral_cutoff=72) on the main phase's trials,
    and the fft path at cutoff 0 against the kernel path's familiarity."""
    t_phase = time.perf_counter()
    cfg, land, route = bench_config(4, VIEWS)
    require(cfg.scan.spectral_cutoff == 72, "config 4 ships spectral_cutoff=72")
    base = phase_memory_start()
    sim = NavigationSimulator(cfg, land, route)
    require(sim.fam_impl == "fft", f"config 4's auto resolved to {sim.fam_impl!r}")
    sim.train()
    res, counts, episode_s = timed_navigate(sim, n_trials=BATCH, seed=0)
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    rate = res.success_rate
    require(res.record.k.shape == (BATCH, cfg.agent.max_steps), "spectral record shape")
    require(bool(torch.isfinite(res.record.fam[~res.record.done]).all()), "non-finite familiarity")

    kernel_fam = make_step_batched(cfg_main, "kernel").fam
    agree = {}
    for cutoff in (0, cfg.scan.spectral_cutoff):
        c = dataclasses.replace(cfg_main, scan=dataclasses.replace(cfg_main.scan,
                                                                   spectral_cutoff=cutoff))
        step = make_step_batched(c, "fft")
        aux = step.lib_prepare(st)
        agree[f"cutoff_{cutoff}"] = compare_fam(lambda s, st_: step.fam(s, st_, aux),
                                                kernel_fam, poses, st, cfg.scan)
    emit({
        "phase": "spectral", "fam_impl": sim.fam_impl, "spectral_cutoff": cfg.scan.spectral_cutoff,
        "batch": BATCH, "max_steps": cfg.agent.max_steps, "success_rate": rate,
        "kernel_success_rate": kernel_rate, "episode_s": episode_s,
        "agent_steps_per_s": BATCH * cfg.agent.max_steps / episode_s, "launches": counts,
        "peak_mem_gb": peak, "vs_kernel_step_fam": agree, "poses": len(poses) * BATCH,
        "seconds": time.perf_counter() - t_phase,
    })
    require(abs(rate - kernel_rate) <= ACCURACY_BAND,
            f"spectral: success {rate} vs the kernel path's {kernel_rate}")
    require_render_only(counts, "spectral")
    require(agree["cutoff_0"]["same_k"] >= 0.999,
            f"fft at cutoff 0: only {agree['cutoff_0']['same_k']:.5f} equal candidates")
    return sim


def run_roll():
    """Config 2 as shipped through the simulator's default "auto" (the JAX
    package's "roll"), against the kernel path on the same trials. Returns
    what the knob phase reuses."""
    t_phase = time.perf_counter()
    cfg, land, route = bench_config(2, CONFIG2_VIEWS)
    base = phase_memory_start()
    sim = NavigationSimulator(cfg, land, route)
    require(sim.fam_impl == "roll", f"config 2's auto resolved to {sim.fam_impl!r}")
    sim.train()
    require(sim.library.views.shape[0] == CONFIG2_VIEWS, f"{sim.library.views.shape[0]} views")
    res, counts, episode_s = timed_navigate(sim, n_trials=CONFIG2_BATCH, seed=0)
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9

    st = make_statics(land, sim.library, route)
    starts, thetas = make_trials(route, cfg, CONFIG2_BATCH, seed=0)
    states0 = init_state(starts, thetas)
    run_k = make_navigate_batch(cfg, "kernel")
    final_k, rec_k = run_k(states0, st)
    rate_k = float(success_rate(final_k))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rate_k2 = float(success_rate(run_k(states0, st)[0]))
    kernel_episode_s = time.perf_counter() - t0
    require(rate_k2 == rate_k, "a repeated kernel episode gave another success rate")
    same_k0 = float((res.record.k[:, 0] == rec_k.k[:, 0]).float().mean())
    t_max = cfg.agent.max_steps
    emit({
        "phase": "roll", "fam_impl": sim.fam_impl, "batch": CONFIG2_BATCH, "max_steps": t_max,
        "library_views": CONFIG2_VIEWS, "lags": len(scan_lag_sets(cfg.scan)[0]),
        "success_rate": res.success_rate, "kernel_success_rate": rate_k, "same_first_k": same_k0,
        "episode_s": episode_s, "agent_steps_per_s": CONFIG2_BATCH * t_max / episode_s,
        "kernel_episode_s": kernel_episode_s,
        "kernel_agent_steps_per_s": CONFIG2_BATCH * t_max / kernel_episode_s,
        "launches": counts, "peak_mem_gb": peak, "seconds": time.perf_counter() - t_phase,
    })
    require(abs(res.success_rate - rate_k) <= ACCURACY_BAND_2,
            f"roll: success {res.success_rate} vs the kernel path's {rate_k}")
    require(same_k0 >= 0.999, f"roll: only {same_k0:.5f} of agents chose the kernel's first candidate")
    require_render_only(counts, "roll")
    return cfg, st, states0


def run_roll_knobs(cfg, st, states0) -> None:
    """The roll path's two opt-in knobs at config 2 on the roll phase's
    poses: one library minimum each against its reference, then one episode
    each (success reported only: the JAX package documents recall loss on
    the blobs world)."""
    t_phase = time.perf_counter()
    sensor = cfg.sensor
    lags, _ = scan_lag_sets(cfg.scan)
    s = make_pooled_panorama(sensor)(make_render_batch(sensor)(st.landscape, states0.xy,
                                                               states0.theta))
    lib = st.lib
    dense = make_lib_min_roll(sensor, cfg.scan, lags)(s, lib, None, None)
    out = {}

    # fixed point: the exact SSD between the 1/255-quantized images
    fixed_scan = dataclasses.replace(cfg.scan, fixed_point_bits=8)
    got = make_lib_min_roll(sensor, fixed_scan, lags)(s, lib, None, None).double()
    cand = make_views_from_pooled(sensor, lags)(s)
    qc = torch.round(cand * 255.0).clamp(0.0, 255.0).double()  # the quantizer's f32 rounding
    del cand
    ql = torch.round(lib.flat * 255.0).clamp(0.0, 255.0).double()
    d64 = (qc * qc).sum(2, keepdim=True) + (ql * ql).sum(1) - 2.0 * (qc @ ql.T)  # integers, exact
    want = d64.amin(dim=2) / 255.0**2
    del qc, d64
    rel = float(((got - want).abs() / want.abs().clamp_min(1e-300)).max())
    out["fixed_point_bits_8"] = {"max_rel_err_vs_float64": rel}
    require(bool(((got - want).abs() <= 2e-7 * want.abs()).all()),
            f"fixed point: {rel} beyond rtol 2e-7 of the float64 quantized SSD")

    # low rank: the bf16 residual's bound around the dense roll path
    rank_scan = dataclasses.replace(cfg.scan, roll_rank=16)
    got = make_lib_min_roll(sensor, rank_scan, lags)(s, lib, None, None)
    scale = float(lib.sq.max())
    diff = (got - dense).abs()
    out["roll_rank_16"] = {"max_abs_err_vs_dense": float(diff.max()), "scale": scale}
    require(bool((diff <= 4e-3 * scale + 4e-3 * dense.abs()).all()),
            f"roll_rank=16: {float(diff.max())} beyond 4e-3 of {scale}")

    for name, scan in (("fixed_point_bits_8", fixed_scan), ("roll_rank_16", rank_scan)):
        run = make_navigate_batch(dataclasses.replace(cfg, scan=scan), "roll")
        aux = run.prepare(st)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        final, _ = run(states0, st, aux)
        out[name]["success_rate"] = float(success_rate(final))
        out[name]["episode_s"] = time.perf_counter() - t0
    emit({"phase": "roll_knobs", "poses": int(s.shape[0]), **out,
          "seconds": time.perf_counter() - t_phase})


def run_checkpoint(sim: NavigationSimulator) -> None:
    """Save the spectral phase's library, load it into a fresh simulator and
    navigate the same trials: the same final states."""
    t_phase = time.perf_counter()
    want = sim.navigate(n_trials=BATCH, seed=0).final_state
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "library.npz")
        sim.save_library(path)
        size = Path(path).stat().st_size
        fresh = NavigationSimulator(sim.cfg, sim.landscape, sim.route).load_library(path)
    for a, b in zip(sim.library, fresh.library):
        require(torch.equal(a, b), "checkpoint: the loaded library differs")
    got = fresh.navigate(n_trials=BATCH, seed=0).final_state
    equal = all(torch.equal(a, b) for a, b in zip(want, got))
    emit({"phase": "checkpoint", "bytes": size, "final_states_equal": equal,
          "seconds": time.perf_counter() - t_phase})
    require(equal, "checkpoint: the loaded library navigates to other final states")


def exact_cfg(cfg: SimConfig) -> SimConfig:
    """``cfg`` for the exact kernel path: the spectral and sector knobs,
    which only ``"fft"`` reads, cleared."""
    return dataclasses.replace(
        cfg, sensor=dataclasses.replace(cfg.sensor, render_mode="full"),
        scan=dataclasses.replace(cfg.scan, spectral_cutoff=0, fused_dft_precision="off"))


def with_hat(cfg: SimConfig, hat: str) -> SimConfig:
    return dataclasses.replace(cfg, sensor=dataclasses.replace(cfg.sensor, hat_dtype=hat))


def with_scan(cfg: SimConfig, **kw) -> SimConfig:
    return dataclasses.replace(cfg, scan=dataclasses.replace(cfg.scan, **kw))


def prepared_fam(cfg: SimConfig, fam_impl: str, st):
    """``step.fam`` of ``fam_impl`` with its per-library constants built once."""
    step = make_step_batched(cfg, fam_impl)
    aux = None if step.lib_prepare is None else step.lib_prepare(st)
    return lambda s, st_: step.fam(s, st_, aux)


def check_roll_identity(cfg4: SimConfig, st4, poses4) -> dict:
    """At config 4's shapes (u = 5, SSD, cutoff 0), on the main episode's
    poses: the spectral library minimum of the sector renderer's pooled
    phi-frame panorama with ``roll_k`` against the same function of that
    panorama unrolled. Both run in fp64 and return f32, so each result must
    be within rtol 1e-9 of the other or one f32 rounding step from it. The
    sector step's candidates against the kernel path's are reported only:
    config 4's best two headings lie closer than render rounding (ROADMAP
    C.1)."""
    sensor, a_fine = cfg4.sensor, cfg4.sensor.n_fine
    lags, _ = scan_lag_sets(cfg4.scan)
    lib_min = make_lib_min_fft(sensor, cfg4.scan, lags)
    aux = lib_min.prepare(st4.lib)
    render = make_render_batch_rolled(sensor, max(2.0, cfg4.agent.step_size))
    pooled = make_pooled_panorama(sensor)
    n = not_equal = 0
    max_rel, ok = 0.0, True
    for s in poses4:
        pano, k = render(st4.landscape, s.xy, s.theta)
        s_phi = pooled(pano)
        idx = (torch.arange(a_fine, device=k.device)[None, :] + k.long()[:, None]) % a_fine
        s_theta = s_phi.gather(2, idx[:, None, :].expand(-1, s_phi.shape[1], -1))
        got = lib_min(s_phi, st4.lib, None, None, aux, roll_k=k)
        want = lib_min(s_theta, st4.lib, None, None, aux)
        diff = (got.double() - want.double()).abs()
        ulp = (torch.nextafter(want.abs(), torch.tensor(math.inf, device=want.device))
               - want.abs()).double()
        ok &= bool((diff <= torch.maximum(1e-9 * want.double().abs(), ulp)).all())
        n += got.numel()
        not_equal += int((got != want).sum())
        max_rel = max(max_rel, float((diff / want.double().abs().clamp_min(1e-30)).max()))
    sector4 = dataclasses.replace(cfg4, sensor=dataclasses.replace(sensor, render_mode="sector"))
    agree = compare_fam(prepared_fam(sector4, "fft", st4), make_step_batched(cfg4, "kernel").fam,
                        poses4, st4, cfg4.scan)
    out = {"results": n, "not_bit_equal": not_equal, "max_rel_diff": max_rel,
           "within_rtol_1e-9_or_one_f32_step": ok, "sector_vs_kernel_reported": agree}
    require(ok, f"roll identity at config 4: relative difference {max_rel} beyond rtol 1e-9 "
                "and one f32 rounding step")
    return out


def run_sector(cfg4: SimConfig, st4, poses4, dev: torch.device) -> dict:
    """Config 3 as shipped (``bench_config(3, 50)``, 256 agents): the sector
    renderer against the full renderer, the simulator's shipped episode
    against the kernel path on the same trials, candidate agreement of the
    fused and unfused sector steps with the kernel path, and the roll
    identity at config 4's shapes. Returns the render kernel's row at
    config 3's shapes."""
    t_phase = time.perf_counter()
    cfg, land, route = bench_config(3, VIEWS)
    require(cfg.sensor.render_mode == "sector" and cfg.scan.fused_dft_precision != "off",
            "config 3 ships the fused sector renderer")
    drift = max(2.0, cfg.agent.step_size)
    land_t = torch.as_tensor(land, dtype=torch.float32, device=dev)
    out = {}

    # 1. the rolled render, unrolled, against the full renderer
    spread = init_state(*make_trials(route, cfg, SECTOR_BATCH, seed=0, heading_sigma=0.5))
    for hat, tol in SECTOR_RENDER_TOL.items():
        sensor = dataclasses.replace(cfg.sensor, hat_dtype=hat)
        pano_phi, k = make_render_batch_rolled(sensor, drift)(land_t, spread.xy, spread.theta)
        full = make_render_batch(sensor)(land_t, spread.xy, spread.theta)
        err = float(np.abs(unroll_panorama(pano_phi, k) - full.cpu().numpy()).max())
        out[f"render_unrolled_vs_full_{hat}"] = err
        require(err <= tol, f"sector render {hat}: unrolled vs full max abs err {err} > {tol}")
    wsz = window_geometry(cfg.sensor)[1]
    corner = (torch.floor(spread.xy).to(torch.int32) - wsz // 2).clamp(0, land.shape[0] - wsz)
    wins = window_gather(land_t, corner[:, 1].contiguous(), corner[:, 0].contiguous(), wsz, wsz)
    render3 = check_render(wins, cfg.sensor, dev, np.random.default_rng(3))

    # 2. the shipped episode, and the kernel path on the same trials
    base = phase_memory_start()
    sim = NavigationSimulator(cfg, land, route)
    require(sim.fam_impl == "fft", f"config 3's auto resolved to {sim.fam_impl!r}")
    require(make_step_batched(cfg, sim.fam_impl).fam.fused,
            "config 3 did not take the fused sector front end")
    sim.train()
    res, counts, episode_s = timed_navigate(sim, n_trials=SECTOR_BATCH, seed=0)
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    t_max = cfg.agent.max_steps
    require(res.record.k.shape == (SECTOR_BATCH, t_max), "sector record shape")
    require(bool(torch.isfinite(res.record.fam[~res.record.done]).all()), "non-finite familiarity")
    require_render_only(counts, "sector")

    kcfg = exact_cfg(cfg)
    st = make_statics(land, sim.library, route)
    states0 = init_state(*make_trials(route, cfg, SECTOR_BATCH, seed=0))
    base = phase_memory_start()
    run_k = make_navigate_batch(kcfg, "kernel")
    final_k, rec_k = run_k(states0, st)
    rate_k = float(success_rate(final_k))
    peak_k = (torch.cuda.max_memory_allocated() - base) / 1e9
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rate_k2 = float(success_rate(run_k(states0, st)[0]))
    kernel_episode_s = time.perf_counter() - t0
    require(rate_k2 == rate_k, "a repeated kernel episode gave another success rate")

    # 3. candidate agreement on the kernel episode's poses
    poses = episode_poses(cfg, states0, rec_k)
    exact = with_scan(with_hat(cfg, "float32"), spectral_cutoff=0)
    kernel_f32 = prepared_fam(with_hat(kcfg, "float32"), "kernel", st)
    fused_f32 = prepared_fam(exact, "fft", st)
    agree = {
        "fused_vs_kernel": compare_fam(fused_f32, kernel_f32, poses, st, cfg.scan),
        "fused_vs_unfused": compare_fam(
            fused_f32, prepared_fam(with_scan(exact, fused_dft_precision="off"), "fft", st),
            poses, st, cfg.scan),
        "shipped_cutoff_vs_kernel_reported": compare_fam(
            prepared_fam(with_hat(cfg, "float32"), "fft", st), kernel_f32, poses, st, cfg.scan),
        "shipped_bf16_vs_kernel_bf16_reported": compare_fam(
            prepared_fam(cfg, "fft", st), prepared_fam(kcfg, "kernel", st), poses, st, cfg.scan),
    }
    roll = check_roll_identity(cfg4, st4, poses4)
    emit({
        "phase": "sector", "fam_impl": sim.fam_impl, "front_end": "fused", "batch": SECTOR_BATCH,
        "max_steps": t_max, "library_views": int(sim.library.views.shape[0]),
        "lags": len(scan_lag_sets(cfg.scan)[0]), "spectral_cutoff": cfg.scan.spectral_cutoff,
        **out, "render_kernel_config3": render3, "success_rate": res.success_rate,
        "kernel_success_rate": rate_k, "episode_s": episode_s,
        "agent_steps_per_s": SECTOR_BATCH * t_max / episode_s,
        "kernel_episode_s": kernel_episode_s,
        "kernel_agent_steps_per_s": SECTOR_BATCH * t_max / kernel_episode_s,
        "launches": counts, "peak_mem_gb": peak, "kernel_peak_mem_gb": peak_k,
        "poses": len(poses) * SECTOR_BATCH, "pose_steps": list(LAG_POSE_STEPS),
        "agreement_f32_cutoff_0": agree, "roll_identity_config4": roll,
        "seconds": time.perf_counter() - t_phase,
    })
    require(abs(res.success_rate - rate_k) <= ACCURACY_BAND_3,
            f"sector: success {res.success_rate} vs the kernel path's {rate_k}")
    for name in ("fused_vs_kernel", "fused_vs_unfused"):
        require(agree[name]["same_k"] >= 0.999,
                f"sector {name}: only {agree[name]['same_k']:.5f} equal candidates")
    return render3


def run_sweep_phase() -> None:
    """The default ``SweepSpec`` (8 cells, 256 trials, 256 steps, early exit)
    on the bench world with a 128-trial recall check, into a temporary
    directory; then the same sweep again, which must resume every cell from
    disk and launch no kernel."""
    t_phase = time.perf_counter()
    _, land, route = bench_config(4, VIEWS)  # the bench world
    spec = SweepSpec()
    with tempfile.TemporaryDirectory() as tmp:
        ops.reset_launch_counts()
        res = run_sweep(land, route, spec, tmp, verbose=False, tensorboard=False,
                        recall_check_trials=SWEEP_RECALL_TRIALS)
        counts = ops.launch_counts()
        ops.reset_launch_counts()
        again = run_sweep(land, route, spec, tmp, verbose=False, tensorboard=False,
                          recall_check_trials=SWEEP_RECALL_TRIALS)
        resumed_counts = ops.launch_counts()
        summary = json.loads((Path(tmp) / "summary.json").read_text())
    cells = {}
    for key, cfg, _ in spec.cells():
        r = res[key]
        impl, want = str(r["fam_impl"]), resolve_fam_impl(cfg, "auto")
        cells[key] = {
            "fam_impl": impl, "success_rate": float(r["success_rate"]),
            "agent_steps_per_s": float(r["agent_steps_per_s"]),
            "executed_steps": float(r["executed_steps"]), "wall_s": float(r["wall_s"]),
            "warmup_s": float(r["warmup_s"]), "library_views": int(r["n_library_views"]),
        }
        if "success_rate_jnp" in r:
            cells[key]["success_rate_subset"] = float(r["success_rate_subset"])
            cells[key]["success_rate_kernel_check"] = float(r["success_rate_jnp"])
        require(impl == want, f"sweep {key}: ran {impl!r}, auto resolves to {want!r}")
        require(float(again[key]["success_rate"]) == float(r["success_rate"]),
                f"sweep {key}: the resumed result differs")
    emit({"phase": "sweep", "cells": cells, "n_trials": spec.n_trials,
          "max_steps": spec.max_steps, "recall_check_trials": SWEEP_RECALL_TRIALS,
          "launches": counts, "resumed_launches": resumed_counts,
          "summary_cells": len(summary), "seconds": time.perf_counter() - t_phase})
    for key, c in cells.items():
        if c["fam_impl"] == "fft":
            d = abs(c["success_rate_subset"] - c["success_rate_kernel_check"])
            require(d <= ACCURACY_BAND, f"sweep {key}: fft recall {d} from the kernel path's")
    require(len(again) == len(res) == 8, "sweep: the default grid has 8 cells")
    require(not any(resumed_counts.values()), f"sweep resume launched kernels: {resumed_counts}")
    require(len(summary) == 8, f"sweep: summary.json lists {len(summary)} cells")
    for name in MAIN_KERNELS:
        require(counts[name] > 0, f"sweep: kernel {name} was not launched")


def run_golden() -> None:
    """The small parity world of the test suite: the port's own library and
    a one-agent episode on the card against the frozen float64 fixture, at
    the JAX package's golden tolerances."""
    cfg = SimConfig(
        sensor=SensorConfig(n_radial=4, n_azimuth=24, az_upsample=3, r_min=2.0, r_max=8.0),
        scan=ScanConfig(n_headings=12, scan_step_bins=2),
        agent=AgentConfig(step_size=1.0, goal_radius=2.0, corridor=15.0, max_steps=48),
        capture_spacing=1.5,
    )
    land = make_landscape("blobs", size=(128, 128), seed=3, n_features=60)
    route = make_route("line", size=(128, 128), margin=32.0, length=40.0)
    t0 = time.perf_counter()
    with np.load(GOLDEN) as f:
        gold = {k: f[k] for k in f.files}
    lib = train_library(land, route, cfg)
    lib_err = float(np.abs(lib.views.cpu().double().numpy() - gold["library"]).max())
    st = make_statics(land, lib, route)
    pts, hd = resample_route(route, cfg.capture_spacing)
    final, rec = make_navigate_batch(cfg, fam_impl="kernel")(init_state(pts[:1], hd[:1]), st)
    k = rec.k[0, :6].cpu().numpy()
    xy_err = float(np.abs(rec.xy[0, :6].cpu().double().numpy() - gold["xy"][:6]).max())
    fam = rec.fam[0, :6].cpu().double().numpy()
    fam_ok = bool(np.all(np.abs(fam - gold["fam"][:6]) <= 5e-4 + 1e-3 * np.abs(gold["fam"][:6])))
    n_steps = int((~rec.done[0]).sum())
    final1, rec1 = navigate(land, lib, route, pts[0], hd[0], cfg)  # the one-agent API
    one_agent_equal = all(torch.equal(a, b[0]) for a, b in zip(rec1 + final1, rec + final))
    emit({"phase": "golden", "library_max_abs_err": lib_err, "k": k.tolist(),
          "golden_k": gold["k"][:6].tolist(), "xy_max_abs_err": xy_err,
          "steps": n_steps, "golden_steps": len(gold["xy"]), "status": int(final.status[0]),
          "one_agent_navigate_equal": one_agent_equal, "seconds": time.perf_counter() - t0})
    require(one_agent_equal, "golden: navigate() differs from the batched one-agent episode")
    require(np.array_equal(k, gold["k"][:6]), "golden: first 6 candidates differ")
    require(xy_err <= 1e-4, f"golden: positions off by {xy_err}")
    require(fam_ok, "golden: familiarity beyond atol 5e-4 / rtol 1e-3")
    require(int(final.status[0]) == STATUS_REACHED, "golden: the agent did not reach the goal")
    require(abs(n_steps - len(gold["xy"])) <= 5, "golden: step count off by more than 5")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    dev = resolve_device("cuda")  # also switches TF32 off for matmuls and convolutions
    card = card_line()
    emit({"phase": "card", "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "name": torch.cuda.get_device_name(0)})

    build_s, logs = _build.build_all()
    emit({"phase": "build", "seconds": build_s, **check_build(logs)})

    cfg, land, route = slice_config()
    t0 = time.perf_counter()
    results = check_kernels(cfg, dev)
    # what the two timers charge any launch: a kernel that does nothing
    empty = {"ms": time_ms(lambda: torch.cuda._sleep(0)),
             "ms_in_run": time_ms_in_run(lambda: torch.cuda._sleep(0))}
    emit({"phase": "kernels", **results, "empty_kernel": empty,
          "seconds": time.perf_counter() - t0})
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    st, states0, final, rec, counts = run_main_path(cfg, land, route)
    run_reference(cfg, st, states0, final, rec)
    launches = {name: (n, "main") for name, n in counts.items()}
    poses = episode_poses(cfg, states0, rec)
    launches["lag_fam"] = (run_lag(cfg, st, poses), "lag phase")
    sim = run_spectral(cfg, st, poses, float(success_rate(final)))
    render3 = run_sector(cfg, st, poses, dev)
    del st, states0, final, rec, poses
    torch.cuda.empty_cache()
    run_roll_knobs(*run_roll())
    run_checkpoint(sim)
    del sim
    torch.cuda.empty_cache()
    run_sweep_phase()
    run_golden()

    results["render"]["config3"] = {key: render3[key] for key in (
        "shape", "ms", "ms_in_run", "plain_ms", "bound_ms", "bound_by", "library_ms")}
    kernels = [
        {"name": name, "route": r["route"], "source": r["source"], "replaces": r["replaces"],
         "launches": launches[name][0], "launches_in": launches[name][1],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "library_ms": r["library_ms"], **({"config3": r["config3"]} if "config3" in r else {})}
        for name, r in results.items()
    ]
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
