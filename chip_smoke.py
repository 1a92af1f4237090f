"""Drive the port (navdv_torch) on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, one JSON line each:

1. card   — the card's name and power limit (nvidia-smi);
2. build  — every CUDA kernel of the main path, built from ``navdv_torch/csrc``
            (one nvcc per source, all started together);
3. kernels — each kernel against its plain PyTorch version at the main
            path's shapes (BASELINE config 4: 1024 agents, 72x16 sensor with
            a 360-bin fine panorama, 60 lags, 50 library views), with inputs
            from ``numpy.random.default_rng(0)``; median times from CUDA events;
4. main   — config 4 with the exact familiarity path (``spectral_cutoff=0``):
            train a 50-view library on the 512^2 blobs world, then a batched
            episode of 1024 agents with ``fam_impl="kernel"``; every kernel's
            launch count over that run must be > 0;
5. reference — the same episode with ``fam_impl="plain"``: success rates
            within 0.025, >= 99% of agents choose the same first candidate;
6. golden — the port's own training plus a one-agent episode on the small
            parity world against ``tests/golden_oracle_small.npz``.

Then the card line, the kernels line and, last, ``{"ok": true, "device": ...}``.
Any failed check raises and the script exits non-zero. Without a CUDA device
it exits 2 and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from navdv_torch import _build, ops
from navdv_torch.agent import STATUS_REACHED, init_state, make_navigate_batch, make_statics
from navdv_torch.config import (
    AgentConfig,
    ScanConfig,
    SensorConfig,
    SimConfig,
    baseline_config,
)
from navdv_torch.device import resolve_device
from navdv_torch.familiarity import zscore
from navdv_torch.landscape import make_landscape
from navdv_torch.metrics import episode_metrics, success_rate
from navdv_torch.ops.familiarity import min_distance_rows, min_distance_rows_plain
from navdv_torch.ops.render import render_windows, render_windows_plain
from navdv_torch.ops.window import window_gather, window_gather_plain
from navdv_torch.oracle import resample_route
from navdv_torch.routes import make_route
from navdv_torch.sensor import polar_offsets, window_geometry
from navdv_torch.training import train_library
from navdv_torch.trials import make_trials

# NVIDIA H100 SXM data sheet: HBM3 bandwidth, and the peak that is both the
# fp32 rate outside the tensor cores and the fp64 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = 67e12

BATCH = 1024
VIEWS = 50
ROUTE_LENGTH = 40.0
ACCURACY_BAND = 0.025  # config 4's success-rate band (bench.py ACCURACY_BAND[4])
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


def time_ms(fn, runs: int = 25, warmup: int = 3) -> float:
    """Median device time of ``fn()`` in ms, one CUDA-event pair per run.

    Before each run a sleep kernel holds the device while the host enqueues
    the run, so its kernels execute back to back and the events measure
    device time, not the host's time to prepare the launches."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        require(not start.query(), "timing: the device sleep ended before the run was queued")
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    """Least time the card could take: max(bytes / HBM rate, flops / peak)."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def slice_config() -> tuple[SimConfig, np.ndarray, np.ndarray]:
    """BASELINE config 4 on the bench world: 512^2 blobs (seed 7, 150
    features), sine route of length 40, 50 stored views, a step budget of
    1.3x the route's arc. ``spectral_cutoff`` belongs to the JAX spectral
    path and is cleared for the exact path."""
    cfg = baseline_config(4)
    land = make_landscape("blobs", size=(512, 512), seed=7, n_features=150)
    route = make_route("sine", size=(512, 512), margin=60.0, length=ROUTE_LENGTH,
                       amplitude=ROUTE_LENGTH / 8.0)
    arc = float(np.hypot(*np.diff(route, axis=0).T).sum())
    cfg = dataclasses.replace(
        cfg,
        scan=dataclasses.replace(cfg.scan, spectral_cutoff=0),
        capture_spacing=arc / (VIEWS - 0.5),
        agent=dataclasses.replace(cfg.agent, max_steps=int(arc / cfg.agent.step_size * 1.3)),
    )
    return cfg, land, route


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
    results["window_gather"] = dict(
        route="cuda", source="navdv_torch/csrc/window.cu",
        replaces="navdv_tpu/ops/window_pallas.py:88",
        max_abs_err=err, tolerance="exact",
        ms=time_ms(lambda: window_gather(land, by, bx, wy, wx)),
        plain_ms=time_ms(lambda: window_gather_plain(land, by, bx, wy, wx)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
    )

    # render: windows from the gather above, poses as the main path makes them
    win = got
    dx0_np, dy0_np = polar_offsets(sensor)
    dx0 = torch.from_numpy(dx0_np).to(dev)
    dy0 = torch.from_numpy(dy0_np).to(dev)
    half = wx // 2
    theta = rng.uniform(-math.pi, math.pi, size=BATCH)
    fxy_np = np.stack([
        rng.uniform(half, half + 1, size=BATCH), rng.uniform(half, half + 1, size=BATCH),
        np.cos(theta), np.sin(theta)], axis=1).astype(np.float32)
    fxy = torch.from_numpy(fxy_np).to(dev)
    render = {}
    for mode, hat_bf16, tol in (("f32", False, 1e-4), ("bf16", True, 2e-3)):
        got = render_windows(win, fxy, dx0, dy0, hat_bf16)
        want = render_windows_plain(win, fxy, dx0, dy0, hat_bf16)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        require(err <= tol, f"render {mode}: max abs err {err} > {tol}")
        render[mode] = dict(
            max_abs_err=err, tolerance=f"atol {tol}",
            ms=time_ms(lambda: render_windows(win, fxy, dx0, dy0, hat_bf16)),
            plain_ms=time_ms(lambda: render_windows_plain(win, fxy, dx0, dy0, hat_bf16)),
        )
    # yardstick: grid_sample computes the f32 function (bilinear, border clamp)
    fx, fy, c, s = (fxy[:, i, None, None] for i in range(4))
    xs = ((fx + c * dx0) - s * dy0).clamp(0.0, wx - 1.0)
    ys = ((fy + s * dx0) + c * dy0).clamp(0.0, wy - 1.0)
    grid = torch.stack([xs / (wx - 1) * 2 - 1, ys / (wy - 1) * 2 - 1], dim=-1)
    win4 = win[:, None]

    def grid_sample():
        return torch.nn.functional.grid_sample(
            win4, grid, mode="bilinear", padding_mode="border", align_corners=True)

    lib_err = float((grid_sample()[:, 0] - render_windows_plain(win, fxy, dx0, dy0, False))
                    .abs().max())
    require(lib_err <= 1e-4, f"grid_sample yardstick: max abs err {lib_err} > 1e-4")
    render["f32"]["library_max_abs_err"] = lib_err
    samples = BATCH * dx0.numel()
    b_ms, b_by = bound(nbytes(win, fxy, dx0, dy0) + samples * 4, samples * 29)
    results["render"] = dict(
        route="cuda", source="navdv_torch/csrc/render.cu",
        replaces="navdv_tpu/ops/render_pallas.py:61",
        max_abs_err=render["bf16"]["max_abs_err"], tolerance="atol 2e-3 (bf16 mode)",
        ms=render["bf16"]["ms"], plain_ms=render["bf16"]["plain_ms"],
        f32_mode=render["f32"],
        bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(grid_sample),
    )

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
            plain_ms=time_ms(lambda: min_distance_rows_plain(aa, bb, gamma, alpha, with_rowsq)),
        )
        del a64, b64, want, diff
    flops = 2.0 * rows_n * nl * p + 2.0 * rows_n * p  # cross term + |a|^2
    b_ms, b_by = bound(nbytes(a, b) + nl * 4 + rows_n * 4, flops)
    results["min_distance"] = dict(
        route="cuda", source="navdv_torch/csrc/min_distance.cu",
        replaces="navdv_tpu/ops/familiarity_pallas.py:103",
        max_abs_err=metrics["ssd"]["max_abs_err"], tolerance=metrics["ssd"]["tolerance"],
        ms=metrics["ssd"]["ms"], plain_ms=metrics["ssd"]["plain_ms"],
        ncc=metrics["ncc"], bound_ms=b_ms, bound_by=b_by, library_ms=None,
    )
    return results


def run_main_path(cfg, land, route):
    """Training + one batched episode through the kernels; returns what the
    reference phase compares against."""
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
    counts = ops.launch_counts()
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
    })
    require(abs(rate_k - rate_p) <= ACCURACY_BAND,
            f"success rates differ: kernel {rate_k} vs plain {rate_p}")
    require(same_k0 >= 0.99, f"only {same_k0:.4f} of agents chose the same first candidate")


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
    emit({"phase": "golden", "library_max_abs_err": lib_err, "k": k.tolist(),
          "golden_k": gold["k"][:6].tolist(), "xy_max_abs_err": xy_err,
          "steps": n_steps, "golden_steps": len(gold["xy"]), "status": int(final.status[0])})
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
    emit({"phase": "build", "seconds": build_s,
          "ptxas": {name: [ln.strip() for ln in log.splitlines()
                           if "registers" in ln or "spill" in ln]
                    for name, log in logs.items()}})

    cfg, land, route = slice_config()
    results = check_kernels(cfg, dev)
    emit({"phase": "kernels", **results})
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    st, states0, final, rec, counts = run_main_path(cfg, land, route)
    run_reference(cfg, st, states0, final, rec)
    run_golden()

    kernels = [
        {"name": name, "route": r["route"], "source": r["source"], "replaces": r["replaces"],
         "launches": counts[name], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "library_ms": r["library_ms"]}
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
