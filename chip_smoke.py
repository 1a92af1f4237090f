"""Drive the port (navdv_torch) on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, one JSON line each:

1. card   — the card's name and power limit (nvidia-smi);
2. build  — every CUDA kernel of the main path, built from ``navdv_torch/csrc``
            (one nvcc per source, all started together); ptxas must report no
            spills in any of the five libraries, and ``cuobjdump -sass`` must
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
            their plain versions bit for bit; so must the render kernel's
            pooled entry (``render_pooled``, the step's front: render and
            the u-tap box filter in one launch), timed beside the route it
            replaces (render, bf16 cast, f32 copy back, the f32 product
            against the 0/1 box matrix) with its share of bit-equal
            elements against that route. The window gather's yardstick
            is one PyTorch indexing call on a strided view of the landscape
            (``unfold``), the render kernel's ``grid_sample``; the port calls
            neither.
            The fused lag kernel is also timed against the port's unfused
            route for the same familiarity (pooled panorama -> candidate
            views -> min-distance kernel -> window pool). ``dgemm_ms`` is the
            time of the fp64 cuBLAS product ``a64 @ b64.T`` at the
            min-distance shape: what DMMA reaches there through cuBLAS, not a
            computation of the kernel's function. The min-distance kernel's
            pooled entry (``min_distance_pooled``, the main path's scorer,
            which forms the candidates from the pooled panorama) must equal
            the rows entry on the gathered candidates bit for bit; it is
            timed beside that entry (``rows_ms``), the gather and permute
            copy (``gather_ms``) and the two together (``route_ms``), the
            route it replaces. The decision kernel
            (``ops.decide``) must equal its plain version bit for bit at
            B = 1024 and B = 1 (``b1``) on the bench route; it replaces no
            TPU kernel, so it has no yardstick;
4. main   — config 4 with the exact familiarity path (``spectral_cutoff=0``):
            train a 50-view library on the 512^2 blobs world, then a batched
            episode of 1024 agents with ``fam_impl="kernel"``; the launch
            count of each of its four kernels (window, the pooled render,
            the pooled min-distance entry, the decision) over that run must
            be > 0, and the rows entry's 0 (below, "render launched" means
            the pooled render wherever the sensor pools, u > 1, and the
            plain render at u = 1, as in config 3);
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
7. reference_functions — the JAX package's reference functions (ROADMAP
            A.20) on the main episode's 4 x 1024 poses at config 4:
            ``make_familiarity_jnp`` over the extended shift set's candidate
            views equal to the ``"plain"`` step's familiarity within rtol
            1e-9 and the kernel path's tie-ordered candidate at >= 99.9% of
            poses; ``make_render_panorama_gather`` within 1e-5 of the window
            renderer (f32);
8. spectral — config 4 as shipped (``spectral_cutoff=72``) through
            ``NavigationSimulator`` with its default ``fam_impl="auto"``, which
            must resolve to ``"fft"``: the main phase's 1024 trials, success
            within 0.025 of the main phase's; the episode must launch the
            window and render kernels and neither distance kernel. At
            ``spectral_cutoff=0``, on the lag phase's 4 x 1024 poses, >= 99.9%
            of tie-ordered candidates must equal the kernel path's
            ``step.fam`` (the shipped cutoff's agreement is reported only);
9. sector — config 3 as shipped (64x360 sensor, NCC, tol_bins 3, the fused
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
10. roll   — config 2 as shipped (500 views, 120 headings, 512 trials)
            through ``NavigationSimulator``, whose ``"auto"`` must resolve to
            ``"roll"``, against the kernel path on the same trials: success
            within 0.010 (``bench.py`` ACCURACY_BAND[2]), >= 99.9% of agents
            with the same first candidate, window and render launched, no
            distance kernel;
11. roll_knobs — one config-2 library minimum on the roll phase's poses:
            ``fixed_point_bits=8`` equals a float64 evaluation of the
            quantized SSD to rtol 2e-7, ``roll_rank=16`` is within 4e-3 of the
            largest |l|^2 of the dense roll path; one episode with each knob,
            its success rate reported only;
12. checkpoint — the spectral phase's library saved and loaded into a fresh
            simulator, whose episode must give the same final states;
13. sweep — the default ``SweepSpec`` (config 5: 8 cells, 256 trials, 256
            steps, early exit) on the bench world with a 128-trial recall
            check: each cell runs the path "auto" resolves to (``kernel`` at
            36x8, ``fft`` at 72x16), each fft cell's recall within 0.025 of
            the kernel path's on its subset; a second run resumes all 8 cells
            from disk and launches no kernel; ``summary.json`` lists 8 cells;
14. conv   — (after sector) the conv path at config 4's width (cutoff 0) on
            the main episode's library: >= 99.9% of tie-ordered candidates
            equal to the kernel path's on the lag phase's 4 x 1024 poses,
            one episode on the main trials with success within 0.025 of
            the kernel path's, window and render launched and no distance
            kernel; device ms/step, and the fp64 contraction by ``conv1d``
            timed beside the port's unfold product (equal to 1e-12);
15. infomax — (after conv) the learned memory at config 1's width (1024
            agents, AUTO dose) on the main library: trained on the card
            (seconds; ``infomax_counts()`` one training of
            ``applied_updates`` updates), one epoch on the card within
            1e-4 (relative Frobenius) of the CPU's from the same initial
            weights, the ``.npz`` checkpoint giving bit-equal
            ``step.fam``, one episode (success reported only), window and
            render launched and no distance kernel;
16. analysis — (after sweep) config 1 as shipped: the RIDF valley within
            one fine bin of 0 on ``"kernel"`` and ``"auto"``, the stride-8
            familiarity map (3,844 positions, 4 batches of 1024) on
            ``"kernel"``, which must launch window, render and min distance,
            and on ``fft`` at cutoff 0, which must choose the same best
            heading at >= 99.9% of positions and the same familiarity
            within 1e-6 of scale (the shipped cutoff's agreement reported
            only); ms per batch, catchment fractions and the
            heading error at every capture pose;
17. golden — the port's own training plus a one-agent episode on the small
            parity world against ``tests/golden_oracle_small.npz``; the
            one-agent ``navigate()`` must give the batched episode's record;
18. parallel — (after sweep) ``navdv_torch.parallel`` over ranks this
            script starts as processes of its own (``--parallel-child``,
            torchrun's variables): NCCL with a card per rank where there are
            2 cards or more (a world of 4 from 4 cards, else 2), gloo with 2
            ranks sharing the one card otherwise. First the min-distance
            kernel on a library shard that holds padding (the main library
            padded to 52 views, its last shard) against that shard's real
            views: the same familiarity (rtol 1e-6). Then, held against the
            unsharded results: (a) the main episode (1024 trials, 50 views,
            66 steps, ``"kernel"``) on meshes (world, 1), (1, world) and, in
            a world of 4, (2, 2): >= 99.9% same first k, first-step fam
            within rtol 1e-6, success within 0.025, exactly one MIN
            collective per step on every rank of a lib mesh, window, render
            and min distance launched on every rank; bit-equality of k, fam
            and status reported; (b) the lib-axis probe at the main trials'
            start poses: >= 99.9% same best heading; (c) config 2 on
            ``"roll"`` (500 views, 512 trials) on (1, world) against the roll
            phase: success within 0.010, >= 99.9% same first candidate; (d)
            the default ``SweepSpec`` with cells over (world, 1): every
            cell's success equal to the sweep phase's, then resumed with no
            launch. Reported: each mesh's episode seconds (the slowest
            rank's) and agent-steps/s, and the MIN's time per step alone.
            Each mesh's run must replay CUDA graphs unless its lib group is
            on gloo, and each rank's slice must equal the eager episode's
            (``make_navigate_batch_fn``) bit for bit;
19. big_landscape — (after golden) config 1 on the 4096^2 fractal world of
            ``bench.py run_big_landscape`` (67 MB, past the TPU window
            kernel's VMEM budget and the card's 50 MB L2; the landscape is
            made once): ``NavigationSimulator`` with "auto", which must
            resolve to ``"fft"``, on 1024 trials, the captured episode equal
            to the eager one bit for bit, success at or above the exact
            kernel path's recall on 256 trials less 0.025, window and render
            launched and no distance kernel (the gate launches min
            distance); the landscape on the card once. Then the window
            gather and render kernels (f32 and bf16) at the trials' corners
            (clustered) and at uniform corners (spread), each equal to its
            plain version bit for bit and timed in the kernels phase's
            timers beside its yardstick and bound; at the spread poses the
            window renderer (f32) within 1e-5 of the gather renderer
            evaluated in fp64 (in f32 its absolute coordinates round to
            1.2e-4 px near x = 2048; that error is reported);
20. memory — captured memory (ROADMAP C.13) on the bench world, with
            ``capture.MAX_PROGRAMS`` bounded and then lifted (the caches as
            before the bound): allocated and reserved GB after each cell of
            the default sweep (``run_sweep``), of a grid of 12 distinct
            cells (views x max_steps x fam_impl, one ProgramCache) and of
            40 familiarity maps on distinct configurations (r_max x metric
            x fam_impl), the grid and the maps then revisiting their first
            two configurations; and the GB of the card's graph pool (its
            segments and the bytes allocated in them, from
            ``torch.cuda.memory_snapshot``). Each series runs in a pool of
            its own (``capture.release_pool`` before it), and bounded, each
            configuration of the grid and the maps also runs alone in a
            pool of its own: what its programs took, as each had a private
            pool before they shared one. Bounded, the pool after all
            configurations within 5% of the most that MAX_PROGRAMS
            consecutive configurations took alone (what their own pools
            held at once), the revisit adding at most 5%, at most
            MAX_PROGRAMS graphs alive at the end, and the pool's segments
            returned to the card once its graphs are released and the pool
            given up; the sweep's results and launch counts equal to the
            unbounded run's;
21. graphs — the JAX package's compiled programs as CUDA graphs
            (``navdv_torch/capture.py``), each against its eager
            counterpart on the same inputs: one window-gather launch, then
            ``make_navigate_batch`` against ``make_navigate_batch_fn`` on
            config 4 ``kernel`` (cutoff 0), config 4 ``fft`` as shipped,
            config 2 ``roll`` (500 views, 512 agents), config 3 on the
            fused sector path (256 agents), config 4 ``conv`` and config 1
            ``infomax``, whose training (AUTO dose) must give the eager
            loop's W bit for bit; the default sweep's first cell (256
            trials, 256 steps) with early exit at every chunk size of
            GRAPH_CHUNKS; config 1's stride-8 familiarity map on
            ``kernel`` (captured ``probe.best`` against ``probe.best.eager``).
            Each must give bit-equal final states and records (and map),
            equal launch counts (under early exit, the captured chunks also
            launch their masked steps: per step x chunks x chunk size), and
            leave a result held from its first call unchanged. Reported:
            each episode's wall time, eager and captured, the training
            seconds, and per chunk size the early exit's time (median and
            quartiles of CHUNK_ROUNDS runs, the chunk sizes in round robin).
            The earlier phases already run captured episodes, so their
            launch counts are replays' counts;
22. graft_entry — (after graphs) the entry points of
            ``navdv_torch/graft_entry.py`` (the counterpart of the repo-root
            ``__graft_entry__.py``) on their tiny world (96^2 blobs, a
            4x24 sensor, 12 headings, ~16 library views): ``entry()``'s
            step of 8 agents, captured, must equal the eager step bit for
            bit and launch window, render and min distance (counts from 0
            around it); window and render at its shapes (B=8, and B=2, the
            slice each rank of the 8-rank gate's (8, 1) mesh renders)
            bit-equal to their plain versions, min distance on its
            candidate rows within rtol/atol 1e-6 of its plain version, each
            timed; then ``python -m navdv_torch.graft_entry dryrun 8`` and
            ``dryrun <cards>`` as processes, every line echoed: exit code
            0, the ``dryrun_multichip ok`` line last with every mesh of
            ``mesh_shapes``, NCCL with every mesh captured where the ranks
            have a card each, gloo otherwise with the data meshes captured
            and the lib meshes eager, window and render launched on every
            rank of every mesh and no distance kernel (the gate runs
            ``fft``);
23. bench — (last) the port's bench as a user runs it, each command in a
            process of its own: ``python -m navdv_torch.cli bench --all``
            (the 7 headline and latency lines of configs 1-4 and config 1
            at B=1/16/64, then the kernel parity gates at config 1 (SSD)
            and config 3 (NCC), the sector gate, the fft and roll precision
            gates) and ``... bench --big-landscape 4096 --repeats 1``. Each
            line is echoed, then checked: exit code 0, no error line,
            ``device`` "gpu" and the card named, ``ok: true`` on every line
            but the B=1 and B=16 latency lines, which carry the JAX bench's
            ``gate`` marker; the window and render kernels launched on
            every line, the min-distance kernel on the parity gates, the
            big landscape's exact gate and at least one headline gate, the
            lag kernel on none.

Every phase line carries its ``seconds``. Then the card line, the kernels
line (with each kernel's ``launches_by_phase``: main, lag, conv, infomax,
parallel (summed over ranks and meshes), analysis, big_landscape,
graft_entry (the entry step and the two gates' ranks, summed), bench
(summed over the bench's lines); rows 1-2 also at config 3's shapes and at
4096^2, rows 1-3 at the graft entry's shapes) and, last, ``{"ok":
true, "device": ...}``. Any failed check raises and the script exits
non-zero. Without a CUDA device it exits 2 and prints no result.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import datetime
import gc
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from navdv_torch import _build, agent, capture, graft_entry, ops, sweep
from navdv_torch.analysis import (
    _AUX_CACHE,
    _STATICS_CACHE,
    _make_familiarity_probe,
    catchment,
    familiarity_map,
    full_circle_scan,
    heading_error,
    make_familiarity_probe,
    ridf,
)
from navdv_torch.agent import (
    STATUS_REACHED,
    AgentState,
    init_state,
    make_navigate_batch,
    make_navigate_batch_fn,
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
from navdv_torch.capture import Captured, ProgramCache
from navdv_torch.checkpoint import load_infomax, save_infomax
from navdv_torch.device import resolve_device
from navdv_torch.familiarity import (
    PAD_PENALTY,
    LibraryPack,
    make_familiarity_jnp,
    pack_library,
    pad_library,
    zscore,
)
from navdv_torch.familiarity_conv import conv_lag_geometry, unfold_contraction
from navdv_torch.familiarity_fft import make_lib_min_fft
from navdv_torch.familiarity_infomax import (
    applied_updates,
    infomax_counts,
    initial_weights,
    reset_infomax_counts,
    train_infomax,
)
from navdv_torch.familiarity_roll import make_lib_min_roll
from navdv_torch.landscape import make_landscape
from navdv_torch.metrics import episode_metrics, success_rate
from navdv_torch.ops.decide import Route, decide, decide_constants, decide_plain
from navdv_torch.ops.familiarity import (
    make_lib_min_kernel,
    min_distance_pooled,
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
from navdv_torch.ops.render import (
    render_pooled,
    render_pooled_plain,
    render_pooled_smem_bytes,
    render_smem_bytes,
    render_windows,
    render_windows_plain,
)
from navdv_torch.ops.window import window_gather, window_gather_plain
from navdv_torch.oracle import resample_route
from navdv_torch.parallel import (
    collective_counts,
    init_distributed,
    launch_ranks,
    make_mesh,
    make_navigate_sharded,
    reset_collective_counts,
    shard_statics,
)
from navdv_torch.routes import make_route
from navdv_torch.sensor import (
    make_pooled_panorama,
    make_render_batch,
    make_render_batch_rolled,
    make_render_panorama,
    make_render_panorama_gather,
    make_views_from_pooled,
    polar_offsets,
    scan_lag_sets,
    scan_shift_sets,
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
# the kernel path's familiarity map: the step's kernels but the decision
# (SSD: the min-distance kernel's pooled entry forms the candidates itself)
# (the full renderer pools: u > 1 renders through the pooled entry, u = 1
# through the plain one, as config 3 does)
MAP_KERNELS = ("window_gather", "render_pooled", "min_distance_pooled")
MAIN_KERNELS = (*MAP_KERNELS, "decide")
RENDER_KERNELS = ("window_gather", "render_pooled")
DISTANCE_KERNELS = ("min_distance", "min_distance_pooled", "lag_fam")
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
MAP_STRIDE = 8.0  # analysis phase: ~3,700 grid positions on the 512^2 world
MAP_BATCH = 1024
# analysis phase: the kernel map against the fft map at cutoff 0, both fp64
# distances, |dfam| over the library's largest squared norm
MAP_DFAM_TOL = 1e-6
PARALLEL_TIMEOUT_S = 600  # the parallel phase's ranks, all together
PARALLEL_GROUP_TIMEOUT_S = 300  # a rank that waits longer in a collective fails
# graphs phase: early-exit chunk sizes, steps per replay (agent.EXIT_CHUNK
# is the default)
GRAPH_CHUNKS = (1, 2, 4, 8, 16, 32, 64, 256)
CHUNK_ROUNDS = 9  # timed early exits per chunk size, in round robin
SLEEP_CYCLES = 50_000_000  # ~25 ms at the H100's clock: outlasts enqueuing one run
# reference_functions phase: make_familiarity_jnp against the plain step
# (both fp64, rounded to f32 once), the gather renderer against the window
# renderer (f32)
REFERENCE_FAM_RTOL = 1e-9
REFERENCE_RENDER_TOL = 1e-5
# big_landscape phase: bench.py run_big_landscape's world and gate
BIG_SIZE = 4096
BIG_GATE_BATCH = 256  # bench.py GATE_BATCH
ACCURACY_BAND_1 = 0.025  # config 1's (bench.py ACCURACY_BAND[1])
TPU_VMEM_LAND_MAX_ELEMS = 2_000_000  # navdv_tpu/ops/window_pallas.py:37, the TPU kernel's
BIG_KERNEL_KEYS = ("max_abs_err", "distinct_cells", "ms", "ms_in_run", "plain_ms", "library_ms",
                   "library_ms_in_run", "bound_ms", "bound_by", "f32_mode",
                   "gather_render_max_abs_err_f32", "gather_f32_own_max_abs_err")
# memory phase: views x max_steps x fam_impl (12 cells); r_max x metric x
# fam_impl (40 maps, stride 32: one batch of 256 positions each)
MEMORY_GRID = ((25, 50, 100), (64, 128), ("kernel", "fft"))
MEMORY_MAPS = (tuple(10.0 + 0.5 * i for i in range(10)), ("ssd", "ncc"), ("kernel", "fft"))
MEMORY_MAP_STRIDE = 32.0
MEMORY_MAP_BATCH = 256
MEMORY_TOL = 0.05
SWEEP_TIMING = ("wall_s", "warmup_s", "agent_steps_per_s")  # host clock, not results
# bench phase: the port's bench command, as a user runs it, and its time limit
BENCH_RUNS = (("--all",), ("--big-landscape", str(BIG_SIZE), "--repeats", "1"))
BENCH_TIMEOUT_S = 600
BENCH_HEADLINE = "agent-steps/sec/chip"
# --all's lines after its 7 headline and latency lines, in bench.py's order
BENCH_GATES = ("pallas_parity_gate", "pallas_parity_gate", "sector_parity_gate",
               "fft_precision_gate", "roll_precision_gate")
GRAFT_DRYRUN_TIMEOUT_S = 600
GRAFT_KEYS = ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
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


def bench_config(n: int, views: int, size: int = 512,
                 kind: str = "blobs") -> tuple[SimConfig, np.ndarray, np.ndarray]:
    """BASELINE config ``n`` as shipped, on the bench world of ``bench.py``
    ``_setup``: 512^2 blobs (seed 7, 150 features; or ``kind`` at ``size``^2,
    as ``run_big_landscape`` asks for its fractal world), sine route of
    length 40, ``views`` stored views, a step budget of 1.3x the route's
    arc."""
    cfg = baseline_config(n)
    land = make_landscape(kind, size=(size, size), seed=7, n_features=150)
    route = make_route("sine", size=(size, size), margin=60.0, length=ROUTE_LENGTH,
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


def check_kernels(cfg: SimConfig, route: np.ndarray, dev: torch.device) -> dict[str, dict]:
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
    results["window_gather"], got = check_window(land, by_np, bx_np, wy, wx)

    results["render"] = check_render(got, sensor, dev, rng)
    results["render_pooled"] = check_render_pooled(got, sensor, dev, rng)

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
    del a, b
    results["min_distance_pooled"] = check_pooled_kernel(cfg, dev, rng)
    results["lag_fam"] = check_lag_kernel(cfg, dev, rng)
    results["decide"] = check_decide(cfg, route, dev, rng)
    return results


def check_pooled_kernel(cfg: SimConfig, dev: torch.device, rng) -> dict:
    """The min-distance kernel's pooled entry at the main path's shapes
    (random pooled panoramas, the 60 scan lags, a random library): equal bit
    for bit to the rows entry on the candidates the step gathered before
    (``make_views_from_pooled``), within rtol 2e-4 / atol 2e-3 of float64,
    and timed beside the rows entry alone (``rows_ms``), the gather and
    permute copy alone (``gather_ms``) and the route it replaces, gather
    then rows entry (``route_ms``). ``plain_ms`` times the plain version's
    arithmetic (gather, then ``min_distance_rows_plain``) without its copy
    of the lags to the host, which the sleep-held timer cannot hold."""
    sensor = cfg.sensor
    lags_np = scan_lag_sets(cfg.scan)[0]
    n_lags, p = len(lags_np), sensor.n_pixels
    s = torch.from_numpy(rng.uniform(size=(BATCH, sensor.n_radial, sensor.n_fine))
                         .astype(np.float32)).to(dev)
    lib = pack_library(torch.from_numpy(
        rng.uniform(size=(VIEWS, sensor.n_radial, sensor.n_azimuth)).astype(np.float32)).to(dev))
    lags = torch.from_numpy(lags_np.astype(np.int32)).to(dev)
    views = make_views_from_pooled(sensor, lags_np, dev)
    args = (s, lags, lib.flat, lib.sq, sensor, -2.0, True)
    got = min_distance_pooled(*args)
    rows = views(s).reshape(-1, p)
    want = min_distance_rows(rows, lib.flat, lib.sq, -2.0, True)
    c64 = rows.double()
    want64 = (-2.0 * (c64 @ lib.flat.double().T) + (c64 * c64).sum(1, keepdim=True)
              + lib.sq.double()[None, :]).min(dim=1).values
    torch.cuda.synchronize()
    require(torch.equal(got.reshape(-1), want),
            "pooled min distance differs from the rows entry on the gathered candidates")
    diff = (got.reshape(-1).double() - want64).abs()
    err = float(diff.max())
    require(bool((diff <= 2e-3 + 2e-4 * want64.abs()).all()),
            f"pooled min distance: max abs err {err} beyond rtol 2e-4 / atol 2e-3 vs float64")
    del c64, want64, diff
    n_rows, nl = BATCH * n_lags, VIEWS
    flops = 2.0 * n_rows * nl * p + 2.0 * n_rows * p  # cross term + |a|^2
    b_ms, b_by = bound(nbytes(s, lib.flat, lags) + nl * 4 + n_rows * 4, flops)
    return dict(
        route="cuda", source="navdv_torch/csrc/min_distance.cu",
        replaces="navdv_tpu/ops/familiarity_pallas.py:103",
        max_abs_err=err, tolerance="rtol 2e-4, atol 2e-3 vs float64; rows entry bit for bit",
        ms=time_ms(lambda: min_distance_pooled(*args)),
        ms_in_run=time_ms_in_run(lambda: min_distance_pooled(*args)),
        plain_ms=time_ms(lambda: min_distance_rows_plain(views(s).reshape(-1, p), lib.flat,
                                                         lib.sq, -2.0, True)),
        rows_ms=time_ms(lambda: min_distance_rows(rows, lib.flat, lib.sq, -2.0, True)),
        gather_ms=time_ms(lambda: views(s)),
        route_ms=time_ms(lambda: min_distance_rows(views(s).reshape(-1, p), lib.flat, lib.sq,
                                                   -2.0, True)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
    )


def check_window(land: torch.Tensor, by_np: np.ndarray, bx_np: np.ndarray, wy: int,
                 wx: int) -> tuple[dict, torch.Tensor]:
    """The window gather against its plain version (bit for bit) at corners
    ``(by_np, bx_np)``, timed beside one PyTorch indexing call; returns the
    kernel's row and the windows."""
    dev = land.device
    by = torch.from_numpy(by_np).to(dev)
    bx = torch.from_numpy(bx_np).to(dev)
    got = window_gather(land, by, bx, wy, wx)
    want = window_gather_plain(land, by, bx, wy, wx)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    require(torch.equal(got, want), "window gather differs from its plain version")
    covered = np.zeros(tuple(land.shape), bool)  # landscape cells the windows need
    for y, x in zip(by_np, bx_np):
        covered[y : y + wy, x : x + wx] = True
    cells = int(covered.sum())
    b_ms, b_by = bound(cells * 4 + nbytes(by, bx, got), 0)
    # yardstick: one indexing kernel on the [H-wy+1, W-wx+1, wy, wx] view of
    # every window, corners clamped beforehand
    views = land.unfold(0, wy, 1).unfold(1, wx, 1)
    by_c = by.long().clamp(0, land.shape[0] - wy)
    bx_c = bx.long().clamp(0, land.shape[1] - wx)
    require(torch.equal(views[by_c, bx_c], want), "unfold yardstick differs from the window gather")
    return dict(
        route="cuda", source="navdv_torch/csrc/window.cu",
        replaces="navdv_tpu/ops/window_pallas.py:88",
        max_abs_err=err, tolerance="exact", distinct_cells=cells,
        ms=time_ms(lambda: window_gather(land, by, bx, wy, wx)),
        ms_in_run=time_ms_in_run(lambda: window_gather(land, by, bx, wy, wx)),
        library_ms_in_run=time_ms_in_run(lambda: views[by_c, bx_c]),
        plain_ms=time_ms(lambda: window_gather_plain(land, by, bx, wy, wx)),
        bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(lambda: views[by_c, bx_c]),
    ), got


def check_render(win: torch.Tensor, sensor: SensorConfig, dev: torch.device, rng,
                 fxy: torch.Tensor | None = None) -> dict:
    """The render kernel against its plain version (bit for bit, both
    modes) on windows ``win`` f32[B, W, W], at poses ``fxy`` (in-window
    position, cos, sin; random poses as the renderers make them where
    None), timed beside ``grid_sample``."""
    batch, wx = win.shape[0], win.shape[2]
    dx0_np, dy0_np = polar_offsets(sensor)
    dx0 = torch.from_numpy(dx0_np).to(dev)
    dy0 = torch.from_numpy(dy0_np).to(dev)
    half = wx // 2
    if fxy is None:
        theta = rng.uniform(-math.pi, math.pi, size=batch)
        fxy = torch.from_numpy(np.stack([
            rng.uniform(half, half + 1, size=batch), rng.uniform(half, half + 1, size=batch),
            np.cos(theta), np.sin(theta)], axis=1).astype(np.float32)).to(dev)
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


def ulp_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b| in float32 ulps: the distance of their bit patterns on the
    line that orders every float32."""
    def ordered(t):
        i = t.contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)

    return (ordered(a) - ordered(b)).abs()


def box_matrix(sensor: SensorConfig, dev: torch.device) -> torch.Tensor:
    """The 0/1 [A, A] banded-circulant matrix whose product the port's
    pooled panorama was before the render kernel summed its taps: column a
    holds ones at rows (a + j) mod A, j < u."""
    a, u = sensor.n_fine, sensor.az_upsample
    box = torch.zeros(a, a, device=dev)
    cols = torch.arange(a, device=dev)
    for j in range(u):
        box[(cols + j) % a, cols] = 1.0
    return box


def check_render_pooled(win: torch.Tensor, sensor: SensorConfig, dev: torch.device,
                        rng) -> dict:
    """The render kernel's pooled entry (``render_pooled``, the step's
    front) against its plain version, bit for bit in both modes, at random
    poses on windows ``win``; timed beside the route it replaces in the
    bf16 mode (``route_ms``): the plain entry, the bf16 cast and f32 copy
    back, and the f32 product against ``box_matrix``. Against that route
    the bf16 mode's share of bit-equal elements and largest difference in
    ulps (``route_equal_share``, ``route_max_ulps``)."""
    batch, wx = win.shape[0], win.shape[2]
    dx0_np, dy0_np = polar_offsets(sensor)
    dx0 = torch.from_numpy(dx0_np).to(dev)
    dy0 = torch.from_numpy(dy0_np).to(dev)
    u, a = sensor.az_upsample, sensor.n_fine
    half = wx // 2
    theta = rng.uniform(-math.pi, math.pi, size=batch)
    fxy = torch.from_numpy(np.stack([
        rng.uniform(half, half + 1, size=batch), rng.uniform(half, half + 1, size=batch),
        np.cos(theta), np.sin(theta)], axis=1).astype(np.float32)).to(dev)
    box = box_matrix(sensor, dev)

    def route():
        pano = render_windows(win, fxy, dx0, dy0, True)
        return (pano.reshape(-1, a).to(torch.bfloat16).float() @ box).reshape(pano.shape)

    pooled = {}
    for mode, hat_bf16 in (("f32", False), ("bf16", True)):
        got = render_pooled(win, fxy, dx0, dy0, u, hat_bf16)
        want = render_pooled_plain(win, fxy, dx0, dy0, u, hat_bf16)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        require(torch.equal(got, want),
                f"pooled render {mode}: differs from its plain version ({err})")
        pooled[mode] = dict(
            max_abs_err=err, tolerance="exact",
            ms=time_ms(lambda: render_pooled(win, fxy, dx0, dy0, u, hat_bf16)),
            ms_in_run=time_ms_in_run(lambda: render_pooled(win, fxy, dx0, dy0, u, hat_bf16)),
            plain_ms=time_ms(lambda: render_pooled_plain(win, fxy, dx0, dy0, u, hat_bf16)),
        )
    ulps = ulp_distance(got, route())  # got: the bf16 mode's S
    samples = batch * dx0.numel()
    b_ms, b_by = bound(nbytes(win, fxy, dx0, dy0) + samples * 4, samples * (29 + u - 1))
    smem = _build.load_function("render", "navdv_render_pooled_smem_bytes",
                                [ctypes.c_int] * 4)(wx, *dx0.shape, u)
    require(smem == render_pooled_smem_bytes(wx, *dx0.shape, u),
            f"pooled render kernel asks for {smem} bytes of shared memory, the wrapper's "
            f"budget assumes {render_pooled_smem_bytes(wx, *dx0.shape, u)}")
    return dict(
        route="cuda", source="navdv_torch/csrc/render.cu",
        replaces="navdv_tpu/ops/render_pallas.py:61 and navdv_tpu/sensor.py:617",
        max_abs_err=pooled["bf16"]["max_abs_err"], tolerance="exact (both modes)",
        ms=pooled["bf16"]["ms"], ms_in_run=pooled["bf16"]["ms_in_run"],
        plain_ms=pooled["bf16"]["plain_ms"], f32_mode=pooled["f32"], smem_bytes=smem,
        shape=[batch, *dx0.shape, wx], u=u, route_ms=time_ms(route),
        route_ms_in_run=time_ms_in_run(route),
        route_equal_share=float((ulps == 0).double().mean()), route_max_ulps=int(ulps.max()),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
    )


def decide_inputs(cfg: SimConfig, route: np.ndarray, batch: int, dev: torch.device, rng):
    """The decision's arguments at ``cfg``'s scan on the bench route: agents
    spread around the route's points, a quarter done, familiarity of four
    values (exact ties) with a few inf and PAD_PENALTY entries."""
    st = make_statics(torch.zeros(512, 512), LibraryPack(*(torch.zeros(1),) * 5), route, dev)
    consts = decide_constants(cfg, dev)
    nh = cfg.scan.n_headings
    xy = route[rng.integers(0, len(route), batch)] + rng.normal(0.0, 8.0, (batch, 2))
    done = rng.uniform(size=batch) < 0.25
    fam = (1.0 + 0.5 * rng.integers(0, 4, (batch, nh))).astype(np.float32)
    special = rng.uniform(size=(batch, nh))
    fam[special < 0.02] = np.inf
    fam[special > 0.98] = PAD_PENALTY
    return (torch.as_tensor(xy, dtype=torch.float32, device=dev),
            torch.as_tensor(rng.uniform(-math.pi, math.pi, batch), dtype=torch.float32,
                            device=dev),
            torch.as_tensor(done, device=dev),
            torch.as_tensor(np.where(done, 1, 0), dtype=torch.int32, device=dev),
            torch.as_tensor(fam, device=dev),
            Route(st.route_a, st.route_ab, st.route_denom, st.goal), (512, 512), consts)


def check_decide(cfg: SimConfig, route: np.ndarray, dev: torch.device, rng) -> dict:
    """The decision kernel against its plain version (bit for bit) at B =
    1024 (the row) and B = 1 (``b1``) on the bench route."""
    rows = {}
    for batch in (BATCH, 1):
        args = decide_inputs(cfg, route, batch, dev, rng)
        got = decide(*args)
        want = decide_plain(*args)
        torch.cuda.synchronize()
        same = [torch.equal(g, w) for g, w in zip(got, want)]
        require(all(same), f"decide B={batch}: differs from its plain version in "
                           f"{[n for n, ok in zip(got._fields, same) if not ok]}")
        xy, theta, done, status, fam, rt, _, consts = args
        n_seg = rt.a.shape[0]
        moved = nbytes(xy, theta, done, status, fam, consts.shifts, consts.tie_order, *rt)
        moved += nbytes(*got)
        # per agent: argmin compares, the move, ~19 operations a segment, the stop rules
        b_ms, b_by = bound(moved, batch * (fam.shape[1] + 10 + 19 * n_seg + 12))
        rows[batch] = dict(
            max_abs_err=0.0, tolerance="exact", shape=[batch, fam.shape[1], n_seg],
            ms=time_ms(lambda: decide(*args)), ms_in_run=time_ms_in_run(lambda: decide(*args)),
            plain_ms=time_ms(lambda: decide_plain(*args)), bound_ms=b_ms, bound_by=b_by,
        )
    return dict(route="cuda", source="navdv_torch/csrc/decide.cu",
                replaces="none (the JAX package leaves the step's tail to XLA)",
                **rows[BATCH], library_ms=None, b1=rows[1])


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
    counts = ops.launch_counts()
    for name in MAIN_KERNELS:
        require(counts[name] > 0, f"kernel {name} was not launched on the main path")
    require(counts["min_distance"] == 0, "the main path launched the rows entry of the "
            "min-distance kernel: its candidates were materialised")

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


def run_reference_functions(cfg, st, poses) -> None:
    """The JAX package's reference functions on the main episode's 4 x 1024
    poses at config 4: ``make_familiarity_jnp`` over the extended shift
    set's candidate views (batched over agents) against the ``"plain"``
    step's familiarity (rtol 1e-9) and the kernel path's tie-ordered
    candidate (>= 99.9% equal), and the gather renderer against the
    window renderer at f32 (1e-5)."""
    t_phase = time.perf_counter()
    sensor, scan = cfg.sensor, cfg.scan
    fam_ref = make_familiarity_jnp(sensor, scan)
    views = make_views_from_pooled(sensor, scan_shift_sets(scan)[1])
    render, pooled = make_render_batch(sensor), make_pooled_panorama(sensor)
    plain_fam = make_step_batched(cfg, "plain").fam
    kernel_fam = make_step_batched(cfg, "kernel").fam
    sensor_f32 = dataclasses.replace(sensor, hat_dtype="float32")
    window_render = make_render_panorama(sensor_f32)
    gather_render = make_render_panorama_gather(sensor_f32)
    n = not_equal = same_k = 0
    max_rel, fam_ok, render_err = 0.0, True, 0.0
    for s in poses:
        got = fam_ref(views(pooled(render(st.landscape, s.xy, s.theta))), st.lib)
        want = plain_fam(s, st)
        diff = (got.double() - want.double()).abs()
        fam_ok &= bool((diff <= REFERENCE_FAM_RTOL * want.double().abs()).all())
        max_rel = max(max_rel, float((diff / want.double().abs().clamp_min(1e-30)).max()))
        not_equal += int((got != want).sum())
        n += got.numel()
        same_k += int((tie_k(got, scan) == tie_k(kernel_fam(s, st), scan)).sum())
        render_err = max(render_err, float((gather_render(st.landscape, s.xy, s.theta)
                                            - window_render(st.landscape, s.xy, s.theta))
                                           .abs().max()))
    poses_n = len(poses) * BATCH
    emit({"phase": "reference_functions", "config": 4, "poses": poses_n,
          "pose_steps": list(LAG_POSE_STEPS), "fam_results": n, "fam_not_bit_equal": not_equal,
          "fam_max_rel_diff_vs_plain": max_rel, "same_k_vs_kernel": same_k / poses_n,
          "gather_render_max_abs_err_f32": render_err, "seconds": time.perf_counter() - t_phase})
    require(fam_ok, f"make_familiarity_jnp vs the plain step: relative difference {max_rel} "
                    f"beyond {REFERENCE_FAM_RTOL}")
    require(same_k / poses_n >= 0.999,
            f"make_familiarity_jnp vs the kernel path: only {same_k / poses_n:.5f} equal candidates")
    require(render_err <= REFERENCE_RENDER_TOL,
            f"gather renderer vs the window renderer (f32): {render_err} > {REFERENCE_RENDER_TOL}")


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


def require_render_only(counts: dict, phase: str, decides: bool = True,
                        renders: tuple = RENDER_KERNELS) -> None:
    """The extraction-free paths render through the window and (pooled)
    render kernels and launch no distance kernel; an episode decides
    through the decision kernel, a familiarity map never does."""
    for name in renders:
        require(counts[name] > 0, f"{phase}: kernel {name} was not launched")
    for name in DISTANCE_KERNELS:
        require(counts[name] == 0, f"{phase}: kernel {name} was launched ({counts[name]})")
    require((counts["decide"] > 0) == decides,
            f"{phase}: decision kernel launched {counts['decide']} times")


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
    what the knob and parallel phases reuse."""
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
    return cfg, st, states0, res


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
    require_render_only(counts, "sector", renders=("window_gather", "render"))

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


def run_sweep_phase() -> dict[str, float]:
    """The default ``SweepSpec`` (8 cells, 256 trials, 256 steps, early exit)
    on the bench world with a 128-trial recall check, into a temporary
    directory; then the same sweep again, which must resume every cell from
    disk and launch no kernel. Returns each cell's success rate."""
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
    return {key: c["success_rate"] for key, c in cells.items()}


def step_device_ms(step, states, st, aux=None) -> float:
    """Device time of one batched step in ms (the sleep-held timer)."""
    return time_ms(lambda: step(states, st, aux), runs=5, warmup=1)


def run_analysis(dev: torch.device) -> dict:
    """Config 1 as shipped on the bench world: the RIDF at a mid-route
    capture pose on ``"kernel"`` and ``"auto"`` (fft, cutoff 72), the
    familiarity map (stride 8, batches of 1024) on ``"kernel"`` and on fft at
    cutoff 0, which must choose the same best heading at >= 99.9% of the
    positions (the shipped cutoff's agreement is reported only), the
    catchment of both maps and the heading error at every capture pose.
    Returns the kernel map's launch counts."""
    t_phase = time.perf_counter()
    cfg, land, route = bench_config(1, VIEWS)
    kcfg = exact_cfg(cfg)
    land_t = torch.as_tensor(land, dtype=torch.float32, device=dev)
    lib = train_library(land_t, route, cfg)
    pts, headings = resample_route(route, cfg.capture_spacing)
    binw = cfg.sensor.bin_width
    out = {}
    mid = len(pts) // 2
    for name, c, impl in (("kernel", kcfg, "kernel"), ("auto", cfg, "auto")):
        angles, fam = ridf(land_t, lib, pts[mid], headings[mid], c, fam_impl=impl)
        k = int(np.argmin(fam))
        out[f"ridf_{name}"] = {"valley_rad": float(angles[k]), "depth": float(fam[k] / fam.max())}
        require(abs(float(angles[k])) <= binw + 1e-6,
                f"analysis: the {name} RIDF valley lies at {float(angles[k])} rad")

    maps, runs = {}, {}
    cases = (("kernel", kcfg, "kernel"), ("fft_cutoff_0", with_scan(cfg, spectral_cutoff=0), "fft"),
             ("fft_shipped", cfg, "fft"))
    for name, c, impl in cases:
        kw = dict(stride=MAP_STRIDE, fam_impl=impl, batch=MAP_BATCH)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        maps[name] = familiarity_map(land_t, lib, c, **kw)  # waits for each batch
        first_s = time.perf_counter() - t0
        counts = ops.launch_counts()
        t0 = time.perf_counter()
        again = familiarity_map(land_t, lib, c, **kw)
        wall = time.perf_counter() - t0
        fam = maps[name]["fam"]
        require(np.array_equal(again["fam"], fam), f"analysis: a repeated {name} map differs")
        require(bool(np.isfinite(fam).all()), f"analysis: non-finite {name} map")
        batches = -(-fam.size // MAP_BATCH)
        probe = make_familiarity_probe(full_circle_scan(c), impl)
        st = make_statics(land_t, lib, route)
        aux = None if probe.prepare is None else probe.prepare(st)
        # one batch's poses already on the card: a host copy inside the timed
        # region would wait for the timer's sleep kernel
        xy = torch.from_numpy(np.stack(np.meshgrid(maps[name]["x"], maps[name]["y"]), -1)
                              .reshape(-1, 2)[:MAP_BATCH].copy()).to(dev)
        zeros = torch.zeros(MAP_BATCH, dtype=torch.float32, device=dev)
        runs[name] = {"positions": int(fam.size), "batches": batches, "first_s": first_s,
                      "wall_ms_per_batch": wall / batches * 1e3,
                      "device_ms_per_batch": time_ms(lambda: probe.best(xy, zeros, st, aux),
                                                     runs=5, warmup=1),
                      "launches": counts}
    for name in MAP_KERNELS:
        require(runs["kernel"]["launches"][name] > 0,
                f"analysis: kernel {name} was not launched by the kernel map")
    require(runs["kernel"]["launches"]["decide"] == 0, "analysis: the kernel map decided")
    require_render_only(runs["fft_cutoff_0"]["launches"], "analysis fft map", decides=False)

    scale = float(lib.sq.max())
    for name in ("fft_cutoff_0", "fft_shipped"):
        a, b = maps[name], maps["kernel"]
        out[f"map_{name}_vs_kernel"] = {
            "same_best_heading": float(np.mean(a["best_heading"] == b["best_heading"])),
            "max_abs_dfam": float(np.abs(a["fam"] - b["fam"]).max()),
            "max_abs_dfam_over_scale": float(np.abs(a["fam"] - b["fam"]).max()) / scale,
        }
    for name in ("kernel", "fft_cutoff_0"):
        out[f"catchment_{name}"] = catchment(maps[name], route)["fraction"]
    for name, c, impl in (("kernel", kcfg, "kernel"), ("auto", cfg, "auto")):
        err = np.abs(heading_error(land_t, lib, c, pts, headings, fam_impl=impl))
        out[f"heading_error_{name}"] = {"poses": len(err), "median_abs_rad": float(np.median(err)),
                                        "max_abs_rad": float(err.max()),
                                        "max_abs_bins": float(err.max() / binw)}
    emit({"phase": "analysis", "config": 1, "library_views": int(lib.views.shape[0]),
          "scale": scale, "maps": runs, **out, "seconds": time.perf_counter() - t_phase})
    same = out["map_fft_cutoff_0_vs_kernel"]["same_best_heading"]
    require(same >= 0.999, f"analysis: fft map at cutoff 0 agrees on only {same:.5f} of positions")
    dfam = out["map_fft_cutoff_0_vs_kernel"]["max_abs_dfam_over_scale"]
    require(dfam <= MAP_DFAM_TOL, f"analysis: the kernel map is off the fp64 fft map by "
            f"{dfam} of scale (> {MAP_DFAM_TOL})")
    return runs["kernel"]["launches"]


def run_conv(cfg, st, states0, poses, kernel_rate: float, dev: torch.device) -> dict:
    """The conv path at config 4's width (cutoff 0) on the main episode's
    library: its familiarity against the kernel path's on the lag phase's
    4 x 1024 poses (>= 99.9% equal candidates), one episode on the main
    trials (success within 0.025 of the kernel path's, window and render
    launched, no distance kernel), device ms/step, and its fp64 contraction
    by ``conv1d`` beside the same contraction as one product over an unfold
    of the signal (the port's form, ``familiarity_conv.unfold_contraction``).
    Returns the episode's launch counts."""
    t_phase = time.perf_counter()
    base = phase_memory_start()
    agree = compare_fam(prepared_fam(cfg, "conv", st), make_step_batched(cfg, "kernel").fam,
                        poses, st, cfg.scan)
    run = make_navigate_batch(cfg, "conv")
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    final, rec = run(states0, st)
    rate = float(success_rate(final))  # waits for the episode
    counts = ops.launch_counts()
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rate2 = float(success_rate(run(states0, st)[0]))
    episode_s = time.perf_counter() - t0
    require(rate2 == rate, "conv: a repeated episode gave another success rate")
    require(bool(torch.isfinite(rec.fam[~rec.done]).all()), "conv: non-finite familiarity")

    sensor = cfg.sensor
    r, w, u = sensor.n_radial, sensor.n_azimuth, sensor.az_upsample
    _, _, _, qrange, _ = conv_lag_geometry(sensor, cfg.scan)
    rng = np.random.default_rng(1)
    lhs = torch.from_numpy(rng.uniform(size=(BATCH * u, r, qrange - 1 + w))).to(dev)
    flat = st.lib.flat.double()
    rhs = flat.view(-1, r, w)
    by_conv = torch.nn.functional.conv1d(lhs, rhs)  # [N, Nl, qrange]
    by_unfold = unfold_contraction(lhs, flat, w).transpose(1, 2)
    contraction_err = float(((by_conv - by_unfold).abs() / by_unfold.abs()).max())
    require(contraction_err <= 1e-12, f"conv: conv1d and the unfold product differ ({contraction_err})")
    flops = 2.0 * lhs.shape[0] * rhs.shape[0] * qrange * r * w
    conv1d_ms = time_ms(lambda: torch.nn.functional.conv1d(lhs, rhs), runs=10)
    unfold_ms = time_ms(lambda: unfold_contraction(lhs, flat, w), runs=10)
    del lhs, by_conv, by_unfold
    t_max = cfg.agent.max_steps
    emit({
        "phase": "conv", "config": 4, "fam_impl": "conv", "batch": BATCH, "max_steps": t_max,
        "library_views": int(st.lib.views.shape[0]), "spectral_cutoff": cfg.scan.spectral_cutoff,
        "vs_kernel_step_fam": agree, "poses": len(poses) * BATCH, "success_rate": rate,
        "kernel_success_rate": kernel_rate, "episode_s": episode_s,
        "agent_steps_per_s": BATCH * t_max / episode_s, "launches": counts, "peak_mem_gb": peak,
        "device_ms_per_step": step_device_ms(make_step_batched(cfg, "conv"), states0, st),
        "kernel_device_ms_per_step": step_device_ms(make_step_batched(cfg, "kernel"), states0, st),
        "contraction": {"shape": [BATCH * u, r, qrange - 1 + w, VIEWS, w], "gflop": flops / 1e9,
                        "conv1d_ms": conv1d_ms, "unfold_product_ms": unfold_ms,
                        "max_rel_diff": contraction_err},
        "seconds": time.perf_counter() - t_phase,
    })
    require(agree["same_k"] >= 0.999, f"conv: only {agree['same_k']:.5f} equal candidates")
    require(abs(rate - kernel_rate) <= ACCURACY_BAND,
            f"conv: success {rate} vs the kernel path's {kernel_rate}")
    require_render_only(counts, "conv")
    return counts


def _rel_fro(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def run_infomax(cfg, st, states0, poses) -> dict:
    """The learned memory at config 1's width (B=1024, cutoff 0) on the main
    episode's library with the AUTO dose: training on the card (seconds;
    its counters one training of ``applied_updates`` updates), one epoch on
    the card against the CPU from the same initial weights and library
    (relative Frobenius difference <= 1e-4), the checkpoint round
    trip (bit-equal ``step.fam``), one episode on the main trials (success
    reported only: another model than perfect memory; window and render
    launched, no distance kernel).
    Returns the episode's launch counts."""
    t_phase = time.perf_counter()
    scan, p = cfg.scan, cfg.sensor.n_pixels
    m = scan.infomax_units or p
    step = make_step_batched(cfg, "infomax")
    torch.cuda.synchronize()
    reset_infomax_counts()
    t0 = time.perf_counter()
    pack = step.lib_prepare(st)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    training = infomax_counts()
    nl = int(st.lib.views.shape[0])
    updates = applied_updates(st.lib, scan.infomax_epochs, cfg.capture_spacing)

    w0 = initial_weights(m, p, scan.infomax_seed)
    lib_cpu = type(st.lib)(*(t.cpu() for t in st.lib))
    one_card = train_infomax(st.lib, m, scan.infomax_eta, 1, scan.infomax_seed, w0=w0)
    one_cpu = train_infomax(lib_cpu, m, scan.infomax_eta, 1, scan.infomax_seed, w0=w0)
    rel_one = _rel_fro(one_card.w, one_cpu.w)

    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "infomax.npz")
        save_infomax(path, pack)
        size = Path(path).stat().st_size
        loaded = load_infomax(path)
    ckpt_equal = all(torch.equal(step.fam(s, st, pack), step.fam(s, st, loaded)) for s in poses)

    run = make_navigate_batch(cfg, "infomax")
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    final, rec = run(states0, st, pack)
    rate = float(success_rate(final))  # waits for the episode
    counts = ops.launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rate2 = float(success_rate(run(states0, st, pack)[0]))
    episode_s = time.perf_counter() - t0
    require(rate2 == rate, "infomax: a repeated episode gave another success rate")
    require(bool(torch.isfinite(rec.fam[~rec.done]).all()), "infomax: non-finite familiarity")
    t_max = cfg.agent.max_steps
    emit({
        "phase": "infomax", "config": 1, "fam_impl": "infomax", "batch": BATCH, "max_steps": t_max,
        "library_views": nl, "units": m, "updates": updates, "training_counts": training,
        "train_s": train_s,
        "train_updates_per_s": updates / train_s, "one_epoch_card_vs_cpu_rel_fro": rel_one,
        "checkpoint_bytes": size, "checkpoint_fam_bit_equal": ckpt_equal,
        "success_rate": rate, "episode_s": episode_s,
        "agent_steps_per_s": BATCH * t_max / episode_s, "launches": counts,
        "device_ms_per_step": step_device_ms(step, states0, st, pack),
        "seconds": time.perf_counter() - t_phase,
    })
    require(training["trainings"] == 1 and training["updates"] == updates,
            f"infomax: the training counted {training}, not one of {updates} updates")
    require(rel_one <= 1e-4, f"infomax: one epoch on the card vs the CPU, {rel_one} > 1e-4")
    require(ckpt_equal, "infomax: the loaded network scores differently")
    require_render_only(counts, "infomax")
    return counts


def parallel_layout() -> tuple[str, int, int]:
    """(backend, world, cards) of the parallel phase: NCCL with a card per
    rank where there are two cards or more (a world of 4 from 4 cards, else
    2); on one card, gloo with 2 ranks sharing it (NCCL refuses two ranks
    on one card)."""
    cards = torch.cuda.device_count()
    if cards >= 2:
        return "nccl", (4 if cards >= 4 else 2), cards
    return "gloo", 2, cards


def parallel_meshes(world: int) -> list[tuple[int, int]]:
    return [(world, 1), (1, world)] + ([(2, 2)] if world == 4 else [])


def main_reference(cfg, st, states0, final, rec) -> dict:
    """What the parallel phase holds its config-4 episodes and probe
    against: the main phase's library, trials and unsharded results, and the
    kernel path's unsharded probe at the trials' start poses."""
    probe = make_familiarity_probe(cfg, "kernel")
    return {
        **{f"lib_{k}": v.cpu().numpy() for k, v in st.lib._asdict().items()},
        "starts": states0.xy.cpu().numpy(), "thetas": states0.theta.cpu().numpy(),
        "k": rec.k.cpu().numpy(), "fam": rec.fam.cpu().numpy(),
        "status": final.status.cpu().numpy(),
        "probe_fam": probe(states0.xy, states0.theta, st).cpu().numpy(),
    }


def roll_reference(st, states0, res) -> dict:
    """The roll phase's library, trials, first candidates and success."""
    return {
        **{f"roll_lib_{k}": v.cpu().numpy() for k, v in st.lib._asdict().items()},
        "roll_starts": states0.xy.cpu().numpy(), "roll_thetas": states0.theta.cpu().numpy(),
        "roll_k0": res.record.k[:, 0].cpu().numpy(),
        "roll_success": np.asarray(res.success_rate),
    }


def check_padded_shard(cfg, ref: dict) -> dict:
    """The min-distance kernel on a library shard that holds padding: the
    main library padded to a multiple of 4 (``valid = 0`` views) and its
    last shard, against that shard's real views alone, through the kernel
    path's familiarity at the main trials' start poses. Padded views must
    never win: the same familiarity."""
    land, route = slice_config()[1:]
    lib = LibraryPack(*(torch.from_numpy(ref[f"lib_{k}"]) for k in LibraryPack._fields))
    padded = pad_library(lib, 4)
    per = padded.views.shape[0] // 4
    shard = LibraryPack(*(x[3 * per:] for x in padded))
    n_real = int(shard.valid.sum())
    require(n_real < per, "the padded shard holds no padding")
    real = LibraryPack(*(x[:n_real] for x in shard))
    states = init_state(ref["starts"], ref["thetas"])
    fam = make_step_batched(cfg, "kernel").fam
    got = fam(states, make_statics(land, shard, route))
    want = fam(states, make_statics(land, real, route))
    diff = float((got - want).abs().max())
    require(bool(((got - want).abs() <= 1e-6 * want.abs()).all()),
            f"padded shard: familiarity off the real views' by {diff} (rtol 1e-6)")
    return {"views": per, "padded_views": per - n_real, "max_abs_dfam": diff,
            "bit_equal": bool(torch.equal(got, want))}


def run_parallel(main_ref: dict, roll_ref: dict, sweep_ref: dict) -> dict:
    """The parallel phase: ``world`` ranks, each a process that runs this
    script with ``--parallel-child``, hold the library-sharded and
    data-parallel episodes, the lib-axis probe, config 2 on roll and the
    sweep's cells over ranks against the unsharded results of the main, lag,
    roll and sweep phases. Returns the kernel launches of the config-4
    episodes, summed over ranks and meshes."""
    t_phase = time.perf_counter()
    backend, world, cards = parallel_layout()
    cfg = slice_config()[0]
    padded = check_padded_shard(cfg, main_ref)
    with tempfile.TemporaryDirectory() as tmp:
        np.savez(Path(tmp) / "inputs.npz", **main_ref, **roll_ref)
        (Path(tmp) / "spec.json").write_text(json.dumps({
            "backend": backend, "meshes": parallel_meshes(world), "sweep": sweep_ref}))
        results = launch_parallel_children(tmp, world)
    meshes = {}
    for shape in parallel_meshes(world):
        tag = f"{shape[0]}x{shape[1]}"
        rs = [r["meshes"][tag] for r in results]
        wall = max(r["episode_s"] for r in rs)
        meshes[tag] = {
            **{k: rs[0][k] for k in ("same_k0", "max_rel_dfam0", "success_rate", "bit_equal")},
            "captured_by_rank": [r["captured"] for r in rs],
            "eager_equal_by_rank": [r["eager_equal"] for r in rs],
            "episode_s": wall, "agent_steps_per_s": BATCH * cfg.agent.max_steps / wall,
            "episode_s_by_rank": [r["episode_s"] for r in rs],
            "lib_pmin_by_rank": [r["lib_pmin"] for r in rs],
            "collective_ms_per_step": [r["collective_ms_per_step"] for r in rs],
            "launches_by_rank": [r["launches"] for r in rs],
        }
    out = {k: results[0][k] for k in ("probe", "roll", "sweep")}
    emit({"phase": "parallel", "backend": backend, "world": world, "cards": cards,
          "meshes": meshes, **out, "padded_shard": padded,
          "kernel_success_rate": float(np.mean(main_ref["status"] == STATUS_REACHED)),
          "seconds": time.perf_counter() - t_phase})
    t_max = cfg.agent.max_steps
    for tag, m in meshes.items():
        n_lib = int(tag.split("x")[1])
        require(m["same_k0"] >= 0.999, f"parallel {tag}: only {m['same_k0']:.5f} same first k")
        require(m["max_rel_dfam0"] <= 1e-6, f"parallel {tag}: first-step fam off by "
                f"{m['max_rel_dfam0']} (rtol 1e-6)")
        rate = float(np.mean(main_ref["status"] == STATUS_REACHED))
        require(abs(m["success_rate"] - rate) <= ACCURACY_BAND,
                f"parallel {tag}: success {m['success_rate']} vs unsharded {rate}")
        want = t_max if n_lib > 1 else 0
        captured = backend == "nccl" or n_lib == 1  # gloo's collectives run on the host
        require(m["captured_by_rank"] == [captured] * world,
                f"parallel {tag}: captured {m['captured_by_rank']}, want {captured}")
        require(all(m["eager_equal_by_rank"]),
                f"parallel {tag}: a rank's episode differs from the eager one on its slice")
        require(m["lib_pmin_by_rank"] == [want] * world,
                f"parallel {tag}: MIN collectives per rank {m['lib_pmin_by_rank']}, want {want}")
        for rank, counts in enumerate(m["launches_by_rank"]):
            for name in MAIN_KERNELS:
                require(counts[name] > 0, f"parallel {tag}: rank {rank} launched no {name}")
    for r in results:
        require(r["probe"]["same_best_heading"] >= 0.999,
                f"parallel probe: only {r['probe']['same_best_heading']:.5f} same best heading")
        require(abs(r["roll"]["success_rate"] - float(roll_ref["roll_success"])) <= ACCURACY_BAND_2,
                f"parallel roll: success {r['roll']['success_rate']} vs {roll_ref['roll_success']}")
        require(r["roll"]["same_k0"] >= 0.999, f"parallel roll: only {r['roll']['same_k0']:.5f}")
        for key, rate in sweep_ref.items():
            require(r["sweep"]["success_rate"][key] == rate,
                    f"parallel sweep {key}: {r['sweep']['success_rate'][key]} vs serial {rate}")
        require(r["sweep"]["resumed_cells"] == len(sweep_ref) == 8 and r["sweep"]["resumed_equal"],
                "parallel sweep: the resumed run differs")
        require(not any(r["sweep"]["resumed_launches"].values()),
                f"parallel sweep: the resumed run launched {r['sweep']['resumed_launches']}")
    return {name: sum(r["meshes"][f"{a}x{b}"]["launches"][name]
                      for r in results for a, b in parallel_meshes(world))
            for name in ops.launch_counts()}


def launch_parallel_children(tmp: str, world: int) -> list[dict]:
    """Start ``world`` ranks of this script's ``--parallel-child`` as
    torchrun would (``parallel.launch_ranks``), each logging to a file;
    fail, and stop them all, as soon as one exits non-zero or the phase's
    time runs out. Returns each rank's JSON results."""
    launch_ranks([sys.executable, str(Path(__file__).resolve()), "--parallel-child", tmp], world,
                 tmp, PARALLEL_TIMEOUT_S)
    return [json.loads((Path(tmp) / f"rank{r}.json").read_text()) for r in range(world)]


def parallel_child(tmp: str) -> None:
    """One rank of the parallel phase. Writes ``rank<r>.json``; prints no
    result line."""
    spec = json.loads((Path(tmp) / "spec.json").read_text())
    timeout = datetime.timedelta(seconds=PARALLEL_GROUP_TIMEOUT_S)
    if spec["backend"] == "nccl":
        dev = init_distributed(timeout=timeout)
    else:
        dev = init_distributed(device="cuda:0", backend="gloo", timeout=timeout)
    rank = dist.get_rank()
    with np.load(Path(tmp) / "inputs.npz") as f:
        ref = {k: f[k] for k in f.files}
    cfg, land, route = slice_config()
    lib = LibraryPack(*(torch.from_numpy(ref[f"lib_{k}"]) for k in LibraryPack._fields))
    st = make_statics(land, lib, route, dev)
    states0 = init_state(ref["starts"], ref["thetas"], dev)
    ref_k = torch.from_numpy(ref["k"]).to(dev)
    ref_fam = torch.from_numpy(ref["fam"]).to(dev)
    ref_status = torch.from_numpy(ref["status"]).to(dev)
    out = {"rank": rank, "device": str(dev), "meshes": {}}
    meshes = {}
    for nd, nl in spec["meshes"]:
        mesh = meshes[(nd, nl)] = make_mesh(nd, nl)
        st_m = shard_statics(st, mesh, shard_lib=nl > 1)
        nav = make_navigate_sharded(cfg, mesh, "kernel", shard_lib=nl > 1)
        nav(states0, st_m)  # warm-up (and capture)
        torch.cuda.synchronize()
        dist.barrier()
        ops.reset_launch_counts()
        reset_collective_counts()
        t0 = time.perf_counter()
        final, rec = nav(states0, st_m)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, pmin = ops.launch_counts(), collective_counts()["lib_pmin"]
        d0 = (rec.fam[:, 0].double() - ref_fam[:, 0].double()).abs()
        coll_ms = None
        if nl > 1:  # the step's MIN alone, on this rank's [B / n_data, L] minima
            m = torch.zeros(BATCH // nd, len(scan_lag_sets(cfg.scan)[0]), device=dev)
            torch.cuda.synchronize()
            dist.barrier()
            t1 = time.perf_counter()
            for _ in range(cfg.agent.max_steps):
                dist.all_reduce(m, op=dist.ReduceOp.MIN, group=mesh.lib_group)
            torch.cuda.synchronize()
            coll_ms = (time.perf_counter() - t1) / cfg.agent.max_steps * 1e3
        # this rank's slice against the eager episode on it (one MIN a step)
        bl = BATCH // nd
        rows = slice(mesh.data_index * bl, (mesh.data_index + 1) * bl)
        eager = make_navigate_batch_fn(cfg, "kernel", lib_axis=mesh.lib_group if nl > 1 else None,
                                       device=dev)
        want = eager(AgentState(*(x[rows] for x in states0)), st_m)
        eager_equal = all(torch.equal(a, b[rows]) for a, b in zip((*want[0], *want[1]),
                                                                   (*final, *rec)))
        out["meshes"][f"{nd}x{nl}"] = {
            "captured": nav.captured, "eager_equal": eager_equal,
            "episode_s": wall, "launches": launches, "lib_pmin": pmin,
            "collective_ms_per_step": coll_ms,
            "same_k0": float((rec.k[:, 0] == ref_k[:, 0]).float().mean()),
            "max_rel_dfam0": float((d0 / ref_fam[:, 0].double().abs().clamp_min(1e-30)).max()),
            "success_rate": float(success_rate(final)),
            "bit_equal": {"k": bool(torch.equal(rec.k, ref_k)),
                          "fam": bool(torch.equal(rec.fam, ref_fam)),
                          "status": bool(torch.equal(final.status, ref_status))},
        }
    world = dist.get_world_size()
    lib_mesh = meshes[(1, world)]

    # the lib-axis probe at the trials' start poses (the lag phase's step 0)
    probe = make_familiarity_probe(cfg, "kernel", lib_axis=lib_mesh.lib_group)
    fam = probe(states0.xy, states0.theta, shard_statics(st, lib_mesh))
    want = torch.from_numpy(ref["probe_fam"]).to(dev)
    out["probe"] = {"poses": BATCH, "mesh": f"1x{world}",
                    "same_best_heading": float((tie_k(fam, cfg.scan) == tie_k(want, cfg.scan))
                                               .float().mean()),
                    "max_abs_dfam": float((fam - want).abs().max())}

    # config 2 on roll, the library split over every rank
    cfg2, land2, route2 = bench_config(2, CONFIG2_VIEWS)
    lib2 = LibraryPack(*(torch.from_numpy(ref[f"roll_lib_{k}"]) for k in LibraryPack._fields))
    st2 = shard_statics(make_statics(land2, lib2, route2, dev), lib_mesh)
    states2 = init_state(ref["roll_starts"], ref["roll_thetas"], dev)
    nav = make_navigate_sharded(cfg2, lib_mesh, "roll")
    aux = nav.prepare(st2)
    nav(states2, st2, aux)  # warm-up
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    final, rec = nav(states2, st2, aux)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out["roll"] = {"mesh": f"1x{world}", "batch": CONFIG2_BATCH, "library_views": CONFIG2_VIEWS,
                   "success_rate": float(success_rate(final)), "episode_s": wall,
                   "agent_steps_per_s": CONFIG2_BATCH * cfg2.agent.max_steps / wall,
                   "same_k0": float((rec.k[:, 0].cpu().numpy() == ref["roll_k0"]).mean())}

    # the default sweep's cells over the ranks, then resumed
    _, land_s, route_s = bench_config(4, VIEWS)
    sweep_dir = str(Path(tmp) / "sweep")
    t0 = time.perf_counter()
    res = run_sweep(land_s, route_s, SweepSpec(), sweep_dir, verbose=False, tensorboard=False,
                    cells_mesh=meshes[(world, 1)])
    sweep_s = time.perf_counter() - t0
    ops.reset_launch_counts()
    again = run_sweep(land_s, route_s, SweepSpec(), sweep_dir, verbose=False, tensorboard=False,
                      cells_mesh=meshes[(world, 1)])
    out["sweep"] = {"mesh": f"{world}x1", "seconds": sweep_s,
                    "success_rate": {k: float(v["success_rate"]) for k, v in res.items()},
                    "group_size": {k: int(v["group_size"]) for k, v in res.items()},
                    "resumed_cells": len(again),
                    "resumed_equal": all(float(again[k]["success_rate"]) == float(v["success_rate"])
                                         for k, v in res.items()),
                    "resumed_launches": ops.launch_counts()}
    (Path(tmp) / f"rank{rank}.json").write_text(json.dumps(out))
    # the teardown hangs while a CUDA graph that holds one of the groups'
    # collectives is alive: free them first (the probe cache holds probes)
    del nav, probe
    _make_familiarity_probe.cache_clear()
    gc.collect()
    dist.barrier()
    dist.destroy_process_group()


def big_corners(xy: torch.Tensor, wsz: int, size: int) -> tuple[np.ndarray, np.ndarray]:
    """Window corners of poses ``xy`` as the renderer clamps them."""
    c = (torch.floor(xy).to(torch.int32) - wsz // 2).clamp(0, size - wsz).cpu().numpy()
    return c[:, 1].copy(), c[:, 0].copy()


def check_big_kernels(land: torch.Tensor, trial_xy: torch.Tensor, trial_theta: torch.Tensor,
                      sensor: SensorConfig) -> dict:
    """The window gather and the render kernel on the 4096^2 landscape at
    two corner layouts, the trials' (clustered round the route's start) and
    uniform over the landscape (spread): each equal to its plain version bit
    for bit, timed in the kernels phase's timers beside its yardstick and
    bound; at the spread poses the window renderer (f32) against the gather
    renderer, which reads the landscape directly."""
    size = land.shape[0]
    wsz = window_geometry(sensor)[1]
    half = wsz // 2
    rng = np.random.default_rng(BIG_SIZE)
    spread_xy = rng.uniform(half, size - half - 1, size=(BATCH, 2)).astype(np.float32)
    spread_theta = rng.uniform(-math.pi, math.pi, size=BATCH).astype(np.float32)
    layouts = {"clustered": (trial_xy, trial_theta),
               "spread": (torch.from_numpy(spread_xy).to(land.device),
                          torch.from_numpy(spread_theta).to(land.device))}
    out = {"window_gather": {}, "render": {}}
    for name, (xy, theta) in layouts.items():
        by_np, bx_np = big_corners(xy, wsz, size)
        out["window_gather"][name], wins = check_window(land, by_np, bx_np, wsz, wsz)
        fxy = torch.stack([xy[:, 0] - torch.from_numpy(bx_np).to(xy.device).float(),
                           xy[:, 1] - torch.from_numpy(by_np).to(xy.device).float(),
                           torch.cos(theta), torch.sin(theta)], dim=1)
        out["render"][name] = check_render(wins, sensor, land.device, rng, fxy=fxy)
    # the gather renderer's sample coordinates are absolute: near x = 2048 an
    # f32 coordinate rounds to 1.2e-4 px, which moves a sample by ~1e-5-1e-4
    # on this texture, so it is evaluated in fp64 (its f32 error reported)
    sensor_f32 = dataclasses.replace(sensor, hat_dtype="float32")
    xy, theta = layouts["spread"]
    gather = make_render_panorama_gather(sensor_f32)
    want = gather(land.double(), xy.double(), theta.double())
    err = float((make_render_panorama(sensor_f32)(land, xy, theta) - want).abs().max())
    out["render"]["spread"]["gather_render_max_abs_err_f32"] = err
    out["render"]["spread"]["gather_f32_own_max_abs_err"] = float(
        (gather(land, xy, theta) - want).abs().max())
    require(err <= REFERENCE_RENDER_TOL, f"big landscape: window renderer vs the fp64 gather "
            f"renderer {err} > {REFERENCE_RENDER_TOL}")
    return out


def run_big_landscape(cfg: SimConfig, land_np: np.ndarray, route: np.ndarray,
                      dev: torch.device) -> tuple[dict, dict]:
    """Config 1 on the 4096^2 fractal world of ``bench.py run_big_landscape``
    (past the TPU window kernel's VMEM budget and the card's L2):
    ``NavigationSimulator`` with "auto", which must resolve to "fft", on
    1024 trials; its captured episode against the eager one (bit for bit);
    its success against the exact kernel path's recall on GATE_BATCH
    trials less ACCURACY_BAND_1; then the window and render kernels at
    this size (:func:`check_big_kernels`). Returns the phase's launch
    counts and the kernels' rows at this size, by corner layout."""
    t_phase = time.perf_counter()
    require(land_np.size > TPU_VMEM_LAND_MAX_ELEMS, "the big landscape fits the TPU kernel's VMEM")
    base = phase_memory_start()
    t0 = time.perf_counter()
    sim = NavigationSimulator(cfg, land_np, route)
    require(sim.fam_impl == "fft", f"config 1's auto resolved to {sim.fam_impl!r}")
    sim.train()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    st = sim._statics
    one_copy = st.landscape.data_ptr() == sim.landscape.data_ptr()
    _, first_s = _timed(lambda: sim.navigate(n_trials=BATCH, seed=0))  # captures
    res, counts, episode_s = timed_navigate(sim, n_trials=BATCH, seed=0)
    replays_s = [episode_s] + [_wall_s(lambda: sim.navigate(n_trials=BATCH, seed=0))
                               for _ in range(2)]
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    t_max = cfg.agent.max_steps
    states0 = init_state(*make_trials(route, cfg, BATCH, seed=0))
    eager = make_navigate_batch_fn(cfg, sim.fam_impl)
    want, eager_s = _timed(lambda: eager(states0, st, sim._aux))
    differ = _differing_fields(want, (res.final_state, res.record))
    statics_bytes = nbytes(*(x for x in st if isinstance(x, torch.Tensor)), *st.lib)
    buf = torch.empty_like(st.landscape)
    copy_in_ms = time_ms(lambda: buf.copy_(st.landscape), runs=5, warmup=1)
    del buf

    gate = init_state(*make_trials(route, cfg, BIG_GATE_BATCH, seed=0))
    run_k = make_navigate_batch(exact_cfg(cfg), "kernel")
    final_k, gate_counts = _counted(lambda: run_k(gate, st)[0])
    rate_ref = float(success_rate(final_k))
    floor = max(0.0, rate_ref - ACCURACY_BAND_1)
    launches = {name: counts[name] + gate_counts[name] for name in counts}
    kernels = {name: {layout: {key: r[key] for key in BIG_KERNEL_KEYS if key in r}
                      for layout, r in rows.items()}
               for name, rows in check_big_kernels(sim.landscape, states0.xy, states0.theta,
                                                   cfg.sensor).items()}
    emit({
        "phase": "big_landscape", "config": 1, "landscape": f"fractal-{BIG_SIZE}x{BIG_SIZE}",
        "landscape_cells": int(land_np.size), "landscape_mb": land_np.nbytes / 1e6,
        "fam_impl": sim.fam_impl, "batch": BATCH, "max_steps": t_max,
        "library_views": int(sim.library.views.shape[0]), "success_rate": res.success_rate,
        "exact_recall_ref": rate_ref, "recall_floor": floor, "gate_batch": BIG_GATE_BATCH,
        "setup_s": setup_s, "first_call_s": first_s, "episode_s_captured": replays_s,
        "episode_s_eager": eager_s,
        "agent_steps_per_s": BATCH * t_max / float(np.median(replays_s)),
        "captured_equals_eager": not differ, "differing_fields": differ,
        "landscape_on_card_once": one_copy, "statics_copied_in_per_call_mb": statics_bytes / 1e6,
        "statics_copy_in_ms": copy_in_ms, "peak_mem_gb": peak, "launches": counts,
        "gate_launches": gate_counts, "kernels": kernels,
        "seconds": time.perf_counter() - t_phase,
    })
    require(one_copy, "big landscape: the statics hold a second copy of the landscape")
    require(not differ, f"big landscape: captured episode differs from eager in {differ}")
    require(res.success_rate >= floor,
            f"big landscape: success {res.success_rate} below the exact path's {rate_ref} "
            f"less {ACCURACY_BAND_1}")
    require_render_only(counts, "big_landscape")
    require(gate_counts["min_distance_pooled"] > 0, "big landscape: the exact gate did not "
            "launch the min-distance kernel")
    return launches, kernels


def _pool_segments(pool: tuple) -> list[dict]:
    """The segments of CUDA-graph pool ``pool`` once the freed blocks are
    returned to the card."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return [seg for seg in torch.cuda.memory_snapshot() if tuple(seg["segment_pool_id"]) == pool]


def _memory_gb(dev: torch.device) -> dict:
    """Allocated and reserved GB, then the GB of the card's graph pool: its
    segments (``graph_pool``: the most that live graphs and captures have
    held, their working sets included, which allocated bytes leave out)
    and the bytes allocated in them (``graph_active``: the live graphs'
    outputs)."""
    torch.cuda.synchronize()
    out = {"allocated": torch.cuda.memory_allocated() / 1e9,
           "reserved": torch.cuda.memory_reserved() / 1e9}
    segs = _pool_segments(tuple(capture.graph_pool(dev)))
    out["graph_pool"] = sum(seg["total_size"] for seg in segs) / 1e9
    out["graph_active"] = sum(seg["allocated_size"] for seg in segs) / 1e9
    return out


def _clear_program_caches() -> None:
    """Drop every cached probe, statics and aux, and return the freed
    blocks to the card."""
    _make_familiarity_probe.cache_clear()
    _AUX_CACHE.clear()
    _STATICS_CACHE.clear()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _fresh_pool(dev: torch.device) -> bool:
    """Drop every cached program and give up the card's graph pool, so that
    what runs next captures into a pool of its own. True when the old pool's
    segments went back to the card."""
    old = tuple(capture.graph_pool(dev))
    capture.release_pool(dev)
    _clear_program_caches()
    return not _pool_segments(old)


def _live_graphs(prefix: str) -> int:
    """Live, unreleased ``capture.Graph`` objects of captured functions
    whose name starts with ``prefix``."""
    gc.collect()
    return sum(1 for o in gc.get_objects()
               if type(o) is capture.Graph and o.args is not None and o.name.startswith(prefix))


def _memory_series(calls: list, prefix: str, revisit: int, dev: torch.device,
                   alone: bool) -> dict:
    """Run ``calls`` (each given the series' ProgramCache), then the first
    ``revisit`` of them again, in a graph pool of their own: the memory after
    each call, the live graphs at the end, and whether giving up the pool
    then returned its segments. With ``alone``, first each call by itself,
    with a cache and a pool of its own: that pool's GB (``alone``)."""
    out = {}
    if alone:
        sizes = []
        for call in calls:
            _fresh_pool(dev)
            call(ProgramCache())
            sizes.append(_memory_gb(dev)["graph_pool"])
        out["alone"] = sizes
    _fresh_pool(dev)
    cache = ProgramCache()
    after = [(call(cache), _memory_gb(dev))[1] for call in calls + calls[:revisit]]
    out.update({key: [m[key] for m in after] for key in after[0]})
    live = _live_graphs(prefix)
    del cache
    out.update(configs=len(calls), revisited=revisit, live_graphs=live,
               pool_returned=_fresh_pool(dev))
    return out


def _memory_summary(series: dict, bound_n: int) -> dict:
    """The pool's and allocated GB after the first configurations (as many
    as are revisited), after all, and after the revisit; growth per
    configuration over the distinct ones. Where the configurations also ran
    alone: the largest alone, and ``own_pools``, the most that the
    configurations' own pools held at once, the largest sum of ``bound_n``
    consecutive ones (a program enters its cache before it captures, so the
    cache then holds it and the bound_n - 1 before it)."""
    n, k = series["configs"], series["revisited"]
    out = {}
    for key in ("graph_pool", "graph_active", "allocated"):
        v = series[key]
        out[key] = {"after_first": v[k - 1], "after_all": v[n - 1], "after_revisit": v[-1],
                    "growth_per_config": (v[n - 1] - v[0]) / (n - 1)}
    if "alone" in series:
        a = series["alone"]
        seq = a + a[:k]
        out["largest_alone"] = max(a)
        out["own_pools"] = max(sum(seq[max(0, i - bound_n + 1):i + 1]) for i in range(len(seq)))
    return out


def memory_runs(land: torch.Tensor, route: np.ndarray, libs: dict, tmp: str,
                revisit: int, dev: torch.device, alone: bool) -> tuple:
    """The three series of the memory phase at the current
    ``capture.MAX_PROGRAMS``, each in a graph pool of its own: the default
    sweep through ``run_sweep`` (memory after each cell), the grid of 12
    distinct cells through ``run_cell`` and one ProgramCache, and 40 maps on
    distinct configurations, each then revisiting its first ``revisit``
    (with ``alone``, each configuration of the grid and the maps first runs
    alone). Also the sweep's results (timing left out) and launch counts."""
    out = {}
    _fresh_pool(dev)
    cells = []
    run_cell = sweep.run_cell

    def recorded(*args, **kw):
        res = run_cell(*args, **kw)
        cells.append(_memory_gb(dev))
        return res

    sweep.run_cell = recorded
    try:
        ops.reset_launch_counts()
        res = run_sweep(land, route, SweepSpec(), tmp, verbose=False, tensorboard=False,
                        recall_check_trials=SWEEP_RECALL_TRIALS)
        launches = ops.launch_counts()
    finally:
        sweep.run_cell = run_cell
    out["default_sweep"] = {key: [m[key] for m in cells] for key in cells[0]}
    results = {key: {k: np.asarray(v).tolist() for k, v in r.items() if k not in SWEEP_TIMING}
               for key, r in res.items()}
    del res

    cfg1 = bench_config(1, VIEWS)[0]
    arc = cfg1.capture_spacing * (VIEWS - 0.5)
    grid = []
    for views, steps, impl in itertools.product(*MEMORY_GRID):
        cfg = dataclasses.replace(cfg1, capture_spacing=arc / (views - 0.5), agent=dataclasses
                                  .replace(cfg1.agent, max_steps=steps))
        cfg = exact_cfg(cfg) if impl == "kernel" else cfg
        grid.append(lambda cache, c=cfg, i=impl: sweep.run_cell(
            land, route, c, SweepSpec().n_trials, 0, i, nav_cache=cache))
    out["grid_12"] = _memory_series(grid, "early-exit chunk", revisit, dev, alone)
    del grid

    maps = []
    for r_max, metric, impl in itertools.product(*MEMORY_MAPS):
        cfg = with_scan(libs[r_max][0], metric=metric)
        cfg = exact_cfg(cfg) if impl == "kernel" else cfg
        # the probes' own caches (analysis._LIVE_PROBES) bound their graphs
        maps.append(lambda cache, c=cfg, i=impl, lib=libs[r_max][1]: familiarity_map(
            land, lib, c, stride=MEMORY_MAP_STRIDE, fam_impl=i, batch=MEMORY_MAP_BATCH))
    out["maps_40"] = _memory_series(maps, "familiarity probe", revisit, dev, alone)
    return out, results, launches


def run_memory(dev: torch.device) -> None:
    """Captured memory (ROADMAP C.13) on the bench world: the default sweep,
    a grid of 12 distinct cells (views x max_steps x fam_impl) and 40
    familiarity maps on distinct configurations (r_max x metric x
    fam_impl), first bounded, then with the bound lifted
    (``capture.MAX_PROGRAMS = None``, the caches as they were before it),
    each series in a graph pool of its own. The grid and the maps then
    revisit their first MAX_PROGRAMS configurations; bounded, each of their
    configurations also runs alone first, in a pool of its own.
    Every graph of a card shares one pool, which keeps the segments it
    grows by. Bounded, that pool after all configurations must stay within
    5% of the most that MAX_PROGRAMS consecutive configurations took alone,
    which their own pools held at once before graphs shared one; the
    revisit may add at most 5%; at most MAX_PROGRAMS graphs may live; and
    once the series' graphs are released and the pool given up, its
    segments must go back to the card. The sweep's results and launch
    counts must equal the unbounded run's."""
    t_phase = time.perf_counter()
    cfg1, land_np, route = bench_config(1, VIEWS)
    land = torch.as_tensor(land_np, device=dev)
    libs = {}
    for r_max in MEMORY_MAPS[0]:
        c = dataclasses.replace(cfg1, sensor=dataclasses.replace(cfg1.sensor, r_max=r_max))
        libs[r_max] = (c, train_library(land, route, c))
    bound_n = capture.MAX_PROGRAMS
    out, results, launches = {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for mode, limit in (("bounded", bound_n), ("unbounded", None)):
            capture.MAX_PROGRAMS = limit
            try:
                out[mode], results[mode], launches[mode] = memory_runs(
                    land, route, libs, str(Path(tmp) / mode), bound_n, dev, mode == "bounded")
            finally:
                capture.MAX_PROGRAMS = bound_n
    summary = {mode: {series: _memory_summary(out[mode][series], bound_n)
                      for series in ("grid_12", "maps_40")} for mode in out}
    # as JSON: a NaN equals itself there
    same = json.dumps(results["bounded"], sort_keys=True) == json.dumps(results["unbounded"],
                                                                        sort_keys=True)
    emit({"phase": "memory", "max_programs": bound_n, "grid": [list(a) for a in MEMORY_GRID],
          "maps": [list(a) for a in MEMORY_MAPS], **out, "summary": summary,
          "sweep_results_equal": same, "sweep_launches": launches,
          "seconds": time.perf_counter() - t_phase})
    require(same, "memory: the bounded sweep's results differ from the unbounded sweep's")
    require(launches["bounded"] == launches["unbounded"],
            f"memory: launches {launches['bounded']} bounded, {launches['unbounded']} unbounded")
    for series in ("grid_12", "maps_40"):
        got = summary["bounded"][series]
        pool = got["graph_pool"]
        require(pool["after_all"] <= (1 + MEMORY_TOL) * got["own_pools"],
                f"memory: {series} graph pool {pool['after_all']} GB after all configurations, "
                f"{got['own_pools']} GB in the configurations' own pools at once")
        require(pool["after_revisit"] <= (1 + MEMORY_TOL) * pool["after_all"],
                f"memory: {series} graph pool {pool['after_revisit']} GB after the revisit, "
                f"{pool['after_all']} GB after all configurations")
        live = out["bounded"][series]["live_graphs"]
        require(live <= bound_n, f"memory: {series} leaves {live} graphs alive, bounded")
        require(out["bounded"][series]["pool_returned"],
                f"memory: {series} pool kept its segments after its graphs and the pool went")


def _counted(fn):
    """``fn()`` with every launch and collective count zeroed just before
    it and read just after; waits for the card."""
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    reset_collective_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, {**ops.launch_counts(), **collective_counts()}


def _timed(fn):
    """``(fn(), seconds)``, on the host's clock until the card is done."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _wall_s(fn) -> float:
    return _timed(fn)[1]


def _differing_fields(a, b) -> list[str]:
    """Names of the fields of two (states, records) pairs that differ."""
    return [f"{tag}.{name}" for tag, x, y in (("final", a[0], b[0]), ("record", a[1], b[1]))
            for name, u, v in zip(x._fields, x, y) if not torch.equal(u, v)]


def compare_captured(eager, run, states0, st, aux, chunk=None) -> dict:
    """The eager episode against the captured one on the same inputs: the
    fields that differ (none may), both launch counts (equal on a full loop;
    under early exit the captured chunks also launch their masked steps:
    per step x chunks replayed x chunk), and each episode's wall time, in
    the order eager, captured, captured, eager (the first captured call
    captures, uncounted in the times). The captured result held from the
    first call must be unchanged by the later ones."""
    want, n_eager = _counted(lambda: eager(states0, st, aux))
    got, n_captured = _counted(lambda: run(states0, st, aux))
    held = [t.clone() for t in (*got[0], *got[1])]
    walls = [_wall_s(lambda: eager(states0, st, aux)), _wall_s(lambda: run(states0, st, aux)),
             _wall_s(lambda: run(states0, st, aux)), _wall_s(lambda: eager(states0, st, aux))]
    t_max = want[1].k.shape[1]
    n_exec = int((~want[1].done).sum(dim=1).max())
    expected = dict(n_eager)
    if chunk is not None and n_exec:
        replays = max(1, -(-n_exec // chunk))
        expected = {k: v // n_exec * replays * chunk for k, v in n_eager.items()}
        require(all(v % n_exec == 0 for v in n_eager.values()),
                f"eager early exit: launches {n_eager} not a multiple of its {n_exec} steps")
    out = {
        "differing_fields": _differing_fields(want, got),
        "held_result_unchanged": all(torch.equal(a, b)
                                     for a, b in zip(held, (*got[0], *got[1]))),
        "launches_eager": n_eager, "launches_captured": n_captured,
        "launches_captured_expected": expected, "steps_executed": n_exec, "max_steps": t_max,
        "episode_s_eager": [walls[0], walls[3]], "episode_s_captured": [walls[1], walls[2]],
        "success_rate": float(success_rate(got[0])), "captured": run.captured,
    }
    if chunk is not None:
        out["exit_chunk"] = chunk
    return out


def check_window_capture(dev: torch.device) -> dict:
    """One window-gather launch (a ctypes library with its own CUDA runtime)
    captured and replayed against the same launch run eagerly, at the main
    path's shapes."""
    rng = np.random.default_rng(5)
    land = torch.from_numpy(rng.uniform(size=(512, 512)).astype(np.float32)).to(dev)
    by = torch.from_numpy(rng.integers(0, 488, BATCH).astype(np.int32)).to(dev)
    bx = torch.from_numpy(rng.integers(0, 488, BATCH).astype(np.int32)).to(dev)
    graphed = Captured(lambda l, y, x: window_gather(l, y, x, 24, 24), dev, "window gather")
    got, counts = _counted(lambda: graphed(land, by, bx))
    want = window_gather(land, by, bx, 24, 24)
    return {"bit_equal": bool(torch.equal(got, want)), "launches": counts["window_gather"]}


def map_pair(probe, pts: np.ndarray, st, aux) -> dict:
    """A familiarity map's batches (padded as ``familiarity_map`` pads them)
    through the captured ``probe.best`` and through ``probe.best.eager``."""
    zeros = np.zeros(MAP_BATCH, np.float32)
    batches = []
    for lo in range(0, len(pts), MAP_BATCH):
        chunk = pts[lo:lo + MAP_BATCH]
        if len(chunk) < MAP_BATCH:
            chunk = np.concatenate([chunk, np.repeat(chunk[-1:], MAP_BATCH - len(chunk), axis=0)])
        batches.append(chunk)

    def whole(best):
        return [best(c, zeros, st, aux) for c in batches]

    want, n_eager = _counted(lambda: whole(probe.best.eager))
    got, n_captured = _counted(lambda: whole(probe.best))
    walls = [_wall_s(lambda: whole(probe.best.eager)), _wall_s(lambda: whole(probe.best)),
             _wall_s(lambda: whole(probe.best)), _wall_s(lambda: whole(probe.best.eager))]
    equal = all(torch.equal(a, b) for w, g in zip(want, got) for a, b in zip(w, g))
    return {"positions": len(pts), "batches": len(batches), "bit_equal": equal,
            "launches_eager": n_eager, "launches_captured": n_captured,
            "ms_per_batch_eager": [walls[0] / len(batches) * 1e3, walls[3] / len(batches) * 1e3],
            "ms_per_batch_captured": [walls[1] / len(batches) * 1e3,
                                      walls[2] / len(batches) * 1e3],
            "captured": probe.captured}


def chunked_run(cfg: SimConfig, fam_impl: str, chunk: int):
    """The captured early exit with ``chunk`` steps per replay
    (``agent.EXIT_CHUNK``, read when a run is built)."""
    default, agent.EXIT_CHUNK = agent.EXIT_CHUNK, chunk
    try:
        return make_navigate_batch(cfg, fam_impl, early_exit=True)
    finally:
        agent.EXIT_CHUNK = default


def world_of(cfg: SimConfig, land, route, batch: int):
    """Statics with a freshly trained library, and the trials' start states."""
    st = make_statics(land, train_library(land, route, cfg), route)
    return st, init_state(*make_trials(route, cfg, batch, seed=0))


def run_graphs(dev: torch.device) -> dict:
    """Each compiled program of the JAX package, eager against captured on
    the same inputs (one window-gather launch first): the batched episode on
    config 4 ``kernel``, config 4 ``fft`` as shipped, config 2 ``roll``,
    config 3 on the fused sector path, config 4 ``conv``, config 1
    ``infomax`` (its training too: W bit-equal), the default sweep's first
    cell with early exit at every chunk size of GRAPH_CHUNKS, and config
    1's familiarity map on ``kernel``. Every path must give bit-equal final
    states and records and the expected launch counts. Returns the phase's
    results."""
    t_phase = time.perf_counter()
    out = {"window_gather_capture": check_window_capture(dev)}
    cfg4, land, route = slice_config()
    st4, states4 = world_of(cfg4, land, route, BATCH)
    cfg2, land2, route2 = bench_config(2, CONFIG2_VIEWS)
    cfg3, land3, route3 = bench_config(3, VIEWS)
    cfg1 = exact_cfg(bench_config(1, VIEWS)[0])
    st1, states1 = world_of(cfg1, land, route, BATCH)
    paths = [("kernel_config4", cfg4, "kernel", lambda: (st4, states4)),
             ("fft_config4_shipped", bench_config(4, VIEWS)[0], "fft", lambda: (st4, states4)),
             ("roll_config2", cfg2, "roll", lambda: world_of(cfg2, land2, route2, CONFIG2_BATCH)),
             ("sector_config3", cfg3, "fft", lambda: world_of(cfg3, land3, route3, SECTOR_BATCH)),
             ("conv_config4", cfg4, "conv", lambda: (st4, states4)),
             ("infomax_config1", cfg1, "infomax", lambda: (st1, states1))]
    for name, cfg, impl, world in paths:
        st, states0 = world()
        eager = make_navigate_batch_fn(cfg, impl)
        run = make_navigate_batch(cfg, impl)
        aux = None
        if impl == "infomax":
            scan = cfg.scan
            args = (st.lib, scan.infomax_units or cfg.sensor.n_pixels, scan.infomax_eta,
                    scan.infomax_epochs, scan.infomax_seed, cfg.capture_spacing)
            aux, captured_s = _timed(lambda: train_infomax(*args))
            eager_pack, eager_s = _timed(lambda: train_infomax(*args, captured=False))
            out["infomax_training"] = {
                "updates": applied_updates(st.lib, scan.infomax_epochs, cfg.capture_spacing),
                "w_bit_equal": bool(torch.equal(aux.w, eager_pack.w)),
                "train_s_captured": captured_s, "train_s_eager": eager_s}
        elif run.prepare is not None:
            aux = run.prepare(st)
        out[name] = compare_captured(eager, run, states0, st, aux)
        del run, eager, aux
        torch.cuda.empty_cache()

    key, cfg5, _ = next(iter(SweepSpec().cells()))
    impl5 = resolve_fam_impl(cfg5, "auto")
    st5, states5 = world_of(cfg5, land, route, SweepSpec().n_trials)
    eager = make_navigate_batch_fn(cfg5, impl5, early_exit=True)
    prepare = make_step_batched(cfg5, impl5).lib_prepare
    aux5 = None if prepare is None else prepare(st5)
    exits, runs = {}, {}
    for chunk in GRAPH_CHUNKS:
        runs[chunk] = chunked_run(cfg5, impl5, chunk)
        exits[chunk] = compare_captured(eager, runs[chunk], states5, st5, aux5, chunk=chunk)
    walls = {chunk: [] for chunk in GRAPH_CHUNKS}
    for _ in range(CHUNK_ROUNDS):  # round robin, so drift spreads over every chunk size
        for chunk, run in runs.items():
            walls[chunk].append(_wall_s(lambda: run(states5, st5, aux5)))
    for chunk in GRAPH_CHUNKS:
        exits[chunk]["episode_s_captured_median"] = float(np.median(walls[chunk]))
        exits[chunk]["episode_s_captured_quartiles"] = [float(q) for q in
                                                        np.percentile(walls[chunk], [25, 75])]
    del runs
    out["early_exit_sweep_cell"] = {"cell": key, "fam_impl": impl5, "batch": SweepSpec().n_trials,
                                    "default_chunk": agent.EXIT_CHUNK, "rounds": CHUNK_ROUNDS,
                                    "by_chunk": exits}

    mcfg = full_circle_scan(cfg1)
    probe = make_familiarity_probe(mcfg, "kernel")
    xs = np.arange(cfg1.sensor.r_max, 511 - cfg1.sensor.r_max + 1e-9, MAP_STRIDE, dtype=np.float32)
    pts = np.stack([a.ravel() for a in np.meshgrid(xs, xs)], axis=1)
    out["map_kernel_config1"] = map_pair(probe, pts, st1, None)
    emit({"phase": "graphs", **out, "seconds": time.perf_counter() - t_phase})

    require(out["window_gather_capture"]["bit_equal"], "graphs: the captured window gather differs")
    require(out["window_gather_capture"]["launches"] == 1,
            "graphs: one replayed window gather did not count one launch")
    require(out["infomax_training"]["w_bit_equal"], "graphs: captured infomax training gave "
            "another W than the eager loop")
    checked = {name: out[name] for name, *_ in paths}
    checked.update({f"early_exit_chunk_{c}": r for c, r in exits.items()})
    for name, r in checked.items():
        require(r["captured"], f"graphs {name}: the run did not replay CUDA graphs")
        require(not r["differing_fields"], f"graphs {name}: captured episode differs from eager "
                f"in {r['differing_fields']}")
        require(r["held_result_unchanged"], f"graphs {name}: a held result changed")
        require(r["launches_captured"] == r["launches_captured_expected"],
                f"graphs {name}: launches {r['launches_captured']}, want "
                f"{r['launches_captured_expected']}")
    m = out["map_kernel_config1"]
    require(m["captured"] and m["bit_equal"], "graphs: the captured kernel map differs from eager")
    require(m["launches_captured"] == m["launches_eager"],
            f"graphs map: launches {m['launches_captured']} vs eager {m['launches_eager']}")
    for name in MAP_KERNELS:
        require(m["launches_captured"][name] > 0, f"graphs map: kernel {name} was not launched")
    return out


def check_tiny_min_distance(cfg: SimConfig, st, states, dev: torch.device) -> dict:
    """The min-distance kernel on the candidate rows ``entry()``'s step
    scores (its pooled panorama's views at every scan lag against the
    tiny library) within rtol/atol 1e-6 of its plain version, timed."""
    pano = make_render_batch(cfg.sensor, dev)(st.landscape, states.xy, states.theta)
    lags = scan_lag_sets(cfg.scan)[0]
    cand = make_views_from_pooled(cfg.sensor, lags, dev)(make_pooled_panorama(cfg.sensor, dev)(pano))
    rows = cand.reshape(-1, cfg.sensor.n_pixels).contiguous()
    lib = st.lib
    args = (rows, lib.flat, lib.sq + (1.0 - lib.valid) * PAD_PENALTY, -2.0, True)
    got, want = min_distance_rows(*args), min_distance_rows_plain(*args)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    require(torch.allclose(got, want, rtol=1e-6, atol=1e-6),
            f"graft_entry: min distance vs its plain version {err} (rtol/atol 1e-6)")
    n_rows, p = rows.shape
    nl = lib.flat.shape[0]
    b_ms, b_by = bound(nbytes(rows, lib.flat) + nl * 4 + n_rows * 4,
                       2.0 * n_rows * nl * p + 2.0 * n_rows * p)
    return dict(shape=[n_rows, nl, p], max_abs_err=err, tolerance="rtol/atol 1e-6 vs plain",
                ms=time_ms(lambda: min_distance_rows(*args)),
                plain_ms=time_ms(lambda: min_distance_rows_plain(*args)),
                bound_ms=b_ms, bound_by=b_by, library_ms=None)


def check_tiny_kernels(cfg: SimConfig, st, states, dev: torch.device) -> dict:
    """Window and render (both modes) at the graft entry's shapes, B=8 and
    B=2, and min distance at B=8: rows for the kernels line, keyed by B."""
    land = st.landscape
    wsz = window_geometry(cfg.sensor)[1]
    rng = np.random.default_rng(0)
    out = {"window_gather": {}, "render": {}}
    for b in (8, 2):
        xy, theta = states.xy[:b], states.theta[:b]
        by_np, bx_np = big_corners(xy, wsz, land.shape[0])
        row, wins = check_window(land, by_np, bx_np, wsz, wsz)
        out["window_gather"][f"b{b}"] = {**row, "shape": [b, wsz, wsz]}
        fxy = torch.stack([xy[:, 0] - torch.from_numpy(bx_np).to(dev).float(),
                           xy[:, 1] - torch.from_numpy(by_np).to(dev).float(),
                           torch.cos(theta), torch.sin(theta)], dim=1)
        out["render"][f"b{b}"] = check_render(wins, cfg.sensor, dev, rng, fxy=fxy)
    out["min_distance"] = {"b8": check_tiny_min_distance(cfg, st, states, dev)}
    return {name: {b: {k: r[k] for k in GRAFT_KEYS} for b, r in rows.items()}
            for name, rows in out.items()}


def graft_dryrun(n: int) -> dict:
    """``python -m navdv_torch.graft_entry dryrun n``, every line echoed;
    exit code 0 and the ok line last. Returns its JSON summary line."""
    lines = module_lines(["navdv_torch.graft_entry", "dryrun", str(n)], GRAFT_DRYRUN_TIMEOUT_S)
    require(bool(lines) and lines[-1].startswith("dryrun_multichip ok: impl=fft "),
            f"graft_entry dryrun {n}: no ok line last")
    summary = [json.loads(ln)["dryrun_multichip"] for ln in lines if ln.startswith("{")]
    require(len(summary) == 1, f"graft_entry dryrun {n}: {len(summary)} summary lines")
    return summary[0]


def check_dryrun(n: int, s: dict, cards: int) -> dict[str, int]:
    """The gate's summary against what its layout implies; returns its
    launches summed over ranks and meshes."""
    backend = "nccl" if n <= cards else "gloo"
    require(s["ranks"] == n and s["backend"] == backend and s["device"] == "cuda",
            f"graft_entry dryrun {n}: ranks {s['ranks']}, backend {s['backend']} (want "
            f"{backend}), device {s['device']}")
    shapes = [(m["n_data"], m["n_lib"]) for m in s["meshes"]]
    require(shapes == graft_entry.mesh_shapes(n), f"graft_entry dryrun {n}: meshes {shapes}")
    launches = {name: 0 for name in ops.launch_counts()}
    for m in s["meshes"]:
        tag = f"dryrun {n} mesh ({m['n_data']},{m['n_lib']})"
        captured = backend == "nccl" or m["n_lib"] == 1  # gloo's collectives run on the host
        require(m["captured"] == [captured] * n, f"{tag}: captured {m['captured']}")
        require(m["lib_pmin"] == [2 * s["steps"] if m["n_lib"] > 1 else 0] * n,
                f"{tag}: MIN collectives per rank {m['lib_pmin']}")
        for rank, counts in enumerate(m["launches"]):
            require(counts["window_gather"] > 0 and counts["render_pooled"] > 0,
                    f"{tag}: rank {rank} launched no window or pooled render kernel: {counts}")
            require(all(counts[name] == 0 for name in DISTANCE_KERNELS),
                    f"{tag}: rank {rank} launched a distance kernel on fft: {counts}")
            require(counts["decide"] > 0, f"{tag}: rank {rank} launched no decision kernel")
            for name in launches:
                launches[name] += counts[name]
    return launches


def run_graft_entry(dev: torch.device) -> tuple[dict, dict]:
    """The graft_entry phase (see the module docstring): returns its
    launches (the entry step's and the two gates' ranks') and the kernel
    rows at its shapes."""
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    fn, (states0, st) = graft_entry.entry()
    setup_s = time.perf_counter() - t0
    cfg = graft_entry.tiny_config()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    new = fn(states0, st)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    for name in MAIN_KERNELS:
        require(launches[name] > 0, f"graft_entry: entry()'s step launched no {name}")
    require(fn.captured, "graft_entry: entry()'s step is not captured on the card")
    replay_s = _wall_s(lambda: fn(states0, st))
    eager_s = _wall_s(lambda: fn.eager(states0, st))
    want = fn.eager(states0, st)
    require(all(torch.equal(a, b) for a, b in zip(new, want)),
            "graft_entry: the captured step differs from the eager step in "
            f"{[f for f, a, b in zip(new._fields, new, want) if not torch.equal(a, b)]}")
    require(all(torch.equal(a, b) for a, b in zip(fn(states0, st), new)),
            "graft_entry: a replay gave another result")
    fn.release()
    rows = check_tiny_kernels(cfg, st, states0, dev)
    del fn, st, states0, new, want
    torch.cuda.empty_cache()

    cards = torch.cuda.device_count()
    gates = {}
    for n in dict.fromkeys((8, cards)):
        t0 = time.perf_counter()
        summary = graft_dryrun(n)
        gate_launches = check_dryrun(n, summary, cards)
        for name in launches:
            launches[name] += gate_launches[name]
        gates[str(n)] = {**summary, "seconds": time.perf_counter() - t0,
                         "launches": gate_launches}
    emit({"phase": "graft_entry", "batch": graft_entry.BATCH, "setup_s": setup_s,
          "first_call_s": first_s, "replay_s": replay_s, "eager_s": eager_s,
          "kernels": rows, "dryrun": gates, "launches": launches,
          "seconds": time.perf_counter() - t_phase})
    return launches, rows


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


def module_lines(args: list[str], timeout: float) -> list[str]:
    """``python -m <args>`` in a process of its own, from the repo root;
    every line of its standard output echoed here. Fails on a non-zero exit
    (its standard error printed). Returns the non-empty lines."""
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [str(root), os.environ.get("PYTHONPATH")])))
    out = subprocess.run([sys.executable, "-m", *args], cwd=root, env=env, capture_output=True,
                         text=True, timeout=timeout)
    lines = [ln for ln in out.stdout.splitlines() if ln.strip()]
    for ln in lines:
        print(ln, flush=True)
    what = " ".join(args)
    if out.returncode != 0:
        print(f"--- {what} exited {out.returncode}:\n{out.stderr[-3000:]}", file=sys.stderr)
    require(out.returncode == 0, f"{what}: exit code {out.returncode}")
    return lines


def bench_lines(extra: tuple[str, ...]) -> list[dict]:
    """``python -m navdv_torch.cli bench <extra>``, every line parsed (a
    line that is not JSON fails)."""
    return [json.loads(ln) for ln in module_lines(["navdv_torch.cli", "bench", *extra],
                                                  BENCH_TIMEOUT_S)]


def run_bench_phase() -> dict[str, int]:
    """The port's bench (``navdv_torch.bench``) through the command line:
    ``--all`` (configs 1-4, the config-1 latency envelope at B=1/16/64, the
    kernel parity gates at config 1 (SSD) and 3 (NCC), the sector gate, the
    fft and roll precision gates) and ``--big-landscape 4096 --repeats 1``.
    Every line must name ``device: "gpu"`` and the card, carry no error and
    read ``ok: true``, except the B=1 and B=16 latency lines, which carry
    the JAX bench's ``gate`` marker instead; every line must launch the
    window and render kernels, the parity gates and the big landscape's
    exact gate the min-distance kernel, and no line the lag kernel.
    Returns the launches summed over the lines (each line counts its own
    from 0)."""
    t0 = time.perf_counter()
    lines = {extra[0]: bench_lines(extra) for extra in BENCH_RUNS}
    all_lines, big = lines["--all"], lines["--big-landscape"]
    metrics = [ln.get("metric") for ln in all_lines]
    require(metrics == [BENCH_HEADLINE] * 7 + list(BENCH_GATES),
            f"bench --all: lines {metrics}")
    require([ln.get("metric") for ln in big] == ["big_landscape_dma"],
            f"bench --big-landscape: lines {[ln.get('metric') for ln in big]}")
    launches = {name: 0 for name in ops.launch_counts()}
    for ln in all_lines + big:
        what = f"bench line {ln.get('metric')} config {ln.get('config')} batch {ln.get('batch')}"
        require("error" not in ln, f"{what}: error {ln.get('error')}")
        require(ln.get("device") == "gpu" and bool(ln.get("card")),
                f"{what}: device {ln.get('device')!r}, card {ln.get('card')!r}")
        if "gate" in ln:
            require(ln["metric"] == BENCH_HEADLINE and ln["batch"] < 64 and "ok" not in ln,
                    f"{what}: gate marker {ln['gate']!r} where bench.py gives a verdict")
        else:
            require(ln.get("ok") is True, f"{what}: ok {ln.get('ok')}")
        n = ln["launches"]
        require(n["window_gather"] > 0 and n["render"] + n["render_pooled"] > 0
                and n["decide"] > 0, f"{what}: window, render or decision kernel not launched: {n}")
        require(n["lag_fam"] == 0, f"{what}: the lag kernel launched: {n}")
        # the parity gate scores gathered candidates (rows entry); every exact
        # recall gate runs the kernel path's SSD step (pooled entry)
        if ln["metric"] == "pallas_parity_gate":
            require(n["min_distance"] > 0, f"{what}: the min-distance kernel not launched")
        if ln["metric"] == "big_landscape_dma":
            require(n["min_distance_pooled"] > 0, f"{what}: the min-distance kernel not launched")
        for name in launches:
            launches[name] += n[name]
    require(sum(ln["launches"]["min_distance_pooled"] for ln in all_lines[:7]) > 0,
            "bench: no exact recall gate launched the min-distance kernel")
    emit({"phase": "bench", "lines": len(all_lines) + len(big),
          "gated_ok": sum(ln.get("ok") is True for ln in all_lines + big),
          "gate_markers": sum("gate" in ln for ln in all_lines + big),
          "launches": launches, "seconds": time.perf_counter() - t0})
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parallel-child", metavar="DIR", help="run one rank of the parallel phase")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if args.parallel_child:
        parallel_child(args.parallel_child)
        return 0
    t_start = time.perf_counter()
    dev = resolve_device("cuda")  # also switches TF32 off for matmuls and convolutions
    card = card_line()
    emit({"phase": "card", "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "name": torch.cuda.get_device_name(0)})

    build_s, logs = _build.build_all()
    emit({"phase": "build", "seconds": build_s, **check_build(logs)})

    cfg, land, route = slice_config()
    t0 = time.perf_counter()
    results = check_kernels(cfg, route, dev)
    # what the two timers charge any launch: a kernel that does nothing
    empty = {"ms": time_ms(lambda: torch.cuda._sleep(0)),
             "ms_in_run": time_ms_in_run(lambda: torch.cuda._sleep(0))}
    emit({"phase": "kernels", **results, "empty_kernel": empty,
          "seconds": time.perf_counter() - t0})
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    st, states0, final, rec, counts = run_main_path(cfg, land, route)
    run_reference(cfg, st, states0, final, rec)
    main_ref = main_reference(cfg, st, states0, final, rec)
    launches = {name: (n, "main") for name, n in counts.items()}
    poses = episode_poses(cfg, states0, rec)
    launches["lag_fam"] = (run_lag(cfg, st, poses), "lag phase")
    run_reference_functions(cfg, st, poses)
    sim = run_spectral(cfg, st, poses, float(success_rate(final)))
    render3 = run_sector(cfg, st, poses, dev)
    by_phase = {"main": counts, "lag": {"lag_fam": launches["lag_fam"][0]}}
    by_phase["conv"] = run_conv(cfg, st, states0, poses, float(success_rate(final)), dev)
    by_phase["infomax"] = run_infomax(cfg, st, states0, poses)
    del st, states0, final, rec, poses
    torch.cuda.empty_cache()
    cfg2, st2, states2, res2 = run_roll()
    roll_ref = roll_reference(st2, states2, res2)
    run_roll_knobs(cfg2, st2, states2)
    del st2, states2, res2
    run_checkpoint(sim)
    del sim
    torch.cuda.empty_cache()
    sweep_ref = run_sweep_phase()
    by_phase["parallel"] = run_parallel(main_ref, roll_ref, sweep_ref)
    by_phase["analysis"] = run_analysis(dev)
    run_golden()
    torch.cuda.empty_cache()
    cfg1, land1, route1 = bench_config(1, VIEWS, size=BIG_SIZE, kind="fractal")
    by_phase["big_landscape"], big = run_big_landscape(cfg1, land1, route1, dev)
    del land1
    torch.cuda.empty_cache()
    run_memory(dev)
    run_graphs(dev)
    torch.cuda.empty_cache()
    by_phase["graft_entry"], graft_rows = run_graft_entry(dev)
    torch.cuda.empty_cache()
    by_phase["bench"] = run_bench_phase()

    results["render"]["config3"] = {key: render3[key] for key in (
        "shape", "ms", "ms_in_run", "plain_ms", "bound_ms", "bound_by", "library_ms")}
    for name, rows in big.items():
        results[name]["big_landscape"] = rows
    for name, rows in graft_rows.items():
        results[name]["graft_entry"] = rows
    kernels = [
        {"name": name, "route": r["route"], "source": r["source"], "replaces": r["replaces"],
         "launches": launches[name][0], "launches_in": launches[name][1],
         "launches_by_phase": {ph: c[name] for ph, c in by_phase.items() if name in c},
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "library_ms": r["library_ms"],
         **{key: r[key] for key in ("config3", "big_landscape", "graft_entry", "b1") if key in r}}
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
