"""Where one episode of the port spends its time on the card.

    python3 chip_profile.py [--fam-impl kernel|fft|roll|conv|infomax] [--config 1|2|3|4]
                            [--eager | --split]

The cells are those ``chip_smoke.py`` drives: configs 1 and 4 (50 views,
1024 agents), config 2 (500 views, 512 agents) and config 3 (50 views, 256
agents, the fused sector front end on ``fft``), as shipped except that the
other paths clear the knobs only ``fft`` reads (``chip_smoke.exact_cfg``).
``--config`` defaults to the cell each path ships for: 4 for ``kernel``
(the default), ``fft`` and ``conv``, 2 for ``roll``, 1 for ``infomax``
(whose prepare stage, the network's training, runs once before the
timed episodes). Trains the library, prepares its per-library constants
once (as ``NavigationSimulator`` does), warms the episode up (which
captures it), times three plain episodes (host clock around work that ends
in a synchronize), then runs one more under
``navdv_torch.utils.profiling.trace`` and prints one JSON line: the
episode's wall time, the device time summed by kernel name (``top_ops``),
and the device's idle share (1 - summed kernel time / profiled wall time;
one stream, so kernels never overlap), also against the unprofiled
episodes' median wall time, since tracing slows the host. The Chrome trace
goes to ``build/traces/``. The episode is ``make_navigate_batch``'s,
replayed as CUDA graphs; ``--eager`` profiles ``make_navigate_batch_fn``'s
instead, launched op by op from the host. Exits non-zero without a card or
when the profiler records no device activity.

``--split`` instead runs SPLIT_RUNS synchronized captured episodes inside
``navdv_torch.utils.profiling.recording()``, after one that captures the
graph with the step's stage marks, and prints what the recording read: the
host ms a call of the captured run's spans (``copy_in``, ``launch``,
``copy_out``; ``launch`` holds ``fold_ms``, the recording's own reading of
the last replay's events), each stage's device ms a step, the graph's device ms from
its first mark to its last (median), the stages' share of it, and the
median wall time of a call up to the return of ``torch.cuda.synchronize()``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from chip_smoke import (
    BATCH,
    CONFIG2_BATCH,
    CONFIG2_VIEWS,
    SECTOR_BATCH,
    VIEWS,
    bench_config,
    card_line,
    exact_cfg,
)
from navdv_torch.agent import (
    init_state,
    make_navigate_batch,
    make_navigate_batch_fn,
    make_statics,
)
from navdv_torch.metrics import success_rate
from navdv_torch.training import train_library
from navdv_torch.trials import make_trials
from navdv_torch.utils.profiling import recording, top_ops, trace

TRACE_DIR = Path(__file__).resolve().parent / "build" / "traces"
SPLIT_RUNS = 25


def cell(fam_impl: str, config: int):
    """(cfg, landscape, route, batch) of ``config``'s cell for ``fam_impl``."""
    if config in (1, 4):
        cfg, land, route = bench_config(config, VIEWS)
        return (cfg if fam_impl == "fft" else exact_cfg(cfg)), land, route, BATCH
    if config == 3:
        cfg, land, route = bench_config(3, VIEWS)
        return (cfg if fam_impl == "fft" else exact_cfg(cfg)), land, route, SECTOR_BATCH
    return (*bench_config(2, CONFIG2_VIEWS), CONFIG2_BATCH)


def split_episode(cfg, fam_impl: str, st, states0) -> dict:
    """What ``profiling.recording()`` reads of SPLIT_RUNS synchronized
    captured episodes (see ``--split``)."""
    run = make_navigate_batch(cfg, fam_impl)
    aux = None if run.prepare is None else run.prepare(st)
    with recording():
        run(states0, st, aux)  # warm-up and the capture of the marked graph
    torch.cuda.synchronize()
    walls = []
    with recording() as rec:
        for _ in range(SPLIT_RUNS):
            t0 = time.perf_counter()
            run(states0, st, aux)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
    spans = rec.totals()
    return {
        "host_ms": {name: spans[name]["self_ms"] / SPLIT_RUNS
                    for name in ("copy_in", "launch", "copy_out")},
        "fold_ms": rec.fold_ms / SPLIT_RUNS,
        "stage_ms_per_step": {name: ms / marks for name, (ms, marks) in rec.stages.items()},
        "graph_ms": float(np.median(rec.graph_ms)),
        "stages_share_of_graph": sum(ms for ms, _ in rec.stages.values()) / sum(rec.graph_ms),
        "wall_ms": float(np.median(walls)), "runs": SPLIT_RUNS,
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--fam-impl", choices=("kernel", "fft", "roll", "conv", "infomax"),
                        default="kernel")
    parser.add_argument("--config", type=int, choices=(1, 2, 3, 4), default=None)
    mode = parser.add_mutually_exclusive_group()
    mode.add_argument("--eager", action="store_true",
                      help="profile the eager episode instead of the captured one")
    mode.add_argument("--split", action="store_true",
                      help="split captured episodes into host spans and device stages")
    args = parser.parse_args()
    config = args.config or {"roll": 2, "infomax": 1}.get(args.fam_impl, 4)
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    cfg, land, route, batch = cell(args.fam_impl, config)
    lib = train_library(land, route, cfg)
    st = make_statics(land, lib, route)
    starts, thetas = make_trials(route, cfg, batch, seed=0)
    states0 = init_state(starts, thetas)
    if args.split:
        print(json.dumps({
            "phase": "split", "card": card_line(), "fam_impl": args.fam_impl, "config": config,
            "library_views": int(lib.views.shape[0]), "batch": batch,
            "max_steps": cfg.agent.max_steps, **split_episode(cfg, args.fam_impl, st, states0),
        }), flush=True)
        return 0
    run = (make_navigate_batch_fn if args.eager else make_navigate_batch)(cfg, args.fam_impl)
    prepare = run.lib_prepare if args.eager else run.prepare
    aux = None if prepare is None else prepare(st)
    rate = float(success_rate(run(states0, st, aux)[0]))  # warm-up

    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        final, _ = run(states0, st, aux)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)

    torch.cuda.reset_peak_memory_stats()
    with trace(str(TRACE_DIR)) as prof:
        t0 = time.perf_counter()
        run(states0, st, aux)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0

    try:
        rows = top_ops(prof, n=None)
    except ValueError as e:
        print(f"chip_profile: {e}", file=sys.stderr)
        return 1
    busy_ms = sum(r["self_us"] for r in rows) / 1e3
    steps = cfg.agent.max_steps
    print(json.dumps({
        "phase": "profile", "card": card_line(), "fam_impl": args.fam_impl, "config": config,
        "episode": "eager" if args.eager else "captured",
        "library_views": int(lib.views.shape[0]), "batch": batch, "max_steps": steps,
        "success_rate": rate, "episode_s": walls, "episode_s_median": float(np.median(walls)),
        "agent_steps_per_s": batch * steps / float(np.median(walls)),
        "profiled_episode_s": prof_wall, "device_busy_ms": busy_ms,
        "device_ms_per_step": busy_ms / steps,
        "device_idle_share": 1.0 - busy_ms / (prof_wall * 1e3),
        "device_idle_share_unprofiled": 1.0 - busy_ms / (float(np.median(walls)) * 1e3),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "kernels": [{"name": r["op"][:80], "ms": r["self_us"] / 1e3, "count": r["count"],
                     "ms_per_step": r["self_us"] / 1e3 / steps} for r in rows[:15]],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
