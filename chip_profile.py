"""Where one episode of the port spends its time on the card.

    python3 chip_profile.py [--fam-impl kernel|fft|roll] [--config 2|3|4]

The cells are those ``chip_smoke.py`` drives: config 4 (50 views, 1024
agents), config 2 (500 views, 512 agents) and config 3 (50 views, 256
agents, the fused sector front end on ``fft``), as shipped except that the
exact paths clear the knobs only ``fft`` reads (``chip_smoke.exact_cfg``).
``--config`` defaults to the cell each path ships for: 4 for ``kernel``
(the default) and ``fft``, 2 for ``roll``. Trains
the library, prepares its per-library constants once (as
``NavigationSimulator`` does), warms the episode up, times three plain
episodes (host clock around work that ends in a synchronize), then runs one
more under ``torch.profiler`` and prints one JSON line: the episode's wall
time, the device time summed by kernel name, and the device's idle share
(1 - summed kernel time / profiled wall time; one stream, so kernels never
overlap). Exits non-zero without a card or when the profiler records no
device activity.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from chip_smoke import (
    BATCH,
    CONFIG2_BATCH,
    CONFIG2_VIEWS,
    SECTOR_BATCH,
    VIEWS,
    bench_config,
    card_line,
    exact_cfg,
    slice_config,
)
from navdv_torch.agent import init_state, make_navigate_batch, make_statics
from navdv_torch.metrics import success_rate
from navdv_torch.training import train_library
from navdv_torch.trials import make_trials


def cell(fam_impl: str, config: int):
    """(cfg, landscape, route, batch) of ``config``'s cell for ``fam_impl``."""
    if config == 4:
        cfg, land, route = bench_config(4, VIEWS) if fam_impl == "fft" else slice_config()
        return cfg, land, route, BATCH
    if config == 3:
        cfg, land, route = bench_config(3, VIEWS)
        return (cfg if fam_impl == "fft" else exact_cfg(cfg)), land, route, SECTOR_BATCH
    return (*bench_config(2, CONFIG2_VIEWS), CONFIG2_BATCH)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--fam-impl", choices=("kernel", "fft", "roll"), default="kernel")
    parser.add_argument("--config", type=int, choices=(2, 3, 4), default=None)
    args = parser.parse_args()
    config = args.config or (2 if args.fam_impl == "roll" else 4)
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    cfg, land, route, batch = cell(args.fam_impl, config)
    lib = train_library(land, route, cfg)
    st = make_statics(land, lib, route)
    starts, thetas = make_trials(route, cfg, batch, seed=0)
    states0 = init_state(starts, thetas)
    run = make_navigate_batch(cfg, fam_impl=args.fam_impl)
    aux = None if run.prepare is None else run.prepare(st)
    rate = float(success_rate(run(states0, st, aux)[0]))  # warm-up

    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        final, _ = run(states0, st, aux)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)

    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(states0, st, aux)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0

    by_name = collections.defaultdict(lambda: [0.0, 0])
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            by_name[evt.name][0] += evt.time_range.elapsed_us() / 1e3  # us -> ms
            by_name[evt.name][1] += 1
    busy_ms = sum(v[0] for v in by_name.values())
    if busy_ms <= 0:
        print("chip_profile: the profiler recorded no device time", file=sys.stderr)
        return 1
    steps = cfg.agent.max_steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    print(json.dumps({
        "phase": "profile", "card": card_line(), "fam_impl": args.fam_impl, "config": config,
        "library_views": int(lib.views.shape[0]), "batch": batch, "max_steps": steps,
        "success_rate": rate, "episode_s": walls, "episode_s_median": float(np.median(walls)),
        "agent_steps_per_s": batch * steps / float(np.median(walls)),
        "profiled_episode_s": prof_wall, "device_busy_ms": busy_ms,
        "device_ms_per_step": busy_ms / steps,
        "device_idle_share": 1.0 - busy_ms / (prof_wall * 1e3),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "kernels": [{"name": name[:80], "ms": ms, "count": n, "ms_per_step": ms / steps}
                    for name, (ms, n) in top[:15]],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
