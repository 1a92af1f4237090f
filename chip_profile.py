"""Where one config-4 episode of the port spends its time on the card.

    python3 chip_profile.py

Trains the config-4 library as ``chip_smoke.py`` does, warms the episode up,
times three plain episodes (host clock around work that ends in a
synchronize), then runs one more under ``torch.profiler`` and prints one
JSON line: the episode's wall time, the device time summed by kernel name,
and the device's idle share (1 - summed kernel time / profiled wall time;
one stream, so kernels never overlap). Exits non-zero without a card or when
the profiler records no device activity.
"""

from __future__ import annotations

import collections
import json
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from chip_smoke import BATCH, card_line, slice_config
from navdv_torch.agent import init_state, make_navigate_batch, make_statics
from navdv_torch.metrics import success_rate
from navdv_torch.training import train_library
from navdv_torch.trials import make_trials


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    cfg, land, route = slice_config()
    lib = train_library(land, route, cfg)
    st = make_statics(land, lib, route)
    starts, thetas = make_trials(route, cfg, BATCH, seed=0)
    states0 = init_state(starts, thetas)
    run = make_navigate_batch(cfg, fam_impl="kernel")
    rate = float(success_rate(run(states0, st)[0]))  # warm-up

    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        final, _ = run(states0, st)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(states0, st)
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
        "phase": "profile", "card": card_line(), "batch": BATCH, "max_steps": steps,
        "success_rate": rate, "episode_s": walls, "episode_s_median": float(np.median(walls)),
        "agent_steps_per_s": BATCH * steps / float(np.median(walls)),
        "profiled_episode_s": prof_wall, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / (prof_wall * 1e3),
        "kernels": [{"name": name[:80], "ms": ms, "count": n, "ms_per_step": ms / steps}
                    for name, (ms, n) in top[:15]],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
