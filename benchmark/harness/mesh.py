"""A cell across cards: one rank process per card, started by the harness.

The launcher gives each rank torchrun's contract (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT`` on a
free localhost port) and the process's start time, waits for every rank,
and stops them all as soon as one fails. Rank 0's standard output is the
run's: it prints the result line. The others log to files under ``TMPDIR``,
whose tails are shown when a rank fails.

Each rank drives ``navdv_torch.parallel.make_navigate_sharded(cfg,
make_mesh(n_data, n_lib), fam_impl)`` on ``shard_statics``, with the
configuration's ``fam_impl_arg`` ("auto" where it states none): every rank
trains the whole library from the same world, keeps its shard, prepares it
once, and calls the run with the same global trials; the step's
``all_reduce(MIN)`` joins the shards. After each episode the success rate
is read on the host, and rank 0 tells the others over a gloo group whether
another episode follows. The runs built on the NCCL group are released
before ``destroy_process_group``: while a CUDA graph holding one of the
group's collectives is alive, the teardown hangs.
"""

from __future__ import annotations

import hashlib
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from harness import check, drive, world
from harness.cells import Cell

BUDGET_S = 340.0  # a run's whole life, within the 360 s a run may take


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(argv: list[str], world_size: int, t_process: float, budget_s: float = BUDGET_S,
           cwd=None, env=None) -> int:
    """Run ``argv`` as ``world_size`` ranks; returns 0 when every rank
    exits 0, else 1 (after stopping the others and printing the failed
    rank's log to standard error)."""
    base = dict(os.environ if env is None else env, MASTER_ADDR="localhost",
                MASTER_PORT=str(_free_port()), WORLD_SIZE=str(world_size),
                LOCAL_WORLD_SIZE=str(world_size), BENCH_PROCESS_START=repr(t_process))
    logdir = Path(tempfile.mkdtemp(prefix="navbench_ranks_"))
    procs, files = [], []
    try:
        for r in range(world_size):
            env_r = dict(base, RANK=str(r), LOCAL_RANK=str(r))
            if r == 0:
                procs.append(subprocess.Popen(argv, env=env_r, cwd=cwd))
            else:
                files.append(open(logdir / f"rank{r}.log", "w"))
                procs.append(subprocess.Popen(argv, env=env_r, cwd=cwd, stdout=files[-1],
                                              stderr=subprocess.STDOUT))
        deadline = time.monotonic() + budget_s
        while True:
            codes = [p.poll() for p in procs]
            if all(c == 0 for c in codes):
                return 0
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if failed or time.monotonic() > deadline:
                r = failed[0] if failed else None
                why = (f"rank {r} of {world_size} exited {codes[r]}" if failed
                       else f"the ranks exceeded their {budget_s:.0f} s")
                print(f"navbench: {why}", file=sys.stderr)
                for q in range(1, world_size):
                    log = logdir / f"rank{q}.log"
                    if log.exists():
                        print(f"--- rank {q}:\n{log.read_text()[-3000:]}", file=sys.stderr)
                return 1
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in files:
            f.close()
        for log in logdir.glob("*.log"):
            log.unlink()
        logdir.rmdir()


def _digest(ep: check.Episode) -> str:
    h = hashlib.sha256()
    for t in (*ep.final, *ep.rec):
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def run_rank(cell: Cell, seed: int, seconds: float, traced_run: bool, device_type: str,
             guard, control: bool = False) -> dict | None:
    """This rank's part of a mesh cell's run; rank 0 returns the result's
    fields, the other ranks None."""
    from navdv_torch.agent import init_state, make_statics
    from navdv_torch.metrics import success_rate
    from navdv_torch.parallel import (collective_counts, init_distributed, make_mesh,
                                      make_navigate_sharded, shard_statics)
    from navdv_torch.training import train_library

    if drive.early_exit(cell):
        raise ValueError("a cell across cards runs the whole episode: make_navigate_sharded "
                         "has no early exit")
    t_process = float(os.environ["BENCH_PROCESS_START"])
    rank, size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    n_data, n_lib = cell.config["mesh"]
    kwargs = dict(init_method=f"tcp://localhost:{os.environ['MASTER_PORT']}", rank=rank,
                  world_size=size)
    dev = init_distributed(device="cpu" if device_type == "cpu" else None, **kwargs)
    mesh = make_mesh(n_data, n_lib, device=dev)
    flags = dist.new_group(backend="gloo")

    land, route, spacing, pts, headings = drive.make_world(cell, seed, dev)
    cfg = drive.sim_config(cell.config, spacing)
    lib = train_library(land, route, cfg, device=dev)
    st = shard_statics(make_statics(land.clone(), lib, route, dev), mesh)
    nav = make_navigate_sharded(cfg, mesh, drive.fam_impl_arg(cell.config, cfg))
    aux = None if nav.prepare is None else nav.prepare(st)

    def call(starts, thetas):
        final, rec = nav(init_state(starts, thetas, dev), st, aux)
        return float(success_rate(final)), tuple(final), tuple(rec)

    trials = world.Trials(seed, 0, pts, headings, cell.traffic)
    warm = world.Trials(seed, 1, pts, headings, cell.traffic)
    for _ in range(drive.WARMUP_EPISODES):
        call(*warm.draw())
    reservoir = drive.Reservoir(seed, int(cell.traffic["check"]["episodes"]))
    flag = torch.zeros(1, dtype=torch.int32)

    def more(go: bool) -> bool:
        flag[0] = int(go)
        dist.broadcast(flag, src=0, group=flags)
        return bool(flag[0])

    views_per_rank = st.lib.views.shape[0]
    calls0 = collective_counts()["lib_pmin"]
    dist.barrier(group=flags)
    result: dict = {}
    t_window = time.time()
    if traced_run:
        episodes = drive.episodes_for_trace(cell)
        tr, failed = drive.traced(call, trials, episodes, reservoir, drive.steps_of(cell),
                                  drive.trace_context(cell, views_per_rank))
        mine = {"busy_s": tr.busy_s(), "window_s": tr.window_s}
        if rank == 0:
            result["metrics"] = drive.per_layer(cell, tr)
            result["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
            result["window"] = drive.trace_summary(tr)
    else:
        times, wall, failed = drive.measure(call, trials, seconds, reservoir, more)
        episodes = len(times)
        mine = {}
        if rank == 0:
            result["metrics"] = drive.end_to_end(cell, times, wall, t_window - t_process)
            result["window"] = drive.window_summary(times, wall)
    mine["memory_peak_bytes"] = drive.memory_peak(dev)
    mine["min_calls"] = collective_counts()["lib_pmin"] - calls0
    mine["digests"] = [_digest(ep) for ep in reservoir.items]
    guard()
    everyone = [None] * size
    dist.all_gather_object(everyone, mine, group=flags)
    library = lib.views.detach().clone()
    nav.release()
    del nav, st, aux
    drive.free(dev)
    dist.barrier(group=flags)
    dist.destroy_process_group()
    if rank != 0:
        return None

    device = {"memory_peak_bytes": max(e["memory_peak_bytes"] for e in everyone)}
    if traced_run:
        device["busy_s"] = float(np.mean([e["busy_s"] for e in everyone]))
        device["window_s"] = mine["window_s"]
    result["device"] = device
    numbers = check.judge(cell.config, land, route, spacing, library, reservoir.items, seed,
                          int(cell.traffic["check"]["poses"]), control)
    steps = (episodes + traced_run) * drive.steps_of(cell)  # a traced run calls once more
    numbers["min_calls_off"] = sum(abs(e["min_calls"] - steps) for e in everyone)
    numbers["rank_mismatch"] = sum(e["digests"] != mine["digests"] for e in everyone)
    ok, checks = check.verdict(numbers, cell.config["limits"])
    result.update(correct=ok, attempted=episodes, failed=failed, checks=checks,
                  numbers=numbers)
    return result
