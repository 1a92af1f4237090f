"""Tracing and profiling helpers (counterpart of the JAX package's
``utils/profiling.py``).

Usage::

    from navdv_torch.utils.profiling import top_ops, trace

    with trace("/tmp/navdv_trace") as prof:
        final, rec = run(states0, st)
        torch.cuda.synchronize()
    print(top_ops(prof, n=10, divisor=cfg.agent.max_steps))

``trace`` writes a Chrome trace (``chrome://tracing`` or Perfetto) into
``log_dir``; :func:`top_ops` reads either the profile or that directory.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import json
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile

# the trace's event categories that are device work
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def trace(log_dir: str):
    """A ``torch.profiler`` profile of the CPU and, where there is a card,
    the CUDA activity inside the block; yields the profile and writes its
    Chrome trace into ``log_dir`` when the block ends. Synchronize inside
    the block: work still queued on the card when it ends is not traced."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    name = f"trace_{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}.json"
    prof.export_chrome_trace(os.path.join(log_dir, name))


def _totals_from_profile(prof, device: str) -> dict:
    kind = torch.autograd.DeviceType.CUDA if device == "cuda" else torch.autograd.DeviceType.CPU
    totals = collections.defaultdict(lambda: [0.0, 0])
    for evt in prof.events():
        if evt.device_type != kind:
            continue
        us = evt.time_range.elapsed_us() if device == "cuda" else evt.self_cpu_time_total
        totals[evt.name][0] += us
        totals[evt.name][1] += 1
    return totals


def _totals_from_trace(log_dir: str, device: str) -> dict:
    paths = sorted(glob.glob(os.path.join(log_dir, "*.json")), key=os.path.getmtime)
    if not paths:
        raise FileNotFoundError(f"no Chrome trace (*.json) under {log_dir}")
    with open(paths[-1]) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    totals = collections.defaultdict(lambda: [0.0, 0])
    if device == "cuda":
        for e in events:
            if e.get("cat") in _DEVICE_CATS:
                totals[e["name"]][0] += e["dur"]
                totals[e["name"]][1] += 1
        return totals
    # CPU operators nest on their thread: an operator's self time is its
    # duration less that of the operators directly inside it
    ops = sorted((e for e in events if e.get("cat") == "cpu_op"),
                 key=lambda e: (e["pid"], e["tid"], e["ts"], -e["dur"]))
    self_us = [float(e["dur"]) for e in ops]
    stack = []  # (thread, end, index) of the enclosing operators
    for i, e in enumerate(ops):
        thread = (e["pid"], e["tid"])
        while stack and (stack[-1][0] != thread or stack[-1][1] <= e["ts"]):
            stack.pop()
        if stack:
            self_us[stack[-1][2]] -= e["dur"]
        stack.append((thread, e["ts"] + e["dur"], i))
    for e, us in zip(ops, self_us):
        totals[e["name"]][0] += us
        totals[e["name"]][1] += 1
    return totals


def top_ops(prof_or_dir, n: int | None = 10, divisor: float = 1.0,
            device: str = "cuda") -> list[dict]:
    """The ``n`` operations (all with ``n=None``) with the most self time on
    ``device``, summed by name, from a profile (:func:`trace`,
    ``torch.profiler.profile``) or the newest Chrome trace in a directory:
    ``[{"self_us", "op", "count"}]``, descending by ``self_us``.

    On ``"cuda"`` an operation is a kernel, memory copy or memory set, and
    its self time its device time; on ``"cpu"`` an operator and its own host
    time, without the operators it calls. ``divisor`` scales the times
    (steps per episode gives per-step numbers). Raises ValueError when the
    profile holds no time on ``device``.
    """
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', not {device!r}")
    if isinstance(prof_or_dir, (str, os.PathLike)):
        totals = _totals_from_trace(os.fspath(prof_or_dir), device)
    else:
        totals = _totals_from_profile(prof_or_dir, device)
    if not totals or sum(us for us, _ in totals.values()) <= 0:
        raise ValueError(f"the profile holds no {device} time")
    rows = sorted(totals.items(), key=lambda kv: -kv[1][0])
    if n is not None:
        rows = rows[:n]
    return [{"self_us": us / divisor, "op": name, "count": count} for name, (us, count) in rows]
