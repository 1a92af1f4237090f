"""The traced slice of a run: ``torch.profiler`` events read in memory.

The harness wraps each call into the program in a ``record_function``
span of its own (:data:`SPAN`). After the slice, :func:`summarize` keeps the
device's operations (kernels, copies, sets), the harness's spans and the
host's operators, and :class:`Trace` gives the per-layer readers what they
need: device busy time, time and count by kernel-name pattern, the traced
window, and the steps it held. Nothing is written to disk.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import heapq
import re

import torch
from torch.profiler import ProfilerActivity, profile, record_function

SPAN = "bench.navigate"
_DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
# CUPTI instruments a CUDA graph's kernel nodes inside the launch call: with
# the profiler on, each episode's cudaGraphLaunch holds the host for
# milliseconds while the card waits (unprofiled it takes microseconds)
LAUNCH = "cudaGraphLaunch"
# the host operators in which CUPTI does the profiler's own work: the card
# may idle while the host sits in them, and unprofiled they do not run
PROFILER_OPS = ("Activity Buffer Request", "Buffer Flush")


@contextlib.contextmanager
def profiled():
    """A CPU and CUDA profile of the block; yields the profile."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof


def span():
    return record_function(SPAN)


@dataclasses.dataclass
class Trace:
    """Events of a traced slice, in microseconds on one clock."""

    device: list  # (name, kind, start, end) of device operations, by start
    spans: list  # (start, end) of the harness's spans
    host_ops: list  # (name, start, end) of host operators and runtime calls
    steps: int  # agent-steps' steps in the slice: episodes x max_steps
    context: dict  # the cell's configuration, traffic and work counts

    @property
    def window(self) -> tuple[float, float]:
        return self.spans[0][0], self.spans[-1][1]

    @property
    def window_s(self) -> float:
        a, b = self.window
        return (b - a) * 1e-6

    def busy_s(self) -> float:
        """Seconds in the window in which a device operation ran (the union
        of their intervals)."""
        a, b = self.window
        total, cur_a, cur_b = 0.0, None, None
        for _, _, s, e in self.device:
            s, e = max(s, a), min(e, b)
            if e <= s:
                continue
            if cur_b is None or s > cur_b:
                if cur_b is not None:
                    total += cur_b - cur_a
                cur_a, cur_b = s, e
            else:
                cur_b = max(cur_b, e)
        if cur_b is not None:
            total += cur_b - cur_a
        return total * 1e-6

    def _gaps(self) -> list:
        """(start, end) of the intervals in the window with no device
        operation."""
        a, b = self.window
        gaps, last = [], a
        for _, _, s, e in self.device:
            if s > last:
                gaps.append((last, min(s, b)))
            last = max(last, e)
        if b > last:
            gaps.append((last, b))
        return [g for g in gaps if g[1] > g[0]]

    def launch_stall_s(self) -> float:
        """Seconds in which the card idled while the host was inside
        ``cudaGraphLaunch``: the profiler's cost, not the program's. Each
        launch is matched by bisection to the gaps it overlaps, and the
        overlaps are summed gap by gap, each gap's in the launches' order."""
        launches = [(x, y) for name, x, y in self.host_ops if name == LAUNCH]
        gaps = self._gaps()
        starts, ends = [g[0] for g in gaps], [g[1] for g in gaps]
        terms = []
        for j, (x, y) in enumerate(launches):
            for i in range(bisect.bisect_right(ends, x), bisect.bisect_left(starts, y)):
                terms.append((i, j, min(ends[i], y) - max(starts[i], x)))
        return sum(max(0.0, t) for _, _, t in sorted(terms)) * 1e-6

    def span_launches(self) -> list:
        """For each harness span, the (start, end) of the ``cudaGraphLaunch``
        calls that begin inside it, by start."""
        launches = sorted((x, y) for name, x, y in self.host_ops if name == LAUNCH)
        xs = [x for x, _ in launches]
        return [launches[bisect.bisect_left(xs, a):bisect.bisect_right(xs, b)]
                for a, b in self.spans]

    def idle_share(self) -> float:
        """1 - busy / window, the profiler's launch stalls left out of the
        window."""
        return 1.0 - self.busy_s() / (self.window_s - self.launch_stall_s())

    def time_s(self, pattern: str, kinds=("kernel",)) -> float:
        """Summed duration of the device operations whose name matches."""
        rx = re.compile(pattern)
        return sum(e - s for n, k, s, e in self.device if k in kinds and rx.search(n)) * 1e-6

    def count(self, pattern: str = "", kinds=("kernel",)) -> int:
        rx = re.compile(pattern)
        return sum(1 for n, k, _, _ in self.device if k in kinds and rx.search(n))

    def top_ops(self, n: int = 10) -> list:
        """[[name, seconds]] of the device operations that took most time."""
        totals: dict = {}
        for name, _, s, e in self.device:
            totals[name] = totals.get(name, 0.0) + (e - s) * 1e-6
        rows = sorted(totals.items(), key=lambda kv: -kv[1])[:n]
        return [[_short(name), sec] for name, sec in rows]

    def idle_gaps(self, n: int = 10) -> list:
        """[[what the host was doing, seconds]] of the longest gaps between
        device operations in the window: the harness span open at the gap's
        middle, or "harness" outside every span, and the innermost host
        operator open there. The profiler's launch stalls are left out."""
        out, host = [], sorted((x, y, name) for name, x, y in self.host_ops)
        k, open_ = 0, []  # the host operators begun by mid, by end
        for s, e in self._gaps():
            mid = 0.5 * (s + e)
            while k < len(host) and host[k][0] <= mid:
                heapq.heappush(open_, (host[k][1], host[k][0], host[k][2]))
                k += 1
            while open_ and open_[0][0] < mid:
                heapq.heappop(open_)
            ops = [(y - x, name) for y, x, name in open_]
            if ops and min(ops)[1] == LAUNCH:
                continue
            inside = any(x <= mid <= y for x, y in self.spans)
            what = (SPAN if inside else "harness") + ("/" + min(ops)[1] if ops else "")
            out.append([what, (e - s) * 1e-6])
        return sorted(out, key=lambda g: -g[1])[:n]


def _short(name: str, limit: int = 160) -> str:
    return name if len(name) <= limit else name[:limit] + "..."


def _kind(ev) -> str:
    """The event's activity: ``activity_type()`` where the profiler gives
    it, else told from its device and name as Kineto names them."""
    if hasattr(ev, "activity_type"):
        return ev.activity_type()
    name = ev.name()
    annotation = name == SPAN or getattr(ev, "is_user_annotation", lambda: False)()
    if ev.device_type() == torch.autograd.DeviceType.CUDA:
        if annotation:
            return "gpu_user_annotation"
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "kernel"
    return "user_annotation" if annotation else "cpu_op"


def summarize(prof, steps: int, context: dict) -> Trace:
    device, spans, host_ops = [], [], []
    for ev in prof.profiler.kineto_results.events():
        kind = _kind(ev)
        start = ev.start_ns() * 1e-3
        end = start + ev.duration_ns() * 1e-3
        if kind in _DEVICE_KINDS:
            device.append((ev.name(), kind, start, end))
        elif kind == "user_annotation" and ev.name() == SPAN:
            spans.append((start, end))
        elif kind in ("cpu_op", "cuda_runtime", "cuda_driver"):
            host_ops.append((ev.name(), start, end))
    if not spans:
        raise RuntimeError("the traced slice holds no harness span")
    device.sort(key=lambda d: d[2])
    spans.sort()
    return Trace(device=device, spans=spans, host_ops=host_ops, steps=steps, context=context)
