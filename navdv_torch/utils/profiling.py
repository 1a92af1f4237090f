"""Tracing and profiling: the port's one tracing module (counterpart of the
JAX package's ``utils/profiling.py``).

Three kinds of record, placed where the work happens:

- :func:`span` brackets host work (``simulator.NavigationSimulator
  .navigate`` and its parts, ``capture.Captured``'s copy-in, launch and
  copy-out, the mesh's sharded episode, ``familiarity_infomax
  .train_infomax`` as ``infomax_train``). Off, it costs one check. Under
  ``torch.profiler`` it is a ``record_function("navdv.<name>")`` user
  annotation, on the device trace's clock. Inside :func:`recording` it is
  kept in memory: name, parent, start and end (``time.perf_counter_ns``).
- :func:`stage` marks a stage of the batched step on the device. When a
  recording is open while ``capture.Captured`` captures an episode, each
  mark records a pair of timing CUDA events on the capturing stream, which
  become event-record nodes of the graph; whether marks are on is part of
  the graph's key, so a graph captured with no recording open holds no
  event node. The recording folds a replay's events into device ms per
  stage before that graph's next replay and when it closes; it adds no
  synchronisation to a caller that has waited for the replay. Anywhere
  else (the CPU, the eager episode, a warm-up) a mark does nothing.
- Counters stay plain integers beside the code they count:
  ``ops.launch_counts()``, ``agent.lib_pmin.calls``
  (``parallel.collective_counts()``), ``capture.capture_counts()``,
  ``familiarity_infomax.infomax_counts()``.

Usage::

    from navdv_torch.utils import profiling

    with profiling.recording():
        sim.navigate(starts=starts, headings=headings)  # captures the marked graph
    with profiling.recording() as rec:
        for _ in range(n):
            sim.navigate(starts=starts, headings=headings)
    rec.totals()  # {span: {"calls", "ms", "self_ms"}}
    rec.stages    # {stage: [device ms, marks]}

    with profiling.trace("/tmp/navdv_trace") as prof:
        final, rec = run(states0, st)
        torch.cuda.synchronize()
    print(profiling.top_ops(prof, n=10, divisor=cfg.agent.max_steps))

``trace`` also writes a Chrome trace (``chrome://tracing`` or Perfetto)
into ``log_dir``.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

PREFIX = "navdv."  # a span's name under torch.profiler: PREFIX + name

_OFF = contextlib.nullcontext()
_clock = time.perf_counter_ns
_profiler_enabled = torch.autograd._profiler_enabled
_recording: Recording | None = None  # the open recording
_marks: list | None = None  # the stage marks of the graph being captured


@dataclasses.dataclass(slots=True)
class Span:
    """One span of a recording; ``parent`` is the index of the enclosing
    span in :attr:`Recording.spans`, -1 at a root."""

    name: str
    parent: int
    start_ns: int
    end_ns: int = 0


class Recording:
    """What :func:`recording` keeps: ``spans`` in the order they opened,
    ``stages`` (stage name -> [device ms, marks folded]; a stage is marked
    once a step, so ms / marks is its time a step), ``graph_ms`` (each
    folded replay's device time from its first mark to its last) and
    ``fold_ms`` (the host ms the recording spent reading events, inside the
    ``launch`` spans of the calls after the first)."""

    def __init__(self):
        self.spans: list[Span] = []
        self.stages: dict[str, list] = {}
        self.graph_ms: list[float] = []
        self.fold_ms = 0.0
        self._open: list[int] = []
        self._pending: dict[int, list] = {}  # marked graphs replayed, not yet folded

    def totals(self) -> dict[str, dict]:
        """{span name: {"calls", "ms", "self_ms"}}, summed over its spans; a
        span's self time is its duration less its children's."""
        ms = [(s.end_ns - s.start_ns) * 1e-6 for s in self.spans]
        own = list(ms)
        for s, d in zip(self.spans, ms):
            if s.parent >= 0:
                own[s.parent] -= d
        out: dict = {}
        for s, d, o in zip(self.spans, ms, own):
            t = out.setdefault(s.name, {"calls": 0, "ms": 0.0, "self_ms": 0.0})
            t["calls"] += 1
            t["ms"] += d
            t["self_ms"] += o
        return out

    def _begin(self, name: str) -> None:
        self.spans.append(Span(name, self._open[-1] if self._open else -1, _clock()))
        self._open.append(len(self.spans) - 1)

    def _end(self) -> None:
        self.spans[self._open.pop()].end_ns = _clock()

    def _replay(self, marks: list) -> None:
        """Before a marked graph replays: fold its last replay, whose events
        this replay records again."""
        if id(marks) in self._pending:
            t0 = _clock()
            self._fold(marks)
            self.fold_ms += (_clock() - t0) * 1e-6
        self._pending[id(marks)] = marks

    def _fold(self, marks: list) -> None:
        marks[-1][2].synchronize()  # at once when the caller has waited for the replay
        for name, start, end in marks:
            t = self.stages.setdefault(name, [0.0, 0])
            t[0] += start.elapsed_time(end)
            t[1] += 1
        self.graph_ms.append(marks[0][1].elapsed_time(marks[-1][2]))

    def _close(self) -> None:
        for marks in self._pending.values():
            self._fold(marks)
        self._pending.clear()


@contextlib.contextmanager
def recording():
    """Keep the spans opened, and the stage marks of the graphs replayed,
    inside the block; yields the :class:`Recording`. Recordings do not
    nest."""
    global _recording
    if _recording is not None:
        raise RuntimeError("a recording is already open")
    rec = _recording = Recording()
    try:
        yield rec
    finally:
        _recording = None
        rec._close()


def is_recording() -> bool:
    return _recording is not None


class _Span:
    __slots__ = ("name", "annotation", "rec")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.annotation = record_function(PREFIX + self.name) if _profiler_enabled() else None
        if self.annotation is not None:
            self.annotation.__enter__()
        self.rec = _recording
        if self.rec is not None:
            self.rec._begin(self.name)

    def __exit__(self, *exc):
        if self.rec is not None:
            self.rec._end()
        if self.annotation is not None:
            self.annotation.__exit__(*exc)


def span(name: str):
    """A context manager around host work named ``name``: nothing unless
    ``torch.profiler`` runs or a recording is open."""
    if _recording is None and not _profiler_enabled():
        return _OFF
    return _Span(name)


def _event() -> torch.cuda.Event:
    ev = torch.cuda.Event(enable_timing=True, external=True)
    ev.record()
    return ev


class _Stage:
    __slots__ = ("name", "marks", "start")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global _marks
        self.marks, _marks = _marks, None  # a stage opened inside this one is part of it
        self.start = _event()

    def __exit__(self, *exc):
        global _marks
        self.marks.append((self.name, self.start, _event()))
        _marks = self.marks


def stage(name: str):
    """A context manager around a stage of the step: a pair of timing events
    while a graph is captured with marks on (:func:`marking`), else nothing."""
    if _marks is None:
        return _OFF
    return _Stage(name)


@contextlib.contextmanager
def marking():
    """Collect the stage marks recorded inside the block (a capture): yields
    the list of (stage, start event, end event) it fills."""
    global _marks
    marks = _marks = []
    try:
        yield marks
    finally:
        _marks = None


def replaying(marks: list) -> None:
    """Tell the open recording, if any, that a graph holding ``marks`` is
    about to replay."""
    if _recording is not None:
        _recording._replay(marks)


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


def top_ops(prof, n: int | None = 10, divisor: float = 1.0, device: str = "cuda") -> list[dict]:
    """The ``n`` operations (all with ``n=None``) with the most self time on
    ``device``, summed by name, from a profile (:func:`trace`,
    ``torch.profiler.profile``): ``[{"self_us", "op", "count"}]``,
    descending by ``self_us``.

    On ``"cuda"`` an operation is a kernel, memory copy or memory set, and
    its self time its device time; on ``"cpu"`` an operator and its own host
    time, without the operators it calls. ``divisor`` scales the times
    (steps per episode gives per-step numbers). Raises ValueError when the
    profile holds no time on ``device``.
    """
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', not {device!r}")
    kind = torch.autograd.DeviceType.CUDA if device == "cuda" else torch.autograd.DeviceType.CPU
    totals = collections.defaultdict(lambda: [0.0, 0])
    for evt in prof.events():
        if evt.device_type != kind:
            continue
        us = evt.time_range.elapsed_us() if device == "cuda" else evt.self_cpu_time_total
        totals[evt.name][0] += us
        totals[evt.name][1] += 1
    if not totals or sum(us for us, _ in totals.values()) <= 0:
        raise ValueError(f"the profile holds no {device} time")
    rows = sorted(totals.items(), key=lambda kv: -kv[1][0])
    if n is not None:
        rows = rows[:n]
    return [{"self_us": us / divisor, "op": name, "count": count} for name, (us, count) in rows]
