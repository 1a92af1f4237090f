"""The host's turnaround at the early-exit loop's reads, per traced episode
(ms): the least the card waits on them. The run
(``agent.make_navigate_batch(..., early_exit=True)``) replays a graph of
``agent.EXIT_CHUNK`` steps and reads on the host after each whether every
agent is done (``bool(g.replay())``, which returns from
``cudaStreamSynchronize`` only once the card has finished the chunk); the
next chunk's ``cudaGraphLaunch`` comes after that. For each launch of an
episode but its first, the turnaround is the time from the end of the
last sync before it (after the previous launch) to the launch call, less
the time in it that the host spent in the profiler's own work
(``trace.PROFILER_OPS``); a launch with no sync since the previous one
waited for no read. The card is idle all that time, and for the sync's
wake-up and the launch beside it, which this leaves out. The reading is
the median turnaround times the reads an episode, so that a host thread
held up now and then does not set it.

Host times only: in traced slices on an H100 (PyTorch 2.11, CUDA 12.8)
the trace's device times drift against its host times by tens of
microseconds within a slice and jump by milliseconds, so that a host call
can read as returning before the device work it waited for had ended; a
wait taken across the two clocks carries that error. A whole-episode
graph launches once an episode and has nothing to read."""

import bisect
import statistics

from harness.trace import PROFILER_OPS

READS = ("cudaStreamSynchronize", "cudaMemcpyAsync")


def _covered(intervals, a, b):
    """Length of (a, b) covered by the union of the sorted ``intervals``."""
    total, reach = 0.0, a
    for x, y in intervals:
        x, y = max(x, reach), min(y, b)
        if y > x:
            total += y - x
            reach = y
    return total


def turnarounds(trace) -> list:
    """Each read's turnaround (us), in the order of the launches."""
    syncs = sorted(y for name, _, y in trace.host_ops if name in READS)
    profiler = sorted((x, y) for name, x, y in trace.host_ops if name in PROFILER_OPS)
    out = []
    for launches in trace.span_launches():
        for (before, _), (x, _) in zip(launches, launches[1:]):
            j = bisect.bisect_right(syncs, x) - 1
            read = j >= 0 and syncs[j] > before
            out.append(x - syncs[j] - _covered(profiler, syncs[j], x) if read else 0.0)
    return out


def read(trace):
    t = turnarounds(trace)
    return 1e-3 * statistics.median(t) * len(t) / len(trace.spans) if t else None
