"""Host ms per traced pass of a sweep before any graph replays: for each
grid point, the time from the harness's span round ``sweep.run_cell`` to
the first ``cudaGraphLaunch`` that begins inside it, summed over the
points and divided by the passes. It covers what ``run_cell`` does before
its first replay: training the library, the statics, the trials,
``prepare``, and the eager warm-up and capture of its first graph. A
point with no launch (no graph: the CPU) adds nothing; a slice with none
reads nothing."""


def read(trace):
    passes = trace.context.get("passes")
    waits = [launches[0][0] - a
             for (a, _), launches in zip(trace.spans, trace.span_launches()) if launches]
    return 1e-3 * sum(waits) / passes if waits and passes else None
