"""CUDA graphs captured per traced pass of a sweep: the program's counter
``capture.capture_counts()["captures"]``, read by the harness before and
after the traced passes (``Trace.context["captures"]``), over the passes.
``sweep.run_sweep`` keeps one ``capture.ProgramCache`` per call, of at most
``capture.MAX_PROGRAMS`` programs, so every pass captures each program it
runs again: a graph for each fft point's main run and recall run, one for
each kernel point's run, about 12 a pass of the default grid."""


def read(trace):
    passes = trace.context.get("passes")
    return trace.context["captures"] / passes if passes else None
