"""Share of the traced window in which no operation ran on the card: 1 -
device busy time (the union of kernel, copy and set intervals) / the window
from the first traced call to the end of the last (rank 0 on a mesh). The
card's idle time while the host sat in ``cudaGraphLaunch`` is left out of
the window: with the profiler on, CUPTI instruments each graph's kernels
there for milliseconds, which an unprofiled run never pays."""


def read(trace):
    return trace.idle_share()
