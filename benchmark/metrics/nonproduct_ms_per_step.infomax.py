"""Device busy time per step outside the Infomax scoring product (ms): the
traced busy time less the fp64 gemm kernels' time, over the slice's steps.
It is the step's bandwidth-bound part: the front end, the candidate gather
and copy, the fp64 casts, the z-score fold, |h| and its mean, and the
decision."""

GEMM = r"[Dd]gemm|gemm.*f64|f64.*gemm|[Dd]mma"


def read(trace):
    t = trace.time_s(GEMM)
    if not t:
        return None
    return (trace.busy_s() - t) * 1e3 / trace.steps
