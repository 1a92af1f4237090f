"""The rolled-library product of ``familiarity_roll`` against the fp64
tensor-core peak (%): 2 B P Nl L operations a step (Nl the views this rank
holds) over 67 TFLOP/s, over the traced time of the fp64 gemm kernels."""

from harness import work

GEMM = r"[Dd]gemm|gemm.*f64|f64.*gemm|[Dd]mma"


def read(trace):
    t = trace.time_s(GEMM)
    if not t:
        return None
    ctx = trace.context
    flops = trace.steps * work.roll_product_flops(ctx["batch"], ctx["sensor"], ctx["scan"],
                                                  ctx["views_per_rank"])
    return 100.0 * flops / work.FP64_FLOP_PER_S / t
