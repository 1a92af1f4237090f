"""The Infomax scoring product of ``familiarity_infomax`` against the fp64
tensor-core peak (%): 2 B L P M operations a step, every candidate's P
pixels against the network's M units at each of the L lags the scan needs
(M = ``infomax_units``, or P where it is 0; the rolled-library product's
count, :func:`harness.work.roll_product_flops`, with M in place of the
views), over 67 TFLOP/s, over the traced time of the fp64 gemm kernels. In
a step of ``fam_impl="infomax"`` that product is the only fp64 gemm. At B
1024, L 60, P = M = 1152 it is 163 GFLOP a step, 2.43 ms at the peak."""

from harness import work

GEMM = r"[Dd]gemm|gemm.*f64|f64.*gemm|[Dd]mma"


def read(trace):
    t = trace.time_s(GEMM)
    if not t:
        return None
    ctx = trace.context
    sensor, scan = ctx["sensor"], ctx["scan"]
    units = scan["infomax_units"] or sensor["n_radial"] * sensor["n_azimuth"]
    flops = trace.steps * work.roll_product_flops(ctx["batch"], sensor, scan, units)
    return 100.0 * flops / work.FP64_FLOP_PER_S / t
