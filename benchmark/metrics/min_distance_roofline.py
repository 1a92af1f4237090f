"""``min_distance_kernel`` (``navdv_torch/csrc/min_distance.cu``) against the
fp64 tensor-core peak (%): 2 B P Nl L operations a step, every candidate's P
pixels against the Nl stored views at each of the L lags the scan needs
(:func:`harness.work.roll_product_flops`, the same count the rolled-library
product is held to), over 67 TFLOP/s, over the kernel's traced time. At
BASELINE config 4 (B 1024, P 1152, Nl 50, L 60) that is 7.08 GFLOP a step,
0.1056 ms at the peak."""

from harness import work

KERNEL = r"min_distance_kernel"


def read(trace):
    t = trace.time_s(KERNEL)
    if not t:
        return None
    ctx = trace.context
    flops = trace.steps * work.roll_product_flops(ctx["batch"], ctx["sensor"], ctx["scan"],
                                                  ctx["views_per_rank"])
    return 100.0 * flops / work.FP64_FLOP_PER_S / t
