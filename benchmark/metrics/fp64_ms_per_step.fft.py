"""Device time per step of kernels on fp64 data (ms): the DFT products
(cuBLAS fp64 gemms), the spectral passes, reductions and copies whose
kernel names carry ``double`` or an fp64 gemm's marks."""

FP64 = r"double|[Dd]gemm|f64|[Dd]mma|gemm.*_d_|complex<double>"


def read(trace):
    t = trace.time_s(FP64)
    return t * 1e3 / trace.steps if t else None
