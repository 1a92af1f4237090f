// Fused distance + running minimum over a library:
//
//   out[i] = min_v ( alpha * <a_i, b_v> + beta_i + gamma_v )
//
// beta_i = |a_i|^2 when with_rowsq (SSD), else 1 (NCC on z-scored rows).
//
// Replaces navdv_tpu/ops/familiarity_pallas.py min_distance_rows
// (_min_kernel). The [rows, Nl] distance matrix is never written: each block
// owns TILE_R rows of `a`, walks the whole library and keeps a running
// per-row minimum in registers (min_tile.cuh, shared with lag_fam.cu). On
// the TPU the library tiles are a sequential grid axis carrying the minimum
// in scratch memory; here blocks run in no order, so that loop lives inside
// the block. `a` is read from device memory once per library tile and never
// for the norm alone.
//
// Precision: inputs are fp32; products and sums are fp64. The SSD
// decomposition cancels: at BASELINE config 4 the view norms are ~300 while
// the distance gap between the two best headings is ~1e-5 (median over
// agents), below fp32 accumulation noise (~3e-4), so an fp32 sum decides
// most headings by rounding. An fp32 product is exact in fp64 and the fp64
// sum keeps the result within ~1e-10 of the exact value of the same
// decomposition, so the choice no longer depends on summation order.
//
// Ragged edges: rows past the end read zeros and are not written; library
// entries past Nl are masked inside min_tile.cuh.
//
// Bound on the H100: operations. At config 4 (rows = 1024 agents x 60 lags,
// P = 1152, Nl = 50) one call is 7.08 GFLOP, ~106 us at 67 TFLOP/s (the fp64
// tensor-core rate, equal to the non-tensor fp32 rate), against ~85 us to
// read the 283 MB of `a`. This first version is a shared-memory tiled
// product on the fp64 FMA units (half that rate). With Nl = 50 one 64-entry
// library tile covers the library, so `a` is read once; 14 of its 64
// columns are masked work.

#include "common.cuh"
#include "min_tile.cuh"

namespace {

using navdv::THREADS;
using navdv::TILE_R;

__global__ void __launch_bounds__(THREADS)
min_distance_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    const float* __restrict__ gamma, float* __restrict__ out, int rows,
                    int nl, int p, double alpha, int with_rowsq) {
    const int row0 = blockIdx.x * TILE_R;
    const auto load_row = [&](int r, int k) -> float {
        const int gr = row0 + r;
        return gr < rows ? a[static_cast<size_t>(gr) * p + k] : 0.0f;
    };
    double mn[4];
    navdv::tile_min(load_row, b, gamma, nl, p, alpha, with_rowsq != 0, mn);
    if (threadIdx.x % 16 == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int gr = row0 + (threadIdx.x / 16) * 4 + i;
            if (gr < rows) out[gr] = static_cast<float>(mn[i]);
        }
    }
}

}  // namespace

NAVDV_EXPORT int navdv_min_distance(const float* a, const float* b, const float* gamma,
                                    float* out, int rows, int nl, int p, double alpha,
                                    int with_rowsq, void* stream) {
    if (rows > 0) {
        const int blocks = (rows + TILE_R - 1) / TILE_R;
        min_distance_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
            a, b, gamma, out, rows, nl, p, alpha, with_rowsq);
    }
    return static_cast<int>(cudaGetLastError());
}
