// Fused distance + running minimum over a library:
//
//   out[i] = min_v ( alpha * <a_i, b_v> + beta_i + gamma_v )
//
// beta_i = |a_i|^2 when with_rowsq (SSD), else 1 (NCC on z-scored rows).
//
// Replaces navdv_tpu/ops/familiarity_pallas.py min_distance_rows
// (_min_kernel). The [rows, Nl] distance matrix is never written: each block
// owns TILE_R rows, walks the whole library in TILE_V-entry tiles, and keeps
// a running per-row minimum in registers. On the TPU the library tiles are a
// sequential grid axis carrying the minimum in scratch memory; here blocks
// run in no order, so that loop lives inside the block. beta = |a|^2 is
// summed from the same shared-memory tiles of `a` during the first library
// tile, as _min_kernel does on its first library pass, so `a` is read from
// device memory once per library tile and never for the norm alone.
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
// entries past Nl are masked with gamma = +PAD_PENALTY so they never win,
// so Nl needs no padding to a tile multiple.
//
// Bound on the H100: operations. At config 4 (rows = 1024 agents x 60 lags,
// P = 1152, Nl = 50) one call is 7.08 GFLOP, ~106 us at 67 TFLOP/s (the fp64
// tensor-core rate, equal to the non-tensor fp32 rate), against ~85 us to
// read the 283 MB of `a`. This first version is a shared-memory tiled
// product on the fp64 FMA units (half that rate): 256 threads, each a 4 x 4
// register tile of (rows x library entries), TILE_K pixels staged per step
// and widened to fp64 once as they enter shared memory. With Nl = 50 one
// 64-entry library tile covers the library, so `a` is read once; 14 of its
// 64 columns are masked work.

#include "common.cuh"

namespace {

constexpr int TILE_R = 64;
constexpr int TILE_V = 64;
constexpr int TILE_K = 16;
constexpr int THREADS = 256;
constexpr double PAD_PENALTY = 1e30;

__global__ void __launch_bounds__(THREADS)
min_distance_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    const float* __restrict__ gamma, float* __restrict__ out, int rows,
                    int nl, int p, double alpha, int with_rowsq) {
    __shared__ __align__(16) double as[TILE_K][TILE_R + 2];
    __shared__ __align__(16) double bs[TILE_K][TILE_V + 2];
    __shared__ double beta_s[TILE_R];

    const int tid = threadIdx.x;
    const int tx = tid % 16;  // library sub-tile: entries tx*4 .. tx*4+3
    const int ty = tid / 16;  // row sub-tile: rows ty*4 .. ty*4+3
    const int row0 = blockIdx.x * TILE_R;

    double rsq = 0.0;  // threads tid < TILE_R: |a|^2 of row row0 + tid
    double mn[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) mn[i] = INFINITY;

    for (int v0 = 0; v0 < nl; v0 += TILE_V) {
        double acc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = 0.0;

        for (int k0 = 0; k0 < p; k0 += TILE_K) {
#pragma unroll
            for (int i = 0; i < (TILE_R * TILE_K) / THREADS; ++i) {
                const int e = tid + i * THREADS;
                const int r = e / TILE_K;
                const int k = e % TILE_K;
                const int gk = k0 + k;
                const int gr = row0 + r;
                const int gv = v0 + r;
                as[k][r] = (gr < rows && gk < p) ? a[static_cast<size_t>(gr) * p + gk] : 0.0f;
                bs[k][r] = (gv < nl && gk < p) ? b[static_cast<size_t>(gv) * p + gk] : 0.0f;
            }
            __syncthreads();
            if (with_rowsq && v0 == 0 && tid < TILE_R) {
#pragma unroll
                for (int k = 0; k < TILE_K; ++k) rsq = fma(as[k][tid], as[k][tid], rsq);
            }
#pragma unroll
            for (int k = 0; k < TILE_K; ++k) {
                const double2 a01 = *reinterpret_cast<const double2*>(&as[k][ty * 4]);
                const double2 a23 = *reinterpret_cast<const double2*>(&as[k][ty * 4 + 2]);
                const double2 b01 = *reinterpret_cast<const double2*>(&bs[k][tx * 4]);
                const double2 b23 = *reinterpret_cast<const double2*>(&bs[k][tx * 4 + 2]);
                const double ar[4] = {a01.x, a01.y, a23.x, a23.y};
                const double br[4] = {b01.x, b01.y, b23.x, b23.y};
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j) acc[i][j] = fma(ar[i], br[j], acc[i][j]);
            }
            __syncthreads();
        }

        if (v0 == 0) {  // the whole of `a` has passed: beta is complete
            if (tid < TILE_R) beta_s[tid] = with_rowsq ? rsq : 1.0;
            __syncthreads();
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int gv = v0 + tx * 4 + j;
            const double g = gv < nl ? static_cast<double>(gamma[gv]) : PAD_PENALTY;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const double d = alpha * acc[i][j] + beta_s[ty * 4 + i] + g;
                mn[i] = fmin(mn[i], d);
            }
        }
    }

    // the 16 threads sharing a row sub-tile are 16 consecutive lanes of one warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
            mn[i] = fmin(mn[i], __shfl_xor_sync(0xffffffffu, mn[i], off));
    }
    if (tx == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int gr = row0 + ty * 4 + i;
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
