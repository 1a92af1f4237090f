// The running library minimum shared by min_distance.cu and lag_fam.cu:
// one block of THREADS threads scores TILE_R rows against the whole library,
//
//   mn[row] = min_v ( alpha * <row, b_v> + beta_row + gamma_v )
//
// with beta_row = |row|^2 when with_rowsq (SSD), else 1. The two kernels
// differ only in where a row's pixels come from, so the rows arrive through
// a loader: load_row(r, k) is pixel k (< p) of the block's row r (< TILE_R)
// as fp32, 0 for rows past the end.
//
// Design: 256 threads, each a 4 x 4 register tile of (rows x library
// entries); the library is walked in TILE_V-entry tiles, TILE_K pixels of
// rows and entries staged per step in shared memory and widened to fp64 once
// as they enter it. beta = |row|^2 is summed from the same staged pixels
// during the first library tile, so rows are never read for the norm alone.
// Library entries past nl get gamma = +PAD_PENALTY and never win, so nl
// needs no padding to a tile multiple. The 16 threads sharing a row
// sub-tile are 16 consecutive lanes of one warp and reduce with shuffles.
//
// Precision: products and sums in fp64. An fp32 product is exact in fp64,
// and the SSD decomposition cancels (view norms ~300, gaps between the best
// headings ~1e-5 at BASELINE config 4), so fp32 sums would let rounding pick
// the heading (ROADMAP C.1).
#pragma once

#include <cuda_runtime.h>

namespace navdv {

constexpr int TILE_R = 64;
constexpr int TILE_V = 64;
constexpr int TILE_K = 16;
constexpr int THREADS = 256;
constexpr double PAD_PENALTY = 1e30;

// On return every thread holds the minima of rows (threadIdx.x / 16) * 4 + i,
// i < 4, in mn[i]; the thread with threadIdx.x % 16 == 0 writes them.
template <class RowLoader>
__device__ __forceinline__ void tile_min(const RowLoader& load_row, const float* __restrict__ b,
                                         const float* __restrict__ gamma, int nl, int p,
                                         double alpha, bool with_rowsq, double (&mn)[4]) {
    __shared__ __align__(16) double as[TILE_K][TILE_R + 2];
    __shared__ __align__(16) double bs[TILE_K][TILE_V + 2];
    __shared__ double beta_s[TILE_R];

    const int tid = threadIdx.x;
    const int tx = tid % 16;  // library sub-tile: entries tx*4 .. tx*4+3
    const int ty = tid / 16;  // row sub-tile: rows ty*4 .. ty*4+3

    double rsq = 0.0;  // threads tid < TILE_R: |row|^2 of row tid
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
                const int gv = v0 + r;
                as[k][r] = gk < p ? load_row(r, gk) : 0.0f;
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

        if (v0 == 0) {  // every pixel of the rows has passed: beta is complete
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

#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
            mn[i] = fmin(mn[i], __shfl_xor_sync(0xffffffffu, mn[i], off));
    }
}

}  // namespace navdv
