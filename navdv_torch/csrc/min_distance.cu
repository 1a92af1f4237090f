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
// the block.
//
// Precision: inputs are fp32; products and sums are fp64. The SSD
// decomposition cancels: at BASELINE config 4 the view norms are ~300 while
// the distance gap between the two best headings is ~1e-5 (median over
// agents), below fp32 accumulation noise (~3e-4), so an fp32 sum decides
// most headings by rounding. An fp32 product is exact in fp64 and the fp64
// sum keeps the result within ~1e-10 of the exact value of the same
// decomposition, so the choice no longer depends on summation order.
//
// Bound on the H100: operations. At config 4 (rows = 1024 agents x 60 lags,
// P = 1152, Nl = 50) one call is 7.08 GFLOP, 0.106 ms at the 67 TFLOP/s of
// the fp64 tensor cores, against 0.085 ms to read the 283 MB of `a` once at
// 3.35 TB/s. The cross term runs on those tensor cores (min_tile.cuh); the
// stager below streams `a` with cp.async, a chunk ahead of the tensor
// cores, so the read hides under the compute. With Nl = 50 one
// 56-entry library tile covers the library: `a` is read once, and the norm
// comes from the same staged pixels. Each warp holds two 16-row groups, so
// every library fragment it loads serves two mma. What is left between
// this kernel and its bound is feeding the tensor cores from shared memory
// (fragment loads and widening) and the grid's last partial wave, not the
// row stream: a deeper ring does not change its time (PERF.md).
//
// Ragged edges: rows past the end stage zeros and are not written; pixels
// past P stage zeros; library entries past Nl are masked in min_tile.cuh.
// Rows copy 16 bytes at a time when P % 4 == 0 and `a` is 16-byte aligned,
// else 4 bytes at a time, in the same kernel.

#include <cstdint>

#include "common.cuh"
#include "min_tile.cuh"

namespace {

using navdv::LDA;
using navdv::THREADS;
using navdv::TILE_K;

constexpr int M_TILES = 2;
constexpr int TILE_R = navdv::tile_rows<M_TILES>;
using Smem = navdv::TileSmem<TILE_R>;

// Stages a[row0 + r, k0 : k0 + TILE_K] by cp.async, zero-filled at the edges.
struct GlobalRows {
    const float* a;
    int rows, p, row0;
    bool vec;

    __device__ __forceinline__ void operator()(float (*dst)[LDA], int k0) const {
        if (vec) {
            constexpr int PER_ROW = TILE_K / 4;
            for (int e = threadIdx.x; e < TILE_R * PER_ROW; e += THREADS) {
                const int r = e / PER_ROW;
                const int k = (e % PER_ROW) * 4;
                const int gr = row0 + r;
                const bool ok = gr < rows && k0 + k < p;  // P % 4 == 0: all 4 or none
                const float* src = ok ? a + static_cast<size_t>(gr) * p + k0 + k : a;
                navdv::cp_async<16>(&dst[r][k], src, ok ? 16 : 0);
            }
        } else {
            for (int e = threadIdx.x; e < TILE_R * TILE_K; e += THREADS) {
                const int r = e / TILE_K;
                const int k = e % TILE_K;
                const int gr = row0 + r;
                const bool ok = gr < rows && k0 + k < p;
                const float* src = ok ? a + static_cast<size_t>(gr) * p + k0 + k : a;
                navdv::cp_async<4>(&dst[r][k], src, ok ? 4 : 0);
            }
        }
    }
};

__global__ void __launch_bounds__(THREADS, 2)
min_distance_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    const float* __restrict__ gamma, float* __restrict__ out, int rows,
                    int nl, int p, double alpha, int with_rowsq, int vec) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int row0 = blockIdx.x * TILE_R;
    const GlobalRows stager{a, rows, p, row0, vec != 0};
    double mn[M_TILES][2];
    navdv::tile_min<M_TILES>(*reinterpret_cast<Smem*>(smem), stager, b, gamma, nl, p,
                                     alpha, with_rowsq != 0, mn);
    if (threadIdx.x % 4 == 0) {
#pragma unroll
        for (int m = 0; m < M_TILES; ++m) {
            const int gr = row0 + ((threadIdx.x / 32) * M_TILES + m) * 16 + (threadIdx.x % 32) / 4;
            if (gr < rows) out[gr] = static_cast<float>(mn[m][0]);
            if (gr + 8 < rows) out[gr + 8] = static_cast<float>(mn[m][1]);
        }
    }
}

}  // namespace

NAVDV_EXPORT int navdv_min_distance(const float* a, const float* b, const float* gamma,
                                    float* out, int rows, int nl, int p, double alpha,
                                    int with_rowsq, void* stream) {
    static bool opted_in = false;
    if (!opted_in) {  // the ring may pass the default 48 KB
        const cudaError_t err = cudaFuncSetAttribute(
            min_distance_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, sizeof(Smem));
        if (err != cudaSuccess) return static_cast<int>(err);
        opted_in = true;
    }
    if (rows > 0) {
        const int vec = p % 4 == 0 && reinterpret_cast<std::uintptr_t>(a) % 16 == 0;
        const int blocks = (rows + TILE_R - 1) / TILE_R;
        min_distance_kernel<<<blocks, THREADS, sizeof(Smem), static_cast<cudaStream_t>(stream)>>>(
            a, b, gamma, out, rows, nl, p, alpha, with_rowsq, vec);
    }
    return static_cast<int>(cudaGetLastError());
}
