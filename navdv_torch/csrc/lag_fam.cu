// Fused lag familiarity (SSD) straight from the raw fine panorama:
//
//   S[r, c]      = (pano[b, r, c] + pano[b, r, c+1] + ... + pano[b, r, c+u-1]) * (1/u)
//                  (columns mod A, added left to right in fp32)
//   row_l[r, w]  = S[r, (w*u + lags[l]) mod A]           (candidate view at lag l)
//   out[b, l]    = max( min_v ( |row_l|^2 + gamma_v - 2 <row_l, lib_v> ), 0 )
//
// Replaces navdv_tpu/ops/lag_pallas.py make_lag_fam_pallas (_lag_kernel and
// the pooling prep around it). The JAX version pools and residue-splits the
// panorama in XLA (T2), then builds every (q, j) row of the lag grid in VMEM
// by static slices: 120 rows per agent at config 4, of which the 60 scan
// lags are read. Here one block owns one agent and a TILE_R-lag tile of its
// scan lags: it pools the agent's panorama row into shared memory in the
// plain version's add order (so the candidate values equal the plain
// version's, and the main path's at hat_dtype="float32", bit for bit),
// and scores only the scan lags, reading row_l[r, w] from shared memory as
// it stages it. Neither the [B, L, P] candidates nor T2 reach device memory.
// The library minimum is min_tile.cuh, shared with min_distance.cu; a row
// loader that reads S[r, (w*u + lag) mod A] instead of a[row, k] is the
// whole difference between the two kernels.
//
// Precision: products and sums in fp64. The JAX kernel sums in fp32 at
// Precision.HIGHEST; at config 4 fp32 sums decide headings by rounding
// (ROADMAP C.1), so this kernel keeps the min-distance kernel's arithmetic.
//
// Ragged edges: lag tiles past L load zeros and are not written; library
// entries past Nl are masked in min_tile.cuh; any B.
//
// Bound on the H100: operations. At config 4 (B = 1024, L = 60, Nl = 50,
// P = 1152) one call is 2*1024*60*50*1152 = 7.08 GFLOP, ~0.106 ms at
// 67 TFLOP/s, against ~24 MB of traffic (pano 23.6 MB + library + out),
// ~7 us at 3.35 TB/s. Like min_distance.cu this first version runs on the
// fp64 FMA units, at half that rate.

#include "common.cuh"
#include "min_tile.cuh"

namespace {

using navdv::THREADS;
using navdv::TILE_R;

__global__ void __launch_bounds__(THREADS)
lag_fam_kernel(const float* __restrict__ pano, const float* __restrict__ lib,
               const float* __restrict__ gamma, const int* __restrict__ lags,
               float* __restrict__ out, int n_lags, int nl, int r, int w, int u, float inv_u) {
    extern __shared__ float pooled[];  // [R * A]: this agent's S, scaled by 1/u
    __shared__ int lag_s[TILE_R];      // the tile's lags mod A; -1 past L

    const int a = w * u;
    const int ra = r * a;
    const int agent = blockIdx.x;
    const int lag0 = blockIdx.y * TILE_R;
    const float* src = pano + static_cast<size_t>(agent) * ra;

    if (threadIdx.x < TILE_R) {
        const int li = lag0 + threadIdx.x;
        int lag = -1;
        if (li < n_lags) {
            lag = lags[li] % a;
            if (lag < 0) lag += a;
        }
        lag_s[threadIdx.x] = lag;
    }
    for (int e = threadIdx.x; e < ra; e += THREADS) {
        const int rr = e / a;
        const int c = e - rr * a;
        const float* row = src + rr * a;
        float s = row[c];
        for (int j = 1; j < u; ++j) {
            const int cj = c + j < a ? c + j : c + j - a;
            s = s + row[cj];
        }
        pooled[e] = s * inv_u;
    }
    __syncthreads();

    const auto load_row = [&](int lr, int k) -> float {
        const int lag = lag_s[lr];
        if (lag < 0) return 0.0f;
        const int rr = k / w;
        int c = (k - rr * w) * u + lag;
        if (c >= a) c -= a;
        return pooled[rr * a + c];
    };
    double mn[4];
    navdv::tile_min(load_row, lib, gamma, nl, r * w, -2.0, true, mn);
    if (threadIdx.x % 16 == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int li = lag0 + (threadIdx.x / 16) * 4 + i;
            if (li < n_lags)
                out[static_cast<size_t>(agent) * n_lags + li] =
                    static_cast<float>(fmax(mn[i], 0.0));
        }
    }
}

}  // namespace

NAVDV_EXPORT int navdv_lag_fam(const float* pano, const float* lib, const float* gamma,
                               const int* lags, float* out, int batch, int n_lags, int nl,
                               int r, int w, int u, float inv_u, void* stream) {
    // dynamic shared memory that fits the default 48 KB beside the kernel's
    // ~17.7 KB of static shared memory; a larger panorama row opts in first
    static size_t dyn_allowed = 28 * 1024;
    const size_t dyn = static_cast<size_t>(r) * w * u * sizeof(float);
    if (dyn > dyn_allowed) {
        const cudaError_t err = cudaFuncSetAttribute(
            lag_fam_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(dyn));
        if (err != cudaSuccess) return static_cast<int>(err);
        dyn_allowed = dyn;
    }
    if (batch > 0 && n_lags > 0) {
        const dim3 grid(batch, (n_lags + TILE_R - 1) / TILE_R);
        lag_fam_kernel<<<grid, THREADS, dyn, static_cast<cudaStream_t>(stream)>>>(
            pano, lib, gamma, lags, out, n_lags, nl, r, w, u, inv_u);
    }
    return static_cast<int>(cudaGetLastError());
}
