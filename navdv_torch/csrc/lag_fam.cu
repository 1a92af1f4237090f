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
// and scores only the scan lags. Neither the [B, L, P] candidates nor T2
// reach device memory. The library minimum is min_tile.cuh, shared with
// min_distance.cu; the stager below, which gathers S[r, (w*u + lag) mod A]
// from shared memory instead of copying a[row, k], is the whole difference
// between the two kernels, so both sum in one order.
//
// Precision: products and sums in fp64. The JAX kernel sums in fp32 at
// Precision.HIGHEST; at config 4 fp32 sums decide headings by rounding
// (ROADMAP C.1), so this kernel keeps the min-distance kernel's arithmetic.
//
// Bound on the H100: operations. At config 4 (B = 1024, L = 60, Nl = 50,
// P = 1152) the cross term is 2*1024*60*50*1152 = 7.08 GFLOP, 0.106 ms at
// the 67 TFLOP/s of the fp64 tensor cores, against ~24 MB of traffic (pano
// 23.6 MB + library + out), ~7 us at 3.35 TB/s. The cross term runs on those
// tensor cores (min_tile.cuh). The block first copies the agent's raw row
// into shared memory with cp.async and pools it there, so pooling reads no
// device memory twice. The stager's per-pixel k -> (k / W) * A and
// (k % W) * u is computed once per block into a table and each lane keeps
// its rows' lags in registers, so the staging loop has no division, only
// one wrap-around subtract. 60 of the 64 rows of a block are live.
//
// Ragged edges: lag tiles past L stage zeros and are not written; library
// entries past Nl are masked in min_tile.cuh; any B.
//
// Shared memory, all dynamic: the raw panorama row, then in its place the
// tile's ring; the pooled row (R*A floats); the k table (P words).
// ops/lag.py computes the same size from the constants of this file and
// min_tile.cuh and refuses a panorama whose row does not fit.

#include <cstdint>

#include "common.cuh"
#include "min_tile.cuh"

namespace {

using navdv::LDA;
using navdv::THREADS;
using navdv::TILE_K;

constexpr int LAG_M_TILES = 1;
constexpr int TILE_R = navdv::tile_rows<LAG_M_TILES>;
using Smem = navdv::TileSmem<TILE_R>;

// Dynamic shared memory: [front | pooled row (R*A floats) | k table (P
// words)]. The front holds the agent's raw panorama row while it is pooled,
// then the tile's ring.
__host__ __device__ constexpr size_t front_bytes(int ra) {
    const size_t raw = (static_cast<size_t>(ra) * sizeof(float) + 15) / 16 * 16;
    return raw > sizeof(Smem) ? raw : sizeof(Smem);
}

__host__ __device__ constexpr size_t smem_bytes(int r, int w, int u) {
    return front_bytes(r * w * u) + (static_cast<size_t>(r) * w * u + r * w) * sizeof(float);
}

// Gathers row_l[k] = S[k / W, ((k % W) * u + lag) mod A] for the tile's lags;
// koff[k] = ((k / W) * A) << 16 | (k % W) * u (both fit 16 bits: R * A
// floats fit in shared memory). A thread stages pixel k0 + threadIdx.x %
// TILE_K of rows threadIdx.x / TILE_K + i * ROW_STEP, whose lags (mod A, -1
// past L) it holds in registers.
constexpr int ROW_STEP = THREADS / TILE_K;
constexpr int ROWS_PER_THREAD = TILE_R / ROW_STEP;

struct PooledRows {
    const float* pooled;
    const unsigned* koff;
    int p, a;
    int lag[ROWS_PER_THREAD];

    __device__ __forceinline__ float value(float x) const { return x; }  // pooled and scaled

    __device__ __forceinline__ void operator()(float (*dst)[LDA], int k0) const {
        const int k = threadIdx.x % TILE_K;
        const int r0 = threadIdx.x / TILE_K;
        const bool in = k0 + k < p;
        const unsigned o = in ? koff[k0 + k] : 0u;
        const int base = static_cast<int>(o >> 16);
        const int col = static_cast<int>(o & 0xffffu);
#pragma unroll
        for (int i = 0; i < ROWS_PER_THREAD; ++i) {
            float v = 0.0f;
            if (in && lag[i] >= 0) {
                int c = col + lag[i];
                if (c >= a) c -= a;
                v = pooled[base + c];
            }
            dst[r0 + i * ROW_STEP][k] = v;
        }
    }
};

__global__ void __launch_bounds__(THREADS, 3)
lag_fam_kernel(const float* __restrict__ pano, const float* __restrict__ lib,
               const float* __restrict__ gamma, const int* __restrict__ lags,
               float* __restrict__ out, int n_lags, int nl, int r, int w, int u, float inv_u,
               int vec) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int a = w * u;
    const int ra = r * a;
    const int p = r * w;
    float* raw = reinterpret_cast<float*>(smem);  // [R * A], then the ring
    float* pooled = reinterpret_cast<float*>(smem + front_bytes(ra));  // [R * A]: this agent's S
    unsigned* koff = reinterpret_cast<unsigned*>(pooled + ra);          // [P]

    const int agent = blockIdx.x;
    const int lag0 = blockIdx.y * TILE_R;
    const float* src = pano + static_cast<size_t>(agent) * ra;

    PooledRows stager{pooled, koff, p, a, {}};
#pragma unroll
    for (int i = 0; i < ROWS_PER_THREAD; ++i) {
        const int li = lag0 + static_cast<int>(threadIdx.x) / TILE_K + i * ROW_STEP;
        int lag = -1;
        if (li < n_lags) {
            lag = lags[li] % a;
            if (lag < 0) lag += a;
        }
        stager.lag[i] = lag;
    }
    for (int k = threadIdx.x; k < p; k += THREADS) {
        const int rr = k / w;
        koff[k] = static_cast<unsigned>(rr * a) << 16 | static_cast<unsigned>((k - rr * w) * u);
    }
    if (vec) {
        for (int e = threadIdx.x * 4; e < ra; e += THREADS * 4) navdv::cp_async<16>(raw + e, src + e, 16);
    } else {
        for (int e = threadIdx.x; e < ra; e += THREADS) navdv::cp_async<4>(raw + e, src + e, 4);
    }
    navdv::cp_async_commit();
    navdv::cp_async_wait<0>();
    __syncthreads();
    for (int e = threadIdx.x; e < ra; e += THREADS) {
        const int rr = e / a;
        const int c = e - rr * a;
        const float* row = raw + rr * a;
        float s = row[c];
        for (int j = 1; j < u; ++j) {
            const int cj = c + j < a ? c + j : c + j - a;
            s = s + row[cj];
        }
        pooled[e] = s * inv_u;
    }
    __syncthreads();  // the ring may now overwrite the raw row

    double mn[LAG_M_TILES][2];
    navdv::tile_min<LAG_M_TILES>(*reinterpret_cast<Smem*>(smem), stager, lib, gamma,
                                             nl, p, -2.0, true, mn);
    if (threadIdx.x % 4 == 0) {
        float* o = out + static_cast<size_t>(agent) * n_lags;
#pragma unroll
        for (int m = 0; m < LAG_M_TILES; ++m) {
            const int li =
                lag0 + ((threadIdx.x / 32) * LAG_M_TILES + m) * 16 + (threadIdx.x % 32) / 4;
            if (li < n_lags) o[li] = static_cast<float>(fmax(mn[m][0], 0.0));
            if (li + 8 < n_lags) o[li + 8] = static_cast<float>(fmax(mn[m][1], 0.0));
        }
    }
}

}  // namespace

// Shared memory one block asks for at this sensor, for checking the
// wrapper's budget (ops/lag.py lag_smem_bytes).
NAVDV_EXPORT int navdv_lag_fam_smem_bytes(int r, int w, int u) {
    return static_cast<int>(smem_bytes(r, w, u));
}

NAVDV_EXPORT int navdv_lag_fam(const float* pano, const float* lib, const float* gamma,
                               const int* lags, float* out, int batch, int n_lags, int nl,
                               int r, int w, int u, float inv_u, void* stream) {
    // all shared memory is dynamic; it opts in above the default 48 KB once per size
    static size_t dyn_allowed = 0;
    const size_t dyn = smem_bytes(r, w, u);
    if (dyn > dyn_allowed) {
        const cudaError_t err = cudaFuncSetAttribute(
            lag_fam_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(dyn));
        if (err != cudaSuccess) return static_cast<int>(err);
        dyn_allowed = dyn;
    }
    if (batch > 0 && n_lags > 0) {
        const int ra = r * w * u;
        const int vec = ra % 4 == 0 && reinterpret_cast<std::uintptr_t>(pano) % 16 == 0;
        const dim3 grid(batch, (n_lags + TILE_R - 1) / TILE_R);
        lag_fam_kernel<<<grid, THREADS, dyn, static_cast<cudaStream_t>(stream)>>>(
            pano, lib, gamma, lags, out, n_lags, nl, r, w, u, inv_u, vec);
    }
    return static_cast<int>(cudaGetLastError());
}
