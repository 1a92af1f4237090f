// Fused distance + running minimum over a library:
//
//   out[i] = min_v ( alpha * <a_i, b_v> + beta_i + gamma_v )
//
// beta_i = |a_i|^2 when with_rowsq (SSD), else 1 (NCC on z-scored rows).
//
// Replaces navdv_tpu/ops/familiarity_pallas.py min_distance_rows
// (_min_kernel). The [rows, Nl] distance matrix is never written: each block
// owns TILE_R rows, walks the whole library and keeps a running per-row
// minimum in registers (min_tile.cuh, shared with lag_fam.cu). On the TPU
// the library tiles are a sequential grid axis carrying the minimum in
// scratch memory; here blocks run in no order, so that loop lives inside
// the block.
//
// Two entries run one kernel, min_distance_kernel, through two stagers:
//
// - navdv_min_distance: GlobalRows copies materialised rows a[i, k]
//   (the NCC path's z-scored candidates, plain rows of any origin).
// - navdv_min_distance_pooled: PooledRows forms the SSD candidates of the
//   step from the pooled panorama S f32[B, R, A] itself. Row i = b * L + l,
//   pixel k = r * W + w is S[b, r, (w * u + lags[l]) mod A] * inv_u, the
//   value sensor.make_views_from_pooled writes (an fp32 product by the fp32
//   1/u), so the [B, L, P] candidate tensor never exists and the minima
//   equal those of the materialised route bit for bit.
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
// the fp64 tensor cores. The cross term runs on those tensor cores
// (min_tile.cuh); both stagers issue cp.async a chunk ahead of them, so
// their reads hide under the compute. GlobalRows streams the 283 MB of `a`
// (0.085 ms at 3.35 TB/s). PooledRows reads S, 23.6 MB from device memory
// once: a block's 128 rows span two or three agents, and the 60 lags of a
// pixel are 60 neighbouring floats of one S row, so its 4-byte gathers hit
// L1 and L2. With Nl = 50 one 56-entry library tile covers the library: a
// row is staged once, and the norm comes from the same staged pixels. Each
// warp holds two 16-row groups, so every library fragment it loads serves
// two mma. What is left between this kernel and its bound is feeding the
// tensor cores from shared memory (fragment loads and widening) and the
// grid's last partial wave, not the row stream (PERF.md).
//
// Ragged edges: rows past the end stage zeros and are not written; pixels
// past P stage zeros; library entries past Nl are masked in min_tile.cuh.
// GlobalRows copies 16 bytes at a time when P % 4 == 0 and `a` is 16-byte
// aligned, else 4 bytes at a time, in the same kernel. PooledRows takes any
// B, L, P, lags of any sign (taken mod A) and copies 4 bytes at a time.

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
    struct Args {
        const float* a;
        int vec;
    };
    const float* a;
    int rows, p, row0;
    bool vec;

    __device__ __forceinline__ GlobalRows(const Args& args, int rows_, int p_, int row0_)
        : a(args.a), rows(rows_), p(p_), row0(row0_), vec(args.vec != 0) {}

    __device__ __forceinline__ float value(float x) const { return x; }

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

// Stages row row0 + r, pixels k0 .. k0 + TILE_K - 1, of the candidates
// S[b, k / W, ((k % W) * u + lags[l]) mod A] (row = b * L + l) as S stores
// them; value() scales a staged pixel by inv_u as the tile reads it, since
// cp.async copies bytes. A warp's copy covers 4 neighbouring rows (lags)
// by 8 pixels, so its lanes read runs of neighbouring floats of S and
// write 32 distinct banks. A thread stages pixels k0 + q and k0 + q + 8
// (q = lane % 8) of ROWS_PER_THREAD rows of its own warp's 32, whose
// agent offset b * R * A (-1 past the last row) and lag mod A it decodes
// once into registers. k / W is taken from the fp32 reciprocal of W,
// exact while k + W <= 2^22 (the wrapper checks P + W). Every chunk of a
// block whose rows and pixels all exist (all but the last) takes the path
// without edge tests: the staging is most of the instructions this
// kernel issues besides the tile's, and those tests cost 0.05 ms of
// 0.29 at config 4 (PERF.md).
constexpr int ROWS_PER_THREAD = TILE_R * TILE_K / THREADS / 2;
static_assert(TILE_K == 16 && TILE_R == 32 * navdv::TILE_WARPS && ROWS_PER_THREAD == 8,
              "the lane layout below covers 32 rows a warp, 16 pixels a chunk");

struct PooledRows {
    struct Args {
        const float* s;
        const int* lags;
        int n_lags, w, u, a, ra;  // ra = R * A
        float inv_u;
    };
    const float* s;
    int p, w, u, a;
    float inv_u, inv_w;
    bool full_rows;  // every row of the block exists
    int base[ROWS_PER_THREAD];
    int lag[ROWS_PER_THREAD];

    __device__ __forceinline__ PooledRows(const Args& args, int rows, int p_, int row0)
        : s(args.s), p(p_), w(args.w), u(args.u), a(args.a), inv_u(args.inv_u),
          inv_w(1.0f / args.w), full_rows(row0 + TILE_R <= rows) {
        const int first = row0 + (threadIdx.x / 32) * 32 + (threadIdx.x % 32) / 8;
#pragma unroll
        for (int i = 0; i < ROWS_PER_THREAD; ++i) {
            const int gr = first + 4 * i;
            base[i] = -1;
            lag[i] = 0;
            if (gr < rows) {
                const int b = gr / args.n_lags;
                int l = args.lags[gr - b * args.n_lags] % a;
                if (l < 0) l += a;
                base[i] = b * args.ra;
                lag[i] = l;
            }
        }
    }

    __device__ __forceinline__ float value(float x) const { return __fmul_rn(x, inv_u); }

    template <bool FULL>
    __device__ __forceinline__ void stage(float (*dst)[LDA], int k0) const {
        const int q = threadIdx.x % 8;
        const int r0 = (threadIdx.x / 32) * 32 + (threadIdx.x % 32) / 8;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int k = k0 + q + 8 * h;
            const bool in = FULL || k < p;
            const int rr = in ? __float2int_rz((k + 0.5f) * inv_w) : 0;
            const float* sr = s + rr * a;      // S row rr of agent 0
            const int col = (k - rr * w) * u;  // column at lag 0
#pragma unroll
            for (int i = 0; i < ROWS_PER_THREAD; ++i) {
                const bool ok = FULL || (in && base[i] >= 0);
                int c = col + lag[i];
                if (c >= a) c -= a;
                navdv::cp_async<4>(&dst[r0 + 4 * i][q + 8 * h], ok ? sr + base[i] + c : s,
                                   ok ? 4 : 0);
            }
        }
    }

    __device__ __forceinline__ void operator()(float (*dst)[LDA], int k0) const {
        if (full_rows && k0 + TILE_K <= p) {
            stage<true>(dst, k0);
        } else {
            stage<false>(dst, k0);
        }
    }
};

template <class Rows>
__global__ void __launch_bounds__(THREADS, 2)
min_distance_kernel(const typename Rows::Args args, const float* __restrict__ b,
                    const float* __restrict__ gamma, float* __restrict__ out, int rows,
                    int nl, int p, double alpha, int with_rowsq) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int row0 = blockIdx.x * TILE_R;
    const Rows stager(args, rows, p, row0);
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

template <class Rows>
int launch(const typename Rows::Args& args, const float* b, const float* gamma, float* out,
           int rows, int nl, int p, double alpha, int with_rowsq, void* stream) {
    static bool opted_in = false;
    if (!opted_in) {  // the ring may pass the default 48 KB
        const cudaError_t err = cudaFuncSetAttribute(
            min_distance_kernel<Rows>, cudaFuncAttributeMaxDynamicSharedMemorySize, sizeof(Smem));
        if (err != cudaSuccess) return static_cast<int>(err);
        opted_in = true;
    }
    if (rows > 0) {
        const int blocks = (rows + TILE_R - 1) / TILE_R;
        min_distance_kernel<Rows><<<blocks, THREADS, sizeof(Smem),
                                    static_cast<cudaStream_t>(stream)>>>(
            args, b, gamma, out, rows, nl, p, alpha, with_rowsq);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

NAVDV_EXPORT int navdv_min_distance(const float* a, const float* b, const float* gamma,
                                    float* out, int rows, int nl, int p, double alpha,
                                    int with_rowsq, void* stream) {
    const int vec = p % 4 == 0 && reinterpret_cast<std::uintptr_t>(a) % 16 == 0;
    return launch<GlobalRows>({a, vec}, b, gamma, out, rows, nl, p, alpha, with_rowsq, stream);
}

// s: f32[batch, r, w * u] contiguous, lags: i32[n_lags]; out: f32[batch * n_lags].
NAVDV_EXPORT int navdv_min_distance_pooled(const float* s, const int* lags, const float* b,
                                           const float* gamma, float* out, int batch,
                                           int n_lags, int nl, int r, int w, int u,
                                           float inv_u, double alpha, int with_rowsq,
                                           void* stream) {
    const int a = w * u;
    const PooledRows::Args args{s, lags, n_lags, w, u, a, r * a, inv_u};
    return launch<PooledRows>(args, b, gamma, out, batch * n_lags, nl, r * w, alpha, with_rowsq,
                              stream);
}
