// The running library minimum shared by min_distance.cu and lag_fam.cu:
// one block of THREADS threads scores tile_rows<M_TILES> rows against the
// whole library,
//
//   mn[row] = min_v ( alpha * <row, b_v> + beta_row + gamma_v )
//
// with beta_row = |row|^2 when with_rowsq (SSD), else 1. The two kernels
// differ only in where a row's pixels come from, so the rows arrive through
// a stager: stage_rows(dst, k0) fills dst[r][0, TILE_K) with pixels
// k0 .. k0 + TILE_K - 1 of the block's row r as fp32, zeros past p and past
// the last row. It may issue cp.async copies (the tile commits and waits on
// them) or store directly.
//
// Bound on the H100: operations. At config 4 (rows = 1024 x 60, P = 1152,
// Nl = 50) the cross term is 7.08 GFLOP, 0.106 ms at the 67 TFLOP/s of the
// fp64 tensor cores, against 0.085 ms to read the 283 MB of rows once at
// 3.35 TB/s. The design aims at the tensor cores and hides the row stream:
//
// - The cross term runs on the fp64 tensor cores (DMMA), through warp-level
//   mma.sync m16n8k8 f64 (wgmma has no fp64 type). Each warp owns M_TILES
//   groups of 16 rows against a library tile of TILE_V = 56 entries, 7
//   n-tiles of 8, so Nl = 50 masks 6 entries. Its M_TILES x 7 x 4 fp64
//   accumulators stay in registers, and each library fragment serves all
//   M_TILES row groups.
// - Rows pass through a ring of STAGES chunks of TILE_K pixels, library
//   entries through two. The next chunks load while DMMA runs on this one:
//   rows by the stager, issued STAGES - 1 chunks ahead; the library one
//   chunk ahead in registers, widened to fp64 once as it enters shared
//   memory. Row fragments stay fp32 in shared memory and are widened in
//   registers.
// - A lane's two k-slots of an mma are two neighbouring pixels, so its row
//   fragment is two float2 loads and its library fragment one double2 load
//   (the order of k inside an mma is free as long as rows and library
//   agree). Both strides are padded by PAD words, so these loads are free
//   of bank conflicts.
// - beta = |row|^2 is summed in fp64 from the staged row fragments during
//   the first library tile and reduced over the 4 lanes that share a row,
//   so rows are never read for the norm alone.
// - Library entries past nl get gamma = +PAD_PENALTY and never win, so nl
//   needs no padding. A library of more than TILE_V entries loops over
//   library tiles and stages the rows again for each.
//
// Precision: products and sums in fp64. DMMA is IEEE fp64 and an fp32
// product is exact in fp64; only the summation order differs from a plain
// fp64 matrix product. The SSD decomposition cancels (view norms ~300, gaps
// between the best headings ~1e-5 at BASELINE config 4), so fp32 sums would
// let rounding pick the heading (ROADMAP C.1). Both kernels run this one
// routine, so they sum in one order and agree bit for bit on equal rows.
//
// ops/lag.py reads the integer constants below by name to size the lag
// kernel's shared-memory budget; keep them plain literals.
#pragma once

#include <cuda_runtime.h>

namespace navdv {

constexpr int TILE_WARPS = 4;
constexpr int TILE_V = 56;
constexpr int TILE_K = 16;
constexpr int PAD = 8;
constexpr int STAGES = 2;
constexpr int MMA_K = 8;
constexpr int THREADS = TILE_WARPS * 32;
constexpr int N_TILES = TILE_V / 8;
constexpr int LDA = TILE_K + PAD;  // floats per staged row
constexpr int LDB = TILE_K + PAD;  // doubles per staged library entry
constexpr double PAD_PENALTY = 1e30;
static_assert(TILE_K % MMA_K == 0 && MMA_K == 8, "fragments below are m16n8k8");
static_assert((TILE_V * TILE_K) % THREADS == 0, "library chunk must split evenly");

// The tile's shared memory, placed by the kernel (dynamic shared memory):
// a ring of STAGES row chunks and two library chunks.
template <int ROWS>
struct __align__(16) TileSmem {
    float a[STAGES][ROWS][LDA];
    double b[2][TILE_V][LDB];
};

// cp.async of BYTES (4 or 16) from global to shared memory; src_bytes < BYTES
// zero-fills the rest (0: nothing is read).
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int src_bytes) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    if constexpr (BYTES == 16) {
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                     ::"r"(s), "l"(src), "r"(src_bytes));
    } else {
        asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                     ::"r"(s), "l"(src), "n"(BYTES), "r"(src_bytes));
    }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// D = A * B + D on the fp64 tensor cores. Fragments of lane (g, t) =
// (lane / 4, lane % 4): a = {A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4]},
// b = {B[t][g], B[t+4][g]}, d = {D[g][2t], D[g][2t+1], D[g+8][2t], D[g+8][2t+1]}.
// tile_min maps k-slot t to pixel 2t and k-slot t + 4 to pixel 2t + 1.
__device__ __forceinline__ void dmma_16x8x8(double (&d)[4], const double (&a)[4],
                                            const double (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// Rows of a block tile: each warp owns M_TILES groups of 16.
template <int M_TILES>
constexpr int tile_rows = TILE_WARPS * 16 * M_TILES;

// On return lanes with lane % 4 == 0 hold, for each m < M_TILES, the minima
// of the block's rows (warp * M_TILES + m) * 16 + lane / 4 (mn[m][0]) and
// that + 8 (mn[m][1]).
template <int M_TILES, class Stager>
__device__ __forceinline__ void tile_min(TileSmem<tile_rows<M_TILES>>& sm,
                                         const Stager& stage_rows, const float* __restrict__ b,
                                         const float* __restrict__ gamma, int nl, int p,
                                         double alpha, bool with_rowsq,
                                         double (&mn)[M_TILES][2]) {
    constexpr int B_PER_THREAD = TILE_V * TILE_K / THREADS;

    const int tid = threadIdx.x;
    const int lane = tid % 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const int r0 = (tid / 32) * M_TILES * 16 + g;  // row of mn[0][0]
    const int n_chunks = (p + TILE_K - 1) / TILE_K;

    double rsq[M_TILES][2], beta[M_TILES][2];
#pragma unroll
    for (int m = 0; m < M_TILES; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            rsq[m][h] = 0.0;
            beta[m][h] = 1.0;
            mn[m][h] = INFINITY;
        }

    for (int v0 = 0; v0 < nl; v0 += TILE_V) {
        const bool first = v0 == 0;
        float breg[B_PER_THREAD];
        const auto load_b = [&](int k0) {
#pragma unroll
            for (int i = 0; i < B_PER_THREAD; ++i) {
                const int e = tid + i * THREADS;
                const int v = v0 + e / TILE_K;
                const int k = k0 + e % TILE_K;
                breg[i] = (v < nl && k < p) ? __ldg(b + static_cast<size_t>(v) * p + k) : 0.0f;
            }
        };
        const auto store_b = [&](int s) {
#pragma unroll
            for (int i = 0; i < B_PER_THREAD; ++i) {
                const int e = tid + i * THREADS;
                sm.b[s][e / TILE_K][e % TILE_K] = static_cast<double>(breg[i]);
            }
        };

#pragma unroll
        for (int c = 0; c < STAGES - 1; ++c) {
            if (c < n_chunks) stage_rows(sm.a[c], c * TILE_K);
            cp_async_commit();
        }
        load_b(0);
        store_b(0);
        if (n_chunks > 1) load_b(TILE_K);

        double acc[M_TILES][N_TILES][4];
#pragma unroll
        for (int m = 0; m < M_TILES; ++m)
#pragma unroll
            for (int j = 0; j < N_TILES; ++j)
#pragma unroll
                for (int i = 0; i < 4; ++i) acc[m][j][i] = 0.0;

        for (int c = 0; c < n_chunks; ++c) {
            const int s = c % STAGES;
            cp_async_wait<STAGES - 2>();
            __syncthreads();  // chunk c is staged; chunk c - 1's buffers are free
            if (c + 1 < n_chunks) {
                store_b((c + 1) % 2);
                if (c + 2 < n_chunks) load_b((c + 2) * TILE_K);
            }
            const int cn = c + STAGES - 1;
            if (cn < n_chunks) stage_rows(sm.a[cn % STAGES], cn * TILE_K);
            cp_async_commit();

#pragma unroll 1
            for (int kk = 0; kk < TILE_K; kk += MMA_K) {
                double af[M_TILES][4];
#pragma unroll
                for (int m = 0; m < M_TILES; ++m) {
                    const float* ar = &sm.a[s][r0 + m * 16][kk + 2 * t];
                    const float2 x = *reinterpret_cast<const float2*>(ar);
                    const float2 y = *reinterpret_cast<const float2*>(ar + 8 * LDA);
                    af[m][0] = x.x;
                    af[m][1] = y.x;
                    af[m][2] = x.y;
                    af[m][3] = y.y;
                    if (first && with_rowsq) {
                        rsq[m][0] = fma(af[m][0], af[m][0], rsq[m][0]);
                        rsq[m][1] = fma(af[m][1], af[m][1], rsq[m][1]);
                        rsq[m][0] = fma(af[m][2], af[m][2], rsq[m][0]);
                        rsq[m][1] = fma(af[m][3], af[m][3], rsq[m][1]);
                    }
                }
#pragma unroll
                for (int j = 0; j < N_TILES; ++j) {
                    const double2 bb =
                        *reinterpret_cast<const double2*>(&sm.b[c % 2][j * 8 + g][kk + 2 * t]);
                    const double bf[2] = {bb.x, bb.y};
#pragma unroll
                    for (int m = 0; m < M_TILES; ++m) dmma_16x8x8(acc[m][j], af[m], bf);
                }
            }
        }

#pragma unroll
        for (int m = 0; m < M_TILES; ++m)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                if (first && with_rowsq) {  // every pixel has passed: beta is complete
                    rsq[m][h] += __shfl_xor_sync(0xffffffffu, rsq[m][h], 1);
                    rsq[m][h] += __shfl_xor_sync(0xffffffffu, rsq[m][h], 2);
                    beta[m][h] = rsq[m][h];
                }
#pragma unroll
                for (int j = 0; j < N_TILES; ++j)
#pragma unroll
                    for (int i = 0; i < 2; ++i) {
                        const int v = v0 + j * 8 + 2 * t + i;
                        const double gv =
                            v < nl ? static_cast<double>(__ldg(gamma + v)) : PAD_PENALTY;
                        mn[m][h] = fmin(mn[m][h], alpha * acc[m][j][2 * h + i] + beta[m][h] + gv);
                    }
            }
        __syncthreads();  // the next library tile restages every buffer
    }

#pragma unroll
    for (int m = 0; m < M_TILES; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int off = 1; off < 4; off <<= 1)
                mn[m][h] = fmin(mn[m][h], __shfl_xor_sync(0xffffffffu, mn[m][h], off));
}

}  // namespace navdv
