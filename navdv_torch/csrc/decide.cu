// The step's decision, a warp per agent: tie-ordered argmin over the
// pooled familiarity, the turn and the move, the distance to the route,
// and the stop rules (ops/decide.py decide_plain, bit for bit).
//
// Replaces no TPU kernel: the JAX package leaves this tail of the step to
// XLA, which fuses it into the scan. In plain PyTorch (decide_plain) it is
// ~47 kernels a step, each touching at most B x Nh floats.
//
// Bound on the H100: neither bytes nor operations. At B = 1024, Nh = 60
// and 40 route segments it reads ~0.26 MB (0.08 us at 3.35 TB/s) and does
// ~1.3 M float operations; a launch costs more. What is left beside the
// launch is the latency of one agent's chain of dependent steps, so the
// design is one launch with a warp per agent:
//
// - The warp's lanes share the agent's candidates and segments (lane l
//   takes l, l + 32, ...): every load a lane makes is independent of its
//   others, so each of the two phases costs one round trip to memory and
//   five shuffles, where a thread alone walked 60 candidates and 40
//   segments one after another (~7 us beyond an empty launch, at B = 1
//   and B = 1024 alike).
// - Argmin: the lanes' winners are combined by one total order, NaN
//   first, then the smaller value, then the earlier place in tie order,
//   which is torch.argmin's rule over the row permuted by tie order, so
//   the order of combination does not matter. The minimum over segments
//   is exact in any order, and a NaN sticks, as in torch.min.
// - The lanes compute the turn and the move alike (every lane needs the
//   new position for its segments); lane 0 writes the agent's outputs.
// - Every product, sum, quotient and root is written with a _rn intrinsic:
//   PyTorch rounds each operation on its own, and nvcc would otherwise
//   contract a product and a sum into one FMA. cosf and sinf are the math
//   library's full-precision functions, as torch.cos and torch.sin call
//   them. The scalars come rounded to float32 from the wrapper.

#include <climits>
#include <cmath>

#include "common.cuh"

namespace {

constexpr int DECIDE_WARPS = 4;  // agents per block, one warp each
constexpr unsigned FULL = 0xffffffffu;

// torch.clamp(t, 0, 1): a NaN passes through
__device__ __forceinline__ float clamp01(float t) {
    return isnan(t) ? t : fminf(fmaxf(t, 0.0f), 1.0f);
}

// whether candidate (v, j) wins over (w, i): torch.argmin's order, j and i
// the places in tie order
__device__ __forceinline__ bool beats(float v, int j, float w, int i) {
    if (isnan(v)) return !isnan(w) || j < i;
    if (isnan(w)) return false;
    return v < w || (v == w && j < i);
}

// torch.min's pairwise rule: a NaN wins
__device__ __forceinline__ float nan_min(float a, float b) {
    return isnan(a) ? a : isnan(b) ? b : fminf(a, b);
}

__global__ void __launch_bounds__(DECIDE_WARPS * 32)
decide_kernel(const float* __restrict__ fam, const float* __restrict__ xy,
              const float* __restrict__ theta, const unsigned char* __restrict__ done,
              const int* __restrict__ status, const float* __restrict__ shifts,
              const int* __restrict__ order, const float* __restrict__ seg_a,
              const float* __restrict__ seg_ab, const float* __restrict__ seg_denom,
              const float* __restrict__ goal, int batch, int nh, int n_seg, float binw,
              float step, float goal_r2, float corridor, float lo, float x_hi, float y_hi,
              float* __restrict__ xy_out, float* __restrict__ theta_out,
              unsigned char* __restrict__ done_out, int* __restrict__ status_out,
              float* __restrict__ fam_out, int* __restrict__ k_out,
              float* __restrict__ dist_out) {
    const int b = blockIdx.x * DECIDE_WARPS + threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    if (b >= batch) return;  // a whole warp
    // the agent's own state, in flight while the argmin waits on its loads
    const float th0 = theta[b], x0 = xy[2 * b], y0 = xy[2 * b + 1];
    const float g0 = goal[0], g1 = goal[1];

    // argmin in tie order; a lane with no candidate loses to every one
    const float* row = fam + static_cast<size_t>(b) * nh;
    float best = INFINITY;
    int jb = INT_MAX, k = 0;
    for (int j = lane; j < nh; j += 32) {
        const int kj = __ldg(order + j);
        const float v = __ldg(row + kj);
        if (beats(v, j, best, jb)) best = v, jb = j, k = kj;
    }
#pragma unroll
    for (int d = 16; d > 0; d /= 2) {
        const float v = __shfl_xor_sync(FULL, best, d);
        const int j = __shfl_xor_sync(FULL, jb, d);
        const int kj = __shfl_xor_sync(FULL, k, d);
        if (beats(v, j, best, jb)) best = v, jb = j, k = kj;
    }

    const float th = __fadd_rn(th0, __fmul_rn(__ldg(shifts + k), binw));
    const float x = __fadd_rn(x0, __fmul_rn(step, cosf(th)));
    const float y = __fadd_rn(y0, __fmul_rn(step, sinf(th)));

    // squared distance to the nearest segment (no segment: +inf, refused
    // by the wrapper)
    float m = INFINITY;
    for (int s = lane; s < n_seg; s += 32) {
        const float ax = __ldg(seg_a + 2 * s), ay = __ldg(seg_a + 2 * s + 1);
        const float bx = __ldg(seg_ab + 2 * s), by = __ldg(seg_ab + 2 * s + 1);
        const float dot = __fadd_rn(__fmul_rn(__fsub_rn(x, ax), bx),
                                    __fmul_rn(__fsub_rn(y, ay), by));
        const float t = clamp01(__fdiv_rn(dot, __ldg(seg_denom + s)));
        const float dx = __fsub_rn(x, __fadd_rn(ax, __fmul_rn(t, bx)));
        const float dy = __fsub_rn(y, __fadd_rn(ay, __fmul_rn(t, by)));
        m = nan_min(m, __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
    }
#pragma unroll
    for (int d = 16; d > 0; d /= 2) m = nan_min(m, __shfl_xor_sync(FULL, m, d));
    if (lane != 0) return;

    const float dist = __fsqrt_rn(m);
    const float gx = __fsub_rn(x, g0);
    const float gy = __fsub_rn(y, g1);
    const bool reached = __fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)) <= goal_r2;
    const bool diverged = dist > corridor;
    const bool off = !((x >= lo) & (x <= x_hi) & (y >= lo) & (y <= y_hi));
    const int next = reached ? 1 : diverged ? 2 : off ? 3 : 0;  // reached > diverged > off

    const bool was_done = done[b] != 0;
    xy_out[2 * b] = was_done ? x0 : x;
    xy_out[2 * b + 1] = was_done ? y0 : y;
    theta_out[b] = was_done ? th0 : th;
    done_out[b] = was_done || next != 0;
    status_out[b] = was_done ? status[b] : next;
    fam_out[b] = best;
    k_out[b] = k;
    dist_out[b] = dist;
}

}  // namespace

NAVDV_EXPORT int navdv_decide(const float* fam, const float* xy, const float* theta,
                              const unsigned char* done, const int* status, const float* shifts,
                              const int* order, const float* seg_a, const float* seg_ab,
                              const float* seg_denom, const float* goal, int batch, int nh,
                              int n_seg, float binw, float step, float goal_r2, float corridor,
                              float lo, float x_hi, float y_hi, float* xy_out, float* theta_out,
                              unsigned char* done_out, int* status_out, float* fam_out,
                              int* k_out, float* dist_out, void* stream) {
    if (batch > 0) {
        decide_kernel<<<(batch + DECIDE_WARPS - 1) / DECIDE_WARPS, DECIDE_WARPS * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
            fam, xy, theta, done, status, shifts, order, seg_a, seg_ab, seg_denom, goal, batch,
            nh, n_seg, binw, step, goal_r2, corridor, lo, x_hi, y_hi, xy_out, theta_out,
            done_out, status_out, fam_out, k_out, dist_out);
    }
    return static_cast<int>(cudaGetLastError());
}
