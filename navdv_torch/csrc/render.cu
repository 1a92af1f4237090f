// Batched polar-panorama render from per-agent windows.
//
// Replaces navdv_tpu/ops/render_pallas.py make_render_batch_pallas
// (_render_kernel), and with it the hat-weight contraction of
// navdv_tpu/sensor.py make_render_batch:
//
//   out[b, r, a] = sum_pq hat(ys - p) * hat(xs - q) * win[b, p, q]
//   xs = clip(fx + c*dx0[r, a] - s*dy0[r, a], 0, wsz - 1)
//   ys = clip(fy + s*dx0[r, a] + c*dy0[r, a], 0, wsz - 1)
//
// with (fx, fy, c, s) = fxy[b]. hat(t) = max(0, 1 - |t|) is nonzero on at
// most two taps per axis, so the contraction is a 4-tap bilinear blend: the
// TPU builds dense hat matrices because it gathers poorly; this card gathers
// from shared memory cheaply, so no hat matrix exists. The two taps' weights
// are computed in the hat form max(0, 1 - |xs - q|), and every operation
// rounds separately (no FMA contraction), so the kernel repeats the plain
// PyTorch version's arithmetic operation for operation and equals it bit
// for bit.
//
// hat_bf16 = 1 reproduces the JAX bfloat16 renderer's rounding class
// (sensor.py, hat_dtype="bfloat16"): window values and each axis' weights
// are rounded to bf16 before the products; accumulation stays f32.
// hat_bf16 = 0 keeps everything f32 (training capture).
//
// Bound on the H100. Bytes: at config 4 (1024 agents, 16 x 360 samples,
// 24 x 24 windows) the function moves 26.0 MB, the 23.6 MB panorama write
// above all, 7.77 us at 3.35 TB/s. Instruction throughput comes close: 5.9 M
// samples at the card's ~33.5 T thread-instructions/s cost 0.18 us per
// instruction a sample. The first port spent 50-60 of them, six on the
// quarter-rate conversion pipe (floor to int, int to float), and fetched
// each window from L2 once per 256 samples. So the design cuts what a
// sample pays beyond its own arithmetic, to about 42 instructions in f32
// mode and 48 in bf16 mode (counted in the SASS of one agent's samples):
//
// - A block owns RENDER_AGENTS agents and one chunk of their samples. It
//   stages the agents' windows into shared memory once, in 16-byte loads
//   that all leave before the first is stored, rounding each value to bf16
//   as it is staged in hat_bf16 mode (the same rounding of the same value
//   the plain version applies to each gathered tap, so the bits do not
//   change). A window crosses L2 -> SM once per chunk, and no sample rounds
//   a window value.
// - A warp owns 32 * RENDER_SAMPLES consecutive samples, a lane every 32nd
//   of them: its dx0, dy0 stay in registers while it loops over the tile's
//   agents, and the agent's pose is one broadcast shared load. Lanes on
//   consecutive samples read neighbouring taps of the arc, so the four tap
//   loads seldom meet a bank conflict; with 4 consecutive samples a lane
//   (float4 stores) a warp's taps spread over a 128-bin arc and conflict
//   far more often, and padding the row stride does not undo that. Stores
//   stay 128 contiguous bytes a warp.
// - No conversion instruction: floor(min(xs, wsz - 1.5)) is min(floor(xs),
//   wsz - 2) on [0, wsz - 1], and xs + 2^23 rounded down holds it in its
//   low mantissa bits, read as the tap's byte offset; the taps' weights
//   follow from d = xs - x0, which is exact (see sample()). The bf16 weights
//   are rounded in pairs, one conversion per axis.
// - Grid: agent tiles x sample chunks, a chunk being at most
//   RENDER_MAX_THREADS threads, split evenly. At config 4: 128 x 2 blocks
//   of 384 threads, 40 registers a thread.
//
// Ragged shapes take the same kernel: any R*A (the last warp's lanes past
// it idle); a misaligned window tensor is staged in 4-byte loads, and a
// window tile whose size is not a multiple of 4 floats ends in a 4-byte
// tail; the last agent tile may be short.
//
// Shared memory, all dynamic: RENDER_AGENTS poses (float4), then the
// agents' windows (wsz * wsz floats each). ops/render.py computes the same
// size and the grid from the constants below and refuses a launch that
// does not fit; keep them plain literals.

#include <cstdint>
#include <cstring>

#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int RENDER_AGENTS = 8;        // agents per block
constexpr int RENDER_SAMPLES = 8;       // samples per thread, 32 apart
constexpr int RENDER_MAX_THREADS = 512; // threads per block at most
constexpr int STAGE_UNROLL = 4;         // float4 loads in flight per thread while staging

static_assert(RENDER_AGENTS % 4 == 0, "a full window tile must start 16-byte aligned");

__host__ __device__ constexpr size_t smem_bytes(int wsz) {
    return RENDER_AGENTS * (sizeof(float4) + static_cast<size_t>(wsz) * wsz * sizeof(float));
}

// Rounds a and b to bf16 (round to nearest even) in one conversion; the
// bf16 bits are the high half of the f32.
__device__ __forceinline__ void round_bf16_pair(float& a, float& b) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    unsigned u;
    memcpy(&u, &h, sizeof(u));
    a = __uint_as_float(u << 16);
    b = __uint_as_float(u & 0xffff0000u);
}

constexpr float MAGIC = 8388608.0f;  // 2^23: x + 2^23 rounded down keeps floor(x) in its low bits
constexpr unsigned MAGIC_BITS = 0x4B000000u;

// One sample of the window whose rows 0 and 1 start at w0 and w1 = w0 +
// wsz (shared memory), pose p = (fx, fy, c, s): the plain version's
// operations, value for value. With x0 = min(floor(xs), wsz - 2), xs lies in
// [x0, x0 + 1], so d = xs - x0 is exact (Sterbenz, or d = xs for x0 = 0) and
// hat(xs, x0) = 1 - d needs no max with 0. And |xs - (x0 + 1)| is the
// rounding of 1 - d, which is hat(xs, x0) itself, so hat(xs, x0 + 1) =
// 1 - hat(xs, x0), bit for bit. The tap's byte offset 4 * (y0 * wsz + x0)
// comes straight from the bits of 2^23 + y0 and 2^23 + x0, mod 2^32:
// unbias = 4 * MAGIC_BITS * (wsz + 1).
template <bool BF16>
__device__ __forceinline__ float sample(const float* w0, const float* w1, float4 p, float dx,
                                        float dy, unsigned row_bytes, unsigned unbias,
                                        float hi, float hi_floor) {
    float xs = __fsub_rn(__fadd_rn(p.x, __fmul_rn(p.z, dx)), __fmul_rn(p.w, dy));
    float ys = __fadd_rn(__fadd_rn(p.y, __fmul_rn(p.w, dx)), __fmul_rn(p.z, dy));
    xs = fminf(fmaxf(xs, 0.0f), hi);
    ys = fminf(fmaxf(ys, 0.0f), hi);
    const float tx = __fadd_rd(fminf(xs, hi_floor), MAGIC);  // 2^23 + x0
    const float ty = __fadd_rd(fminf(ys, hi_floor), MAGIC);
    float wx0 = __fsub_rn(1.0f, __fsub_rn(xs, __fsub_rn(tx, MAGIC)));
    float wy0 = __fsub_rn(1.0f, __fsub_rn(ys, __fsub_rn(ty, MAGIC)));
    float wx1 = __fsub_rn(1.0f, wx0);
    float wy1 = __fsub_rn(1.0f, wy0);
    if (BF16) {  // the window values were rounded as they were staged
        round_bf16_pair(wx0, wx1);
        round_bf16_pair(wy0, wy1);
    }
    const unsigned off = __float_as_uint(ty) * row_bytes + (__float_as_uint(tx) << 2) - unbias;
    const float* t0 = reinterpret_cast<const float*>(reinterpret_cast<const char*>(w0) + off);
    const float* t1 = reinterpret_cast<const float*>(reinterpret_cast<const char*>(w1) + off);
    const float t0v = __fadd_rn(__fmul_rn(wx0, t0[0]), __fmul_rn(wx1, t0[1]));
    const float t1v = __fadd_rn(__fmul_rn(wx0, t1[0]), __fmul_rn(wx1, t1[1]));
    return __fadd_rn(__fmul_rn(wy0, t0v), __fmul_rn(wy1, t1v));
}

template <bool BF16>
__device__ __forceinline__ float4 stage_value(float4 v) {
    if (BF16) {
        round_bf16_pair(v.x, v.y);
        round_bf16_pair(v.z, v.w);
    }
    return v;
}

// vec_win: win is 16-byte aligned (then so is every full tile:
// RENDER_AGENTS % 4 == 0).
template <bool BF16>
__global__ void __launch_bounds__(RENDER_MAX_THREADS)
render_kernel(const float* __restrict__ win, const float* __restrict__ fxy,
              const float* __restrict__ dx0, const float* __restrict__ dy0,
              float* __restrict__ out, int batch, int ra_count, int wsz, int vec_win) {
    extern __shared__ __align__(16) float smem[];
    float4* pose = reinterpret_cast<float4*>(smem);
    float* tiles = smem + 4 * RENDER_AGENTS;
    const int b0 = blockIdx.x * RENDER_AGENTS;
    const int na = min(RENDER_AGENTS, batch - b0);
    const int w2 = wsz * wsz;
    const int n = na * w2;
    const float* src = win + static_cast<size_t>(b0) * w2;
    const int tid = threadIdx.x;
    const int nt = blockDim.x;

    if (tid < na) {
        const float* f = fxy + 4 * (b0 + tid);
        pose[tid] = make_float4(f[0], f[1], f[2], f[3]);
    }
    int tail = 0;  // first element staged in 4-byte loads
    if (vec_win) {
        const int n4 = n / 4 * 4;
        for (int e0 = tid * 4; e0 < n4; e0 += nt * 4 * STAGE_UNROLL) {
            float4 v[STAGE_UNROLL];
#pragma unroll
            for (int i = 0; i < STAGE_UNROLL; ++i) {
                const int e = e0 + i * nt * 4;
                if (e < n4) v[i] = __ldg(reinterpret_cast<const float4*>(src + e));
            }
#pragma unroll
            for (int i = 0; i < STAGE_UNROLL; ++i) {
                const int e = e0 + i * nt * 4;
                if (e < n4) *reinterpret_cast<float4*>(tiles + e) = stage_value<BF16>(v[i]);
            }
        }
        tail = n4;
    }
    for (int e = tail + tid; e < n; e += nt) {
        float v = __ldg(src + e);
        if (BF16) v = __bfloat162float(__float2bfloat16_rn(v));
        tiles[e] = v;
    }
    __syncthreads();

    // warp k of the chunk owns samples [32 S k, 32 S (k + 1)) of it; lane l
    // takes l, l + 32, ...
    const int ra = (blockIdx.y * nt + (tid & ~31)) * RENDER_SAMPLES + (tid & 31);
    if (ra >= ra_count) return;
    float dx[RENDER_SAMPLES], dy[RENDER_SAMPLES];
#pragma unroll
    for (int j = 0; j < RENDER_SAMPLES; ++j) {
        const bool in = ra + 32 * j < ra_count;
        dx[j] = in ? __ldg(dx0 + ra + 32 * j) : 0.0f;
        dy[j] = in ? __ldg(dy0 + ra + 32 * j) : 0.0f;
    }
    const float hi = static_cast<float>(wsz - 1);
    const float hi_floor = hi - 0.5f;
    const unsigned row_bytes = 4u * static_cast<unsigned>(wsz);
    const unsigned unbias = 4u * MAGIC_BITS * (static_cast<unsigned>(wsz) + 1u);
    // every lane computes all its samples (lanes past ra_count sample the
    // pose's point), so only the stores of the last warp test their index
    const bool full = ra + 32 * (RENDER_SAMPLES - 1) < ra_count;
    float* o = out + static_cast<size_t>(b0) * ra_count + ra;
    for (int a = 0; a < na; ++a, o += ra_count) {
        const float4 p = pose[a];
        const float* w0 = tiles + a * w2;
        float v[RENDER_SAMPLES];
#pragma unroll
        for (int j = 0; j < RENDER_SAMPLES; ++j) {
            v[j] = sample<BF16>(w0, w0 + wsz, p, dx[j], dy[j], row_bytes, unbias, hi, hi_floor);
        }
        if (full) {
#pragma unroll
            for (int j = 0; j < RENDER_SAMPLES; ++j) o[32 * j] = v[j];
        } else {
#pragma unroll
            for (int j = 0; j < RENDER_SAMPLES; ++j) {
                if (ra + 32 * j < ra_count) o[32 * j] = v[j];
            }
        }
    }
}

bool aligned16(const void* p) { return reinterpret_cast<std::uintptr_t>(p) % 16 == 0; }

// All shared memory is dynamic; a kernel opts in above the default 48 KB
// once per size.
template <bool BF16>
int launch(const float* win, const float* fxy, const float* dx0, const float* dy0, float* out,
           int batch, int ra_count, int wsz, cudaStream_t stream) {
    static size_t dyn_allowed = 0;
    const size_t dyn = smem_bytes(wsz);
    if (dyn > 48 * 1024 && dyn > dyn_allowed) {
        const cudaError_t err = cudaFuncSetAttribute(
            render_kernel<BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(dyn));
        if (err != cudaSuccess) return static_cast<int>(err);
        dyn_allowed = dyn;
    }
    const int warps = (ra_count + 32 * RENDER_SAMPLES - 1) / (32 * RENDER_SAMPLES);
    const int chunks = (warps * 32 + RENDER_MAX_THREADS - 1) / RENDER_MAX_THREADS;
    const int threads = (warps + chunks - 1) / chunks * 32;
    const dim3 grid((batch + RENDER_AGENTS - 1) / RENDER_AGENTS, chunks);
    render_kernel<BF16><<<grid, threads, dyn, stream>>>(win, fxy, dx0, dy0, out, batch, ra_count,
                                                        wsz, aligned16(win));
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory one block asks for at this window size, for checking the
// wrapper's budget (ops/render.py render_smem_bytes).
NAVDV_EXPORT int navdv_render_smem_bytes(int wsz) { return static_cast<int>(smem_bytes(wsz)); }

NAVDV_EXPORT int navdv_render(const float* win, const float* fxy, const float* dx0,
                              const float* dy0, float* out, int batch, int ra_count,
                              int wsz, int hat_bf16, void* stream) {
    if (batch <= 0 || ra_count <= 0) return static_cast<int>(cudaGetLastError());
    const auto s = static_cast<cudaStream_t>(stream);
    return hat_bf16 ? launch<true>(win, fxy, dx0, dy0, out, batch, ra_count, wsz, s)
                    : launch<false>(win, fxy, dx0, dy0, out, batch, ra_count, wsz, s);
}
