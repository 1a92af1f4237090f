// Batched landscape-window gather: out[b, p, q] = land[by[b] + p, bx[b] + q].
//
// Replaces navdv_tpu/ops/window_pallas.py make_window_gather_pallas
// (_vmem_kernel / _dma_kernel). On the TPU that kernel reads 8x128-aligned
// bands and rotates them into place; on this card there is no alignment
// constraint, so each window is copied straight from the landscape. Only
// the contract is kept: the corners are the true, unaligned window origins,
// clamped here into the landscape so no read can leave it.
//
// Bound on the H100: bytes, but only nominally. At config 4 (land 512x512,
// 1024 agents, 24x24 windows) the function moves about 3.3 MB, 0.98 us at
// 3.35 TB/s, less than a launch; a copy this small is bound by the latency
// of its two dependent loads (corner, then window) and by per-block
// overhead. So the design keeps every load of a thread in flight at once:
//
// - A block owns WIN_AGENTS agents and clamps their corners once into
//   shared memory. Two agents a block measured a little faster on the H100
//   than 4 or 8 (the TPU kernel's tb = 16, window_pallas.py:89, is VMEM
//   tiling): 512 blocks of 160 threads at config 4.
// - A thread owns WIN_VEC = 4 consecutive elements of the window, the same
//   four in every agent of the block. Their landscape offsets come from one
//   division per thread, then step (p, q) by one; no element divides.
// - The thread starts all WIN_AGENTS x 4 loads, a count fixed at compile
//   time, before its first store.
// - Stores are one float4 per agent where wy * wx % 4 == 0, 4-byte stores
//   otherwise, in the same kernel.
//
// Offsets into the landscape are 32-bit: ops/window.py refuses a landscape
// of 2^31 cells or more.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int WIN_AGENTS = 2;         // agents per block
constexpr int WIN_VEC = 4;            // consecutive window elements per thread
constexpr int WIN_MAX_THREADS = 256;  // threads per block at most

// vec: wy * wx % 4 == 0 and out 16-byte aligned.
__global__ void __launch_bounds__(WIN_MAX_THREADS)
window_gather_kernel(const float* __restrict__ land, int h, int w,
                     const int* __restrict__ by, const int* __restrict__ bx, int batch,
                     int wy, int wx, float* __restrict__ out, int vec) {
    __shared__ int corner[WIN_AGENTS];
    const int b0 = blockIdx.x * WIN_AGENTS;
    const int na = min(WIN_AGENTS, batch - b0);
    if (threadIdx.x < na) {
        const int y0 = min(max(by[b0 + threadIdx.x], 0), h - wy);
        const int x0 = min(max(bx[b0 + threadIdx.x], 0), w - wx);
        corner[threadIdx.x] = y0 * w + x0;
    }
    __syncthreads();
    const int n = wy * wx;
    for (int r0 = threadIdx.x * WIN_VEC; r0 < n; r0 += blockDim.x * WIN_VEC) {
        int off[WIN_VEC];
        int p = r0 / wx;
        int q = r0 - p * wx;
#pragma unroll
        for (int j = 0; j < WIN_VEC; ++j) {
            off[j] = p * w + q;
            if (++q == wx) q = 0, ++p;
        }
        float v[WIN_AGENTS][WIN_VEC];
#pragma unroll
        for (int a = 0; a < WIN_AGENTS; ++a) {
#pragma unroll
            for (int j = 0; j < WIN_VEC; ++j) {
                if (a < na && r0 + j < n) v[a][j] = __ldg(land + corner[a] + off[j]);
            }
        }
#pragma unroll
        for (int a = 0; a < WIN_AGENTS; ++a) {
            if (a >= na) break;
            float* dst = out + static_cast<size_t>(b0 + a) * n + r0;
            if (vec) {
                *reinterpret_cast<float4*>(dst) = make_float4(v[a][0], v[a][1], v[a][2], v[a][3]);
            } else {
#pragma unroll
                for (int j = 0; j < WIN_VEC; ++j) {
                    if (r0 + j < n) dst[j] = v[a][j];
                }
            }
        }
    }
}

}  // namespace

NAVDV_EXPORT int navdv_window_gather(const float* land, int h, int w, const int* by,
                                     const int* bx, int batch, int wy, int wx,
                                     float* out, void* stream) {
    if (batch > 0) {
        const int quads = (wy * wx + WIN_VEC - 1) / WIN_VEC;
        const int threads = ((quads < WIN_MAX_THREADS ? quads : WIN_MAX_THREADS) + 31) / 32 * 32;
        const int vec = (wy * wx) % 4 == 0 && reinterpret_cast<std::uintptr_t>(out) % 16 == 0;
        window_gather_kernel<<<(batch + WIN_AGENTS - 1) / WIN_AGENTS, threads, 0,
                               static_cast<cudaStream_t>(stream)>>>(land, h, w, by, bx, batch,
                                                                    wy, wx, out, vec);
    }
    return static_cast<int>(cudaGetLastError());
}
