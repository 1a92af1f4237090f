// Batched landscape-window gather: out[b, p, q] = land[by[b] + p, bx[b] + q].
//
// Replaces navdv_tpu/ops/window_pallas.py make_window_gather_pallas
// (_vmem_kernel / _dma_kernel). On the TPU that kernel reads 8x128-aligned
// bands and rotates them into place; on this card there is no alignment
// constraint, so one block per agent copies its window straight from the
// landscape. Only the contract is kept: the corners are the true,
// unaligned window origins, clamped here into the landscape so no read can
// leave it.
//
// Bound on the H100: bytes. At the config-4 shapes (land 512x512, 1024
// agents, 24x24 windows) the function moves about 3.4 MB, about a
// microsecond at 3.35 TB/s, so a launch costs more than the copy. Reads of
// one window row are consecutive addresses, so each warp reads whole
// 96-byte rows; the writes are fully consecutive.

#include "common.cuh"

__global__ void window_gather_kernel(const float* __restrict__ land, int h, int w,
                                     const int* __restrict__ by,
                                     const int* __restrict__ bx, int wy, int wx,
                                     float* __restrict__ out) {
    const int b = blockIdx.x;
    const int y0 = min(max(by[b], 0), h - wy);
    const int x0 = min(max(bx[b], 0), w - wx);
    const int n = wy * wx;
    float* dst = out + static_cast<size_t>(b) * n;
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
        const int p = e / wx;
        const int q = e - p * wx;
        dst[e] = land[static_cast<size_t>(y0 + p) * w + (x0 + q)];
    }
}

NAVDV_EXPORT int navdv_window_gather(const float* land, int h, int w, const int* by,
                                     const int* bx, int batch, int wy, int wx,
                                     float* out, void* stream) {
    if (batch > 0) {
        window_gather_kernel<<<batch, 128, 0, static_cast<cudaStream_t>(stream)>>>(
            land, h, w, by, bx, wy, wx, out);
    }
    return static_cast<int>(cudaGetLastError());
}
