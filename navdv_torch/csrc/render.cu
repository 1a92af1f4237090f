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
// from L1 cheaply, so one thread per (agent, ring, azimuth) sample reads its
// four window values and no hat matrix exists. The two taps' weights are
// computed in the hat form max(0, 1 - |xs - q|), and every operation rounds
// separately (no FMA contraction), so the kernel repeats the plain PyTorch
// version's arithmetic operation for operation.
//
// hat_bf16 = 1 reproduces the JAX bfloat16 renderer's rounding class
// (sensor.py, hat_dtype="bfloat16"): window values and each axis' weights
// are rounded to bf16 before the products; accumulation stays f32.
// hat_bf16 = 0 keeps everything f32 (training capture).
//
// Bound on the H100: bytes. At config 4 (1024 agents, 16 x 360 samples,
// 24 x 24 windows) the panorama write (23.6 MB) dominates the 26 MB moved,
// about 8 us at 3.35 TB/s; the arithmetic (~20 flops a sample) is a small
// fraction of the fp32 rate. Consecutive threads own consecutive azimuths,
// so the panorama write and the dx0/dy0 reads are fully coalesced.

#include <cuda_bf16.h>

#include "common.cuh"

__device__ __forceinline__ float round_bf16(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float hat(float t, float q) {
    return fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(t, q))));
}

__global__ void render_kernel(const float* __restrict__ win, const float* __restrict__ fxy,
                              const float* __restrict__ dx0, const float* __restrict__ dy0,
                              float* __restrict__ out, int ra_count, int wsz, int hat_bf16) {
    const int b = blockIdx.x;
    const int ra = blockIdx.y * blockDim.x + threadIdx.x;
    if (ra >= ra_count) return;
    const float fx = fxy[4 * b + 0];
    const float fy = fxy[4 * b + 1];
    const float c = fxy[4 * b + 2];
    const float s = fxy[4 * b + 3];
    const float dx = dx0[ra];
    const float dy = dy0[ra];
    const float hi = static_cast<float>(wsz - 1);
    float xs = __fsub_rn(__fadd_rn(fx, __fmul_rn(c, dx)), __fmul_rn(s, dy));
    float ys = __fadd_rn(__fadd_rn(fy, __fmul_rn(s, dx)), __fmul_rn(c, dy));
    xs = fminf(fmaxf(xs, 0.0f), hi);
    ys = fminf(fmaxf(ys, 0.0f), hi);
    const int x0 = min(static_cast<int>(floorf(xs)), wsz - 2);
    const int y0 = min(static_cast<int>(floorf(ys)), wsz - 2);
    float wx0 = hat(xs, static_cast<float>(x0));
    float wx1 = hat(xs, static_cast<float>(x0 + 1));
    float wy0 = hat(ys, static_cast<float>(y0));
    float wy1 = hat(ys, static_cast<float>(y0 + 1));
    const float* w = win + static_cast<size_t>(b) * wsz * wsz + y0 * wsz + x0;
    float v00 = w[0], v01 = w[1], v10 = w[wsz], v11 = w[wsz + 1];
    if (hat_bf16) {
        wx0 = round_bf16(wx0);
        wx1 = round_bf16(wx1);
        wy0 = round_bf16(wy0);
        wy1 = round_bf16(wy1);
        v00 = round_bf16(v00);
        v01 = round_bf16(v01);
        v10 = round_bf16(v10);
        v11 = round_bf16(v11);
    }
    const float t0 = __fadd_rn(__fmul_rn(wx0, v00), __fmul_rn(wx1, v01));
    const float t1 = __fadd_rn(__fmul_rn(wx0, v10), __fmul_rn(wx1, v11));
    out[static_cast<size_t>(b) * ra_count + ra] =
        __fadd_rn(__fmul_rn(wy0, t0), __fmul_rn(wy1, t1));
}

NAVDV_EXPORT int navdv_render(const float* win, const float* fxy, const float* dx0,
                              const float* dy0, float* out, int batch, int ra_count,
                              int wsz, int hat_bf16, void* stream) {
    if (batch > 0 && ra_count > 0) {
        const int threads = 256;
        const dim3 grid(batch, (ra_count + threads - 1) / threads);
        render_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
            win, fxy, dx0, dy0, out, ra_count, wsz, hat_bf16);
    }
    return static_cast<int>(cudaGetLastError());
}
