"""Batched polar-panorama render from per-agent windows (kernel
``csrc/render.cu``).

Replaces ``navdv_tpu/ops/render_pallas.py::make_render_batch_pallas`` and
the hat-weight contraction of ``navdv_tpu/sensor.py::make_render_batch``:

    out[b, r, a] = sum_pq hat(ys - p) * hat(xs - q) * win[b, p, q]

with ``xs = clip(fx + c*dx0 - s*dy0, 0, wsz-1)`` and
``ys = clip(fy + s*dx0 + c*dy0, 0, wsz-1)``, ``(fx, fy, c, s) = fxy[b]``.
The hat weights are nonzero on two taps per axis, so both versions compute
the 4-tap bilinear blend with weights in the hat form; no hat tensor is
built. ``hat_bf16`` rounds window values and weights to bf16 before the
products (the JAX bfloat16 renderer's rounding class), accumulating in f32.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from navdv_torch import _build

# shared memory one block can use on the H100 (static + dynamic, after opt-in)
_BLOCK_SMEM_BYTES = 232_448
_MAX_GRID_Y = 65535  # sample chunks per launch (gridDim.y)


@functools.cache
def _constants() -> dict[str, int]:
    """The launch constants of ``csrc/render.cu``, read once: every render
    call checks its shapes against them."""
    return _build.source_constants("render.cu")


def render_smem_bytes(wsz: int) -> int:
    """Shared-memory bytes of one render block at window size ``wsz``, from
    the constants that ``csrc/render.cu`` declares (its ``smem_bytes``): a
    pose (float4) and a ``wsz x wsz`` f32 window for each agent of the tile."""
    c = _constants()
    return c["RENDER_AGENTS"] * (16 + wsz * wsz * 4)


def render_chunks(r: int, a: int) -> int:
    """Blocks along the samples of one agent tile (``csrc/render.cu``
    ``launch``): ``R*A`` samples, ``32 * RENDER_SAMPLES`` to a warp, at most
    ``RENDER_MAX_THREADS`` threads to a block."""
    c = _constants()
    warps = -(-r * a // (32 * c["RENDER_SAMPLES"]))
    return -(-warps * 32 // c["RENDER_MAX_THREADS"])


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def render_windows_plain(win: torch.Tensor, fxy: torch.Tensor, dx0: torch.Tensor,
                         dy0: torch.Tensor, hat_bf16: bool) -> torch.Tensor:
    """Plain PyTorch version: win f32[B, W, W], fxy f32[B, 4], dx0/dy0
    f32[R, A] -> f32[B, R, A]. Operation for operation the kernel's
    arithmetic."""
    b, wsz, _ = win.shape
    r, a = dx0.shape
    fx, fy, c, s = (fxy[:, i, None, None] for i in range(4))
    xs = ((fx + c * dx0) - s * dy0).clamp(0.0, wsz - 1.0)
    ys = ((fy + s * dx0) + c * dy0).clamp(0.0, wsz - 1.0)
    x0 = torch.floor(xs).clamp(max=wsz - 2)
    y0 = torch.floor(ys).clamp(max=wsz - 2)

    def hat(t, q):
        return (1.0 - (t - q).abs()).clamp_min(0.0)

    wx0, wx1 = hat(xs, x0), hat(xs, x0 + 1.0)
    wy0, wy1 = hat(ys, y0), hat(ys, y0 + 1.0)
    idx = (y0.long() * wsz + x0.long()).reshape(b, r * a)
    flat = win.reshape(b, wsz * wsz)

    def tap(off):
        return torch.gather(flat, 1, idx + off).reshape(b, r, a)

    v00, v01, v10, v11 = tap(0), tap(1), tap(wsz), tap(wsz + 1)
    if hat_bf16:
        wx0, wx1, wy0, wy1 = _bf16(wx0), _bf16(wx1), _bf16(wy0), _bf16(wy1)
        v00, v01, v10, v11 = _bf16(v00), _bf16(v01), _bf16(v10), _bf16(v11)
    t0 = wx0 * v00 + wx1 * v01
    t1 = wx0 * v10 + wx1 * v11
    return wy0 * t0 + wy1 * t1


def _check(win, fxy, dx0, dy0):
    for name, t in (("win", win), ("fxy", fxy), ("dx0", dx0), ("dy0", dy0)):
        if t.dtype != torch.float32:
            raise ValueError(f"render_windows: {name} must be float32")
    if win.dim() != 3 or win.shape[1] != win.shape[2] or win.shape[1] < 2:
        raise ValueError("render_windows: win must be f32[B, W, W] with W >= 2")
    if fxy.shape != (win.shape[0], 4):
        raise ValueError("render_windows: fxy must be f32[B, 4]")
    if dx0.dim() != 2 or dx0.shape != dy0.shape:
        raise ValueError("render_windows: dx0/dy0 must be matching f32[R, A]")
    devs = {win.device, fxy.device, dx0.device, dy0.device}
    if len(devs) != 1:
        raise ValueError(f"render_windows: tensors on different devices {devs}")
    if render_smem_bytes(win.shape[1]) > _BLOCK_SMEM_BYTES:
        raise ValueError(f"render_windows: a tile of {win.shape[1]}^2 windows does not fit "
                         "in shared memory")
    if render_chunks(*dx0.shape) > _MAX_GRID_Y:
        raise ValueError("render_windows: panorama too large for one launch")


def render_windows(win: torch.Tensor, fxy: torch.Tensor, dx0: torch.Tensor,
                   dy0: torch.Tensor, hat_bf16: bool) -> torch.Tensor:
    """``(win f32[B, W, W], fxy f32[B, 4], dx0/dy0 f32[R, A]) -> f32[B, R, A]``."""
    _check(win, fxy, dx0, dy0)
    dev = win.device
    if dev.type == "cpu":
        return render_windows_plain(win, fxy, dx0, dy0, hat_bf16)
    if dev.type != "cuda":
        raise ValueError(f"render_windows: unsupported device {dev}")
    fn = _build.load_function("render", "navdv_render", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ])
    win = win.contiguous()
    fxy = fxy.contiguous()
    dx0 = dx0.contiguous()
    dy0 = dy0.contiguous()
    b, wsz, _ = win.shape
    r, a = dx0.shape
    out = torch.empty((b, r, a), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(win.data_ptr(), fxy.data_ptr(), dx0.data_ptr(), dy0.data_ptr(),
                  out.data_ptr(), b, r * a, wsz, int(bool(hat_bf16)), stream)
    render_windows.launches += 1
    _build.check_launch("render", code)
    return out


render_windows.launches = 0
