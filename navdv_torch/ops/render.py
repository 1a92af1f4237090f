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

The pooled entry (:func:`render_pooled`) writes, in the same launch, the
pooled panorama ``S[b, r, a] = sum_{j<u} pano[b, r, (a + j) mod A]`` of
:func:`box_pool`: the kernel sums the u taps in its epilogue, so the
panorama itself never reaches device memory.
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


def render_pooled_chunks(r: int, a: int) -> tuple[int, int]:
    """The pooled entry's split of ``r`` rings of ``a`` samples
    (``csrc/render.cu`` ``ring_chunks``): ``(chunks, rings)``, chunks of
    whole rings, at most ``RENDER_MAX_THREADS * RENDER_SAMPLES`` samples
    each, ``rings`` to a chunk."""
    c = _constants()
    most = c["RENDER_MAX_THREADS"] * c["RENDER_SAMPLES"] // a
    if most == 0:
        raise ValueError(f"render_pooled: a ring of {a} samples does not fit one block")
    chunks = -(-r // most)
    return chunks, -(-r // chunks)


def render_pooled_smem_bytes(wsz: int, r: int, a: int, u: int) -> int:
    """Shared-memory bytes of one pooled render block (``csrc/render.cu``
    ``smem_bytes``): :func:`render_smem_bytes` and two ring buffers of a
    chunk's rings, each ring followed by its first ``u - 1`` samples."""
    return render_smem_bytes(wsz) + 2 * render_pooled_chunks(r, a)[1] * (a + u - 1) * 4


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


def box_pool(pano: torch.Tensor, u: int, bf16: bool) -> torch.Tensor:
    """The circular u-tap box filter ``S[..., a] = sum_{j<u} p[..., (a + j)
    mod A]`` of ``p = pano`` (rounded to bf16 first if ``bf16``), summed
    left to right: ``((p_a + p_{a+1}) + p_{a+2}) + ...``, the order of the
    pooled render kernel's epilogue."""
    p = _bf16(pano) if bf16 else pano
    s = p
    for j in range(1, u):
        s = s + torch.roll(p, -j, dims=-1)
    return s


def render_pooled_plain(win: torch.Tensor, fxy: torch.Tensor, dx0: torch.Tensor,
                        dy0: torch.Tensor, u: int, hat_bf16: bool) -> torch.Tensor:
    """Plain PyTorch version of :func:`render_pooled`: the plain render,
    then (``hat_bf16``) the panorama rounded to bf16, then the u-tap sum."""
    return box_pool(render_windows_plain(win, fxy, dx0, dy0, hat_bf16), u, hat_bf16)


def _check(name, win, fxy, dx0, dy0, u=None):
    """The launch limits of the plain entry, or with ``u`` of the pooled
    one: ``1 <= u <= A``, a ring within one block, the ring buffers in
    shared memory and the chunks of whole rings within gridDim.y."""
    for arg, t in (("win", win), ("fxy", fxy), ("dx0", dx0), ("dy0", dy0)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: {arg} must be float32")
    if win.dim() != 3 or win.shape[1] != win.shape[2] or win.shape[1] < 2:
        raise ValueError(f"{name}: win must be f32[B, W, W] with W >= 2")
    if fxy.shape != (win.shape[0], 4):
        raise ValueError(f"{name}: fxy must be f32[B, 4]")
    if dx0.dim() != 2 or dx0.shape != dy0.shape:
        raise ValueError(f"{name}: dx0/dy0 must be matching f32[R, A]")
    devs = {win.device, fxy.device, dx0.device, dy0.device}
    if len(devs) != 1:
        raise ValueError(f"{name}: tensors on different devices {devs}")
    wsz, (r, a) = win.shape[1], dx0.shape
    if u is None:
        smem, chunks = render_smem_bytes(wsz), render_chunks(r, a)
    else:
        if not 1 <= u <= a:
            raise ValueError(f"{name}: u = {u} taps must lie in [1, A = {a}]")
        smem, chunks = render_pooled_smem_bytes(wsz, r, a, u), render_pooled_chunks(r, a)[0]
    if smem > _BLOCK_SMEM_BYTES:
        raise ValueError(f"{name}: a tile of {wsz}^2 windows does not fit in shared memory")
    if chunks > _MAX_GRID_Y:
        raise ValueError(f"{name}: panorama too large for one launch")


def _launch(symbol: str, win, fxy, dx0, dy0, *ints: int):
    """Launch the render library's ``symbol(win, fxy, dx0, dy0, out, *ints,
    stream)`` into a fresh ``out`` f32[B, R, A]; returns (out, its error
    code)."""
    fn = _build.load_function("render", symbol, [ctypes.c_void_p] * 5
                              + [ctypes.c_int] * len(ints) + [ctypes.c_void_p])
    win, fxy, dx0, dy0 = (t.contiguous() for t in (win, fxy, dx0, dy0))
    dev = win.device
    out = torch.empty((win.shape[0], *dx0.shape), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(win.data_ptr(), fxy.data_ptr(), dx0.data_ptr(), dy0.data_ptr(),
                  out.data_ptr(), *ints, stream)
    return out, code


def render_windows(win: torch.Tensor, fxy: torch.Tensor, dx0: torch.Tensor,
                   dy0: torch.Tensor, hat_bf16: bool) -> torch.Tensor:
    """``(win f32[B, W, W], fxy f32[B, 4], dx0/dy0 f32[R, A]) -> f32[B, R, A]``."""
    _check("render_windows", win, fxy, dx0, dy0)
    dev = win.device
    if dev.type == "cpu":
        return render_windows_plain(win, fxy, dx0, dy0, hat_bf16)
    if dev.type != "cuda":
        raise ValueError(f"render_windows: unsupported device {dev}")
    b, wsz, _ = win.shape
    out, code = _launch("navdv_render", win, fxy, dx0, dy0, b, dx0.numel(), wsz,
                        int(bool(hat_bf16)))
    render_windows.launches += 1
    _build.check_launch("render", code)
    return out


render_windows.launches = 0


def render_pooled(win: torch.Tensor, fxy: torch.Tensor, dx0: torch.Tensor, dy0: torch.Tensor,
                  u: int, hat_bf16: bool) -> torch.Tensor:
    """``(win f32[B, W, W], fxy f32[B, 4], dx0/dy0 f32[R, A], u) -> S f32[B,
    R, A]``: :func:`render_pooled_plain` in one launch of the render
    kernel, its u-tap sum in the epilogue."""
    _check("render_pooled", win, fxy, dx0, dy0, u)
    dev = win.device
    if dev.type == "cpu":
        return render_pooled_plain(win, fxy, dx0, dy0, u, hat_bf16)
    if dev.type != "cuda":
        raise ValueError(f"render_pooled: unsupported device {dev}")
    b, wsz, _ = win.shape
    out, code = _launch("navdv_render_pooled", win, fxy, dx0, dy0, b, *dx0.shape, wsz, int(u),
                        int(bool(hat_bf16)))
    render_pooled.launches += 1
    _build.check_launch("render", code)
    return out


render_pooled.launches = 0
