"""Batched landscape-window gather (kernel ``csrc/window.cu``).

Replaces ``navdv_tpu/ops/window_pallas.py::make_window_gather_pallas``.
``out[b] = landscape[base_y[b] : base_y[b] + wy, base_x[b] : base_x[b] + wx]``
for unaligned per-agent corners. The TPU kernel's aligned bands, lane and
sublane rotations and the 8 replicated bottom rows it needs are TPU layout
mechanics; the port keeps the contract only. Corners are clamped into the
landscape, which leaves every in-range corner unchanged.
"""

from __future__ import annotations

import ctypes

import torch

from navdv_torch import _build


def window_gather_plain(landscape: torch.Tensor, base_y: torch.Tensor,
                        base_x: torch.Tensor, wy: int, wx: int) -> torch.Tensor:
    """Plain PyTorch version: f32[H, W], i32[B], i32[B] -> f32[B, wy, wx]."""
    h, w = landscape.shape
    by = base_y.long().clamp(0, h - wy)
    bx = base_x.long().clamp(0, w - wx)
    rows = by[:, None] + torch.arange(wy, device=landscape.device)  # [B, wy]
    cols = bx[:, None] + torch.arange(wx, device=landscape.device)  # [B, wx]
    return landscape[rows[:, :, None], cols[:, None, :]]


def _check(landscape, base_y, base_x, wy, wx):
    if landscape.dtype != torch.float32 or landscape.dim() != 2:
        raise ValueError("window_gather: landscape must be f32[H, W]")
    if base_y.dtype != torch.int32 or base_x.dtype != torch.int32:
        raise ValueError("window_gather: base_y/base_x must be int32")
    if base_y.dim() != 1 or base_y.shape != base_x.shape:
        raise ValueError("window_gather: base_y/base_x must be matching [B] vectors")
    h, w = landscape.shape
    if not (0 < wy <= h and 0 < wx <= w):
        raise ValueError(f"window_gather: window {wy}x{wx} does not fit landscape {h}x{w}")
    devs = {landscape.device, base_y.device, base_x.device}
    if len(devs) != 1:
        raise ValueError(f"window_gather: tensors on different devices {devs}")


def window_gather(landscape: torch.Tensor, base_y: torch.Tensor,
                  base_x: torch.Tensor, wy: int, wx: int) -> torch.Tensor:
    """``(landscape f32[H, W], base_y i32[B], base_x i32[B]) -> f32[B, wy, wx]``."""
    _check(landscape, base_y, base_x, wy, wx)
    dev = landscape.device
    if dev.type == "cpu":
        return window_gather_plain(landscape, base_y, base_x, wy, wx)
    if dev.type != "cuda":
        raise ValueError(f"window_gather: unsupported device {dev}")
    fn = _build.load_function("window", "navdv_window_gather", [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ])
    land = landscape.contiguous()
    by = base_y.contiguous()
    bx = base_x.contiguous()
    b = by.shape[0]
    out = torch.empty((b, wy, wx), dtype=torch.float32, device=dev)
    h, w = land.shape
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(land.data_ptr(), h, w, by.data_ptr(), bx.data_ptr(), b, wy, wx,
                  out.data_ptr(), stream)
    window_gather.launches += 1
    _build.check_launch("window", code)
    return out


window_gather.launches = 0
