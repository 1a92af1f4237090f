"""The pooled entry of the min-distance kernel on the CPU, where it runs its
plain version: the step's materialised route (candidate gather, then the
plain minimum) bit for bit, float64 within rounding, the step's SSD lag
minimum, and the wrapper's input checks. The kernel itself runs only on the
card (tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

from navdv_torch import ops
from navdv_torch.config import ScanConfig, SensorConfig
from navdv_torch.familiarity import pack_library, pad_library
from navdv_torch.ops.familiarity import (
    make_lib_min_kernel,
    make_lib_min_pooled,
    min_distance_pooled,
    min_distance_rows_plain,
)
from navdv_torch.sensor import make_views_from_pooled, scan_lag_sets

CONFIG4 = SensorConfig(n_radial=16, n_azimuth=72, az_upsample=5)
CONFIG4_LAGS = scan_lag_sets(ScanConfig(n_headings=60))[0]
WRAPPING = np.array([-40, -36, -7, -1, 0, 3, 11, 35, 36, 70, 71], dtype=np.int64)


def _inputs(sensor, b, nl, seed, layout="contiguous"):
    rng = np.random.default_rng(seed)
    shape = (b, sensor.n_radial, sensor.n_fine)
    if layout == "contiguous":
        s = torch.from_numpy(rng.uniform(size=shape).astype(np.float32))
    elif layout == "strided":  # every other column of a wider panorama
        wide = torch.from_numpy(rng.uniform(size=(*shape[:2], 2 * shape[2])).astype(np.float32))
        s = wide[:, :, ::2]
    else:  # "offset": one float into a buffer
        buf = torch.from_numpy(rng.uniform(size=int(np.prod(shape)) + 1).astype(np.float32))
        s = buf[1:].view(shape)
    views = rng.uniform(size=(nl, sensor.n_radial, sensor.n_azimuth)).astype(np.float32)
    return s, pack_library(torch.from_numpy(views))


@pytest.mark.parametrize("sensor,lags,b,nl,layout", [
    (CONFIG4, CONFIG4_LAGS, 5, 50, "contiguous"),
    (CONFIG4, CONFIG4_LAGS[::7], 3, 57, "strided"),
    (SensorConfig(n_radial=3, n_azimuth=7, az_upsample=1), WRAPPING, 6, 9, "offset"),
    (SensorConfig(n_radial=3, n_azimuth=7, az_upsample=5), WRAPPING, 4, 120, "contiguous"),
], ids=["config4", "config4_subset_strided", "r3w7_u1_wrap_offset", "r3w7_u5_wrap"])
def test_plain_pooled_equals_the_materialised_route(sensor, lags, b, nl, layout):
    """The plain version is the step's former route bit for bit: the
    candidates gathered from S (``make_views_from_pooled``), then the plain
    minimum; and float64 from scratch (pixel r*W + w of candidate l is
    S[r, (w*u + l) mod A] / u) within fp32 rounding of S / u."""
    s, lib = _inputs(sensor, b, nl, seed=len(lags) + nl)
    lags_t = torch.from_numpy(lags.astype(np.int32))
    got = min_distance_pooled(s, lags_t, lib.flat, lib.sq, sensor, -2.0, True)
    rows = make_views_from_pooled(sensor, lags, "cpu")(s).reshape(-1, sensor.n_pixels)
    want = min_distance_rows_plain(rows, lib.flat, lib.sq, -2.0, True).reshape(b, len(lags))
    assert got.shape == (b, len(lags)) and got.dtype == torch.float32
    assert torch.equal(got, want)

    u, w, a = sensor.az_upsample, sensor.n_azimuth, sensor.n_fine
    cols = (np.arange(w)[None, :] * u + lags[:, None]) % a  # [L, W]
    s64 = s.double().numpy() / u
    cand = s64[:, :, cols].transpose(0, 2, 1, 3).reshape(b, len(lags), -1)  # [B, L, P]
    lib64 = lib.flat.double().numpy()
    d = ((cand[:, :, None, :] - lib64[None, None]) ** 2).sum(-1).min(-1)
    np.testing.assert_allclose(got.numpy(), d, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("nl,pad_to", [(50, 50), (9, 16)])
def test_pooled_lib_min_is_the_kernel_path_lag_minimum(nl, pad_to):
    """``make_lib_min_pooled`` gives the kernel path's former SSD lag
    minimum (materialised candidates through ``make_lib_min_kernel``) bit
    for bit, padded library entries included, clamped at >= 0."""
    scan = ScanConfig(n_headings=60)
    s, lib = _inputs(CONFIG4, 3, nl, seed=nl)
    lib = pad_library(lib, pad_to)
    got = make_lib_min_pooled(CONFIG4, CONFIG4_LAGS, "cpu")(s, lib, None, None, None)
    cand = make_views_from_pooled(CONFIG4, CONFIG4_LAGS, "cpu")(s)
    want = make_lib_min_kernel(CONFIG4, scan)(cand, lib)
    assert torch.equal(got, want)
    assert bool((got >= 0).all())


def _bad_inputs():
    sensor = SensorConfig(n_radial=2, n_azimuth=6, az_upsample=2)  # A 12, P 12
    s = torch.zeros(4, 2, 12)
    lags = torch.arange(-2, 3, dtype=torch.int32)
    b, gamma = torch.zeros(3, 12), torch.zeros(3)
    return sensor, s, lags, b, gamma


@pytest.mark.parametrize("bad,match", [
    ("s_dtype", "s must be float32"),
    ("b_dtype", "b must be float32"),
    ("gamma_dtype", "gamma must be float32"),
    ("s_rank", r"s must be f32\[B, 2, 12\]"),
    ("s_width", r"s must be f32\[B, 2, 12\]"),
    ("lags_dtype", r"lags must be int32\[L\]"),
    ("lags_rank", r"lags must be int32\[L\]"),
    ("b_pixels", r"b must be f32\[Nl, 12\]"),
    ("b_empty", r"b must be f32\[Nl, 12\]"),
    ("gamma_len", r"gamma must be f32\[Nl\]"),
    ("devices", "different devices"),
    ("pixels", "more pixels than the kernel indexes"),
])
def test_min_distance_pooled_refuses_bad_inputs(bad, match):
    sensor, s, lags, b, gamma = _bad_inputs()
    if bad == "s_dtype":
        s = s.double()
    elif bad == "b_dtype":
        b = b.double()
    elif bad == "gamma_dtype":
        gamma = gamma.half()
    elif bad == "s_rank":
        s = s.reshape(4, 24)
    elif bad == "s_width":
        s = torch.zeros(4, 2, 6)
    elif bad == "lags_dtype":
        lags = lags.long()
    elif bad == "lags_rank":
        lags = lags.reshape(1, -1)
    elif bad == "b_pixels":
        b = torch.zeros(3, 11)
    elif bad == "b_empty":
        b, gamma = torch.zeros(0, 12), torch.zeros(0)
    elif bad == "gamma_len":
        gamma = torch.zeros(4)
    elif bad == "devices":
        lags = lags.to("meta")
    else:  # 2048 x 2048 pixels: past the kernel's exact k / W; expanded, no storage
        sensor = SensorConfig(n_radial=2048, n_azimuth=2048, az_upsample=1)
        s = torch.zeros(1).expand(1, 2048, 2048)
        b = torch.zeros(1).expand(3, 2048 * 2048)
    with pytest.raises(ValueError, match=match):
        min_distance_pooled(s, lags, b, gamma, sensor, -2.0, True)


def test_launch_counts_name_the_pooled_entry():
    """The pooled entry keeps its own count under ``"min_distance_pooled"``,
    apart from the rows entry's; on CPU tensors it launches nothing."""
    sensor, s, lags, b, gamma = _bad_inputs()
    ops.reset_launch_counts()
    min_distance_pooled(s, lags, b, gamma, sensor, -2.0, True)
    counts = ops.launch_counts()
    assert counts["min_distance_pooled"] == 0 and counts["min_distance"] == 0
    min_distance_pooled.launches = 3
    assert ops.launch_counts()["min_distance_pooled"] == 3
    ops.reset_launch_counts()
    assert ops.launch_counts()["min_distance_pooled"] == 0
