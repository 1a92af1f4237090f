"""The port's render path (window gather + render module) against the JAX
batched renderer and the Pallas render kernel (interpret mode) on the CPU,
where the wrappers run their plain PyTorch versions; the CUDA kernels
themselves run only on the card (tests/test_torch_cuda.py)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navdv_torch.convert import config_from
from navdv_torch.ops.render import (
    _constants,
    render_chunks,
    render_pooled,
    render_pooled_chunks,
    render_pooled_plain,
    render_pooled_smem_bytes,
    render_smem_bytes,
    render_windows,
    render_windows_plain,
)
from navdv_torch.sensor import make_render_batch as t_render_batch
from navdv_tpu.ops.render_pallas import make_render_batch_pallas
from navdv_tpu.sensor import make_render_batch as j_render_batch

_EDGE_POSES = np.array(
    [[1.0, 1.0], [126.5, 126.5], [0.2, 64.0], [64.0, 127.0],
     [5.0, 5.0], [122.0, 6.0], [6.0, 122.0], [64.0, 64.0]],
    dtype=np.float32,
)


@pytest.mark.parametrize("poses", ["random", "edge"])
@pytest.mark.parametrize("hat_dtype", ["float32", "bfloat16"])
def test_render_matches_jax(small_cfg, small_world, poses, hat_dtype):
    """Window gather + render against the JAX batched renderer in the same
    rounding class, and (f32) against the Pallas render kernel."""
    land, _ = small_world
    rng = np.random.default_rng(5)
    if poses == "random":
        xy = rng.uniform(20, 100, size=(16, 2)).astype(np.float32)
        theta = rng.uniform(-4, 4, size=16).astype(np.float32)
    else:
        xy = _EDGE_POSES
        theta = np.linspace(-3, 3, 8).astype(np.float32)
    sensor = dataclasses.replace(small_cfg.sensor, hat_dtype=hat_dtype)
    got = t_render_batch(config_from(dataclasses.replace(small_cfg, sensor=sensor)).sensor,
                         device="cpu")(torch.from_numpy(land), torch.from_numpy(xy),
                                       torch.from_numpy(theta)).numpy()
    args = (jnp.asarray(land), jnp.asarray(xy), jnp.asarray(theta))
    want = np.asarray(j_render_batch(sensor, window_impl="xla")(*args))
    assert got.shape == (len(xy), sensor.n_radial, sensor.n_fine)
    atol = 1e-4 if hat_dtype == "float32" else 2e-3
    np.testing.assert_allclose(got, want, atol=atol)
    if hat_dtype == "float32":
        want_p = np.asarray(make_render_batch_pallas(sensor, interpret=True)(*args))
        np.testing.assert_allclose(got, want_p, atol=1e-4)


def _inputs(rng, b, wsz, r, a):
    win = torch.from_numpy(rng.uniform(size=(b, wsz, wsz)).astype(np.float32))
    theta = rng.uniform(-4, 4, size=b)
    fxy = torch.from_numpy(np.stack([rng.uniform(-3, wsz + 3, b), rng.uniform(-3, wsz + 3, b),
                                     np.cos(theta), np.sin(theta)], axis=1).astype(np.float32))
    dx0 = torch.from_numpy(rng.uniform(-9, 9, size=(r, a)).astype(np.float32))
    dy0 = torch.from_numpy(rng.uniform(-9, 9, size=(r, a)).astype(np.float32))
    return win, fxy, dx0, dy0


@pytest.mark.parametrize("limit", ["window", "panorama"])
def test_render_refuses_shapes_beyond_kernel_limits(limit):
    """The wrapper checks the kernel's launch limits on every device, before
    any build or launch: an agent tile of windows must fit in one block's
    shared memory (the size follows render.cu's constants), and the sample
    chunks of one agent tile must fit gridDim.y."""
    assert render_smem_bytes(85) <= 232_448 < render_smem_bytes(86)
    win, fxy, dx0, dy0 = _inputs(np.random.default_rng(0), 1, 85, 2, 3)
    assert render_windows(win, fxy, dx0, dy0, False).shape == (1, 2, 3)
    if limit == "window":
        win = torch.zeros(1, 86, 86)
        match = "shared memory"
    else:
        a = 2048
        while render_chunks(65536, a) <= 65535:  # the smallest such power of two
            a *= 2
        dx0 = dy0 = torch.zeros(1).expand(65536, a)  # no storage
        match = "too large"
    before = render_windows.launches
    with pytest.raises(ValueError, match=match):
        render_windows(win, fxy, dx0, dy0, False)
    assert render_windows.launches == before


def test_render_bf16_rounds_window_values_once():
    """The identity the kernel's staging relies on: in bf16 mode, rounding
    each gathered tap is rounding the whole window first and then blending
    it with the rounded weights, bit for bit."""
    win, fxy, dx0, dy0 = _inputs(np.random.default_rng(1), 6, 24, 16, 360)
    want = render_windows_plain(win, fxy, dx0, dy0, True)
    got = render_windows_plain(win.to(torch.bfloat16).float(), fxy, dx0, dy0, True)
    assert torch.equal(got, want)


def _box_sum_by_index(pano: torch.Tensor, u: int) -> torch.Tensor:
    """The u-tap circular sum written out by index: ``((p[a] + p[a+1]) +
    p[a+2]) + ...`` with every index taken mod A."""
    a = pano.shape[-1]
    cols = torch.arange(a)
    s = pano[..., cols]
    for j in range(1, u):
        s = s + pano[..., (cols + j) % a]
    return s


@pytest.mark.parametrize("u", [1, 2, 5])
@pytest.mark.parametrize("hat_bf16", [False, True])
def test_render_pooled_plain_is_render_then_box_sum(hat_bf16, u):
    """The pooled entry's plain version, bit for bit: the plain render,
    rounded to bf16 in the bf16 class, then the left-to-right u-tap sum; at
    a ragged B (two agent tiles and 3) and config 4's 16 x 360 rings. The
    CPU wrapper takes it."""
    b = 2 * _constants()["RENDER_AGENTS"] + 3
    win, fxy, dx0, dy0 = _inputs(np.random.default_rng(7 + u), b, 24, 16, 360)
    pano = render_windows_plain(win, fxy, dx0, dy0, hat_bf16)
    if hat_bf16:
        pano = pano.to(torch.bfloat16).float()
    want = _box_sum_by_index(pano, u)
    got = render_pooled_plain(win, fxy, dx0, dy0, u, hat_bf16)
    assert got.shape == (b, 16, 360)
    assert torch.equal(got, want)
    before = render_pooled.launches
    assert torch.equal(render_pooled(win, fxy, dx0, dy0, u, hat_bf16), want)
    assert render_pooled.launches == before


@pytest.mark.parametrize("limit", ["window", "panorama", "ring", "taps"])
def test_render_pooled_refuses_shapes_beyond_kernel_limits(limit):
    """The pooled wrapper checks its launch limits on every device, before
    any build or launch: those of the plain entry (an agent tile of windows
    and now two ring buffers in shared memory, the chunks within
    gridDim.y), one ring within one block, and 1 <= u <= A."""
    c = _constants()
    most = c["RENDER_MAX_THREADS"] * c["RENDER_SAMPLES"]
    # config 4: 2 chunks of 8 rings, 2 x 8 x (360 + 4) floats of rings
    assert render_pooled_chunks(16, 360) == (2, 8)
    assert render_pooled_smem_bytes(24, 16, 360, 5) == render_smem_bytes(24) + 2 * 8 * 364 * 4
    win, fxy, dx0, dy0 = _inputs(np.random.default_rng(0), 1, 24, 2, 3)
    u, match = 2, None
    if limit == "window":
        # 82^2 windows fit the plain entry, not with config 4's rings beside them
        assert render_smem_bytes(82) <= 232_448 < render_pooled_smem_bytes(82, 16, 360, 5)
        win, fxy, dx0, dy0 = _inputs(np.random.default_rng(0), 1, 82, 16, 360)
        render_windows(win, fxy, dx0, dy0, False)
        u, match = 5, "shared memory"
    elif limit == "panorama":
        dx0 = dy0 = torch.zeros(1).expand(65535 * (most // 360) + 1, 360)  # no storage
        assert render_pooled_chunks(*dx0.shape)[0] == 65536
        match = "too large"
    elif limit == "ring":
        assert render_pooled(win, fxy, *_inputs(np.random.default_rng(0), 1, 24, 1, most)[2:],
                             u, False).shape == (1, 1, most)
        dx0 = dy0 = torch.zeros(1, most + 1)
        match = "does not fit one block"
    else:
        assert render_pooled(win, fxy, dx0, dy0, 3, False).shape == (1, 2, 3)
        for bad in (0, 4):
            with pytest.raises(ValueError, match="taps must lie"):
                render_pooled(win, fxy, dx0, dy0, bad, False)
        return
    before = render_pooled.launches
    with pytest.raises(ValueError, match=match):
        render_pooled(win, fxy, dx0, dy0, u, False)
    assert render_pooled.launches == before
