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
    render_chunks,
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
