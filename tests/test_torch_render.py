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
