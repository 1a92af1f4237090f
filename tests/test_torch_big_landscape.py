"""Landscapes past the TPU window kernel's VMEM budget (the JAX bench's
``--big-landscape`` world), on the CPU.

The JAX window kernel keeps a landscape of up to ``VMEM_LAND_MAX_ELEMS``
cells resident and reads larger ones band by band through per-agent DMAs;
the port's window gather reads any landscape below 2^31 cells directly.
Here a 1536^2 fractal landscape (2.36M cells) stands for the bench's 4096^2
one: the port's batched renderer against the JAX renderer through the
Pallas window kernel (interpret mode), which takes its DMA band source
there; the port's exact episode against JAX ``make_navigate_batch`` on that
world (JAX's episode on the CPU takes its XLA window path); and the 4096^2
fractal landscape itself, equal to JAX's bit for bit.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navdv_torch.agent import init_state, make_navigate_batch
from navdv_torch.convert import config_from, statics_from_numpy
from navdv_torch.landscape import make_landscape
from navdv_torch.sensor import make_render_batch
from navdv_tpu import oracle
from navdv_tpu.agent import init_state as j_init_state
from navdv_tpu.agent import make_navigate_batch as j_make_navigate_batch
from navdv_tpu.agent import make_statics as j_make_statics
from navdv_tpu.landscape import make_landscape as j_make_landscape
from navdv_tpu.ops.window_pallas import VMEM_LAND_MAX_ELEMS
from navdv_tpu.routes import make_route
from navdv_tpu.sensor import make_render_batch as j_make_render_batch
from navdv_tpu.training import train_library as j_train_library

BIG = 1536
STEPS = 8
B = 8


@pytest.fixture(scope="module")
def big_world():
    """The bench's world at 1536^2: fractal landscape (seed 7), sine route
    of length 40 (bench.py ``_world``)."""
    land = j_make_landscape("fractal", size=(BIG, BIG), seed=7)
    assert land.size > VMEM_LAND_MAX_ELEMS
    route = make_route("sine", size=(BIG, BIG), margin=60.0, length=40.0, amplitude=5.0)
    return land, route


def test_fractal_4096_equals_jax():
    """The bench's 4096^2 fractal landscape, bit for bit."""
    want = j_make_landscape("fractal", size=(4096, 4096), seed=7)
    got = make_landscape("fractal", size=(4096, 4096), seed=7)
    assert got.dtype == np.float32 and got.shape == (4096, 4096)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("hat_dtype", ["float32", "bfloat16"])
def test_render_matches_jax_dma_band_source(small_cfg, big_world, hat_dtype):
    """Window gather + render at corners spread over the whole landscape
    and at its four edges, against the JAX renderer through the Pallas
    window kernel's DMA band source, in the same rounding class (the
    tolerances of tests/test_torch_render.py)."""
    land, _ = big_world
    rng = np.random.default_rng(11)
    xy = rng.uniform(0.0, BIG - 1.0, size=(16, 2)).astype(np.float32)
    xy[:4] = [[0.4, 700.0], [BIG - 1.2, 20.0], [900.0, 0.3], [3.0, BIG - 1.5]]
    theta = rng.uniform(-np.pi, np.pi, size=16).astype(np.float32)
    sensor = dataclasses.replace(small_cfg.sensor, hat_dtype=hat_dtype)
    want = np.asarray(j_make_render_batch(sensor, window_impl="pallas")(
        jnp.asarray(land), jnp.asarray(xy), jnp.asarray(theta)))
    got = make_render_batch(config_from(dataclasses.replace(small_cfg, sensor=sensor)).sensor,
                            device="cpu")(torch.from_numpy(land), torch.from_numpy(xy),
                                          torch.from_numpy(theta)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4 if hat_dtype == "float32" else 2e-3)


@pytest.mark.parametrize("fam_impl", ["plain", "kernel"])
def test_exact_episode_matches_jax(small_cfg, big_world, fam_impl):
    """B agents started as ``run_big_landscape`` starts them, a few steps,
    with the JAX library carried across: the same candidate every step,
    poses and familiarity as tests/test_torch_episode.py holds them."""
    land, route = big_world
    cfg = dataclasses.replace(small_cfg, agent=dataclasses.replace(small_cfg.agent,
                                                                   max_steps=STEPS))
    lib = j_train_library(jnp.asarray(land), route, cfg)
    pts, headings = oracle.resample_route(route, cfg.capture_spacing)
    rng = np.random.default_rng(0)
    starts = (pts[0][None, :] + rng.normal(0, 1.5, size=(B, 2))).astype(np.float32)
    thetas = (headings[0] + rng.normal(0, 0.15, size=(B,))).astype(np.float32)
    final_j, rec_j = j_make_navigate_batch(cfg, "jnp")(
        j_init_state(jnp.asarray(starts), jnp.asarray(thetas)), j_make_statics(land, lib, route))
    st = statics_from_numpy(land, lib, route, device="cpu")
    final, rec = make_navigate_batch(config_from(cfg), fam_impl, device="cpu")(
        init_state(starts, thetas, device="cpu"), st)
    np.testing.assert_array_equal(rec.k.numpy(), np.asarray(rec_j.k))
    np.testing.assert_allclose(rec.xy.numpy(), np.asarray(rec_j.xy), atol=1e-4)
    np.testing.assert_allclose(rec.fam.numpy(), np.asarray(rec_j.fam), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(final.status.numpy(), np.asarray(final_j.status))
    assert not bool(rec.done.any())  # every agent stepped every step
