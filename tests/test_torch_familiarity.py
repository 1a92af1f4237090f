"""The port's min-distance module against float64 NumPy and the JAX Pallas
familiarity kernel (interpret mode) on the CPU, where the wrapper runs its
plain PyTorch version; the CUDA kernel itself runs only on the card
(tests/test_torch_cuda.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import navdv_torch.config as tc
from navdv_torch.convert import config_from, library_from_numpy
from navdv_torch.familiarity import pad_library as t_pad_library
from navdv_torch.ops.familiarity import make_familiarity_batched, min_distance_rows
from navdv_tpu.config import ScanConfig, SensorConfig, SimConfig
from navdv_tpu.familiarity import make_familiarity_jnp, pack_library
from navdv_tpu.ops.familiarity_pallas import make_familiarity_batched_pallas
from navdv_tpu.ops.familiarity_pallas import min_distance_rows as j_min_distance_rows
from navdv_tpu.parallel.mesh import pad_library as j_pad_library


@pytest.mark.parametrize(
    "rows,nl,p,with_rowsq",
    [(64, 27, 96, True), (512, 128, 1152, True), (130, 200, 300, False)],
)
def test_min_distance_rows_matches_float64_and_pallas(rows, nl, p, with_rowsq):
    rng = np.random.default_rng(0)
    a = rng.uniform(size=(rows, p)).astype(np.float32)
    b = rng.uniform(size=(nl, p)).astype(np.float32)
    gamma = rng.uniform(size=(nl,)).astype(np.float32)
    alpha = -2.0
    got = min_distance_rows(torch.from_numpy(a), torch.from_numpy(b),
                            torch.from_numpy(gamma), alpha, with_rowsq).numpy()
    a64 = a.astype(np.float64)
    beta = (a64 * a64).sum(axis=1) if with_rowsq else np.ones(rows)
    want = (alpha * a64 @ b.astype(np.float64).T + beta[:, None] + gamma[None, :]).min(axis=1)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-3)
    want_p = np.asarray(j_min_distance_rows(jnp.asarray(a), jnp.asarray(b), jnp.asarray(gamma),
                                            alpha, with_rowsq, interpret=True))
    np.testing.assert_allclose(got, want_p, rtol=2e-4, atol=2e-3)


@pytest.mark.parametrize("metric", ["ssd", "ncc"])
@pytest.mark.parametrize("tol_bins", [0, 1, 2])
def test_familiarity_batched_matches_jax(metric, tol_bins):
    rng = np.random.default_rng(1)
    sensor = SensorConfig(n_radial=4, n_azimuth=24, az_upsample=3)
    scan = ScanConfig(n_headings=10, scan_step_bins=2, metric=metric, tol_bins=tol_bins)
    b, p = 6, sensor.n_pixels
    ne = scan.n_headings * (2 * tol_bins + 1)
    cand = rng.uniform(size=(b, ne, p)).astype(np.float32)
    views = rng.uniform(size=(17, sensor.n_radial, sensor.n_azimuth)).astype(np.float32)
    jlib = pack_library(jnp.asarray(views))
    want_p = np.asarray(make_familiarity_batched_pallas(sensor, scan, interpret=True)(
        jnp.asarray(cand), jlib))
    want_j = np.asarray(jax.vmap(make_familiarity_jnp(sensor, scan), in_axes=(0, None))(
        jnp.asarray(cand), jlib))
    pcfg = config_from(SimConfig(sensor=sensor, scan=scan))
    got = make_familiarity_batched(pcfg.sensor, pcfg.scan)(
        torch.from_numpy(cand), library_from_numpy(jlib, device="cpu")).numpy()
    assert got.shape == (b, scan.n_headings)
    np.testing.assert_allclose(got, want_p, rtol=2e-4, atol=2e-3)
    np.testing.assert_allclose(got, want_j, rtol=2e-4, atol=2e-3)


def test_padding_never_wins():
    """Padded (invalid) library entries never win the min, and the port's
    padding matches the JAX package's."""
    rng = np.random.default_rng(2)
    sensor = tc.SensorConfig(n_radial=4, n_azimuth=24, az_upsample=3)
    cand = torch.from_numpy(rng.uniform(size=(2, 10, sensor.n_pixels)).astype(np.float32))
    views = rng.uniform(size=(5, 4, 24)).astype(np.float32)
    lib = library_from_numpy(views, device="cpu")
    padded = t_pad_library(lib, 8)
    jpadded = j_pad_library(pack_library(jnp.asarray(views)), 8)
    for name, t in zip(padded._fields, padded):
        np.testing.assert_allclose(t.numpy(), np.asarray(getattr(jpadded, name)), atol=1e-6)
    for metric in ("ssd", "ncc"):
        sc = tc.ScanConfig(n_headings=10, scan_step_bins=2, metric=metric)
        fam = make_familiarity_batched(sensor, sc)
        np.testing.assert_allclose(fam(cand, padded).numpy(), fam(cand, lib).numpy(), rtol=1e-5)
