"""The port's learned memory (``fam_impl="infomax"``) against the benchmark's
plain reference of it, ``benchmark/reference/infomax.py``, loaded by path,
on the CPU at the ``small_cfg`` sensor: the trained network, the novelty at
every lag, the headings of a facade episode, a network rounded to bfloat16
and the reference's own lower precisions against the same tolerances, and
the training's span and counters.

The reference draws its own initial weights (``infomax_seed``), trains its
own network on its own library and imports neither the port nor JAX."""

import dataclasses
import importlib.util
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from navdv_torch.convert import config_from
from navdv_torch.familiarity import pad_library
from navdv_torch.familiarity_infomax import (
    InfomaxPack,
    applied_updates,
    dose_schedule,
    infomax_counts,
    make_lib_min_infomax,
    reset_infomax_counts,
    train_infomax,
)
from navdv_torch.sensor import make_lag_stats, make_views_from_pooled
from navdv_torch.simulator import NavigationSimulator
from navdv_torch.training import train_library
from navdv_torch.utils import profiling

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
REFERENCE = BENCH / "reference" / "infomax.py"

# Both packages train W in float32, by expressions that round differently
# (the port's addr and fused add against the reference's plain outer product
# and sums). The dose multiplies W by e^3 to e^4 (eta / P per update in the
# directions no view constrains), and the recurrence carries each update's
# rounding on: after one epoch W differs by 4.5e-8 (relative, Frobenius),
# after the whole dose by 5.7e-6 at this size (6.8e-5 at config 1's, on the
# CPU). A network rounded to bfloat16 differs by 1.7e-3.
W_TOL = 1e-4
# Novelty, relative to it: the port folds the candidate's z-score into its
# fp64 product with W's per-unit sums taken in float32, and that sum's
# rounding, times mean / spread of the candidate's pixels, cancels into h;
# the reference z-scores directly in float64. From one network 1.2e-5 here,
# from the two networks of the dose 1.5e-5; from a network rounded to
# bfloat16 6.4e-3.
NOVELTY_TOL = 1e-4
# the most by which the reference's novelty at the port's heading may lie
# above its best, relative to the best: novelties within twice the error
# above of each other may rank either way
GAP_TOL = 2 * NOVELTY_TOL


def _load_reference():
    sys.path[:0] = [str(BENCH)]  # its navref and sector_ncc imports
    try:
        spec = importlib.util.spec_from_file_location("reference.infomax", REFERENCE)
        module = sys.modules[spec.name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        sys.path.remove(str(BENCH))
    return module


ref = _load_reference()


def _config(cfg) -> dict:
    """A benchmark configuration file's fields for the port's SimConfig."""
    d = dataclasses.asdict(cfg)
    return {"familiarity": "infomax", "sim": {k: d[k] for k in ("sensor", "scan", "agent")}}


@pytest.fixture(scope="module")
def world(small_cfg, small_world):
    """(port cfg, reference spec, landscape, route, port library, reference
    library, reference network)."""
    landscape, route = small_world
    cfg = config_from(small_cfg)
    land = torch.from_numpy(np.asarray(landscape, np.float32))
    spec = ref.spec_from_config(_config(cfg))
    lib = train_library(land, route, cfg, device="cpu")
    rlib = ref.train_library(land, route, cfg.capture_spacing, spec)
    return cfg, spec, land, route, lib, rlib, ref.network(rlib, spec)


def _rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def _poses(route, n, seed):
    rng = np.random.default_rng(seed)
    pts = np.asarray(route, np.float64)
    xy = pts[rng.integers(0, len(pts), n)] + rng.normal(0, 2.0, (n, 2))
    th = rng.uniform(-np.pi, np.pi, n)
    return torch.from_numpy(xy.astype(np.float32)), torch.from_numpy(th.astype(np.float32))


def _port_novelty(cfg, spec, lib, s, pack):
    """The port's scorer on the pooled panoramas ``s``: f64[N, Nh] from its
    candidates and lag statistics, as the step forms them."""
    s32 = s.float()
    views = make_views_from_pooled(cfg.sensor, spec.shifts(), "cpu")
    lag_sum, lag_sq = make_lag_stats(cfg.sensor, spec.shifts(), "cpu")(s32.double())
    score = make_lib_min_infomax(cfg.sensor, cfg.scan, cfg.capture_spacing)
    return score(views(s32), lib, lag_sum, lag_sq, pack).double()


def _novelty_err(cfg, spec, land, route, lib, rlib, w) -> float:
    xy, th = _poses(route, 48, seed=4)
    s = ref.candidate_panorama(land, xy, th, spec)
    want = ref.familiarity(s, rlib, spec)
    got = _port_novelty(cfg, spec, lib, s, InfomaxPack(w=w, wsum=w.sum(dim=1)))
    return float(((got - want).abs() / want).max())


def test_the_libraries_and_the_dose_are_the_ports(world):
    cfg, spec, _, _, lib, rlib, _ = world
    assert torch.equal(lib.views.double(), rlib)
    assert torch.equal(lib.z, ref.zscored(rlib))
    nl, p = lib.z.shape
    for epochs, spacing in [(0, cfg.capture_spacing), (0, 0.02), (0, 0.5 / (0.8 * p)), (3, 1.5)]:
        assert ref.dose(nl, p, epochs, spacing) == dose_schedule(nl, p, epochs, spacing)


def test_the_trained_network_agrees_with_the_reference(world):
    cfg, spec, _, _, lib, rlib, w_ref = world
    w0 = ref.initial_weights(spec.units, spec.n_pixels, spec.seed)
    one = train_infomax(lib, spec.units, spec.eta, 1, spec.seed, captured=False)
    assert _rel(one.w, ref.train(rlib, spec, cfg.capture_spacing, epochs=1)) <= 1e-6
    pack = train_infomax(lib, spec.units, spec.eta, 0, spec.seed, cfg.capture_spacing,
                         captured=False)
    assert _rel(pack.w, w_ref) <= W_TOL
    assert _rel(pack.w, w0) > 1.0  # it trained: W grew


def test_novelty_agrees_with_the_reference_at_every_lag(world):
    cfg, spec, land, route, lib, rlib, w_ref = world
    assert _novelty_err(cfg, spec, land, route, lib, rlib, w_ref) <= NOVELTY_TOL


def test_a_network_rounded_to_bfloat16_fails_the_tolerances(world):
    cfg, spec, land, route, lib, rlib, w_ref = world
    w16 = w_ref.bfloat16().float()
    assert _rel(w16, w_ref) > W_TOL
    assert _novelty_err(cfg, spec, land, route, lib, rlib, w16) > NOVELTY_TOL


def test_to_tf32_keeps_ten_mantissa_bits_rounding_to_nearest_even():
    x = torch.tensor([1 + 2**-11, 1 + 3 * 2**-11, -(1 + 2**-10 + 2**-12), 3.0, 0.0])
    want = torch.tensor([1.0, 1 + 2**-9, -(1 + 2**-10), 3.0, 0.0])
    assert torch.equal(ref.to_tf32(x), want)


@pytest.mark.parametrize("precision", ["float32", "tf32", "bf16_w"])
def test_the_references_precisions_against_its_float64(world, precision):
    """The reference's own W scored in float32 reads within the novelty
    tolerance of its float64 novelty: the tolerance, like the cell's limits,
    holds the novelty to float32 and cannot tell a float64 product from a
    float32 one. The product's inputs rounded to TF32, and a network trained
    rounded to bfloat16, read beyond it (3.8e-6, 3.9e-3 and 0.95 here)."""
    _, spec, land, route, _, rlib, _ = world
    xy, th = _poses(route, 48, seed=4)
    s = ref.candidate_panorama(land, xy, th, spec)
    want = ref.novelty(s, rlib, spec)
    err = float(((ref.novelty(s, rlib, spec, precision).double() - want).abs() / want).max())
    if precision == "float32":
        assert err <= NOVELTY_TOL
    else:
        assert err > NOVELTY_TOL


def test_a_facade_episode_takes_the_references_headings(world):
    cfg, spec, land, route, _, rlib, _ = world
    sim = NavigationSimulator(cfg, land, route, fam_impl="infomax", device="cpu").train()
    rng = np.random.default_rng(6)  # starts round the route's start, facing along it
    d = route[1] - route[0]
    xy0 = torch.from_numpy((route[0] + rng.normal(0, 1.5, (8, 2))).astype(np.float32))
    th0 = torch.from_numpy((np.arctan2(d[1], d[0]) + rng.normal(0, 0.15, 8)).astype(np.float32))
    out = sim.navigate(starts=xy0.numpy(), headings=th0.numpy())
    rec = out.record
    prev_xy = torch.cat([xy0[:, None], rec.xy[:, :-1]], dim=1)
    prev_th = torch.cat([th0[:, None], rec.theta[:, :-1]], dim=1)
    act = ~rec.done
    assert int(act.sum()) >= 8 * 10
    s = ref.candidate_panorama(land, prev_xy[act], prev_th[act], spec)
    f64 = ref.familiarity(s, rlib, spec)
    k = rec.k[act].long()
    at_k = f64.gather(1, k[:, None])[:, 0]
    best = f64.min(dim=1).values
    assert float(((at_k - best) / best).max()) <= GAP_TOL
    assert float(((rec.fam[act].double() - at_k).abs() / at_k).max()) <= NOVELTY_TOL


@pytest.mark.parametrize("captured", [True, False])
@pytest.mark.parametrize("padded", [False, True])
def test_the_training_is_counted_and_spanned(world, captured, padded):
    cfg, spec, _, _, lib, _, _ = world
    if padded:
        lib = pad_library(lib, 8)
        assert float(lib.valid.min()) == 0.0
    reset_infomax_counts()
    with profiling.recording() as rec:
        train_infomax(lib, spec.units, spec.eta, 0, spec.seed, cfg.capture_spacing,
                      captured=captured)
    counts = infomax_counts()
    updates = applied_updates(lib, 0, cfg.capture_spacing)
    assert counts == {"trainings": 1, "updates": updates}
    assert rec.totals()["infomax_train"]["calls"] == 1
    reset_infomax_counts()
    assert set(infomax_counts().values()) == {0}


def test_the_reference_imports_neither_the_port_nor_jax():
    code = ("import sys; sys.path[:0] = [sys.argv[1]]; import reference.infomax; "
            "bad = sorted({m.split('.')[0] for m in sys.modules} "
            "& {'navdv_torch', 'navdv_tpu', 'jax', 'jaxlib'}); print(bad); sys.exit(bool(bad))")
    p = subprocess.run([sys.executable, "-c", code, str(BENCH)], capture_output=True, text=True,
                       timeout=120)
    assert p.returncode == 0, p.stdout + p.stderr
