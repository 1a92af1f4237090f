"""The port's parallel layer (``navdv_torch.parallel``) on the CPU: the cases
of the JAX package's ``tests/test_parallel.py``, the sharded cases of
``test_infomax.py``, ``test_analysis.py``, ``test_sweep.py`` and
``test_aux.py``, and the library-sharded early exit.

Two gloo jobs are started once for the module, as torchrun would start
them: 2 ranks (meshes (2, 1) and (1, 2)) and 4 ranks (meshes (2, 2) and
(1, 4)). Each rank runs this file as ``python test_torch_parallel.py child
<dir>`` on the small parity world with the JAX package's library carried
across, computes the port's unsharded episodes beside the sharded ones (so
both run with the same thread count), and writes what it saw; many small
tests assert it. Two references:

- the port's unsharded episode: the same ``k`` at every step, ``fam``
  within rtol 1e-12, and bit for bit where the sharded run makes the same
  arithmetic (the data axis; prepared against unprepared statics);
- JAX ``make_navigate_sharded`` (``"jnp"``) on the 8-device CPU mesh of
  ``tests/conftest.py`` at the same (n_data, n_lib): the tolerance the
  port's unsharded step holds against JAX (``tests/test_torch_episode.py``
  ``test_step_matches_jax``): the same first-step ``k`` and ``fam`` within
  rtol/atol 1e-4; over the closed loop the JAX test's band, success within
  0.25.
"""

import dataclasses
import json
import logging
import os
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from test_torch_distributed import GROUP_TIMEOUT, launch_ranks

B = 8  # agents, as tests/test_parallel.py
MESHES = {2: [(2, 1), (1, 2)], 4: [(2, 2), (1, 4)]}
IMPLS = ("kernel", "fft", "roll", "conv")
# the sector renderer's two branches of the fft step, each with its own
# sensor (the library is trained for it by the port on every rank)
SECTOR = {"unfused": dict(az_upsample=3), "fused": dict(az_upsample=1)}
FAM_RTOL = 1e-12  # sharded vs the port's unsharded episode (both fp64 distances)
JAX_TOL = 1e-4  # the port's unsharded step against JAX (test_step_matches_jax)


def _cfg_from_dict(d):
    from navdv_torch.config import AgentConfig, ScanConfig, SensorConfig, SimConfig

    return SimConfig(sensor=SensorConfig(**d["sensor"]), scan=ScanConfig(**d["scan"]),
                     agent=AgentConfig(**d["agent"]), capture_spacing=d["capture_spacing"])


def _episode(final, rec) -> dict:
    return {**{f"final_{k}": v for k, v in final._asdict().items()}, **rec._asdict()}


def _cell(res: dict) -> dict:
    """A sweep cell's aggregates, without its wall times."""
    return {k: v for k, v in res.items() if k not in ("wall_s", "warmup_s", "agent_steps_per_s")}


def _tiny_spec(**kw):
    from navdv_torch.sweep import SweepSpec

    base = dict(sensor_px=((24, 4, 3),), scan_granularity=((12, 2), (8, 3)),
                capture_spacing=(1.5, 2.0, 2.5, 3.0), n_trials=4, max_steps=16, lib_bucket=16)
    return SweepSpec(**{**base, **kw})


def child(out_dir: str) -> None:
    """One rank of a job: every sharded run and its unsharded reference."""
    from navdv_torch.agent import (
        AgentState,
        init_state,
        make_navigate_batch,
        make_statics,
        make_step_batched,
    )
    from navdv_torch.analysis import make_familiarity_probe
    from navdv_torch.familiarity import LibraryPack
    from navdv_torch.metrics import success_rate
    from navdv_torch.parallel import (
        collective_counts,
        init_distributed,
        make_mesh,
        make_navigate_cells,
        make_navigate_sharded,
        reset_collective_counts,
        shard_statics,
    )
    from navdv_torch.sweep import run_cell, run_sweep
    from navdv_torch.training import train_library

    torch.set_num_threads(1)
    init_distributed(device="cpu", timeout=GROUP_TIMEOUT)
    rank, world = dist.get_rank(), dist.get_world_size()
    with open(os.path.join(out_dir, "cfg.json")) as f:
        cfg = _cfg_from_dict(json.load(f))
    with np.load(os.path.join(out_dir, "inputs.npz")) as f:
        inp = {k: f[k] for k in f.files}
    land, route = inp["landscape"], inp["route"]
    lib = LibraryPack(*(torch.from_numpy(inp[f"lib_{k}"]) for k in LibraryPack._fields))
    st = make_statics(land, lib, route, device="cpu")
    states0 = init_state(inp["starts"], inp["thetas"], device="cpu")
    out = {"n_views": int(lib.views.shape[0])}

    def unsharded(impl, **kw):
        run = make_navigate_batch(cfg, impl, device="cpu", **kw)
        return run(states0, st)

    for impl in IMPLS:
        out[f"ref_{impl}"] = _episode(*unsharded(impl))
    if world == 2:  # the sweep cells' unsharded references
        out["cell_kernel_ref"] = _cell(run_cell(land, route, cfg, n_trials=B, seed=0,
                                                fam_impl="kernel", device="cpu"))
        out["cell_kernel4_ref"] = _cell(run_cell(land, route, cfg, n_trials=4, seed=0,
                                                 fam_impl="kernel", device="cpu"))
        out["cell_infomax_ref"] = _cell(run_cell(land, route, cfg, n_trials=4, seed=0,
                                                 fam_impl="infomax", recall_check_trials=4,
                                                 device="cpu"))
    for shape in MESHES[world]:
        mesh = make_mesh(*shape, device="cpu")
        tag = f"{shape[0]}x{shape[1]}"
        shard = shape[1] > 1
        st_m = shard_statics(st, mesh, shard_lib=shard)
        out[f"local_views_{tag}"] = int(st_m.lib.views.shape[0])
        out[f"local_valid_{tag}"] = st_m.lib.valid
        for impl in IMPLS:
            nav = make_navigate_sharded(cfg, mesh, impl, shard_lib=shard)
            reset_collective_counts()
            final, rec = nav(states0, st_m)
            out[f"pmin_{impl}_{tag}"] = collective_counts()["lib_pmin"]
            out[f"sharded_{impl}_{tag}"] = _episode(final, rec)
            if nav.prepare is not None:  # prepared once against prepared per call
                out[f"prepared_{impl}_{tag}"] = _episode(*nav(states0, st_m, nav.prepare(st_m)))
        if world == 4:
            continue
        if shape == (1, 2):
            # early exit: both ranks of the lib group stop at the same step
            reset_collective_counts()
            run = make_navigate_batch(cfg, "kernel", early_exit=True, device="cpu",
                                      lib_axis=mesh.lib_group)
            out["early_exit"] = _episode(*run(states0, st_m))
            out["early_exit_steps"] = collective_counts()["lib_pmin"]
            out["ref_early_exit"] = _episode(*unsharded("kernel", early_exit=True))
            try:
                make_navigate_sharded(cfg, mesh, "infomax", shard_lib=True)
            except ValueError as e:
                out["infomax_lib_error"] = str(e)
            # the lib-axis probe against the unsharded one
            xy, th = inp["probe_xy"], inp["probe_theta"]
            probe = make_familiarity_probe(cfg, "kernel", lib_axis=mesh.lib_group, device="cpu")
            out["probe_sharded"] = probe(xy, th, st_m)
            out["probe_ref"] = make_familiarity_probe(cfg, "kernel", device="cpu")(xy, th, st)
            # sweep cells spanning the mesh: the default path and infomax
            out["cell_kernel_1x2"] = _cell(run_cell(land, route, cfg, n_trials=B, seed=0,
                                                    fam_impl="kernel", mesh=mesh, device="cpu"))
            out["cell_infomax"] = _cell(run_cell(land, route, cfg, n_trials=4, seed=0,
                                                 fam_impl="infomax", mesh=mesh,
                                                 recall_check_trials=4))
            try:
                make_navigate_cells(cfg, mesh, "kernel")
            except ValueError as e:
                out["cells_lib_error"] = str(e)
            for name, sensor in SECTOR.items():
                c = dataclasses.replace(
                    cfg, sensor=dataclasses.replace(cfg.sensor, n_radial=8, n_azimuth=72,
                                                    render_mode="sector", **sensor),
                    scan=dataclasses.replace(cfg.scan, fused_dft_precision="default"))
                st_s = make_statics(land, train_library(land, route, c, device="cpu"), route,
                                    device="cpu")
                ref = make_navigate_batch(c, "fft", device="cpu")
                out[f"ref_sector_{name}"] = _episode(*ref(states0, st_s))
                out[f"fused_sector_{name}"] = make_step_batched(c, "fft", device="cpu").fam.fused
                reset_collective_counts()
                nav = make_navigate_sharded(c, mesh, "fft")
                out[f"sharded_sector_{name}"] = _episode(*nav(states0, shard_statics(st_s, mesh)))
                out[f"pmin_sector_{name}"] = collective_counts()["lib_pmin"]
        if shape == (2, 1):
            try:
                make_navigate_sharded(cfg, mesh, "kernel")(
                    AgentState(*(x[:3] for x in states0)), st_m)
            except ValueError as e:
                out["batch_error"] = str(e)
            # a sweep cell with its trials split over the data axis
            out["cell_kernel_2x1"] = _cell(run_cell(land, route, cfg, n_trials=B, seed=0,
                                                    fam_impl="kernel", mesh=mesh, device="cpu"))
            # data-parallel infomax: the network replicates, bit for bit
            nav = make_navigate_sharded(cfg, mesh, "infomax", shard_lib=False)
            out["infomax_dp"] = _episode(*nav(states0, st_m))
            out["ref_infomax"] = _episode(*unsharded("infomax"))
            _cells_child(out, cfg, mesh, land, lib, st, states0, make_navigate_cells)
            _sweep_child(out, out_dir, mesh, land, route, rank, run_sweep)
    out["success"] = float(success_rate(AgentState(*(
        out["ref_kernel"][f"final_{k}"] for k in AgentState._fields))))
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def _cells_child(out, cfg, mesh, land, lib, st, states0, make_navigate_cells):
    """make_navigate_cells on a (2, 1) mesh: its guards, 4 identical cells,
    and prepared against unprepared cells."""
    def stack(nt, n):
        return type(nt)(*(torch.stack([x] * n) for x in nt))

    shared = st._replace(lib=None)
    run = make_navigate_cells(cfg, mesh, "kernel")
    out["cells_kernel_prepare_is_none"] = run.prepare is None
    for n, sh, key in ((3, shared, "cells_multiple_error"), (4, st, "cells_shared_error")):
        try:
            run(stack(states0, n), stack(lib, n), sh)
        except ValueError as e:
            out[key] = str(e)
    out["cells_kernel"] = run(stack(states0, 4), stack(lib, 4), shared)
    run = make_navigate_cells(cfg, mesh, "fft")
    aux = run.prepare(stack(lib, 4), shared)
    out["cells_fft_aux_owned"] = [a is not None for a in aux]
    out["cells_fft_prepared"] = run(stack(states0, 4), stack(lib, 4), shared, aux)
    out["cells_fft"] = run(stack(states0, 4), stack(lib, 4), shared)


def _sweep_child(out, out_dir, mesh, land, route, rank, run_sweep):
    """Cells over the (2, 1) mesh against the serial sweep, resume,
    infomax cells and the singleton-group warning."""
    kw = dict(verbose=False, tensorboard=False, device="cpu")
    serial = run_sweep(land, route, _tiny_spec(), os.path.join(out_dir, f"serial_{rank}"), **kw)
    meshed_dir = os.path.join(out_dir, "meshed")
    meshed = run_sweep(land, route, _tiny_spec(), meshed_dir, cells_mesh=mesh, **kw)
    out["sweep_serial"], out["sweep_meshed"] = serial, meshed
    out["sweep_files"] = sorted(os.listdir(meshed_dir))
    victim = sorted(meshed)[1]
    if rank == 0:
        os.remove(os.path.join(meshed_dir, f"cell_{victim}.npz"))
    dist.barrier()
    out["sweep_resumed"] = run_sweep(land, route, _tiny_spec(), meshed_dir, cells_mesh=mesh, **kw)
    out["sweep_victim"] = victim
    ispec = _tiny_spec(scan_granularity=((12, 2),), capture_spacing=(1.5, 2.0))
    out["sweep_infomax_serial"] = run_sweep(land, route, ispec,
                                            os.path.join(out_dir, f"iserial_{rank}"),
                                            fam_impl="infomax", **kw)
    out["sweep_infomax_meshed"] = run_sweep(land, route, ispec, os.path.join(out_dir, "imeshed"),
                                            fam_impl="infomax", cells_mesh=mesh, **kw)
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logging.getLogger("navdv_torch.sweep").addHandler(handler)
    sspec = _tiny_spec(scan_granularity=((12, 2),), capture_spacing=(1.5, 2.0), lib_bucket=0,
                       max_steps=8)
    run_sweep(land, route, sspec, os.path.join(out_dir, "singleton"), cells_mesh=mesh, **kw)
    out["singleton_warnings"] = [r.getMessage() for r in records]


@pytest.fixture(scope="module")
def inputs(small_cfg, small_world, tmp_path_factory):
    """The small parity world, the JAX package's library and B noisy starts
    (numpy, seed 1, as tests/test_parallel.py), written for the ranks."""
    import jax.numpy as jnp

    from navdv_tpu import oracle
    from navdv_tpu.training import train_library as j_train_library

    landscape, route = small_world
    jlib = j_train_library(jnp.asarray(landscape), route, small_cfg)
    pts, headings = oracle.resample_route(route, small_cfg.capture_spacing)
    rng = np.random.default_rng(1)
    starts = (pts[0][None, :] + rng.normal(0, 1.0, size=(B, 2))).astype(np.float32)
    thetas = (headings[0] + rng.normal(0, 0.1, size=(B,))).astype(np.float32)
    arrays = dict(landscape=np.asarray(landscape, np.float32), route=np.asarray(route),
                  starts=starts, thetas=thetas,
                  probe_xy=np.asarray(pts, np.float32)[[1, 2, 5]],
                  probe_theta=(np.asarray(headings, np.float32)[[1, 2, 5]] + 0.05),
                  **{f"lib_{k}": np.asarray(getattr(jlib, k)) for k in jlib._fields})
    return small_cfg, jlib, arrays


def _job(world, inputs, tmp_path_factory):
    from navdv_torch.convert import config_from

    cfg, _, arrays = inputs
    d = str(tmp_path_factory.mktemp(f"world{world}"))
    np.savez(os.path.join(d, "inputs.npz"), **arrays)
    with open(os.path.join(d, "cfg.json"), "w") as f:
        json.dump(dataclasses.asdict(config_from(cfg)), f)
    return launch_ranks(__file__, world, d)


@pytest.fixture(scope="module")
def w2(inputs, tmp_path_factory):
    return _job(2, inputs, tmp_path_factory)


@pytest.fixture(scope="module")
def w4(inputs, tmp_path_factory):
    return _job(4, inputs, tmp_path_factory)


@pytest.fixture(scope="module")
def jax_sharded(inputs):
    """JAX make_navigate_sharded ("jnp") at every mesh of the two jobs."""
    import jax.numpy as jnp

    from navdv_tpu.agent import init_state, make_statics
    from navdv_tpu.parallel.mesh import make_mesh, make_navigate_sharded, shard_statics

    cfg, jlib, a = inputs
    st = make_statics(jnp.asarray(a["landscape"]), jlib, a["route"])
    s0 = init_state(jnp.asarray(a["starts"]), jnp.asarray(a["thetas"]))
    out = {}
    for shape in MESHES[2] + MESHES[4]:
        mesh = make_mesh(*shape)
        nav = make_navigate_sharded(cfg, mesh, "jnp", shard_lib=shape[1] > 1)
        final, rec = nav(s0, shard_statics(st, mesh, shard_lib=shape[1] > 1))
        out[shape] = {"k": np.asarray(rec.k), "fam": np.asarray(rec.fam),
                      "status": np.asarray(final.status)}
    return out


def _ranks(w2, w4, shape):
    return w2 if shape in MESHES[2] else w4


ALL_MESHES = MESHES[2] + MESHES[4]


def test_child_config_is_the_small_config(small_cfg):
    from navdv_torch.convert import config_from

    assert _cfg_from_dict(json.loads(json.dumps(dataclasses.asdict(config_from(small_cfg))))) \
        == config_from(small_cfg)


@pytest.mark.parametrize("shape", ALL_MESHES)
def test_every_rank_returns_the_same_global_result(w2, w4, shape):
    tag = f"{shape[0]}x{shape[1]}"
    ranks = _ranks(w2, w4, shape)
    for impl in IMPLS:
        want = ranks[0][f"sharded_{impl}_{tag}"]
        for r in ranks[1:]:
            for k, v in want.items():
                assert torch.equal(r[f"sharded_{impl}_{tag}"][k], v), (impl, k)
        assert want["k"].shape == (B, 48)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("shape", ALL_MESHES)
def test_sharded_matches_unsharded(w2, w4, shape, impl):
    """The same candidate at every step of the closed loop, familiarity
    within rtol 1e-12 and the same statuses; the data axis alone makes the
    same arithmetic per agent, so it is bit for bit."""
    tag = f"{shape[0]}x{shape[1]}"
    r = _ranks(w2, w4, shape)[0]
    got, want = r[f"sharded_{impl}_{tag}"], r[f"ref_{impl}"]
    assert torch.equal(got["k"], want["k"])
    assert torch.equal(got["final_status"], want["final_status"])
    assert torch.equal(got["done"], want["done"])
    np.testing.assert_allclose(got["fam"].numpy(), want["fam"].numpy(), rtol=FAM_RTOL, atol=0)
    if shape[1] == 1:
        for k in want:
            assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("shape", ALL_MESHES)
def test_sharded_matches_jax_sharded(w2, w4, jax_sharded, shape):
    """Against JAX make_navigate_sharded at the same mesh: the first step at
    the unsharded step's tolerance against JAX, the closed loop within the
    JAX test's band."""
    tag = f"{shape[0]}x{shape[1]}"
    got = _ranks(w2, w4, shape)[0][f"sharded_kernel_{tag}"]
    want = jax_sharded[shape]
    np.testing.assert_array_equal(got["k"][:, 0].numpy(), want["k"][:, 0])
    np.testing.assert_allclose(got["fam"][:, 0].numpy(), want["fam"][:, 0], rtol=JAX_TOL,
                               atol=JAX_TOL)
    got_rate = float((got["final_status"] == 1).float().mean())
    assert abs(got_rate - float(np.mean(want["status"] == 1))) <= 0.25


@pytest.mark.parametrize("impl", ("fft", "roll"))
@pytest.mark.parametrize("shape", ALL_MESHES)
def test_sharded_prepare_once_equivalence(w2, w4, shape, impl):
    """``run.prepare`` once against the constants built per call: the same
    computation on the same shard, bit for bit."""
    tag = f"{shape[0]}x{shape[1]}"
    r = _ranks(w2, w4, shape)[0]
    for k, v in r[f"sharded_{impl}_{tag}"].items():
        assert torch.equal(r[f"prepared_{impl}_{tag}"][k], v), k
    assert f"prepared_kernel_{tag}" not in r  # the kernel path has no prepare stage


@pytest.mark.parametrize("shape", ALL_MESHES)
def test_padded_shards_never_win(w2, w4, shape):
    """The library pads to a multiple of the lib axis with ``valid = 0``
    views; the last shard holds the padding, and the sharded minima equal
    the unsharded ones (tests above), so no padded view won."""
    tag = f"{shape[0]}x{shape[1]}"
    ranks = _ranks(w2, w4, shape)
    nl, n_lib = ranks[0]["n_views"], shape[1]
    per = -(-nl // n_lib) if n_lib > 1 else nl
    pad = per * n_lib - nl if n_lib > 1 else 0
    for rank, r in enumerate(ranks):
        assert r[f"local_views_{tag}"] == per
        valid = r[f"local_valid_{tag}"]
        want_pad = pad if rank % n_lib == n_lib - 1 else 0
        assert int((valid == 0).sum()) == want_pad
    assert pad > 0 or n_lib == 1 or nl % n_lib == 0


def test_a_padded_shard_is_exercised(w2, w4):
    nl = w2[0]["n_views"]
    assert any(nl % n_lib for n_lib in (2, 4)), f"{nl} views pad on no lib axis"


@pytest.mark.parametrize("shape", ALL_MESHES)
def test_one_min_collective_per_lib_sharded_step(w2, w4, shape):
    tag = f"{shape[0]}x{shape[1]}"
    for r in _ranks(w2, w4, shape):
        for impl in IMPLS:
            assert r[f"pmin_{impl}_{tag}"] == (48 if shape[1] > 1 else 0), impl


@pytest.mark.parametrize("n_lib", [2, 4])
def test_sharded_closed_loop_statistics(w2, w4, n_lib):
    """Full sharded episodes recall as the unsharded one does."""
    shape = (1, 2) if n_lib == 2 else (1, 4)
    r = _ranks(w2, w4, shape)[0]
    got = r[f"sharded_kernel_{shape[0]}x{shape[1]}"]
    assert float((got["final_status"] == 1).float().mean()) == r["success"]


def test_early_exit_ranks_stop_at_the_same_step(w2):
    """Library-sharded early exit: both ranks of the lib group issue one
    MIN per step they ran and stop at the step the unsharded loop stops at;
    a rank that stopped early would leave the other waiting."""
    steps = [r["early_exit_steps"] for r in w2]
    ref = w2[0]["ref_early_exit"]
    want = int((~ref["done"]).sum(dim=1).max())
    assert steps == [want, want] and want < 48
    for r in w2:
        for k, v in ref.items():
            if k == "fam":
                np.testing.assert_allclose(r["early_exit"][k].numpy(), v.numpy(), rtol=FAM_RTOL)
            else:
                assert torch.equal(r["early_exit"][k], v), k


@pytest.mark.parametrize("branch", sorted(SECTOR))
def test_sharded_sector_branches(w2, branch):
    """The sector renderer's fft step (its MIN before the window pool, for
    the unfused and the fused front end) on the (1, 2) mesh against the
    unsharded step."""
    for r in w2:
        got, want = r[f"sharded_sector_{branch}"], r[f"ref_sector_{branch}"]
        assert r[f"fused_sector_{branch}"] == (branch == "fused")
        assert torch.equal(got["k"], want["k"])
        assert torch.equal(got["final_status"], want["final_status"])
        np.testing.assert_allclose(got["fam"].numpy(), want["fam"].numpy(), rtol=FAM_RTOL, atol=0)
        assert r[f"pmin_sector_{branch}"] == 48


def test_infomax_cannot_shard_the_library(w2):
    assert "infomax" in w2[0]["infomax_lib_error"]
    assert "shard_lib=False" in w2[0]["infomax_lib_error"]


def test_infomax_data_parallel_matches_unsharded(w2):
    """shard_lib=False: the network trains on every rank from the whole
    library and every agent's episode equals the unsharded one."""
    for r in w2:
        for k in ("final_xy", "final_status", "k"):
            assert torch.equal(r["infomax_dp"][k], r["ref_infomax"][k]), k


def test_probe_lib_axis_min(w2):
    """A lib-axis probe on each rank's shard (per-shard minima + the MIN)
    equals the unsharded probe."""
    for r in w2:
        np.testing.assert_allclose(r["probe_sharded"].numpy(), r["probe_ref"].numpy(),
                                   rtol=FAM_RTOL, atol=0)
        assert r["probe_sharded"].shape == (3, 12)


def _assert_cells_equal(got: dict, want: dict, skip=()):
    assert set(got) == set(want)
    for k in want:
        if k not in skip:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("tag", ["2x1", "1x2"])
def test_sweep_cell_on_mesh(w2, tag):
    """One cell spanning the mesh (its trials split over the data axis, or
    its library over the lib axis) against the same cell in one process:
    every aggregate equal, and the library recorded padded to the lib axis."""
    want = w2[0]["cell_kernel_ref"]
    for r in w2:
        c = r[f"cell_kernel_{tag}"]
        _assert_cells_equal(c, want, skip=("n_library_padded",))
        assert int(c["status_counts"].sum()) == B
        nl, n_lib = int(c["n_library_views"]), int(tag[-1])
        assert int(c["n_library_padded"]) == -(-nl // n_lib) * n_lib


@pytest.fixture(scope="module")
def jax_cells(inputs):
    """JAX run_cell ("jnp") on the 8-device CPU mesh at the (2, 1) and (1, 2)
    meshes of the 2-rank job, on the same world, trials and seed."""
    from navdv_tpu.parallel.mesh import make_mesh
    from navdv_tpu.sweep import run_cell

    cfg, _, a = inputs
    return {f"{nd}x{nl}": run_cell(a["landscape"], a["route"], cfg, n_trials=B, seed=0,
                                   fam_impl="jnp", mesh=make_mesh(nd, nl))
            for nd, nl in MESHES[2]}


@pytest.mark.parametrize("tag", ["2x1", "1x2"])
def test_sweep_cell_on_mesh_matches_jax(w2, jax_cells, tag):
    """The port's mesh cell against JAX run_cell on the same mesh, at the
    tolerance the port's sweep holds against JAX's (test_torch_sweep.py
    ``test_sweep_matches_jax_sweep``): the same success, statuses and
    library sizes, mean path error within 1e-4."""
    got, want = w2[0][f"cell_kernel_{tag}"], jax_cells[tag]
    for name in ("success_rate", "status_counts", "n_library_views", "n_library_padded",
                 "n_trials"):
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    np.testing.assert_allclose(got["mean_path_error"], want["mean_path_error"], atol=1e-4)


def test_run_cell_infomax_on_lib_sharded_mesh(w2):
    """An infomax cell on a mesh with a lib axis replicates its library
    instead of failing: every aggregate equals the cell in one process, and
    its kernel recall check, run on the unsharded statics, equals the kernel
    cell of the same first 4 trials."""
    want = w2[0]["cell_infomax_ref"]
    for r in w2:
        c = r["cell_infomax"]
        _assert_cells_equal(c, want)
        assert int(c["n_library_padded"]) == int(c["n_library_views"])
        assert int(c["status_counts"].sum()) == 4
        assert float(c["success_rate_jnp"]) == float(r["cell_kernel4_ref"]["success_rate"])


def test_navigate_cells_rejects_misuse(w2):
    r = w2[0]
    assert "lib=1" in r["cells_lib_error"]
    assert "multiple" in r["cells_multiple_error"]
    assert "lib=None" in r["cells_shared_error"]
    assert r["cells_kernel_prepare_is_none"]


def test_navigate_cells_identical_cells_agree(w2):
    for r in w2:
        sr = r["cells_kernel"]["success_rate"]
        assert sr.shape == (4,) and bool((sr == sr[0]).all())
        assert float(sr[0]) == r["success"]
        assert r["cells_kernel"]["status_counts"].shape == (4, 4)
        assert torch.equal(r["cells_kernel"]["status_counts"].sum(dim=1), torch.full((4,), B))


def test_navigate_cells_prepare_parity(w2):
    """Each rank prepares only its own cells; prepared and unprepared runs
    are the same computation."""
    assert w2[0]["cells_fft_aux_owned"] == [True, True, False, False]
    assert w2[1]["cells_fft_aux_owned"] == [False, False, True, True]
    for r in w2:
        for k, v in r["cells_fft"].items():
            assert torch.equal(r["cells_fft_prepared"][k], v), k


def test_sweep_cells_over_mesh_matches_serial(w2):
    """The 8-cell grid with cells over the (2, 1) mesh: per-cell results
    equal the serial sweep's, groups are the cells that share a navigate
    function and a library shape, and rank 0 wrote every file once."""
    for r in w2:
        serial, meshed = r["sweep_serial"], r["sweep_meshed"]
        assert set(serial) == set(meshed) and len(serial) == 8
        for k in serial:
            np.testing.assert_array_equal(serial[k]["success_rate"], meshed[k]["success_rate"])
            np.testing.assert_allclose(serial[k]["mean_path_error"],
                                       meshed[k]["mean_path_error"], rtol=1e-5, err_msg=k)
            want_group = sum(
                1 for j in meshed
                if meshed[j]["ax_scan"] == meshed[k]["ax_scan"]
                and int(meshed[j]["n_library_padded"]) == int(meshed[k]["n_library_padded"]))
            assert int(meshed[k]["group_size"]) == want_group, k
        assert max(int(v["group_size"]) for v in meshed.values()) >= 3
    assert w2[0]["sweep_files"] == sorted([f"cell_{k}.npz" for k in w2[0]["sweep_meshed"]]
                                          + ["summary.json"])


def test_sweep_cells_over_mesh_resume(w2):
    """A deleted cell file is recomputed on every rank; the others resume
    from the files, which rank 0 wrote (with its own wall times)."""
    written = w2[0]["sweep_meshed"]
    for r in w2:
        first, second, victim = r["sweep_meshed"], r["sweep_resumed"], r["sweep_victim"]
        assert set(second) == set(first)
        np.testing.assert_array_equal(first[victim]["success_rate"],
                                      second[victim]["success_rate"])
        assert "group_size" in second[victim]  # recomputed in cells mode
        others = [k for k in first if k != victim]
        assert all(float(second[k]["wall_s"]) == float(written[k]["wall_s"]) for k in others)


def test_sweep_cells_over_mesh_infomax(w2):
    for r in w2:
        serial, meshed = r["sweep_infomax_serial"], r["sweep_infomax_meshed"]
        assert set(serial) == set(meshed) and len(serial) == 2
        for k in serial:
            np.testing.assert_array_equal(serial[k]["success_rate"], meshed[k]["success_rate"])


def test_sweep_cells_over_mesh_warns_on_singleton_groups(w2):
    assert any("lib_bucket" in m for m in w2[0]["singleton_warnings"])


@pytest.fixture
def one_rank():
    from navdv_torch.parallel import init_distributed

    assert not dist.is_initialized()
    init_distributed(device="cpu", timeout=GROUP_TIMEOUT)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_one_rank_mesh_runs_the_unsharded_episode(one_rank, small_cfg, small_world):
    """A (1, 1) mesh in one process: the sharded entry is the unsharded
    episode, bit for bit, and issues no collective in the step."""
    from navdv_torch import train_library
    from navdv_torch.agent import init_state, make_navigate_batch, make_statics
    from navdv_torch.convert import config_from
    from navdv_torch.parallel import (
        collective_counts,
        make_mesh,
        make_navigate_sharded,
        reset_collective_counts,
        shard_statics,
    )

    land, route = small_world
    cfg = dataclasses.replace(config_from(small_cfg), agent=dataclasses.replace(
        config_from(small_cfg).agent, max_steps=8))
    st = make_statics(land, train_library(land, route, cfg, device="cpu"), route, device="cpu")
    s0 = init_state(np.zeros((2, 2)) + 64.0, np.zeros(2), device="cpu")
    mesh = make_mesh(1, 1, device="cpu")
    reset_collective_counts()
    final, rec = make_navigate_sharded(cfg, mesh, "kernel")(s0, shard_statics(st, mesh))
    want_final, want_rec = make_navigate_batch(cfg, "kernel", device="cpu")(s0, st)
    assert collective_counts() == {"lib_pmin": 0}
    for a, b in zip(final + rec, want_final + want_rec):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="no prepare stage"):
        make_navigate_sharded(cfg, mesh, "kernel")(s0, st, aux=())


def test_batch_must_tile_the_data_axis(w2):
    assert "batch 3 must be a multiple of the data-axis size 2" in w2[0]["batch_error"]


if __name__ == "__main__" and sys.argv[1] == "child":
    child(sys.argv[2])
