"""The port's multi-process entry (``navdv_torch.parallel.distributed``)
against the JAX package's ``tests/test_distributed.py`` and the
``init_distributed``/``global_mesh`` cases of ``tests/test_aux.py``.

Four gloo ranks on the CPU, started once for the module as torchrun would
start them (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``): each runs this file as ``python test_torch_distributed.py
child <dir>``, exercises ``init_distributed`` (and its no-op re-entry),
``global_mesh``, the MIN over the lib axis and over the data axis, and the
gather over the data axis, and writes what it saw; the tests assert it.
``launch_ranks`` is shared with ``tests/test_torch_parallel.py``.
"""

import datetime
import os
import socket
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT_S = 120  # each launch's limit; the jobs take a few seconds
GROUP_TIMEOUT = datetime.timedelta(seconds=60)  # a hung rank fails, not hangs
WORLD = 4


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch_ranks(script: str, world: int, out_dir: str) -> list[dict]:
    """Run ``script child out_dir`` once per rank with torchrun's variables
    and one thread each; every rank must exit 0 within RANK_TIMEOUT_S (all
    are killed otherwise). Returns each rank's ``rank<r>.pt``."""
    env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(free_port()),
               WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world), OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]))
    procs = [
        subprocess.Popen([sys.executable, script, "child", out_dir],
                         env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), cwd=REPO,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        pytest.fail(f"ranks timed out after {RANK_TIMEOUT_S} s; output so far: {outs}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{out}"
    # the ranks' own results (sweep results hold numpy arrays)
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def child(out_dir: str) -> None:
    """One rank's checks of the entry, written to ``rank<r>.pt``."""
    from navdv_torch.parallel import gather_data, global_mesh, init_distributed, make_mesh

    torch.set_num_threads(1)
    dev = init_distributed(device="cpu", timeout=GROUP_TIMEOUT)
    again = init_distributed(device="cpu")  # already initialized: a no-op
    rank, world = dist.get_rank(), dist.get_world_size()
    mesh = global_mesh(n_lib=2, device="cpu")
    out = {"device": str(dev), "again": str(again), "world": world, "backend": dist.get_backend(),
           "shape": dict(mesh.shape), "coords": (mesh.data_index, mesh.lib_index)}
    # the value of rank r is 7 r - 5: the MIN over lib pairs ranks within a
    # data row, the MIN over data pairs them across rows
    v = torch.tensor([7.0 * rank - 5.0, float(rank)])
    lib_min = v.clone()
    dist.all_reduce(lib_min, op=dist.ReduceOp.MIN, group=mesh.lib_group)
    data_min = v.clone()
    dist.all_reduce(data_min, op=dist.ReduceOp.MIN, group=mesh.data_group)
    out["lib_min"], out["data_min"] = lib_min, data_min
    # the gather: float, int and bool slices of this data row, in data order
    f = torch.arange(3, dtype=torch.float32) + 10.0 * mesh.data_index
    i = torch.full((3, 2), mesh.data_index, dtype=torch.int32)
    b = torch.tensor([mesh.data_index == 0, True, False])
    out["gathered"] = gather_data(mesh, [f, i, b])
    for bad in ((3, 1), (2, 3)):
        try:
            make_mesh(*bad, device="cpu")
        except ValueError as e:
            out[f"mesh_{bad[0]}x{bad[1]}"] = str(e)
    try:
        global_mesh(n_lib=3, device="cpu")
    except ValueError as e:
        out["global_mesh_3"] = str(e)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return launch_ranks(__file__, WORLD, str(tmp_path_factory.mktemp("ranks")))


def test_init_distributed_joins_from_launcher_env(ranks):
    assert [r["world"] for r in ranks] == [WORLD] * WORLD
    assert {r["backend"] for r in ranks} == {"gloo"}
    assert {r["device"] for r in ranks} == {r["again"] for r in ranks} == {"cpu"}


def test_global_mesh_lays_lib_innermost(ranks):
    assert all(r["shape"] == {"data": 2, "lib": 2} for r in ranks)
    assert [r["coords"] for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]


@pytest.mark.parametrize("axis", ["lib", "data"])
def test_min_over_each_axis(ranks, axis):
    """The system's one collective over the lib axis (ranks of a data row)
    and over the data axis (the axis that spans rows)."""
    vals = [7.0 * r - 5.0 for r in range(WORLD)]
    for rank, r in enumerate(ranks):
        d, lib = divmod(rank, 2)
        peers = [d * 2 + j for j in range(2)] if axis == "lib" else [j * 2 + lib for j in range(2)]
        want = torch.tensor([min(vals[p] for p in peers), float(min(peers))])
        assert torch.equal(r[f"{axis}_min"], want), (rank, r[f"{axis}_min"])


def test_gather_over_data_keeps_dtypes_and_order(ranks):
    for r in ranks:
        f, i, b = r["gathered"]
        assert torch.equal(f, torch.tensor([0.0, 1, 2, 10, 11, 12]))
        assert i.dtype == torch.int32 and torch.equal(i[:, 0], torch.tensor([0, 0, 0, 1, 1, 1],
                                                                            dtype=torch.int32))
        assert torch.equal(b, torch.tensor([True, True, False, False, True, False]))


def test_meshes_must_cover_every_rank(ranks):
    for r in ranks:
        assert "needs 3 ranks; the world has 4" in r["mesh_3x1"]
        assert "needs 6 ranks" in r["mesh_2x3"]
        assert "do not tile a lib axis of 3" in r["global_mesh_3"]


@pytest.fixture
def one_rank():
    """``init_distributed`` with no launcher: a group of one rank on a
    localhost port, destroyed afterwards."""
    from navdv_torch.parallel import init_distributed

    assert not dist.is_initialized()
    dev = init_distributed(device="cpu", timeout=GROUP_TIMEOUT)
    try:
        yield dev
    finally:
        dist.destroy_process_group()


def test_init_distributed_single_process(one_rank):
    from navdv_torch.parallel import global_mesh, init_distributed

    assert one_rank == torch.device("cpu")
    assert init_distributed(device="cpu") == one_rank  # a no-op re-entry
    assert dist.get_world_size() == 1
    mesh = global_mesh(n_lib=1, device="cpu")
    assert mesh.shape == {"data": 1, "lib": 1} and (mesh.data_index, mesh.lib_index) == (0, 0)
    with pytest.raises(ValueError, match="do not tile"):
        global_mesh(n_lib=2, device="cpu")


def test_init_distributed_raises_with_cluster_context(monkeypatch):
    """A failed initialization always raises; with a launcher's variable or
    explicit kwargs present, the error says so (carrying on alone would run
    the whole workload once per process)."""
    from navdv_torch.parallel import distributed

    for var in distributed._CLUSTER_ENV:
        monkeypatch.delenv(var, raising=False)

    def boom(**kw):
        raise ValueError("no coordinator")

    monkeypatch.setattr(dist, "init_process_group", boom)
    with pytest.raises(RuntimeError, match="one-rank process group"):
        distributed.init_distributed(device="cpu")
    monkeypatch.setenv("SLURM_JOB_NUM_NODES", "4")
    with pytest.raises(RuntimeError, match="cluster context"):
        distributed.init_distributed(device="cpu")
    monkeypatch.delenv("SLURM_JOB_NUM_NODES")
    with pytest.raises(RuntimeError, match="cluster context"):
        distributed.init_distributed(device="cpu", init_method="tcp://127.0.0.1:1")


def test_backend_is_never_switched_silently(monkeypatch):
    """``device=None`` is the card; NCCL needs a card per rank, so more
    ranks than cards raise naming gloo; the CPU runs gloo only."""
    from navdv_torch.parallel import distributed

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.init_distributed()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="backend='gloo'"):
        distributed.init_distributed()
    with pytest.raises(ValueError, match="use gloo"):
        distributed.init_distributed(device="cpu", backend="nccl")


def test_existing_group_backend_stands_for_none(one_rank, monkeypatch):
    """Re-entry with ``backend=None`` takes the group's backend: two local
    ranks sharing one card under an existing gloo group get the card, where
    forming a group would raise naming gloo."""
    from navdv_torch.parallel import distributed

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "set_device", lambda dev: None)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert dist.get_backend() == "gloo"
    assert distributed.init_distributed() == torch.device("cuda", 0)
    with pytest.raises(ValueError, match="use gloo"):
        distributed.init_distributed(device="cpu", backend="nccl")


def test_mesh_needs_a_process_group():
    from navdv_torch.parallel import global_mesh, make_mesh

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_distributed"):
        make_mesh(1, 1, device="cpu")
    with pytest.raises(RuntimeError, match="init_distributed"):
        global_mesh(device="cpu")


if __name__ == "__main__" and sys.argv[1] == "child":
    child(sys.argv[2])
