"""Multi-process entry (counterpart of the JAX package's
``parallel/distributed.py``): the process group and a mesh over every rank.

Run the same program once per rank, for example with torchrun::

    torchrun --nproc-per-node 4 my_sweep.py

    from navdv_torch.parallel import init_distributed, global_mesh
    device = init_distributed()     # one card per rank, NCCL
    mesh = global_mesh(n_lib=1)     # the data axis spans every rank

``shard_statics``, ``make_navigate_sharded`` and ``make_navigate_cells``
then work on any mesh; the step's library MIN and the gathers of results
are the only collectives.
"""

from __future__ import annotations

import datetime
import logging
import os
import socket
import subprocess
import time
from pathlib import Path

import torch
import torch.distributed as dist

from navdv_torch.device import resolve_device
from navdv_torch.parallel.mesh import Mesh, make_mesh

logger = logging.getLogger(__name__)

# environment variables whose presence means a launcher set this process up
# to join a cluster: a failure to initialize is then an outage, never the
# plain one-process case
_CLUSTER_ENV = (
    "MASTER_ADDR",
    "WORLD_SIZE",
    "TORCHELASTIC_RUN_ID",
    "SLURM_JOB_NUM_NODES",
    "OMPI_COMM_WORLD_SIZE",
)
INIT_TIMEOUT_S = 300.0  # init_process_group's default here, unless the caller passes one


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch_ranks(argv: list[str], world: int, log_dir, budget_s: float, cwd=None,
                 watch=None) -> None:
    """Run ``argv`` as ``world`` ranks on this host, as torchrun would start
    them (``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``, ``LOCAL_WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT`` on a free localhost port), rank r
    logging to ``log_dir/rank<r>.log``, and wait for every rank to exit 0.

    ``watch()``, if given, runs every 0.1 s while they run (to follow a
    log) and may return a line that says how far they got. Raises
    RuntimeError, after stopping every rank, as soon as one exits non-zero
    (naming it, with its log's tail) or when ``budget_s`` seconds run out
    (naming the budget and ``watch``'s last line)."""
    env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()),
               WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world))
    logs = [Path(log_dir) / f"rank{r}.log" for r in range(world)]
    procs, files = [], []
    seen = None
    try:
        for r, log in enumerate(logs):
            files.append(open(log, "w"))
            procs.append(subprocess.Popen(argv, env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                                          cwd=cwd, stdout=files[-1], stderr=subprocess.STDOUT))
        deadline = time.monotonic() + budget_s
        while True:
            if watch is not None:
                seen = watch() or seen
            codes = [p.poll() for p in procs]
            if all(c == 0 for c in codes):
                return
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if failed:
                r = failed[0]
                raise RuntimeError(f"rank {r} of {world} exited {codes[r]}; the tail of its "
                                   f"log:\n{logs[r].read_text()[-3000:]}")
            if time.monotonic() > deadline:
                raise RuntimeError(f"the {world} ranks exceeded their {budget_s:.0f}s budget; "
                                   f"last seen: {seen or 'nothing yet'}")
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in files:
            f.close()


def _rank_device(device, backend: str | None) -> tuple[torch.device, str]:
    """This rank's device and backend. ``device=None`` is the card of the
    rank's ``LOCAL_RANK``; NCCL needs a card per rank, so when the ranks on
    this host outnumber the cards ``backend=None`` raises (gloo shares a
    card: with ``backend="gloo"``, local rank r takes card r mod cards)."""
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    ranks_here = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ.get("WORLD_SIZE", "1")))
    if device is not None and resolve_device(device).type == "cpu":
        if backend not in (None, "gloo"):
            raise ValueError(f"backend={backend!r} does not run on the CPU; use gloo")
        return torch.device("cpu"), "gloo"
    resolve_device("cuda")  # raises without a card
    cards = torch.cuda.device_count()
    if backend is None:
        if ranks_here > cards:
            raise ValueError(
                f"{ranks_here} ranks on this host but {cards} card(s): NCCL needs a card "
                "per rank; pass backend='gloo' to let ranks share a card")
        backend = "nccl"
    dev = torch.device("cuda", local_rank % cards) if device is None else resolve_device(device)
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    torch.cuda.set_device(dev)
    return dev, backend


def init_distributed(device=None, backend: str | None = None, **kwargs) -> torch.device:
    """Join (or, alone, form) the default process group; returns this
    rank's device.

    A no-op, save for choosing the device, when the group exists; its
    backend then stands for ``backend=None``. Under a
    launcher (torchrun sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR``, ``MASTER_PORT``) the group comes from those variables;
    with none of them it is a group of one rank on a free localhost port,
    so :func:`global_mesh` works in one process. ``device=None`` is the card
    (``cuda:<LOCAL_RANK>``, NCCL); ``device="cpu"`` runs gloo. Backends are
    never switched silently: see ``_rank_device``. ``kwargs`` go to
    ``torch.distributed.init_process_group`` (``timeout`` defaults to
    ``INIT_TIMEOUT_S``). Every failure raises; with ``kwargs`` or a cluster
    variable present the error says so, since carrying on alone there would
    run the whole workload once per process.
    """
    if dist.is_initialized():
        logger.info("torch.distributed already initialized; skipping")
        return _rank_device(device, backend or dist.get_backend())[0]
    dev, backend = _rank_device(device, backend)
    cluster_env = [v for v in _CLUSTER_ENV if os.environ.get(v)]
    asked = sorted(kwargs)
    kwargs.setdefault("timeout", datetime.timedelta(seconds=INIT_TIMEOUT_S))
    if not (cluster_env or "init_method" in kwargs or "store" in kwargs):
        kwargs.update(init_method=f"tcp://localhost:{_free_port()}", rank=0, world_size=1)
    try:
        dist.init_process_group(backend=backend, **kwargs)
    except Exception as e:  # re-raised below, with what the caller asked for
        if asked or cluster_env:
            raise RuntimeError(
                f"process-group initialization failed with cluster context present "
                f"(kwargs={asked}, env={cluster_env})") from e
        raise RuntimeError("initialization of a one-rank process group on localhost failed") from e
    return dev


def global_mesh(n_lib: int = 1, device=None) -> Mesh:
    """A ``(world // n_lib, n_lib)`` mesh over every rank, the lib axis
    innermost (so a library group spans neighbouring ranks, the cards of one
    host first)."""
    if not dist.is_initialized():
        raise RuntimeError("global_mesh needs a process group: call init_distributed() first")
    world = dist.get_world_size()
    if world % n_lib != 0:  # not assert: must survive python -O
        raise ValueError(
            f"{world} ranks do not tile a lib axis of {n_lib}; every rank must take part")
    return make_mesh(world // n_lib, n_lib, device)
