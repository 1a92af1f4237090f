"""Parallelism over ranks (counterpart of the JAX package's
``parallel/mesh.py``).

The JAX package lays its devices out on a mesh with two axes:

- ``data``: agents (trials) split over ranks, with no collective;
- ``lib``: the view library split over ranks; each shard's per-lag partial
  minima are combined inside every step by ``all_reduce(MIN)``
  (:func:`navdv_torch.agent.lib_pmin`, the JAX ``lax.pmin``), the
  system's one collective;

and it spreads sweep cells over the data axis (:func:`make_navigate_cells`).

JAX runs one controller that sees every device; PyTorch runs one process
per rank. The port keeps JAX's calling convention: every rank calls the
same function with the same global ``states0`` and statics, computes its
own part, and returns the global result, gathered over ``data`` by one
``broadcast`` per data rank into a preallocated buffer. On device tensors
the port uses only ``all_reduce`` and ``broadcast``, the two collectives
gloo supports on CUDA tensors, so ranks sharing one card (gloo) run the
same code as ranks with a card each (NCCL).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from navdv_torch.agent import (
    AgentState,
    EpisodeStatics,
    StepRecord,
    lib_pmin,
    make_navigate_batch,
    resolve_fam_impl,
)
from navdv_torch.config import SimConfig
from navdv_torch.device import resolve_device
from navdv_torch.familiarity import LibraryPack, pad_library
from navdv_torch.metrics import episode_metrics
from navdv_torch.utils.profiling import span

DATA_AXIS = "data"
LIB_AXIS = "lib"

__all__ = [
    "DATA_AXIS",
    "LIB_AXIS",
    "Mesh",
    "collective_counts",
    "gather_data",
    "make_mesh",
    "make_navigate_cells",
    "make_navigate_sharded",
    "pad_library",
    "reset_collective_counts",
    "shard_statics",
]


def collective_counts() -> dict[str, int]:
    """The step's library MINs (:func:`navdv_torch.agent.lib_pmin`) issued
    by this rank since the last reset, counted as ``ops.launch_counts``
    counts kernel launches: one per lib-sharded step."""
    return {"lib_pmin": lib_pmin.calls}


def reset_collective_counts() -> None:
    lib_pmin.calls = 0


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A (data, lib) grid of ranks, as this rank sees it.

    ``shape`` is ``{"data": n_data, "lib": n_lib}`` (the JAX ``Mesh.shape``).
    Rank r sits at ``(r // n_lib, r % n_lib)``: the lib axis is innermost.
    ``data_group`` holds the ranks that share this rank's lib coordinate (the
    gather over agents runs on it), ``lib_group`` those that share its data
    coordinate (the step's MIN runs on it). ``device`` is this rank's device.
    Meshes compare and hash by identity.
    """

    shape: dict
    data_index: int
    lib_index: int
    data_group: dist.ProcessGroup
    lib_group: dist.ProcessGroup
    device: torch.device

    def rank_of(self, data_index: int, lib_index: int) -> int:
        """The global rank at mesh coordinates (data_index, lib_index)."""
        return data_index * self.shape[LIB_AXIS] + lib_index


def make_mesh(n_data: int, n_lib: int = 1, device=None) -> Mesh:
    """This rank's place on an ``(n_data, n_lib)`` mesh over every rank of
    the default process group (:func:`navdv_torch.parallel.init_distributed`).

    Unlike the JAX version, which takes the first ``n_data * n_lib`` devices
    and leaves the rest idle, a multi-process program cannot leave a rank
    out: ``n_data * n_lib`` must equal the world size, or ValueError.
    ``device=None`` means this rank's current card; ``"cpu"`` runs on the
    CPU (gloo). Every rank must call it, in the same order: the subgroups
    are built collectively.
    """
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs a process group: call navdv_torch.parallel.init_distributed() first")
    world = dist.get_world_size()
    if n_data < 1 or n_lib < 1 or n_data * n_lib != world:
        raise ValueError(
            f"a ({n_data}, {n_lib}) mesh needs {n_data * n_lib} ranks; the world has {world} "
            "(every rank must take part)")
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        # the device mesh picks a card only for a process whose CUDA state
        # is not initialized yet; this rank's card is chosen here
        torch.cuda.set_device(dev)
        torch.cuda.init()
    dm = init_device_mesh(dev.type, (n_data, n_lib), mesh_dim_names=(DATA_AXIS, LIB_AXIS))
    d, l = dm.get_coordinate()
    return Mesh(
        shape={DATA_AXIS: n_data, LIB_AXIS: n_lib},
        data_index=d,
        lib_index=l,
        data_group=dm.get_group(DATA_AXIS),
        lib_group=dm.get_group(LIB_AXIS),
        device=dev,
    )


def gather_data(mesh: Mesh, tensors) -> list[torch.Tensor]:
    """Each rank's ``[b, ...]`` tensors -> the global ``[n_data * b, ...]``
    ones in data order, on every rank. The tensors' bytes are packed into one
    row of a preallocated ``[n_data, bytes]`` buffer, and row j is broadcast
    from data rank j over the data group: bool, int and float tensors take
    the same path, one broadcast per data rank."""
    n = mesh.shape[DATA_AXIS]
    if n == 1:
        return list(tensors)
    flat = [t.contiguous().view(torch.uint8).reshape(-1) for t in tensors]
    sizes = [f.numel() for f in flat]
    buf = torch.empty((n, sum(sizes)), dtype=torch.uint8, device=mesh.device)
    buf[mesh.data_index] = torch.cat(flat)
    for j in range(n):
        dist.broadcast(buf[j], src=mesh.rank_of(j, mesh.lib_index), group=mesh.data_group)
    out, off = [], 0
    for t, size in zip(tensors, sizes):
        part = buf[:, off:off + size].contiguous().view(t.dtype)
        out.append(part.reshape((n * t.shape[0],) + tuple(t.shape[1:])))
        off += size
    return out


def shard_statics(st: EpisodeStatics, mesh: Mesh, shard_lib: bool = True) -> EpisodeStatics:
    """This rank's statics on its device: with ``shard_lib`` the library
    padded to a multiple of the lib axis (padded views carry ``valid = 0``,
    so they never win a minimum) and sliced at this rank's lib coordinate;
    the landscape and route constants whole on every rank."""
    lib = st.lib
    if shard_lib:
        n_lib = mesh.shape[LIB_AXIS]
        lib = pad_library(lib, n_lib)
        per = lib.views.shape[0] // n_lib
        lo = mesh.lib_index * per
        lib = LibraryPack(*(x[lo:lo + per] for x in lib))
    dev = mesh.device
    return EpisodeStatics(
        landscape=st.landscape.to(dev),
        lib=LibraryPack(*(x.to(dev).contiguous() for x in lib)),
        route_a=st.route_a.to(dev),
        route_ab=st.route_ab.to(dev),
        route_denom=st.route_denom.to(dev),
        goal=st.goal.to(dev),
    )


def make_navigate_sharded(cfg: SimConfig, mesh: Mesh, fam_impl: str = "kernel",
                          shard_lib: bool = True):
    """The batched episode over the mesh: ``run(states0[B], st, aux=None) ->
    (final[B], StepRecord[B, T])``, the same global result on every rank.

    Agents are split over the data axis (B must be a multiple of its size).
    With ``shard_lib`` and a lib axis above 1, ``st`` is this rank's library
    shard (:func:`shard_statics`) and the step combines the shards' minima
    by ``all_reduce(MIN)`` over the lib group. ``run.prepare(st)`` builds
    this rank's per-library constants once (None for paths with no prepare
    stage), as :func:`navdv_torch.agent.make_navigate_batch` does.
    ``"infomax"`` cannot shard the library: with ``shard_lib=False`` every
    rank trains the network from the whole library.

    This rank's slice runs through :func:`navdv_torch.agent.make_navigate_batch`,
    captured as CUDA graphs on the card when the episode holds no collective
    (a data mesh) or the lib group's backend is NCCL, whose ``all_reduce``
    is captured with the step after the warm-up has run it. A lib group on
    gloo runs the eager episode (``make_navigate_batch_fn``): its
    collectives are host operations. This is decided from the group's
    backend when the run is built, and ``run.captured`` shows it. The data
    gather runs after the episode, outside any graph; the span ``episode``
    (:mod:`navdv_torch.utils.profiling`) holds both. Free the runs and
    probes built on an NCCL lib group (the probe cache keeps probes:
    ``analysis._make_familiarity_probe.cache_clear()``) before
    ``destroy_process_group``: while a CUDA graph that holds one of the
    group's collectives is alive, the teardown hangs.
    """
    fam_impl = resolve_fam_impl(cfg, fam_impl)
    lib_axis = mesh.lib_group if shard_lib and mesh.shape[LIB_AXIS] > 1 else None
    if fam_impl == "infomax" and lib_axis is not None:
        raise ValueError(
            "fam_impl='infomax' cannot shard the library axis: the Infomax "
            "network trains sequentially over ALL library views, so a "
            "per-shard prepare would silently train on a fraction of them. "
            "Use shard_lib=False (the learned memory is O(units x pixels), "
            "constant in library size — sharding it buys nothing)."
        )
    nav = make_navigate_batch(cfg, fam_impl, device=mesh.device, lib_axis=lib_axis)
    n_data = mesh.shape[DATA_AXIS]

    def run(states0: AgentState, st: EpisodeStatics, aux=None):
        if aux is not None and nav.prepare is None:
            raise ValueError(f"fam_impl={fam_impl!r} has no prepare stage; got aux")
        b = states0.theta.shape[0]
        if b % n_data:
            raise ValueError(f"batch {b} must be a multiple of the data-axis size {n_data}")
        with span("episode"):
            bl = b // n_data
            lo = mesh.data_index * bl
            local = AgentState(*(x[lo:lo + bl].to(mesh.device) for x in states0))
            final, rec = nav(local, st, aux)
            out = gather_data(mesh, [*final, *rec])
        return AgentState(*out[:len(final)]), StepRecord(*out[len(final):])

    run.prepare, run.captured, run.release = nav.prepare, nav.captured, nav.release
    return run


def make_navigate_cells(cfg: SimConfig, mesh: Mesh, fam_impl: str = "kernel",
                        early_exit: bool = True):
    """Sweep cells spread over the data axis: ``run(states0 [C, B, ...],
    lib_stack [C, Nl, ...], shared, aux_stack=None) -> {name: [C] or [C, 4]}``.

    The cells of one group share a configuration and a library shape; each
    has its own library and trials. ``shared`` is an
    :class:`~navdv_torch.agent.EpisodeStatics` with ``lib=None``. Each rank
    runs its C / n_data cells one after another (JAX vmaps them; the
    computation per cell is the same), each as one batched episode, reduces
    every cell on the device to the aggregates of the JAX version
    (success_rate, mean_steps, mean_path_error, max_path_error,
    executed_steps, status_counts), and these are gathered over ``data``.
    C must be a multiple of the data-axis size; the sweep runner pads with
    repeated cells.

    ``run.prepare(lib_stack, shared)`` builds the cells' per-library
    constants once (fft/roll spectra, the infomax training): a list over the
    C cells, holding this rank's cells' constants and None for the others.
    It is None for paths with no prepare stage.

    The mesh must have a lib axis of 1: within-cell library sharding belongs
    to :func:`make_navigate_sharded`. Each cell's episode holds no
    collective, so on the card it replays captured CUDA graphs
    (``run.captured``; :func:`navdv_torch.agent.make_navigate_batch`).
    """
    if mesh.shape[LIB_AXIS] != 1:
        raise ValueError(
            f"make_navigate_cells wants a (data, lib=1) mesh; got lib axis "
            f"size {mesh.shape[LIB_AXIS]} — use make_navigate_sharded for "
            f"within-cell library sharding"
        )
    n_data = mesh.shape[DATA_AXIS]
    dev = mesh.device
    nav = make_navigate_batch(cfg, fam_impl, early_exit=early_exit, device=dev)
    lib_prepare = nav.prepare

    def _shared(shared: EpisodeStatics) -> EpisodeStatics:
        if shared.lib is not None:
            raise ValueError("shared statics must carry lib=None; the "
                             "library stack is the per-cell argument")
        return EpisodeStatics(*(None if x is None else x.to(dev) for x in shared))

    def _own_cells(c: int) -> range:
        if c % n_data:
            raise ValueError(
                f"cell count {c} must be a multiple of the data-axis size "
                f"{n_data} (pad by repeating cells)"
            )
        per = c // n_data
        return range(mesh.data_index * per, (mesh.data_index + 1) * per)

    def _cell_lib(lib_stack: LibraryPack, i: int) -> LibraryPack:
        return LibraryPack(*(x[i].to(dev) for x in lib_stack))

    def _one(st: EpisodeStatics, s0: AgentState, aux) -> dict:
        final, rec = nav(s0, st, aux)
        m = episode_metrics(final, rec)
        return {
            "success_rate": m["success"].float().mean(),
            "mean_steps": m["n_steps"].float().mean(),
            "mean_path_error": m["mean_path_error"].mean(),
            "max_path_error": m["max_path_error"].max(),
            "executed_steps": m["n_steps"].sum(),
            "status_counts": (final.status[:, None] == torch.arange(4, device=dev)).sum(dim=0),
        }

    def run(states0: AgentState, lib_stack: LibraryPack, shared: EpisodeStatics,
            aux_stack=None) -> dict:
        shared = _shared(shared)
        outs = [
            _one(shared._replace(lib=_cell_lib(lib_stack, i)),
                 AgentState(*(x[i].to(dev) for x in states0)),
                 None if aux_stack is None else aux_stack[i])
            for i in _own_cells(states0.theta.shape[0])
        ]
        names = list(outs[0])
        local = [torch.stack([o[k] for o in outs]) for k in names]
        return dict(zip(names, gather_data(mesh, local)))

    run.captured = nav.captured
    if lib_prepare is None:
        run.prepare = None
        return run

    def prepare(lib_stack: LibraryPack, shared: EpisodeStatics) -> list:
        shared = _shared(shared)
        c = lib_stack.views.shape[0]
        aux = [None] * c
        for i in _own_cells(c):
            aux[i] = lib_prepare(shared._replace(lib=_cell_lib(lib_stack, i)))
        return aux

    run.prepare = prepare
    return run
