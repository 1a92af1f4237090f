"""CUDA graphs: the port's counterpart of the JAX package's compiled programs.

The JAX package compiles its whole programs with ``jax.jit``: an episode (a
``lax.scan`` or ``lax.while_loop`` over the steps), infomax training (a
``lax.scan`` over the updates) and the analysis probes. The port runs the
same operations from Python, and a step issues tens of small launches, so
on the card the host's dispatch sets the pace. :class:`Captured` gives such
a program the compiled shape on a CUDA device:

- the first call with a new input signature (every tensor's shape, dtype
  and device, the tree that holds them, and its non-tensor leaves) copies
  the inputs into static buffers, runs the function once on a side stream
  (which builds the kernels, sets their one-time attributes and creates
  the cuBLAS handles and workspaces), and only then captures it into the
  card's graph pool (below);
- every call copies its inputs into the static buffers, replays the graph,
  and returns fresh copies of the outputs, never the graph's own buffers,
  so a result held from one call does not change at the next.

The kernel launch counts (``ops.launch_counts``) and the step's collectives
(``agent.lib_pmin.calls``) count what ran on the card: each replay adds the
counts its capture recorded, and the warm-up and the capture add nothing.
:func:`capture_counts` counts the graphs captured and released, and the
captures that took new device memory with ``cudaMalloc``. A capture that fails
raises, with the operation that broke it in the traceback; nothing catches
it and runs eagerly instead.

A call opens three spans (:mod:`navdv_torch.utils.profiling`):
``copy_in``, ``launch`` (the replay) and ``copy_out``. Whether a recording
is open is part of a graph's key: a graph captured inside one records the
step's stage marks as event nodes, which the recording reads before the
graph's next replay; one captured outside holds none.

Every graph of a card is captured into one memory pool (:func:`graph_pool`),
which the process keeps until :func:`release_pool` gives it up, and no
capture empties the allocator's caches first: ``torch.cuda.graph`` would
synchronize the card, release every cached block with a synchronizing
``cudaFree`` and the pinned host cache with it, and the work after the
capture would allocate all of it again. Where the card runs short, the
allocator's own out-of-memory path frees the cached blocks outside the pool
and tries again, but not the pool's free blocks: they serve later captures
only. A caller that has finished with a large program and knows the point
is cold calls :func:`release_pool`, and the pool's segments go back to the
card once its graphs are released.

Graphs that share a pool share scratch: a graph replays into its
capture-time temporaries, which a graph captured later may hold its
outputs in. That is sound because the outputs of a replay are read or
copied before any other graph of the card replays, and replays run in
order on the caller's stream: :class:`Captured` returns copies at once,
and the callers of :meth:`Graph.replay` read its result at once and keep
their states in the static buffers, which are not in the pool.

A graph holds its static buffers and its outputs as long as it lives,
where a jitted JAX function keeps only its executable. So the caches that
keep captured programs across calls (``sweep.run_sweep``'s runs,
``analysis``'s probes) hold them in a :class:`ProgramCache`: at most
:data:`MAX_PROGRAMS` programs keep their graphs, and an evicted program's
are released at once; it captures again when it is next called. A
released graph's blocks go back to the pool's free lists, where the next
capture finds them. So the pool grows only where a capture finds no free
block large enough, and keeps what it grew by: at most what the programs'
own pools held at once (``chip_smoke.py``'s memory phase holds it to that).

On a CPU device there is no graph: the same copy-in, call and copy-out run
around a direct call, which counts as it runs. Collectives that run on the
host (gloo) cannot be captured; callers decide that from the group's
backend (:func:`host_collectives`) before they build anything.
"""

from __future__ import annotations

import contextlib
import weakref
from collections import OrderedDict

import torch
import torch.distributed as dist

from navdv_torch import ops
from navdv_torch.utils import profiling

MAX_GRAPHS = 4  # input signatures a Captured keeps; the oldest graph goes first
# captured programs a ProgramCache keeps with their graphs; the least
# recently used is released first (None: no bound)
MAX_PROGRAMS = 2
_COUNTS = {"captures": 0, "releases": 0, "grew": 0}


def capture_counts() -> dict[str, int]:
    """Graphs captured (on the CPU: made) and released since the process
    started, and the captures whose warm-up and capture took new device
    memory with ``cudaMalloc`` (``"grew"``; 0 on the CPU)."""
    return dict(_COUNTS)


def host_collectives(group) -> bool:
    """Whether the collectives of process group ``group`` run on the host
    (any backend but NCCL, i.e. gloo), so that no CUDA graph can hold them.
    ``None`` (no collective) is False."""
    return group is not None and dist.get_backend(group) != "nccl"


def _counters() -> list[tuple[object, str]]:
    from navdv_torch.agent import lib_pmin  # agent imports this module

    return [(fn, "launches") for fn in ops._WRAPPERS.values()] + [(lib_pmin, "calls")]


def _read_counts() -> list[int]:
    return [getattr(obj, attr) for obj, attr in _counters()]


def _write_counts(values: list[int]) -> None:
    for (obj, attr), v in zip(_counters(), values):
        setattr(obj, attr, v)


def _flatten(tree, leaves: list):
    """Append ``tree``'s tensors to ``leaves``; return its hashable spec:
    the tree's types, each tensor's shape, dtype and device, and every
    non-tensor leaf's value."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return ("tensor", tuple(tree.shape), tree.dtype, tree.device)
    if isinstance(tree, (tuple, list)):
        return (type(tree), tuple(_flatten(x, leaves) for x in tree))
    if isinstance(tree, dict):
        return (dict, tuple((k, _flatten(v, leaves)) for k, v in tree.items()))
    try:
        hash(tree)
    except TypeError:
        raise TypeError(f"a captured function takes tensors, trees of them and hashable "
                        f"constants; got a {type(tree).__name__}") from None
    return ("const", tree)


def _unflatten(spec, leaves):
    kind, body = spec[0], spec[1]
    if kind == "tensor":
        return next(leaves)
    if kind == "const":
        return body
    if kind is dict:
        return {k: _unflatten(s, leaves) for k, s in body}
    children = [_unflatten(s, leaves) for s in body]
    if kind in (tuple, list):
        return kind(children)
    return kind(*children)  # a NamedTuple


def copy_out(tree):
    """``tree`` with every tensor replaced by a fresh copy."""
    leaves: list = []
    spec = _flatten(tree, leaves)
    return _unflatten(spec, iter([t.clone() for t in leaves]))


_SIDE_STREAMS: dict[torch.device, torch.cuda.Stream] = {}
_POOLS: dict[torch.device, tuple] = {}


def _side_stream(dev: torch.device) -> torch.cuda.Stream:
    """One stream per card for every warm-up and capture, so that the cuBLAS
    workspace the warm-up creates for it is the one the capture uses."""
    if dev not in _SIDE_STREAMS:
        _SIDE_STREAMS[dev] = torch.cuda.Stream(device=dev)
    return _SIDE_STREAMS[dev]


def _card(dev) -> torch.device:
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def graph_pool(dev: torch.device):
    """The id of the memory pool every graph of card ``dev`` is captured
    into. Each graph holds the pool in both allocators that serve a capture,
    of device memory and of pinned host memory; a pool that no graph holds
    is freeable in both, and the pinned one refuses it to a later capture.
    So the pool's first capture is a graph of one launch that is kept with
    it, and the pool lives until :func:`release_pool`."""
    dev = _card(dev)
    if dev not in _POOLS:
        pool = torch.cuda.graph_pool_handle()
        target = torch.zeros((), device=dev)
        keeper = torch.cuda.CUDAGraph()
        with torch.cuda.device(dev), torch.cuda.stream(_side_stream(dev)):
            keeper.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                target.zero_()
            finally:
                keeper.capture_end()
        _POOLS[dev] = (pool, keeper, target)
    return _POOLS[dev][0]


def release_pool(dev: torch.device) -> None:
    """Give up card ``dev``'s graph pool; the next capture starts a new one
    and allocates it anew. The old pool's segments go back to the card (at
    the next ``torch.cuda.empty_cache()``, or in the allocator's own
    out-of-memory retry) once the graphs captured into it are released; they
    replay as before until then. Nothing on the CPU."""
    _POOLS.pop(_card(dev), None)


def _device_allocs(dev: torch.device) -> int:
    """Segments the caching allocator has allocated with ``cudaMalloc`` on
    ``dev``."""
    return torch.cuda.memory_stats(dev)["num_device_alloc"]


class Graph:
    """``fn`` captured at one input signature.

    ``args`` are the static inputs (copies of the first call's), which the
    function reads and may update in place; ``load(*args)`` copies new
    inputs into them, ``replay()`` runs the graph (on the CPU: calls ``fn``)
    and returns its outputs: the graph's own buffers, which the next replay
    overwrites. Use :func:`copy_out` on what is kept. ``marked`` captures
    the stage marks (``marks``: (stage, start event, end event), None
    without)."""

    def __init__(self, fn, spec, leaves: list, device: torch.device, name: str,
                 marked: bool):
        self.fn, self.spec, self.name = fn, spec, name
        self._static = [t.clone() for t in leaves]
        self.args = _unflatten(spec, iter(self._static))
        self.graph = None
        self.out = None
        self.marks = None
        if device.type == "cuda":
            self._capture(device, marked)
        elif device.type != "cpu":
            raise ValueError(f"{name}: no capture on device {device}")
        _COUNTS["captures"] += 1

    def _capture(self, dev: torch.device, marked: bool) -> None:
        dev = _card(dev)
        pool = graph_pool(dev)
        saved = _read_counts()
        allocs = _device_allocs(dev)
        try:
            side = _side_stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                self.fn(*self.args)  # warm-up: builds kernels, handles, workspaces
            torch.cuda.current_stream(dev).wait_stream(side)
            warmed = _read_counts()
            self.graph = torch.cuda.CUDAGraph()
            try:
                with (profiling.marking() if marked else contextlib.nullcontext()) as marks, \
                        torch.cuda.stream(side):
                    # thread_local: a collective's watchdog thread may query events
                    self.graph.capture_begin(pool=pool, capture_error_mode="thread_local")
                    try:
                        self.out = self.fn(*self.args)
                    finally:
                        self.graph.capture_end()
                self.marks = marks or None
            except Exception as e:
                raise RuntimeError(f"{self.name}: CUDA graph capture failed ({e}); the "
                                   "operation that broke it is in the traceback above") from e
            self._delta = [a - b for a, b in zip(_read_counts(), warmed)]
            _COUNTS["grew"] += _device_allocs(dev) > allocs
        finally:
            _write_counts(saved)

    def load(self, *args) -> None:
        leaves: list = []
        spec = _flatten(args, leaves)
        if spec != self.spec:
            raise ValueError(f"{self.name}: inputs of another signature than the capture's")
        self._load(leaves)

    def _load(self, leaves: list) -> None:
        for dst, src in zip(self._static, leaves):
            if dst is not src:
                dst.copy_(src)

    def release(self) -> None:
        """Free the graph, its outputs (their blocks go back to the card's
        graph pool) and the static buffers; the Graph cannot replay after
        this."""
        if self.args is not None:
            _COUNTS["releases"] += 1
        if self.graph is not None:
            self.graph.reset()
        self.graph = self.out = self.args = self.marks = None
        self._static = []

    def replay(self):
        if self.args is None:
            raise RuntimeError(f"{self.name}: the graph was released")
        if self.graph is None:
            self.out = self.fn(*self.args)
        else:
            if self.marks is not None:
                profiling.replaying(self.marks)
            self.graph.replay()
            _write_counts([a + b for a, b in zip(_read_counts(), self._delta)])
        return self.out


class Captured:
    """``fn(*args)`` (trees of tensors in and out) run through a
    :class:`Graph` per input signature, captured at its first call on
    ``device`` and kept while this object lives (at most :data:`MAX_GRAPHS`,
    the oldest dropped first). Calls return fresh tensors. A signature
    captured inside a :func:`~navdv_torch.utils.profiling.recording` and
    outside one are two graphs, the first with the step's stage marks."""

    def __init__(self, fn, device, name: str):
        self.fn, self.device, self.name = fn, torch.device(device), name
        self._graphs: dict = {}

    def _graph(self, spec, leaves: list) -> Graph:
        marked = self.device.type == "cuda" and profiling.is_recording()
        g = self._graphs.get((spec, marked))
        if g is None:
            g = Graph(self.fn, spec, leaves, self.device, self.name, marked)
            while len(self._graphs) >= MAX_GRAPHS:
                self._graphs.pop(next(iter(self._graphs))).release()
            self._graphs[spec, marked] = g
        return g

    def release(self) -> None:
        """Release every graph (outputs and static buffers); the next call
        captures again."""
        for g in self._graphs.values():
            g.release()
        self._graphs.clear()

    def graph(self, *args) -> Graph:
        """The graph for ``args``' signature, captured now if it is new."""
        leaves: list = []
        return self._graph(_flatten(args, leaves), leaves)

    def __call__(self, *args):
        leaves: list = []
        g = self._graph(_flatten(args, leaves), leaves)
        with profiling.span("copy_in"):
            g._load(leaves)
        with profiling.span("launch"):
            out = g.replay()
        with profiling.span("copy_out"):
            return copy_out(out)


class ProgramCache:
    """Captured programs (objects with a ``release()`` that frees their
    graphs) by key, least recently used first out: at most
    :data:`MAX_PROGRAMS` of them, read at each insertion. ``cache[key] =
    program`` adds or refreshes one, ``cache[key]`` returns one and marks it
    used, ``key in cache`` only looks. An evicted program is released at
    once; one built or called again captures again (one more warm-up and
    capture, the same results).

    ``weak=True`` holds the programs by weak reference, to bound the graphs
    of programs that another cache owns: they stay usable after eviction
    and free their graphs when they die."""

    def __init__(self, weak: bool = False):
        self._weak = weak
        self._items: OrderedDict = OrderedDict()

    def _program(self, item):
        return item() if self._weak else item

    def __contains__(self, key) -> bool:
        return key in self._items and self._program(self._items[key]) is not None

    def __len__(self) -> int:
        return len(self._items)

    def __iter__(self):
        return iter(list(self._items))

    def __getitem__(self, key):
        program = self._program(self._items[key])
        if program is None:
            raise KeyError(key)
        self._items.move_to_end(key)
        return program

    def __setitem__(self, key, program) -> None:
        self._items[key] = weakref.ref(program) if self._weak else program
        self._items.move_to_end(key)
        while MAX_PROGRAMS is not None and len(self._items) > MAX_PROGRAMS:
            old = self._program(self._items.popitem(last=False)[1])
            if old is not None:
                old.release()
