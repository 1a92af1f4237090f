"""The card's one CUDA-graph pool (``navdv_torch/capture.py``): every graph
of a card is captured into it, no capture empties the allocator's caches,
a released graph's blocks serve the next capture, and ``release_pool``
gives the pool's segments back to the card.

Graphs that share the pool share scratch, which is sound because each
replay's outputs are read or copied before another graph of the card
replays: these tests replay programs of different signatures in turns and
hold each to its eager result bit for bit. Every case needs the card and
skips here.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from navdv_torch import capture
from navdv_torch.agent import init_state, make_navigate_batch, make_navigate_batch_fn, make_statics
from navdv_torch.convert import config_from
from navdv_torch.oracle import resample_route
from navdv_torch.training import train_library

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _scratchy(scale: float):
    """A function whose capture holds temporaries as large as its input."""
    def fn(x):
        t = torch.sin(x * scale)
        u = torch.cumsum(t, dim=0) + t.exp()
        return u.sum(dim=1), u[:, :3] * 2.0
    return fn


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
def test_captured_programs_share_the_pool_and_replay_in_turns(dev):
    """Two captured programs of different signatures land in the card's
    pool and replay A B A B, each call giving its eager result bit for bit
    though the second's outputs may sit in the first's scratch."""
    fa, fb = _scratchy(1.0), _scratchy(0.5)
    a = capture.Captured(fa, dev, "pool test a")
    b = capture.Captured(fb, dev, "pool test b")
    gen = torch.Generator(device=dev).manual_seed(0)
    xs = [torch.randn(4096, 64, device=dev, generator=gen) for _ in range(3)]
    ys = [torch.randn(2048, 96, device=dev, generator=gen) for _ in range(3)]
    pool = tuple(capture.graph_pool(dev))
    assert tuple(a.graph(xs[0]).graph.pool()) == pool
    assert tuple(b.graph(ys[0]).graph.pool()) == pool
    for x, y in zip(xs, ys):
        assert _equal(a(x), fa(x))
        assert _equal(b(y), fb(y))


def _episode_inputs(cfg, small_world, dev, trial_seed):
    land, route = small_world
    lib = train_library(land, route, cfg, device=dev)
    pts, hd = resample_route(route, cfg.capture_spacing)
    rng = np.random.default_rng(trial_seed)
    states = init_state(pts[0][None] + rng.normal(0.0, 1.5, (12, 2)),
                        hd[0] + rng.normal(0.0, 0.3, 12), device=dev)
    return states, make_statics(land, lib, route, dev)


@pytest.mark.cuda
def test_early_exit_chunks_in_turns_with_a_captured_episode(dev, small_cfg, small_world):
    """The early-exit loop (one graph replayed chunk by chunk, a host read
    each) and a whole-episode graph of another program, called in turns,
    each give their eager episode bit for bit."""
    cfg = config_from(small_cfg)
    chunked = make_navigate_batch(cfg, "kernel", early_exit=True, device=dev)
    whole = make_navigate_batch(cfg, "fft", device=dev)
    eager_chunked = make_navigate_batch_fn(cfg, "kernel", early_exit=True, device=dev)
    eager_whole = make_navigate_batch_fn(cfg, "fft", device=dev)
    for seed in (3, 4, 5):
        states, st = _episode_inputs(cfg, small_world, dev, seed)
        aux = whole.prepare(st)
        got = chunked(states, st)
        got_whole = whole(states, st, aux)
        for out, want in ((got, eager_chunked(states, st)),
                          (got_whole, eager_whole(states, st, aux))):
            assert _equal([*out[0], *out[1]], [*want[0], *want[1]]), seed


@pytest.mark.cuda
def test_capture_keeps_cached_blocks_and_reuses_released_ones(dev):
    """A capture made while the default pool holds cached free blocks leaves
    the reserved bytes where they were (nothing flushed); once a released
    graph's signature has been captured again, capturing it again makes no
    ``cudaMalloc``, and ``"grew"`` does not count it."""
    torch.cuda.synchronize(dev)
    cached = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    del cached  # 64 MiB free in the default pool's cache
    reserved = torch.cuda.memory_reserved(dev)
    fn = _scratchy(2.0)
    cap = capture.Captured(fn, dev, "pool test reuse")
    x = torch.randn(1024, 32, device=dev)
    want = fn(x)
    assert _equal(cap(x), want)
    assert torch.cuda.memory_reserved(dev) >= reserved
    grew = []
    for _ in range(3):
        cap.release()
        allocs = torch.cuda.memory_stats(dev)["num_device_alloc"]
        counts = capture.capture_counts()
        assert _equal(cap(x), want)
        now = capture.capture_counts()
        assert now["captures"] == counts["captures"] + 1
        grew.append((torch.cuda.memory_stats(dev)["num_device_alloc"] - allocs,
                     now["grew"] - counts["grew"]))
    assert grew[-1] == (0, 0), grew


_EMPTY_POOL = """
import gc, json, torch
from navdv_torch import capture
dev = torch.device("cuda", torch.cuda.current_device())
fns = [lambda x: (x * 3.0).sin().cumsum(0), lambda x: (x + 1.0).exp().cumsum(0)]
caps = [capture.Captured(f, dev, f"empty pool {i}") for i, f in enumerate(fns)]
x = torch.randn(4096, device=dev)
first = [c(x) for c in caps]
for c in caps:
    c.release()
gc.collect()
live = sum(1 for o in gc.get_objects() if type(o) is capture.Graph and o.args is not None)
again = [c(x) for c in caps]
torch.cuda.synchronize()
print(json.dumps({"live": live, "pool": list(capture.graph_pool(dev)),
                  "pools": sorted({tuple(c.graph(x).graph.pool()) for c in caps}),
                  "equal": all(torch.equal(a, b) for a, b in zip(first, again)),
                  "eager": all(torch.equal(a, f(x)) for a, f in zip(again, fns))}))
"""


@pytest.mark.cuda
def test_capture_into_the_pool_after_every_graph_is_released(dev):
    """In a process of its own: two graphs captured, both released, so no
    graph of the program holds the pool; capturing again into it works,
    with no allocator assertion, gives the same results, and the process
    exits cleanly."""
    out = subprocess.run([sys.executable, "-c", _EMPTY_POOL], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["live"] == 0 and got["pools"] == [got["pool"]], got
    assert got["equal"] and got["eager"], got


_RELEASED_POOL = """
import gc, json, torch
from navdv_torch import capture
dev = torch.device("cuda", torch.cuda.current_device())
# elementwise only: a scan over many tiles may add in another order each run
fn = lambda x: ((x * 3.0).sin() * x.cos()).exp() + x
cap = capture.Captured(fn, dev, "released pool")
x = torch.randn(1 << 22, device=dev)
first = cap(x)
old = tuple(capture.graph_pool(dev))
def segments(pool):
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if tuple(s["segment_pool_id"]) == pool)
held = segments(old)
capture.release_pool(dev)
kept = segments(old)
again = cap(x)
cap.release()
gc.collect()
returned = segments(old)
third = cap(x)
new = tuple(capture.graph_pool(dev))
torch.cuda.synchronize()
print(json.dumps({"held": held, "kept": kept, "returned": returned, "new": list(new),
                  "old": list(old), "in_new": tuple(cap.graph(x).graph.pool()) == new,
                  "again": torch.equal(first, again), "third": torch.equal(first, third),
                  "eager": torch.equal(first, fn(x))}))
"""


@pytest.mark.cuda
def test_release_pool_returns_the_segments_once_its_graphs_are_released(dev):
    """In a process of its own: ``release_pool`` gives up the card's pool.
    A graph captured into it still holds it and replays; once that graph is
    released, the pool's segments go back to the card, and the next capture
    takes a new pool and gives the same result."""
    out = subprocess.run([sys.executable, "-c", _RELEASED_POOL], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["held"] > 0 and got["kept"] == got["held"] and got["returned"] == 0, got
    assert got["new"] != got["old"] and got["in_new"], got
    assert got["again"] and got["third"] and got["eager"], got
