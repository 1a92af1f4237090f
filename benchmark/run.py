"""The benchmark of navdv_torch: one process runs one cell once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It loads the cell that ``BENCHMARK.json``
names, sets up the program (world and trials from ``--seed``), warms up
every shape the cell uses, then measures for ``--seconds`` (``--trace 0``:
the end-to-end metrics) or profiles a bounded slice of episodes
(``--trace 1``: the per-layer metrics), compares what the program produced
with the plain reference, and prints one JSON line last on standard output.
A sweep configuration's episode is one pass over its grid
(``harness/sweep.py``).
The compared numbers, each beside its limit, are the last lines on standard
error and the last key of that line.

It runs on the machine it is started on and needs the card count the cell
asks for; without it, it exits non-zero and prints no result. A cell on
several cards starts one rank process per card. The program's kernel
builds stay inside the checkout (``build/``).
"""

from __future__ import annotations

import time

T_PROCESS = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from collections import Counter  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# the program's caches, at fixed paths inside the checkout
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton_cache"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
os.environ.setdefault("CUDA_CACHE_PATH", str(ROOT / "build" / "cuda_cache"))
os.environ["USE_FLAX"] = "0"
# one host thread: the program's host work is small and serial, and idle
# worker threads only add jitter to the timed calls
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
sys.path[:0] = [str(BENCH_DIR), str(ROOT)]

FORBIDDEN = ("jax", "jaxlib", "flax", "navdv_tpu")


class Refused(SystemExit):
    """Ends the run with a message on standard error and no result."""

    def __init__(self, message: str):
        print(f"navbench: {message}", file=sys.stderr, flush=True)
        super().__init__(2)


def guard() -> None:
    """Refuse the run when a module of JAX or of the JAX package is loaded,
    comparing each module's top-level name whole."""
    found = sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))
    if found:
        raise Refused(f"modules of {', '.join(found)} are loaded; the benchmark measures "
                      "navdv_torch alone")


def card(device_count: int) -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
                              "temperature.gpu", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return "; ".join(out.stdout.strip().splitlines()[:device_count])


def emit(result: dict, cell, device_name: str) -> None:
    checks = result.pop("checks")
    numbers = result.pop("numbers")
    window = result.pop("window", None)
    if window:
        print("window: " + ", ".join(f"{k} {v:.6g}" for k, v in window.items()), file=sys.stderr)
    columns = result.pop("exit_columns", None)
    if columns:
        counts = Counter(columns)
        print("exit columns: " + ", ".join(f"{c} x{counts[c]}" for c in sorted(counts)),
              file=sys.stderr)
    stages = result.pop("setup_stages", None)
    if stages:
        print("set-up s: " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()),
              file=sys.stderr)
    device = {"platform": "gpu", "kind": device_name, "count": cell.chips, **result["device"]}
    line = {"correct": result["correct"], "attempted": result["attempted"],
            "failed": result["failed"], "metrics": result["metrics"], "device": device}
    if "breakdown" in result:
        line["breakdown"] = result["breakdown"]
    line["card"] = card(cell.chips)
    control = {k: v for k, v in numbers.items() if k.endswith("_control")}
    if control:
        line["control"] = control
    line["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"check correct {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rank", action="store_true", help=argparse.SUPPRESS)
    # the control's readings beside the program's, for setting limits
    ap.add_argument("--control", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    from harness.cells import find_cell

    cell = find_cell(args.workload, ROOT)
    import torch

    t_torch = time.time() - T_PROCESS

    if not torch.cuda.is_available():
        raise Refused("no CUDA device is present; the benchmark runs on the card only")
    if torch.cuda.device_count() < cell.chips:
        raise Refused(f"{cell.name} needs {cell.chips} cards; {torch.cuda.device_count()} "
                      "present")

    if cell.chips > 1 and not args.rank:  # no CUDA context here: the ranks own the cards
        from harness import mesh
        from navdv_torch import _build

        _build.build_all()  # once, before the ranks start
        guard()
        argv = [sys.executable, str(Path(__file__).resolve()), "--workload", args.workload,
                "--seed", str(args.seed), "--seconds", str(args.seconds), "--trace",
                str(args.trace), "--rank"] + (["--control"] if args.control else [])
        return mesh.launch(argv, cell.chips, T_PROCESS, cwd=str(ROOT))

    if args.rank:
        from harness import mesh

        result = mesh.run_rank(cell, args.seed, args.seconds, bool(args.trace), "cuda", guard,
                               args.control)
        if result is None:
            return 0
    else:
        from harness import drive, sweep

        run = sweep.run if sweep.is_sweep(cell) else drive.run_single
        result = run(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_PROCESS, guard,
                     args.control)
        result["setup_stages"] = {"import_torch": t_torch, **result["setup_stages"]}
    guard()
    emit(result, cell, torch.cuda.get_device_name(torch.cuda.current_device()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
