"""Readings to set a one-card cell's limits from: the program's compared
numbers and the control's, over many seeds in one process.

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,3 --seconds 3

For each seed: the run's set-up, a short measured window, the comparison
with the plain reference, and, at the same poses, the control (the
reference computed in float32 in the program's place, and the library pooled
from fp8 in place of bf16). One JSON line per seed on standard output. The
benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH_DIR), str(BENCH_DIR.parent)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args()

    import torch

    from harness import drive, sweep
    from harness.cells import find_cell

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = find_cell(args.workload, BENCH_DIR.parent)
    if cell.chips != 1:
        print("calibrate: one-card cells only (run a mesh cell with run.py --control)",
              file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        run = sweep.run if sweep.is_sweep(cell) else drive.run_single
        result = run(cell, seed, args.seconds, False, "cuda", t0, lambda: None, control=True)
        print(json.dumps({"workload": cell.name, "seed": seed, "correct": result["correct"],
                          "attempted": result["attempted"], "numbers": result["numbers"],
                          "metrics": result["metrics"], "seconds": time.time() - t0}),
              flush=True)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
