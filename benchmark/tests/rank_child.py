"""A rank of a CPU mesh run for the tests: ``rank_child.py <checkout> <cell>
<seed> <seconds> <trace> <fault>``, started by ``harness.mesh.launch``.
``fault`` "no_exchange" leaves out the step's MIN between the ranks."""

from __future__ import annotations

import json
import sys
from pathlib import Path

from fixture import BENCH, ROOT  # noqa: F401  (puts the harness on the path)


def main() -> int:
    root, name, seed, seconds, traced, fault = sys.argv[1:]
    if fault == "no_exchange":
        import navdv_torch.agent as agent

        def skip(m, lib_axis):
            return m

        skip.calls = 0
        agent.lib_pmin = skip
    from harness import mesh
    from harness.cells import find_cell

    result = mesh.run_rank(find_cell(name, Path(root)), int(seed), float(seconds),
                           bool(int(traced)), "cpu", lambda: None)
    if result is not None:
        print(json.dumps({k: v for k, v in result.items() if k != "numbers"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
