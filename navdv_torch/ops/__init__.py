"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Each wrapper takes its plain version for tensors on the CPU and launches its
kernel for tensors on the card; on the card there is no fallback. Each keeps
a plain integer count of its kernel launches, read and reset through
:func:`launch_counts` / :func:`reset_launch_counts`.
"""

from __future__ import annotations

from navdv_torch.ops import familiarity, lag, render, window

_WRAPPERS = {
    "window_gather": window.window_gather,
    "render": render.render_windows,
    "min_distance": familiarity.min_distance_rows,
    "lag_fam": lag.lag_lib_min,
}


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in _WRAPPERS.values():
        fn.launches = 0
