"""Build and load the port's CUDA kernels.

Each source in ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with ``ctypes``. Libraries go to
``build/navdv_torch_kernels/`` at the repository root, named by a hash of
their source and flags, so an edited source is rebuilt and an unchanged one
is reused. Nothing is built at import: the first launch of a kernel builds
its library, and ``build_all`` builds every library at once, one ``nvcc``
process per source, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "navdv_torch_kernels"
SOURCES = {
    "window": "window.cu",
    "render": "render.cu",
    "min_distance": "min_distance.cu",
    "lag_fam": "lag_fam.cu",
}
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LIBS: dict[str, ctypes.CDLL] = {}
_FNS: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("navdv_torch: nvcc not found; the CUDA kernels cannot be built")


def source_constants(*files: str) -> dict[str, int]:
    """The ``constexpr int NAME = <literal>;`` constants of the given
    ``csrc`` files, so that a wrapper sizes what a kernel declares without
    building it."""
    found = {}
    for f in files:
        for name, value in re.findall(r"constexpr int (\w+) = (\d+);", (CSRC / f).read_text()):
            found[name] = int(value)
    return found


def library_path(name: str) -> Path:
    """Where kernel library ``name`` is (or will be) built."""
    src = CSRC / SOURCES[name]
    h = hashlib.sha256()
    h.update(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str):
    """Start nvcc for one source into a temporary file; None if built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> str:
    if started is None:
        return "cached"
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {SOURCES[name]}:\n{log}")
    os.replace(tmp, out)
    return log


def build_all() -> tuple[float, dict[str, str]]:
    """Build every kernel library in parallel; returns the wall time of the
    whole build and each kernel's nvcc output ("cached" if it was built)."""
    t0 = time.perf_counter()
    started = {name: _start(name) for name in SOURCES}
    logs = {name: _finish(name, s) for name, s in started.items()}
    return time.perf_counter() - t0, logs


def load_function(name: str, symbol: str, argtypes: list):
    """The C function ``symbol`` of kernel library ``name``, built at first
    use, with its argument types declared. Every launcher returns the
    ``cudaError_t`` of its launch (0 = success)."""
    fn = _FNS.get((name, symbol))
    if fn is not None:
        return fn
    lib = _LIBS.get(name)
    if lib is None:
        _finish(name, _start(name))
        lib = ctypes.CDLL(str(library_path(name)))
        lib.navdv_error_string.argtypes = [ctypes.c_int]
        lib.navdv_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    _FNS[(name, symbol)] = fn
    return fn


def check_launch(name: str, code: int) -> None:
    """Raise if a launcher reported a CUDA error."""
    if code != 0:
        msg = _LIBS[name].navdv_error_string(code).decode()
        raise RuntimeError(f"navdv_torch {name} kernel launch failed: {msg} ({code})")
