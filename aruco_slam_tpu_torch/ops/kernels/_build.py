"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface, at first use, and loaded with ``ctypes``.
Libraries live in ``build/`` beside this file, named by a hash of the
source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
kernel rebuilds and an unchanged one is reused. Nothing is compiled at
import: the CPU tests import every module.

No ``--use_fast_math``: the kernels' gates rely on IEEE NaN comparisons
(a garbage corner must end as ``keep = 0``), and fast-math also changes
``sqrt`` and division.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
_DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"

_lock = threading.Lock()  # guards _name_locks
_name_locks: dict[str, threading.Lock] = {}  # one per source: builds run in parallel
_loaded: dict[str, ctypes.CDLL] = {}
# ptxas's register / shared-memory / spill report of each build, by source
build_reports: dict[str, str] = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then the
    toolkit's default location. Raises RuntimeError if there is none."""
    cands = []
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        cands.append(os.path.join(home, "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(on_path)
    cands.append(_DEFAULT_NVCC)
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc (the CUDA compiler) was not found in $CUDA_HOME/bin, on PATH "
        f"or at {_DEFAULT_NVCC}; it is needed to build this package's CUDA "
        "kernels for a GPU tensor"
    )


def _compile(src: Path, out: Path) -> str:
    nvcc = find_nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-o", tmp, str(src)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {src.name} (exit {proc.returncode}):\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, out)  # atomic: a reader never sees a partial library
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return proc.stdout + proc.stderr


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``. Different sources may
    be built from several threads at once."""
    with _lock:
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        if name in _loaded:
            return _loaded[name]
        src = CSRC / f"{name}.cu"
        # the shared headers are part of every source's key
        headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
        key = hashlib.sha256(
            src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:16]
        out = BUILD_DIR / f"{name}-{key}.so"
        if not out.exists():
            build_reports[name] = _compile(src, out)
        lib = ctypes.CDLL(str(out))
        _loaded[name] = lib
        return lib
