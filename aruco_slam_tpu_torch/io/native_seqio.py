"""ctypes binding of the native ``.asq`` frame container
(``native/seqio/seqio.cpp``) — the port's own copy of
``aruco_slam_tpu.io.native_seqio``.

An ``.asq`` file holds grayscale uint8 frames behind a small header and a
CRC32 of the payload; the reader maps it and a pool of threads prefetches
frames in order. Both packages build the same C++ source, so a file written
by either reads in the other.

The library is built with ``g++`` at first use into ``build/`` beside this
file, named by a hash of the source and the flags; nothing is built at
import. A failed build raises; :func:`is_available` says whether the
library builds and loads, without raising.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "seqio" / "seqio.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "build"
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lib = None
_lock = threading.Lock()


def _compile(out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        try:
            proc = subprocess.run(["g++", *CXX_FLAGS, str(SOURCE), "-o", tmp],
                                  capture_output=True, text=True, timeout=300)
        except FileNotFoundError as e:
            raise RuntimeError(f"g++ (the C++ compiler) is needed to build {SOURCE.name}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {SOURCE} (exit {proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)  # atomic: a reader never sees a partial library
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        key = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
        path = BUILD_DIR / f"libseqio-{key}.so"
        if not path.exists():
            _compile(path)
        lib = ctypes.CDLL(str(path))
        u32, vp = ctypes.c_uint32, ctypes.c_void_p
        lib.seq_write.restype = ctypes.c_int
        lib.seq_write.argtypes = [ctypes.c_char_p, vp, u32, u32, u32]
        lib.seq_open.restype = vp
        lib.seq_open.argtypes = [ctypes.c_char_p]
        lib.seq_info.restype = ctypes.c_int
        lib.seq_info.argtypes = [vp] + [ctypes.POINTER(u32)] * 3
        lib.seq_verify.restype = ctypes.c_int
        lib.seq_verify.argtypes = [vp]
        lib.seq_read_frame.restype = ctypes.c_int
        lib.seq_read_frame.argtypes = [vp, u32, vp]
        lib.seq_close.restype = None
        lib.seq_close.argtypes = [vp]
        lib.seq_prefetch_start.restype = vp
        lib.seq_prefetch_start.argtypes = [vp, u32, u32, u32, ctypes.c_int]
        lib.seq_prefetch_next.restype = ctypes.c_long
        lib.seq_prefetch_next.argtypes = [vp, vp]
        lib.seq_prefetch_stop.restype = None
        lib.seq_prefetch_stop.argtypes = [vp]
        _lib = lib
        return _lib


def is_available() -> bool:
    """True when the library builds (or is built already) and loads; False
    where g++ or the source is missing or the build or the load fails. It
    never raises: callers gate on it, while the readers and writers call
    ``_load``, which raises and names the cause."""
    try:
        _load()
    except (RuntimeError, OSError, subprocess.SubprocessError):
        return False
    return True


def write_frames(path: str, frames: np.ndarray) -> None:
    """Write ``frames`` [N, H, W] (as uint8) to an ``.asq`` file."""
    frames = np.ascontiguousarray(frames, np.uint8)
    if frames.ndim != 3:
        raise ValueError(f"frames must be [N, H, W], got shape {frames.shape}")
    n, h, w = frames.shape
    rc = _load().seq_write(str(path).encode(), frames.ctypes.data_as(ctypes.c_void_p), n, h, w)
    if rc != 0:
        raise IOError(f"seq_write({path}) failed: {rc}")


class NativeSequenceReader:
    """A mapped ``.asq`` file: ``n_frames``, ``height``, ``width``; random
    access (:meth:`read`) and prefetched iteration (:meth:`iter_prefetched`).
    Close it (or use it as a context manager)."""

    def __init__(self, path: str):
        self._lib = _load()
        self._h = self._lib.seq_open(str(path).encode())
        if not self._h:
            raise IOError(f"cannot open {path} as an .asq container")
        n, hh, ww = ctypes.c_uint32(), ctypes.c_uint32(), ctypes.c_uint32()
        self._lib.seq_info(self._h, ctypes.byref(n), ctypes.byref(hh), ctypes.byref(ww))
        self.n_frames, self.height, self.width = n.value, hh.value, ww.value

    def verify(self) -> bool:
        """Whether the payload's CRC32 matches the header's."""
        return self._lib.seq_verify(self._h) == 0

    def read(self, idx: int) -> np.ndarray:
        out = np.empty((self.height, self.width), np.uint8)
        if self._lib.seq_read_frame(self._h, idx, out.ctypes.data_as(ctypes.c_void_p)) != 0:
            raise IndexError(idx)
        return out

    def iter_prefetched(self, start: int = 0, end: int | None = None, queue: int = 8,
                        threads: int = 2):
        """Yield (idx, frame) for frames ``start`` to ``end`` in order, read
        ahead by ``threads`` threads into a queue of ``queue`` frames."""
        end = self.n_frames if end is None else end
        pf = self._lib.seq_prefetch_start(self._h, start, end, queue, threads)
        if not pf:
            raise RuntimeError(f"cannot prefetch frames {start}..{end} of {self.n_frames}")
        try:
            out = np.empty((self.height, self.width), np.uint8)
            while True:
                idx = self._lib.seq_prefetch_next(pf, out.ctypes.data_as(ctypes.c_void_p))
                if idx < 0:
                    break
                yield int(idx), out.copy()
        finally:
            self._lib.seq_prefetch_stop(pf)

    def close(self) -> None:
        if self._h:
            self._lib.seq_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
