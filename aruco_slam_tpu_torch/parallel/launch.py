"""Start one process per rank and collect what each returns (L6).

:func:`run_ranks` is the launcher that tests and scripts use on one host;
``torchrun`` with :func:`mesh.initialize_multihost` is the other way in.
Ranks are started with the ``spawn`` method (a parent that has a CUDA
context must not fork) and meet at a ``file://`` store in a temporary
directory, so no port is chosen and concurrent launches never collide.
"""

from __future__ import annotations

import os
import pickle
import tempfile
import time
import traceback

import torch

from aruco_slam_tpu_torch.parallel import mesh
from aruco_slam_tpu_torch.utils.device import resolve

# Seconds the other ranks get to exit after one has failed.
FAILURE_GRACE_S = 10.0

def _host(x):
    """``x`` with every tensor moved to the CPU (tuples, lists, dicts and
    named tuples walked)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_host(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_host(v) for v in x)
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    return x


def _rank_main(fn, rank, world, backend, device, store, args, timeout):
    """One rank: join the group, run ``fn(rank, world, device, *args)``,
    leave the group and write the result (or the traceback) beside the
    store."""
    try:
        if torch.device(device).type == "cpu":
            torch.set_num_threads(1)  # the ranks are the parallelism
        dev = mesh.init(rank, world, backend, device, f"file://{store}/rendezvous", timeout)
        try:
            out = fn(rank, world, dev, *args)
        finally:
            torch.distributed.destroy_process_group()
        with open(f"{store}/result-{rank}.pkl", "wb") as f:
            pickle.dump(_host(out), f)
    except BaseException:
        with open(f"{store}/error-{rank}.txt", "w") as f:
            f.write(traceback.format_exc())
        raise


def run_ranks(fn, world: int, backend: str | None = None, device=None, args=(),
              timeout: float = 3600.0) -> list:
    """Run ``fn(rank, world, device, *args)`` in ``world`` new processes
    joined in the default group, and return their results in rank order
    (tensors moved to the CPU). ``fn`` must be importable by name (a
    module-level function), as must ``args``.

    ``device`` None is the card; ``backend`` None follows
    :func:`mesh.backend_for`. On the card the kernels are built here,
    before any rank starts, so no two ranks compile into one build
    directory. A rank that raises or exits makes this raise with its
    traceback, and every rank still running is stopped; so is every rank
    when ``timeout`` seconds pass. The group's rendezvous and each
    collective wait at most ``mesh.DEFAULT_TIMEOUT_S`` (or ``timeout``, if
    shorter)."""
    device = resolve(device)
    backend = backend or mesh.backend_for(world, device)
    if device.type == "cuda":
        from concurrent.futures import ThreadPoolExecutor

        from aruco_slam_tpu_torch.ops.kernels import _build

        sources = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
        with ThreadPoolExecutor(len(sources)) as pool:
            list(pool.map(_build.load, sources))
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="ranks-") as store:
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, world, backend, str(device), store, args,
                                   min(timeout, mesh.DEFAULT_TIMEOUT_S)))
                 for r in range(world)]
        for p in procs:
            p.start()
        try:
            deadline = time.monotonic() + timeout
            while True:
                # one reading of the exit codes an iteration: a rank may exit
                # between two readings
                codes = [p.exitcode for p in procs]
                if any(c not in (None, 0) for c in codes):
                    # the others fail in turn once a peer is gone: give them a
                    # moment, so that the report holds the rank that failed first
                    _join_all(procs, FAILURE_GRACE_S)
                    failed = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
                    raise RuntimeError(_failure(store, failed, procs))
                if None not in codes:
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(f"ranks still running after {timeout} s: "
                                       f"{[r for r, p in enumerate(procs) if p.is_alive()]}")
                procs[codes.index(None)].join(0.05)
            results = []
            for r in range(world):
                with open(f"{store}/result-{r}.pkl", "rb") as f:
                    results.append(pickle.load(f))  # written by our own ranks
            return results
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join()


def _join_all(procs, seconds: float) -> None:
    """Wait up to ``seconds`` for every process to exit."""
    end = time.monotonic() + seconds
    for p in procs:
        p.join(max(0.0, end - time.monotonic()))


def _failure(store, failed, procs) -> str:
    lines = []
    for r in failed:
        path = f"{store}/error-{r}.txt"
        tb = open(path).read() if os.path.exists(path) else "(no traceback written)"
        lines.append(f"rank {r} exited with code {procs[r].exitcode}:\n{tb}")
    return "\n".join(lines)
