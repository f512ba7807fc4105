"""Rank bodies of ``tests/test_torch_dist.py`` (a helper module, not a test
file): spawned ranks import it by name, and it imports only torch, numpy
and the port, so a rank starts without JAX."""

import time

import torch
import torch.distributed as dist

from aruco_slam_tpu_torch import runner
from aruco_slam_tpu_torch.parallel import dist_ba, mesh

# every collective torch.distributed offers; a rank counts its calls to each
TORCH_COLLECTIVES = (
    "all_reduce", "all_gather", "all_gather_into_tensor", "all_gather_object", "broadcast",
    "broadcast_object_list", "reduce", "reduce_scatter", "reduce_scatter_tensor",
    "all_to_all", "all_to_all_single", "barrier", "gather", "scatter", "send", "recv",
    "isend", "irecv",
)


def _counted(calls):
    """Wrap every collective of torch.distributed so its calls land in
    ``calls``; returns a function that undoes it."""
    real = {name: getattr(dist, name) for name in TORCH_COLLECTIVES}

    def wrap(name):
        def counted(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return real[name](*a, **k)
        return counted

    for name in TORCH_COLLECTIVES:
        setattr(dist, name, wrap(name))
    return lambda: [setattr(dist, n, f) for n, f in real.items()]


def solve_and_count(local, kw):
    """(solve_dist's result, mesh.COUNTS, torch.distributed calls) of one solve."""
    for k in mesh.COUNTS:
        mesh.COUNTS[k] = 0
    calls = {}
    undo = _counted(calls)
    try:
        out = dist_ba.solve_dist(local, **kw)
    finally:
        undo()
    return out, dict(mesh.COUNTS), calls


def all_cases(rank, world, dev, solves, counts, replay, detect):
    """Every multi-rank case of the module in one world: ``solves`` and
    ``counts`` map a name to (sharded problem, solve_dist options);
    ``replay`` is (batch data, config); ``detect`` a list of image stacks."""
    out = {"solve": {}, "count": {}}
    for name, (sharded, kw) in solves.items():
        out["solve"][name] = dist_ba.solve_dist(dist_ba.shard(sharded, rank, dev), **kw)
    for name, (sharded, kw) in counts.items():
        _, out["count"][name], out["count"][name + " torch"] = solve_and_count(
            dist_ba.shard(sharded, rank, dev), kw)
    data, cfg = replay
    out["replay"] = runner.replay_sharded(data, cfg, device=dev)
    out["detect"] = [runner.detect_frames(images, chunk=4, group=dist.group.WORLD)
                     for images in detect]
    return out


def fail_at(rank, world, dev, bad_rank):
    """Rank ``bad_rank`` raises; the others wait in a collective."""
    if rank == bad_rank:
        raise ValueError(f"rank {rank} failed on purpose")
    mesh.all_reduce(torch.zeros(1))


def hang(rank, world, dev, seconds):
    time.sleep(seconds)
