"""Process groups and collectives (L6) — counterpart of
``aruco_slam_tpu.parallel.mesh``.

The JAX package lays a ``jax.sharding.Mesh`` over the devices of one
process and lets XLA insert the collectives. In PyTorch a rank is a
process: a ``torch.distributed`` process group joins the ranks, and the
port's distributed code issues its collectives itself, every one of them
through :func:`_collective` (so that a test or a script can count them in
:data:`COUNTS`).

The backend follows one rule (:func:`backend_for`): ``nccl`` when every
rank has a card of its own, ``gloo`` on the CPU or when ranks share a card
(NCCL refuses two ranks on one device). Outside an initialized group a
process is a world of one: its collectives return their input.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from aruco_slam_tpu_torch.utils.device import resolve

Tensor = torch.Tensor

# Collectives issued in this process, by kind (reset by whoever counts).
COUNTS = {"all_reduce": 0, "all_gather": 0}

DEFAULT_TIMEOUT_S = 300.0


def backend_for(world: int, device=None) -> str:
    """The backend for ``world`` ranks on ``device`` (None: the card):
    ``nccl`` when the host has a card for every rank, else ``gloo``.
    Raises if the device is a card and the host has none."""
    device = resolve(device)
    if device.type == "cpu":
        return "gloo"
    if device.type != "cuda":
        raise ValueError(f"no process-group backend for device {device}")
    cards = torch.cuda.device_count()
    if cards == 0:
        raise RuntimeError("no CUDA device: a group on the card needs one (pass device='cpu')")
    return "nccl" if cards >= world else "gloo"


def rank_device(rank: int, device=None) -> torch.device:
    """The device of ``rank``: the CPU, or card ``rank`` modulo the cards
    (ranks share cards when there are fewer cards than ranks)."""
    device = resolve(device)
    if device.type == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return device


def init(rank: int, world: int, backend: str | None = None, device=None,
         init_method: str | None = None,
         timeout: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join this process to the default group as ``rank`` of ``world`` and
    return its device. ``backend`` None takes :func:`backend_for`;
    ``init_method`` is the rendezvous (``file://...``, ``tcp://host:port``
    or None for ``env://``). Every failure raises; nothing falls back to
    another backend or device."""
    backend = backend or backend_for(world, device)
    dev = rank_device(rank, device)
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("nccl needs every rank on a card")
        if torch.cuda.device_count() < world:
            raise ValueError(f"nccl needs a card per rank: {world} ranks, "
                             f"{torch.cuda.device_count()} cards (use gloo)")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout))
    return dev


def initialize_multihost(backend: str | None = None, device=None,
                         timeout: float = DEFAULT_TIMEOUT_S) -> torch.device | None:
    """Join the group that ``torchrun`` describes (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT``) and return this
    rank's device; a no-op returning None outside ``torchrun``, as the JAX
    package's is outside a configured cluster. On a card, the rank's card
    is ``LOCAL_RANK``."""
    if "RANK" not in os.environ or "MASTER_ADDR" not in os.environ:
        return None
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    init(local, world, backend, device, "env://", timeout)
    if dist.get_rank() != rank:
        raise RuntimeError(f"joined as rank {dist.get_rank()}, torchrun said {rank}")
    return rank_device(local, device)


def rank_world(group=None) -> tuple[int, int]:
    """(rank, world size) in ``group`` (None: the default group); (0, 1)
    in a process that joined no group."""
    if group is None and not dist.is_initialized():
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def _collective(kind: str, buf: Tensor, group) -> Tensor:
    """The one place the port issues a collective: counts it in
    :data:`COUNTS` and runs it on ``buf`` (``all_reduce``: summed in place;
    ``all_gather``: every rank's ``buf`` concatenated along dim 0)."""
    COUNTS[kind] += 1
    if group is None and not dist.is_initialized():
        return buf
    if kind == "all_reduce":
        dist.all_reduce(buf, group=group)
        return buf
    if kind != "all_gather":
        raise ValueError(f"unknown collective {kind!r}")
    # gloo gathers host tensors only: a card's tensor goes through the host
    # explicitly, and its result comes back to the card.
    staged = buf.cpu() if dist.get_backend(group) == "gloo" else buf
    parts = [torch.empty_like(staged) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, staged.contiguous(), group=group)
    return torch.cat(parts).to(buf.device)


def all_reduce(*tensors: Tensor, group=None) -> tuple[Tensor, ...]:
    """The sums over the ranks of ``tensors`` (one dtype), in ONE
    collective: they are packed into one flat buffer."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    flat = _collective("all_reduce", flat, group)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at: at + t.numel()].view(t.shape))
        at += t.numel()
    return tuple(out)


def all_gather(t: Tensor, group=None) -> Tensor:
    """Every rank's ``t`` (equal shapes) concatenated along dim 0, in rank
    order. bool travels as uint8."""
    if t.dtype == torch.bool:
        return _collective("all_gather", t.to(torch.uint8), group).bool()
    return _collective("all_gather", t, group)
