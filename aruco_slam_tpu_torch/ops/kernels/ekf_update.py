"""K6: the single-stream EKF frame update as one CUDA launch per frame
(``csrc/ekf_frame_update.cu``), in two variants chosen by the state's size
alone (:func:`variant`):

- ``"cluster"``: a thread-block cluster of 16 CTAs, each holding a
  stripe of sigma's columns in its shared memory for the whole frame, with
  one hardware cluster barrier per observation (max_landmarks up to
  :data:`MAX_CLUSTER_LANDMARKS`);
- ``"grid"``: a cooperative grid, sigma in device memory, one hand-written
  grid barrier per observation (every larger state).

Counterpart of ``aruco_slam_tpu.ops.kernels.ekf_update.frame_update``,
together with the slot lookup and the (slot, arrival) sort that the JAX
function runs around its ``pallas_call``: the kernel takes the frame's
observations in arrival order and computes both itself. A drop-in for
``ekf.update`` on a state with a batch of one. The plain version is
``ekf.update``; the wrapper takes it for a CPU tensor and launches the
kernel, or raises, for a CUDA tensor. A refused launch raises
``RuntimeError``; nothing retries on the other variant.

Per call the wrapper makes one device launch and no other device work: the
outputs are views of one allocation, the launch plans are cached per device
and size, and the grid variant's barrier words are cleared once per device
and stream.
"""

from __future__ import annotations

import ctypes

import torch

from aruco_slam_tpu_torch.models import ekf
from aruco_slam_tpu_torch.ops.kernels import _build
from aruco_slam_tpu_torch.utils.config import SlamConfig

Tensor = torch.Tensor

# Kernel launches by variant since import (or since a caller reset them).
LAUNCHES = {"cluster": 0, "grid": 0}

# Shared memory a CTA may use on Hopper (227 KB), and the observations per
# frame the kernel's shared memory is planned for.
MAX_SHARED_BYTES = 232_448
MAX_OBS = 256
# CTAs in a cluster: 16 is above the portable 8 and needs the kernel's
# non-portable attribute (csrc: ekf_frame_update_cluster_plan).
MAX_CLUSTER = 16

_P = ctypes.c_void_p
_F = ctypes.c_float
_I = ctypes.c_int
_IP = ctypes.POINTER(ctypes.c_int)

_plans: dict = {}  # (device index, variant, N, CTAs) -> launch plan
_barriers: dict = {}  # (device index, stream) -> the grid variant's barrier words
_CFG_ARGS = [_I, _F, _I, _F, _F, _I, _P]  # the compat flags, symmetrize, stream


def _check(name: str, t: Tensor, shape: tuple, dtype, device, contiguous: bool = True) -> None:
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must be {list(shape)}, got {list(t.shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _lib():
    lib = _build.load("ekf_frame_update")
    if lib.ekf_frame_update_cluster_launch.argtypes is None:
        lib.ekf_frame_update_cluster_plan.argtypes = [_I, _I, _I, _IP, _IP, _IP]
        lib.ekf_frame_update_grid_plan.argtypes = [_I, _I, _IP, _IP, _IP]
        lib.ekf_frame_update_cluster_launch.argtypes = [_P] + [_I] * 6 + _CFG_ARGS
        lib.ekf_frame_update_grid_launch.argtypes = [_P, _P, _P] + [_I] * 6 + _CFG_ARGS
        for fn in (lib.ekf_frame_update_cluster_plan, lib.ekf_frame_update_grid_plan,
                   lib.ekf_frame_update_cluster_launch, lib.ekf_frame_update_grid_launch):
            fn.restype = _I
        lib.ekf_frame_update_error_string.argtypes = [_I]
        lib.ekf_frame_update_error_string.restype = ctypes.c_char_p
    return lib


def cluster_shared_bytes(n_dim: int, ctas: int) -> int:
    """Shared bytes per CTA of the cluster variant: the CTA's columns of
    sigma (N x W, W = ceil(N / CTAs)), its mu entries, the double-buffered
    B columns, the whole K^T, and the prologue's slots and order (planned
    for :data:`MAX_OBS` observations); csrc: ``cluster_words``."""
    w = -(-n_dim // ctas)
    return 4 * (n_dim * w + 7 * w + 3 * n_dim + 9 + 64 + 2 * MAX_OBS)


def cluster_ctas(n_dim: int) -> int:
    """CTAs of the cluster variant for an ``n_dim`` state, or 0 when sigma
    fits no cluster: 16 (timed fastest at every N it takes, on an H100:
    PERF.md), never so many that a CTA holds fewer than the pose block's 3
    columns."""
    if cluster_shared_bytes(n_dim, MAX_CLUSTER) > MAX_SHARED_BYTES:
        return 0
    return max(1, min(MAX_CLUSTER, n_dim // 3))


# The largest map the cluster variant holds (N = 3 + 3 * max_landmarks).
MAX_CLUSTER_LANDMARKS = max(lm for lm in range(1, 1024) if cluster_ctas(3 + 3 * lm))


def variant(n_dim: int) -> tuple[str, int]:
    """The kernel variant for an ``n_dim`` state, by its size alone:
    ``("cluster", CTAs)`` where sigma fits a cluster's shared memory, else
    ``("grid", 0)``."""
    ctas = cluster_ctas(n_dim)
    return ("cluster", ctas) if ctas else ("grid", 0)


def _check_inputs(state: ekf.EkfState, frame: ekf.FrameObservations, config: SlamConfig) -> None:
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    if state.mu.dim() != 2 or state.mu.shape[0] != 1:
        raise ValueError(f"frame_update is single-stream: mu must be [1, N], got "
                         f"{list(state.mu.shape)}")
    N = state.mu.shape[1]
    L = config.ekf.max_landmarks
    if N != 3 + 3 * L:
        raise ValueError(f"mu is [1, {N}], config max_landmarks {L} needs N = {3 + 3 * L}")
    M = frame.ids.shape[-1]
    if M > MAX_OBS:
        raise ValueError(f"frame_update takes at most {MAX_OBS} observations per frame, got {M}")
    dev = state.mu.device
    for name, t, shape, dtype in (
        ("mu", state.mu, (1, N), f32),
        ("sigma", state.sigma, (1, N, N), f32),
        ("slot_ids", state.slot_ids, (1, L), i32),
        ("n_landmarks", state.n_landmarks, (1,), i32),
        ("last_obs", state.last_obs, (1, L, 3), f32),
        ("seen_prev", state.seen_prev, (1, L), b8),
        ("initialized", state.initialized, (1,), b8),
        ("diverged", state.diverged, (1,), i32),
        ("dropped", state.dropped, (1,), i32),
        ("ids", frame.ids, (1, M), i32),
        ("z", frame.z, (1, M, 3), f32),
        ("R", frame.R, (1, M, 3, 3), f32),
        ("valid", frame.valid, (1, M), b8),
    ):
        _check(name, t, shape, dtype, dev)


def frame_update_reference(state: ekf.EkfState, frame: ekf.FrameObservations,
                           config: SlamConfig) -> ekf.EkfState:
    """The plain version: the sequential masked update, ``ekf.update``."""
    return ekf.update(state, frame, config)


def frame_update(state: ekf.EkfState, frame: ekf.FrameObservations,
                 config: SlamConfig) -> ekf.EkfState:
    """One frame's observations through the sequential EKF update for a
    single stream (batch of one), any ``max_landmarks``. A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel."""
    _check_inputs(state, frame, config)
    if state.mu.device.type == "cpu":
        return frame_update_reference(state, frame, config)
    if state.mu.device.type != "cuda":
        raise ValueError(f"no kernel for device {state.mu.device}")
    return _launch(state, frame, config, variant(state.mu.shape[1]))


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _raise_on(err: int, lib, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"ekf_frame_update {what} failed: "
                           f"{lib.ekf_frame_update_error_string(err).decode()}")


def _plan(lib, dev_index: int, kind: str, N: int, ctas: int):
    key = (dev_index, kind, N, ctas)
    plan = _plans.get(key)
    if plan is None:
        a, b, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        if kind == "cluster":
            # (columns per CTA, shared bytes, clusters the card holds at once)
            err = lib.ekf_frame_update_cluster_plan(N, MAX_OBS, ctas, ctypes.byref(a),
                                                    ctypes.byref(b), ctypes.byref(c))
            _raise_on(err, lib, f"cluster plan (N={N}, {ctas} CTAs)")
            if c.value < 1:
                raise RuntimeError(f"ekf_frame_update: a cluster of {ctas} CTAs with "
                                   f"{b.value} shared bytes each cannot be resident")
            plan = (ctas, a.value, b.value)
        else:
            # (blocks, columns per block, shared bytes)
            err = lib.ekf_frame_update_grid_plan(N, MAX_OBS, ctypes.byref(a), ctypes.byref(b),
                                                 ctypes.byref(c))
            _raise_on(err, lib, f"grid plan (N={N})")
            plan = (a.value, b.value, c.value)
        _plans[key] = plan
    return plan


def _outputs(state: ekf.EkfState, scratch_words: int):
    """The output state (and the grid variant's scratch) as views of one
    float32 allocation; ``initialized`` passes through."""
    N, L = state.mu.shape[1], state.slot_ids.shape[1]
    words = N + N * N + L + 1 + 3 * L + 2 + scratch_words + (L + 3) // 4
    buf = torch.empty(words, dtype=torch.float32, device=state.mu.device)
    at = 0

    def take(n):
        nonlocal at
        at += n
        return buf[at - n: at]

    i32 = torch.int32
    out = ekf.EkfState(
        mu=take(N).view(1, N),  # never aliases mu: the input is mu0
        sigma=take(N * N).view(1, N, N),
        slot_ids=take(L).view(i32).view(1, L),
        n_landmarks=take(1).view(i32),
        last_obs=take(3 * L).view(1, L, 3),
        diverged=take(1).view(i32),
        dropped=take(1).view(i32),
        initialized=state.initialized,
        seen_prev=None,
    )
    scratch = take(scratch_words) if scratch_words else None
    seen = take((L + 3) // 4).view(torch.uint8)[:L].view(torch.bool).view(1, L)
    return out._replace(seen_prev=seen), scratch


def _launch(state, frame, config, choice):
    """One launch of the variant ``choice`` (``variant``'s answer)."""
    N = state.mu.shape[1]
    L = config.ekf.max_landmarks
    M = frame.ids.shape[1]
    kind, g = choice
    dev = state.mu.device
    lib = _lib()
    with torch.cuda.device(dev):
        dev_index = torch.cuda.current_device()
        stream = _stream(dev)
        plan = _plan(lib, dev_index, kind, N, g)
        out, scratch = _outputs(state, 6 * N if kind == "grid" else 0)
        ptrs = (ctypes.c_void_p * 21)(*(t.data_ptr() for t in (
            state.mu, state.sigma, state.slot_ids, state.n_landmarks, state.last_obs,
            state.seen_prev, state.initialized, state.diverged, state.dropped,
            frame.ids, frame.z, frame.R, frame.valid,
            out.mu, out.sigma, out.slot_ids, out.n_landmarks, out.last_obs, out.seen_prev,
            out.diverged, out.dropped,
        )))
        cc = config.compat
        flags = (int(cc.stationary_gate), cc.stationary_gate_eps**2, int(cc.reject_divergent),
                 cc.divergence_ze_norm**2, cc.divergence_k_norm**2,
                 int(config.ekf.symmetrize_sigma), stream)
        if kind == "cluster":
            err = lib.ekf_frame_update_cluster_launch(ptrs, N, L, M, *plan, *flags)
        else:
            bar = _barriers.get((dev_index, stream))
            if bar is None:  # cleared once; the kernel leaves it at zero arrivals
                bar = _barriers[(dev_index, stream)] = torch.zeros(
                    2, dtype=torch.int32, device=dev)
            err = lib.ekf_frame_update_grid_launch(ptrs, scratch.data_ptr(), bar.data_ptr(),
                                                   N, L, M, *plan, *flags)
    _raise_on(err, lib, f"{kind} launch (N={N})")
    LAUNCHES[kind] += 1
    return out
