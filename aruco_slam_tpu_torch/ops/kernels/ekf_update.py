"""K6: the single-stream EKF frame update as one cooperative CUDA launch
(``csrc/ekf_frame_update.cu``): sigma stays in device memory and a grid of
resident blocks, each owning a stripe of its columns, runs the sequential
chain with one grid barrier per observation. There is no landmark ceiling.

Counterpart of ``aruco_slam_tpu.ops.kernels.ekf_update.frame_update``: a
drop-in for ``ekf.update`` on a state with a batch of one. The slot lookup
and the (slot, arrival) sort run in torch; the kernel takes the sorted
observations. The plain version is ``ekf.update``; the wrapper takes it for
a CPU tensor and launches the kernel, or raises, for a CUDA tensor.
"""

from __future__ import annotations

import ctypes

import torch

from aruco_slam_tpu_torch.models import ekf
from aruco_slam_tpu_torch.ops.kernels import _build
from aruco_slam_tpu_torch.ops.kernels.ekf_update_batched import _check
from aruco_slam_tpu_torch.utils.config import SlamConfig

Tensor = torch.Tensor

# Kernel launches since import (or since a caller reset it to 0).
LAUNCHES = 0

_P = ctypes.c_void_p
_F = ctypes.c_float
_I = ctypes.c_int


def _lib():
    lib = _build.load("ekf_frame_update")
    if lib.ekf_frame_update_launch.argtypes is None:
        lib.ekf_frame_update_launch.argtypes = (
            [_P] * 24 + [_I] * 3 + [_I, _F, _I, _F, _F, _I, _P]
        )
        lib.ekf_frame_update_launch.restype = _I
        lib.ekf_frame_update_grid.argtypes = [_I]
        lib.ekf_frame_update_grid.restype = _I
        lib.ekf_frame_update_error_string.argtypes = [_I]
        lib.ekf_frame_update_error_string.restype = ctypes.c_char_p
    return lib


def grid_blocks(n_dim: int) -> int:
    """Blocks the kernel runs for an ``n_dim`` state on the current card."""
    return _lib().ekf_frame_update_grid(n_dim)


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
    return _launch(state, frame, config)


def _launch(state, frame, config):
    global LAUNCHES
    N = state.mu.shape[1]
    L = config.ekf.max_landmarks
    M = frame.ids.shape[1]
    obs, slots = ekf.sort_observations(frame, ekf.lookup_slots(state.slot_ids, frame.ids))
    ids, z, valid = obs.ids.contiguous(), obs.z.contiguous(), obs.valid.contiguous()
    R9 = obs.R.reshape(1, M, 9).contiguous()
    slots = slots.contiguous()
    lib = _lib()
    out = ekf.EkfState(
        mu=torch.empty_like(state.mu),  # never aliases mu: the input is mu0
        sigma=torch.empty_like(state.sigma),
        slot_ids=torch.empty_like(state.slot_ids),
        n_landmarks=torch.empty_like(state.n_landmarks),
        last_obs=torch.empty_like(state.last_obs),
        seen_prev=torch.empty_like(state.seen_prev),
        initialized=state.initialized,
        diverged=torch.empty_like(state.diverged),
        dropped=torch.empty_like(state.dropped),
    )
    dev = state.mu.device
    scratch = torch.empty(2, 3, N, dtype=torch.float32, device=dev)
    barrier = torch.empty(2, dtype=torch.int32, device=dev)
    cc = config.compat
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ekf_frame_update_launch(
            state.mu.data_ptr(), state.sigma.data_ptr(), state.slot_ids.data_ptr(),
            state.n_landmarks.data_ptr(), state.last_obs.data_ptr(),
            state.seen_prev.data_ptr(), state.initialized.data_ptr(),
            state.diverged.data_ptr(), state.dropped.data_ptr(),
            ids.data_ptr(), z.data_ptr(), R9.data_ptr(), valid.data_ptr(), slots.data_ptr(),
            out.mu.data_ptr(), out.sigma.data_ptr(), out.slot_ids.data_ptr(),
            out.n_landmarks.data_ptr(), out.last_obs.data_ptr(), out.seen_prev.data_ptr(),
            out.diverged.data_ptr(), out.dropped.data_ptr(),
            scratch.data_ptr(), barrier.data_ptr(),
            N, L, M,
            int(cc.stationary_gate), cc.stationary_gate_eps**2,
            int(cc.reject_divergent), cc.divergence_ze_norm**2,
            cc.divergence_k_norm**2, int(config.ekf.symmetrize_sigma), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"ekf_frame_update kernel launch failed: "
            f"{lib.ekf_frame_update_error_string(err).decode()}"
        )
    LAUNCHES += 1
    return out
