"""K2: one EKF frame step for a batch of replay lanes as one CUDA kernel
launch (``csrc/ekf_frame_batched.cu``, one CTA per lane, the lane's sigma
in shared memory).

Counterpart of ``aruco_slam_tpu.ops.kernels.ekf_update_batched``, batch
major: the covariance predict with the frame's composed (A, Q), mu[0:3] <-
pose, then the frame's observations in their sorted order through the
sequential update (``models.ekf.apply_sorted``), then the symmetrize. The
plain version is ``ekf.apply_predict`` + ``ekf.apply_sorted``; the wrapper
takes it for a CPU tensor and launches the kernel, or raises, for a CUDA
tensor.
"""

from __future__ import annotations

import ctypes

import torch

from aruco_slam_tpu_torch.models import ekf
from aruco_slam_tpu_torch.ops.kernels import _build
from aruco_slam_tpu_torch.utils.config import SlamConfig

Tensor = torch.Tensor

# Kernel launches since import (or since a caller reset it to 0).
LAUNCHES = 0

# A block's shared memory on Hopper: 227 KB (232,448 bytes).
MAX_SHARED_BYTES = 232_448

_P = ctypes.c_void_p
_F = ctypes.c_float
_I = ctypes.c_int


def shared_bytes(n_dim: int, max_lm: int) -> int:
    """Shared memory the kernel takes for one lane: sigma N^2 plus
    mu/mu0/B/K^T (8N), a 33-word reduction scratch, last_obs twice (6L),
    slot ids and two seen masks (3L) and three counters — the layout in
    ``csrc/ekf_frame_batched.cu`` (smem_words)."""
    return 4 * (n_dim * n_dim + 8 * n_dim + 33 + 9 * max_lm + 3)


def _lib():
    lib = _build.load("ekf_frame_batched")
    if lib.ekf_frame_launch.argtypes is None:
        lib.ekf_frame_launch.argtypes = (
            [_P] * 24 + [_I] * 4 + [_I, _F, _I, _F, _F, _I, _P]
        )
        lib.ekf_frame_launch.restype = _I
        lib.ekf_frame_smem_bytes.argtypes = [_I, _I]
        lib.ekf_frame_smem_bytes.restype = ctypes.c_longlong
        lib.ekf_frame_error_string.argtypes = [_I]
        lib.ekf_frame_error_string.restype = ctypes.c_char_p
    return lib


def _check(name: str, t: Tensor, shape: tuple, dtype, device) -> None:
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must be {list(shape)}, got {list(t.shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_inputs(state, pose, A, Q, ids, z, R9, valid, slots, config) -> None:
    f32, i32 = torch.float32, torch.int32
    B, N = state.mu.shape
    L = config.ekf.max_landmarks
    M = ids.shape[1] if ids.dim() == 2 else -1
    if N != 3 + 3 * L:
        raise ValueError(f"mu is [B, {N}], config max_landmarks {L} needs N = {3 + 3 * L}")
    dev = state.mu.device
    for name, t, shape, dtype in (
        ("mu", state.mu, (B, N), f32),
        ("sigma", state.sigma, (B, N, N), f32),
        ("slot_ids", state.slot_ids, (B, L), i32),
        ("n_landmarks", state.n_landmarks, (B,), i32),
        ("last_obs", state.last_obs, (B, L, 3), f32),
        ("seen_prev", state.seen_prev, (B, L), torch.bool),
        ("diverged", state.diverged, (B,), i32),
        ("dropped", state.dropped, (B,), i32),
        ("pose", pose, (B, 3), f32),
        ("A", A, (B, 9), f32),
        ("Q", Q, (B, 9), f32),
        ("ids", ids, (B, M), i32),
        ("z", z, (B, M, 3), f32),
        ("R9", R9, (B, M, 9), f32),
        ("valid", valid, (B, M), torch.bool),
        ("slots", slots, (B, M), i32),
    ):
        _check(name, t, shape, dtype, dev)


def frame_step_reference(state, pose, A, Q, ids, z, R9, valid, slots, config):
    """The plain version: the batched covariance predict, then the masked
    sequential update over the sorted observations, in torch ops."""
    B, M = ids.shape
    mu = state.mu.clone()
    mu[:, :3] = pose
    sigma = ekf.apply_predict(state.sigma, A.reshape(B, 3, 3), Q.reshape(B, 3, 3))
    frame = ekf.FrameObservations(ids, z, R9.reshape(B, M, 3, 3), valid)
    return ekf.apply_sorted(state._replace(mu=mu, sigma=sigma), frame, slots, config)


def frame_step_batched(
    state: ekf.EkfState,  # batch-major; sigma [B, N, N] float32
    pose: Tensor,  # [B, 3] predicted pose mean
    A: Tensor,  # [B, 9] composed pose Jacobian, row-major 3x3
    Q: Tensor,  # [B, 9] composed process noise
    ids: Tensor,  # [B, M] int32, sorted
    z: Tensor,  # [B, M, 3] float32
    R9: Tensor,  # [B, M, 9] float32
    valid: Tensor,  # [B, M] bool
    slots: Tensor,  # [B, M] int32 frame-start slots (ekf.lookup_slots), sorted
    config: SlamConfig,
) -> ekf.EkfState:
    """One EKF frame step (covariance predict + sequential observation
    updates + symmetrize) for every lane. ``state.initialized`` passes
    through unchanged. A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel."""
    _check_inputs(state, pose, A, Q, ids, z, R9, valid, slots, config)
    if state.mu.device.type == "cpu":
        return frame_step_reference(state, pose, A, Q, ids, z, R9, valid, slots, config)
    if state.mu.device.type != "cuda":
        raise ValueError(f"no kernel for device {state.mu.device}")
    return _launch(state, pose, A, Q, ids, z, R9, valid, slots, config)


def _launch(state, pose, A, Q, ids, z, R9, valid, slots, config):
    global LAUNCHES
    B, N = state.mu.shape
    M = ids.shape[1]
    L = config.ekf.max_landmarks
    need = shared_bytes(N, L)
    if need > MAX_SHARED_BYTES:
        largest = max(
            lm for lm in range(1, L)
            if shared_bytes(3 + 3 * lm, lm) <= MAX_SHARED_BYTES
        )
        raise ValueError(
            f"max_landmarks={L} needs {need} bytes of shared memory per lane; "
            f"a Hopper block holds at most {MAX_SHARED_BYTES} (227 KB), so "
            f"this kernel takes max_landmarks <= {largest}"
        )
    lib = _lib()
    if lib.ekf_frame_smem_bytes(N, L) != need:
        raise RuntimeError("shared_bytes() disagrees with the kernel's layout")
    out = ekf.EkfState(
        mu=torch.empty_like(state.mu),
        sigma=torch.empty_like(state.sigma),
        slot_ids=torch.empty_like(state.slot_ids),
        n_landmarks=torch.empty_like(state.n_landmarks),
        last_obs=torch.empty_like(state.last_obs),
        seen_prev=torch.empty_like(state.seen_prev),
        initialized=state.initialized,
        diverged=torch.empty_like(state.diverged),
        dropped=torch.empty_like(state.dropped),
    )
    cc = config.compat
    dev = state.mu.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ekf_frame_launch(
            state.mu.data_ptr(), state.sigma.data_ptr(), state.slot_ids.data_ptr(),
            state.n_landmarks.data_ptr(), state.last_obs.data_ptr(),
            state.seen_prev.data_ptr(), state.diverged.data_ptr(),
            state.dropped.data_ptr(),
            pose.data_ptr(), A.data_ptr(), Q.data_ptr(), ids.data_ptr(),
            z.data_ptr(), R9.data_ptr(), valid.data_ptr(), slots.data_ptr(),
            out.mu.data_ptr(), out.sigma.data_ptr(), out.slot_ids.data_ptr(),
            out.n_landmarks.data_ptr(), out.last_obs.data_ptr(),
            out.seen_prev.data_ptr(), out.diverged.data_ptr(),
            out.dropped.data_ptr(),
            B, N, L, M,
            int(cc.stationary_gate), cc.stationary_gate_eps**2,
            int(cc.reject_divergent), cc.divergence_ze_norm**2,
            cc.divergence_k_norm**2, int(config.ekf.symmetrize_sigma), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"ekf_frame kernel launch failed: {lib.ekf_frame_error_string(err).decode()}"
        )
    LAUNCHES += 1
    return out
