"""K1: the batched PnP front-end as one CUDA kernel launch
(``csrc/pnp_frontend.cu``, a group of 8 threads per (sequence, marker-slot)
lane: one per (Gauss-Newton start, corner)).

Counterpart of ``aruco_slam_tpu.ops.kernels.pnp_frontend`` with the same
contract: corners ``[B, M, 4, 2]`` and the slot mask ``[B, M]`` in, the
robot-frame observation ``z [B, M, 3]``, its diagonal covariance
``R [B, M, 3, 3]`` and the gate ``keep [B, M]`` out. The plain version is
``ops.frontend.observations_from_corners`` (square PnP in torch ops); the
wrapper takes it for a CPU tensor and launches the kernel, or raises, for a
CUDA tensor. The kernel reads ``valid`` itself: a padded slot exits at once
with keep = 0 (and z = 0, R = I), so ``keep`` needs no masking after it.
"""

from __future__ import annotations

import ctypes

import torch

from aruco_slam_tpu_torch.ops import frontend
from aruco_slam_tpu_torch.ops.camera import CameraIntrinsics
from aruco_slam_tpu_torch.ops.kernels import _build
from aruco_slam_tpu_torch.utils.config import SlamConfig

Tensor = torch.Tensor

# Kernel launches since import (or since a caller reset it to 0): a run
# shows it went through the kernel by this count growing.
LAUNCHES = 0

_P = ctypes.c_void_p
_F = ctypes.c_float
_I = ctypes.c_int


def _lib():
    lib = _build.load("pnp_frontend")
    if lib.pnp_frontend_launch.argtypes is None:
        lib.pnp_frontend_launch.argtypes = [_P] * 5 + [_I] + [_F] * 16 + [_I, _I, _P]
        lib.pnp_frontend_launch.restype = _I
        lib.pnp_frontend_error_string.argtypes = [_I]
        lib.pnp_frontend_error_string.restype = ctypes.c_char_p
    return lib


def _check_inputs(corners: Tensor, valid: Tensor) -> None:
    if corners.dim() != 4 or corners.shape[2:] != (4, 2):
        raise ValueError(f"corners must be [B, M, 4, 2], got {tuple(corners.shape)}")
    if valid.shape != corners.shape[:2]:
        raise ValueError(
            f"valid must be [B, M] = {tuple(corners.shape[:2])}, got {tuple(valid.shape)}"
        )
    if corners.dtype != torch.float32:
        raise TypeError(f"corners must be float32, got {corners.dtype}")
    if valid.dtype != torch.bool:
        raise TypeError(f"valid must be bool, got {valid.dtype}")
    if corners.device != valid.device:
        raise ValueError(f"corners on {corners.device}, valid on {valid.device}")
    if not (corners.is_contiguous() and valid.is_contiguous()):
        raise ValueError("corners and valid must be contiguous")


def pnp_frontend_reference(corners, valid, camera, config):
    """The plain version: square PnP + gates in torch ops."""
    ids = torch.zeros(valid.shape, dtype=torch.int32, device=valid.device)
    obs = frontend.observations_from_corners(ids, corners, valid, camera, config)
    return obs.z, obs.R, obs.valid


def pnp_frontend_batch(
    corners: Tensor,  # [B, M, 4, 2] float32 pixel corners
    valid: Tensor,  # [B, M] bool
    camera: CameraIntrinsics,
    config: SlamConfig,
):
    """Batched PnP front-end. Returns (z [B, M, 3], R [B, M, 3, 3]
    diagonal, keep [B, M] bool). A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel."""
    _check_inputs(corners, valid)
    if corners.device.type == "cpu":
        return pnp_frontend_reference(corners, valid, camera, config)
    if corners.device.type != "cuda":
        raise ValueError(f"no kernel for device {corners.device}")
    return _launch(corners, valid, camera, config)


def _launch(corners, valid, camera, config):
    global LAUNCHES
    B, M = valid.shape
    lanes = B * M
    dev = corners.device
    z = torch.empty(B, M, 3, dtype=torch.float32, device=dev)
    R = torch.empty(B, M, 3, 3, dtype=torch.float32, device=dev)
    keep = torch.empty(B, M, dtype=torch.bool, device=dev)
    iters = config.aruco.pnp_refine_iters
    settle = min(2, iters)
    finish = max(iters - settle, 1)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pnp_frontend_launch(
            corners.data_ptr(), valid.data_ptr(), z.data_ptr(), R.data_ptr(), keep.data_ptr(),
            lanes,
            camera.fx, camera.fy, camera.cx, camera.cy,
            config.aruco.marker_length / 2.0, config.useful_distance_threshold,
            config.covariance.R_x, config.covariance.R_y, config.covariance.R_theta,
            config.t_r2c_x, config.t_r2c_y, *camera.dist,
            settle, finish, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"pnp_frontend kernel launch failed: {lib.pnp_frontend_error_string(err).decode()}"
        )
    LAUNCHES += 1
    return z, R, keep
