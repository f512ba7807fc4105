"""Vision front-end (L2): corners -> gated EKF observations, over a
``[B, M]`` batch of (sequence, marker-slot) lanes. Counterpart of
``aruco_slam_tpu.ops.frontend``; with ``ops.pnp`` it is the plain version
of the K1 kernel (``ops/kernels/pnp_frontend.py``)."""

from __future__ import annotations

import torch

from aruco_slam_tpu_torch.models.ekf import FrameObservations
from aruco_slam_tpu_torch.ops import pnp
from aruco_slam_tpu_torch.ops.camera import CameraIntrinsics
from aruco_slam_tpu_torch.utils.config import SlamConfig

Tensor = torch.Tensor


def observations_from_corners(
    ids: Tensor,  # [..., M] int32
    corners_px: Tensor,  # [..., M, 4, 2]
    valid: Tensor,  # [..., M] bool
    camera: CameraIntrinsics,
    config: SlamConfig,
) -> FrameObservations:
    """Square PnP + gates -> FrameObservations. Gates as the reference's:
    the range gate ||tvec|| <= the effective 3 m threshold
    (src/aruco_slam.cpp:327-333) and the covariance Frobenius-norm gate
    ||R|| <= 1 (:367-368). NaN from garbage corners fails both."""
    res = pnp.solve_pnp_square(
        corners_px, camera, config.aruco.marker_length,
        config.aruco.pnp_refine_iters,
    )
    z = pnp.camera_observation_to_robot(
        res.rvec, res.tvec, (config.t_r2c_x, config.t_r2c_y)
    )
    R = pnp.observation_covariance(
        res.rms_px, res.tvec, corners_px, config.aruco.marker_length,
        config.covariance.R_x, config.covariance.R_y, config.covariance.R_theta,
    )
    keep = (
        valid
        & (torch.linalg.vector_norm(res.tvec, dim=-1) <= config.useful_distance_threshold)
        & (torch.linalg.matrix_norm(R) <= 1.0)
    )
    return FrameObservations(ids=ids, z=z, R=R, valid=keep)


def observations_direct(ids: Tensor, z: Tensor, R: Tensor, valid: Tensor) -> FrameObservations:
    """Measurement-level stream passthrough (sim level 'obs'): the
    observations as they are."""
    return FrameObservations(ids=ids, z=z, R=R, valid=valid)
