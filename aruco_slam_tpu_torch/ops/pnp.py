"""Planar square PnP + observation extraction (L2) — counterpart of
``aruco_slam_tpu.ops.pnp``, written over a leading ``[..., 4, 2]`` batch.

Replaces ``cv::aruco::estimatePoseSingleMarkers`` (reference
src/aruco_slam.cpp:314), the observation math of ``getObservations``
(:325-374) and ``CalculateCovariance`` (:437-471): a closed-form homography
(Heckbert) with a Zhang decomposition as the first start, the planar flip
as the second, a short Gauss-Newton settle on both, and the winner
finishing the iterations. Together with ``ops.frontend`` this is the plain
version of the K1 kernel (``ops/kernels/pnp_frontend.py``).

Corner order matches the reference's object points (aruco_slam.h:189):
top-left, top-right, bottom-right, bottom-left, at (-+L/2, +-L/2, 0).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from aruco_slam_tpu_torch.ops import geometry, linalg
from aruco_slam_tpu_torch.ops.camera import (
    CameraIntrinsics,
    pixels_to_normalized,
    project_points,
    transform_points,
)
from aruco_slam_tpu_torch.utils.device import resolve

Tensor = torch.Tensor


def marker_object_points(marker_length, dtype=torch.float32, device=None) -> Tensor:
    """Canonical square corners [4, 3]: TL, TR, BR, BL (aruco_slam.h:189),
    on ``device`` (None: the card)."""
    h = marker_length / 2.0
    return torch.tensor(
        [[-h, h, 0.0], [h, h, 0.0], [h, -h, 0.0], [-h, -h, 0.0]],
        dtype=dtype, device=resolve(device),
    )


class PnPResult(NamedTuple):
    rvec: Tensor  # [..., 3] axis-angle, object -> camera
    tvec: Tensor  # [..., 3] object origin in camera frame
    rms_px: Tensor  # [...] mean-squared pixel reprojection error


def _normalize(v: Tensor) -> Tensor:
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def _homography_init(corners_norm: Tensor, marker_length):
    """Pose init by homography decomposition (Zhang): the unit-square
    homography composed with the unit -> object affine map, columns scaled
    by the mean column norm, a symmetrized Gram-Schmidt onto SO(3)."""
    dtype, device = corners_norm.dtype, corners_norm.device
    Hu = linalg.homography_unit_square(corners_norm)
    h = marker_length / 2.0
    L = marker_length
    A_inv = torch.tensor(
        [[1.0 / L, 0.0, h / L], [0.0, -1.0 / L, h / L], [0.0, 0.0, 1.0]],
        dtype=dtype, device=device,
    )
    H = Hu @ A_inv
    h1, h2, h3 = H[..., :, 0], H[..., :, 1], H[..., :, 2]
    n1 = torch.linalg.vector_norm(h1, dim=-1, keepdim=True)
    n2 = torch.linalg.vector_norm(h2, dim=-1, keepdim=True)
    lam = 2.0 / (n1 + n2)
    r1, r2, t = h1 * lam, h2 * lam, h3 * lam
    # the marker must sit in front of the camera
    flip = torch.where(t[..., 2:3] < 0, -1.0, 1.0).to(dtype)
    r1, r2, t = r1 * flip, r2 * flip, t * flip
    r1n = _normalize(r1)
    r2o = r2 - torch.sum(r2 * r1n, dim=-1, keepdim=True) * 0.5 * r1n
    r1o = r1n - torch.sum(r1n * r2o, dim=-1, keepdim=True) * 0.5 * r2o / torch.sum(
        r2o * r2o, dim=-1, keepdim=True
    )
    r1o = _normalize(r1o)
    r2o = r2o - torch.sum(r2o * r1o, dim=-1, keepdim=True) * r1o
    r2o = _normalize(r2o)
    r3 = torch.linalg.cross(r1o, r2o, dim=-1)
    return torch.stack([r1o, r2o, r3], dim=-1), t


def _planar_flip(R: Tensor, t: Tensor) -> Tensor:
    """Second solution of the two-fold planar-pose ambiguity: reflect the
    marker normal about the viewing ray (Schweighofer & Pinz)."""
    v = _normalize(t)
    n = R[..., :, 2]
    axis_raw = torch.linalg.cross(v, n, dim=-1)
    s = torch.linalg.vector_norm(axis_raw, dim=-1, keepdim=True)
    axis = axis_raw / torch.clamp(s, min=1e-9)
    theta = torch.atan2(s, torch.sum(v * n, dim=-1, keepdim=True))
    return geometry.rodrigues(axis * (-2.0 * theta)) @ R


def _gauss_newton_refine(R, t, corners_norm, obj_pts, iters: int):
    """Gauss-Newton on normalized reprojection residuals with the rotation
    parameterized incrementally (R <- R exp(skew(dw))), closed-form
    Jacobian, unrolled 6x6 Cholesky solve and a cheap trust region (a step
    is kept only if it lowers the residual). Returns (R, t, sum r^2)."""
    eye6 = 1e-9 * torch.eye(6, dtype=t.dtype, device=t.device)
    X, Y, Z = obj_pts[:, 0], obj_pts[:, 1], obj_pts[:, 2]
    zo = torch.zeros_like(X)
    skewX = torch.stack(
        [
            torch.stack([zo, -Z, Y], dim=-1),
            torch.stack([Z, zo, -X], dim=-1),
            torch.stack([-Y, X, zo], dim=-1),
        ],
        dim=-2,
    )  # [4, 3, 3]

    def residual_of(R, t):
        pc = transform_points(R, t, obj_pts)  # [..., 4, 3]
        proj = pc[..., :2] / pc[..., 2:3]
        return (proj - corners_norm).flatten(-2), pc

    r, pc = residual_of(R, t)
    for _ in range(iters):
        x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
        inv_z = 1.0 / z
        zero = torch.zeros_like(x)
        dpdc = torch.stack(
            [
                torch.stack([inv_z, zero, -x * inv_z * inv_z], dim=-1),
                torch.stack([zero, inv_z, -y * inv_z * inv_z], dim=-1),
            ],
            dim=-2,
        )  # [..., 4, 2, 3]
        J_rot = dpdc @ (-(R[..., None, :, :] @ skewX))
        J = torch.cat([J_rot, dpdc], dim=-1).flatten(-3, -2)  # [..., 8, 6]
        Jt = J.transpose(-1, -2)
        delta = linalg.solve_spd(Jt @ J + eye6, (Jt @ r[..., None])[..., 0], 6)
        R_new = R @ geometry.rodrigues(delta[..., :3] * -1.0)
        t_new = t - delta[..., 3:]
        r_new, pc_new = residual_of(R_new, t_new)
        better = torch.sum(r_new**2, dim=-1) < torch.sum(r**2, dim=-1)
        R = torch.where(better[..., None, None], R_new, R)
        t = torch.where(better[..., None], t_new, t)
        r = torch.where(better[..., None], r_new, r)
        pc = torch.where(better[..., None, None], pc_new, pc)
    return R, t, torch.sum(r**2, dim=-1)


def solve_pnp_square(
    corners_px: Tensor,
    camera: CameraIntrinsics,
    marker_length,
    refine_iters: int = 10,
) -> PnPResult:
    """Marker pose from its 4 pixel corners, ``corners_px [..., 4, 2]``.

    Dual start: the planar pose is two-fold ambiguous at shallow view
    angles, so both candidate rotations settle for 2 iterations and the
    lower-residual one finishes the remaining ``refine_iters - 2``."""
    dtype, device = corners_px.dtype, corners_px.device
    obj_pts = marker_object_points(marker_length, dtype, device)
    corners_norm = pixels_to_normalized(corners_px, camera)
    R0, t0 = _homography_init(corners_norm, marker_length)
    settle = min(2, refine_iters)
    Ra, ta, ra = _gauss_newton_refine(R0, t0, corners_norm, obj_pts, settle)
    Rb, tb, rb = _gauss_newton_refine(
        _planar_flip(R0, t0), t0, corners_norm, obj_pts, settle
    )
    pick_b = rb < ra
    R1 = torch.where(pick_b[..., None, None], Rb, Ra)
    t1 = torch.where(pick_b[..., None], tb, ta)
    R, tvec, _ = _gauss_newton_refine(
        R1, t1, corners_norm, obj_pts, max(refine_iters - settle, 1)
    )
    rvec = geometry.inv_rodrigues(R)
    # Mean-squared pixel reprojection error: the reference's "rmserror" is
    # the MSE (src/aruco_slam.cpp:460-465). Preserved semantics.
    proj = project_points(
        transform_points(geometry.rodrigues(rvec), tvec, obj_pts), camera
    )
    rms = torch.mean(torch.sum((proj - corners_px) ** 2, dim=-1), dim=-1)
    return PnPResult(rvec=rvec, tvec=tvec, rms_px=rms)


def observation_covariance(
    rms_px, tvec, corners_px, marker_length, r_x, r_y, r_theta
) -> Tensor:
    """Diagonal 3x3 observation covariance from the reprojection error
    (``ArucoSlam::CalculateCovariance``, src/aruco_slam.cpp:437-471)."""
    diag = torch.linalg.vector_norm(
        corners_px[..., 0, :] - corners_px[..., 2, :], dim=-1
    )
    object_error = (rms_px / diag) * (
        torch.linalg.vector_norm(tvec, dim=-1) / marker_length
    )
    d = torch.stack(
        [
            object_error * r_x + 1e-2,
            object_error * r_y + 1e-2,
            object_error * r_theta + 1e-3,
        ],
        dim=-1,
    )
    return torch.diag_embed(d)


def camera_observation_to_robot(rvec: Tensor, tvec: Tensor, t_r2c_xy) -> Tensor:
    """Marker pose in the camera optical frame -> planar robot-frame
    observation (x, y, theta): x = tvec_z + t_x, y = -tvec_x + t_y,
    theta = atan2(-R02, R22) (src/aruco_slam.cpp:359-362)."""
    R = geometry.rodrigues(rvec)
    x = tvec[..., 2] + t_r2c_xy[0]
    y = -tvec[..., 0] + t_r2c_xy[1]
    theta = geometry.wrap_angle(torch.atan2(-R[..., 0, 2], R[..., 2, 2]))
    return torch.stack([x, y, theta], dim=-1)
