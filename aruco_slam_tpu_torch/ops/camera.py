"""Pinhole camera with Brown-Conrady distortion (L0) — counterpart of
``aruco_slam_tpu.ops.camera`` (reference ``cv::projectPoints`` and the
undistortion inside ``cv::aruco::estimatePoseSingleMarkers``).

:class:`CameraIntrinsics` is a frozen dataclass of Python floats, so it
reaches a kernel as scalar launch arguments with no host-device copy per
frame. The floats are rounded to float32 when the camera is made: those are
the values the kernels compute with, and the values the JAX package holds.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

Tensor = torch.Tensor


def _f32(x) -> float:
    return float(np.float32(x))


@dataclass(frozen=True)
class CameraIntrinsics:
    """Pinhole intrinsics + OpenCV 5-term distortion (k1, k2, p1, p2, k3),
    as the reference parses sensor_msgs/CameraInfo
    (src/aruco_slam_node.cpp:121-130)."""

    fx: float
    fy: float
    cx: float
    cy: float
    dist: tuple = (0.0, 0.0, 0.0, 0.0, 0.0)

    @classmethod
    def create(cls, fx, fy, cx, cy, dist=None) -> "CameraIntrinsics":
        d = (0.0,) * 5 if dist is None else tuple(_f32(v) for v in dist)
        if len(d) != 5:
            raise ValueError(f"dist needs 5 coefficients, got {len(d)}")
        return cls(_f32(fx), _f32(fy), _f32(cx), _f32(cy), d)

    @classmethod
    def from_camera_info(cls, K, D=None) -> "CameraIntrinsics":
        """From CameraInfo-style fields: row-major 3x3 ``K`` (9 floats) and
        the distortion list ``D``, padded/truncated to 5."""
        K = np.asarray(K, float).reshape(3, 3)
        d = np.zeros(5)
        if D is not None:
            D = np.asarray(D, float).ravel()
            d[: min(5, len(D))] = D[:5]
        return cls.create(K[0, 0], K[1, 1], K[0, 2], K[1, 2], dist=d)

    @property
    def matrix(self) -> np.ndarray:
        """3x3 K matrix (float32, host)."""
        return np.array(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            np.float32,
        )


def distort_normalized(pts: Tensor, dist) -> Tensor:
    """Apply Brown-Conrady distortion to normalized points ``[..., 2]``."""
    k1, k2, p1, p2, k3 = dist
    x, y = pts[..., 0], pts[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xy2 = 2.0 * x * y
    xd = x * radial + p1 * xy2 + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p2 * xy2 + p1 * (r2 + 2.0 * y * y)
    return torch.stack([xd, yd], dim=-1)


def undistort_normalized(pts: Tensor, dist, iters: int = 8) -> Tensor:
    """Invert the distortion by a fixed number of fixed-point steps
    (OpenCV's ``undistortPoints`` inner loop)."""
    k1, k2, p1, p2, k3 = dist
    xd, yd = pts[..., 0], pts[..., 1]
    x, y = xd, yd
    for _ in range(iters):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = p1 * 2.0 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p2 * 2.0 * x * y + p1 * (r2 + 2.0 * y * y)
        x, y = (xd - dx) / radial, (yd - dy) / radial
    return torch.stack([x, y], dim=-1)


def project_points(points_cam: Tensor, camera: CameraIntrinsics) -> Tensor:
    """Camera-frame points ``[..., 3]`` -> pixels ``[..., 2]``."""
    inv_z = 1.0 / points_cam[..., 2]
    d = distort_normalized(points_cam[..., :2] * inv_z[..., None], camera.dist)
    return torch.stack(
        [camera.fx * d[..., 0] + camera.cx, camera.fy * d[..., 1] + camera.cy],
        dim=-1,
    )


def transform_points(R: Tensor, t: Tensor, points: Tensor) -> Tensor:
    """Rigid transform: ``R [..., 3, 3] @ points [..., P, 3] + t [..., 3]``."""
    return points @ R.transpose(-1, -2) + t[..., None, :]


def pixels_to_normalized(
    pts: Tensor, camera: CameraIntrinsics, undistort: bool = True
) -> Tensor:
    """Pixels ``[..., 2]`` -> undistorted normalized image coordinates."""
    x = (pts[..., 0] - camera.cx) / camera.fx
    y = (pts[..., 1] - camera.cy) / camera.fy
    norm = torch.stack([x, y], dim=-1)
    return undistort_normalized(norm, camera.dist) if undistort else norm
