"""Planar / 3-D geometry primitives (L0), batched over leading dims.

Counterparts of ``aruco_slam_tpu.ops.geometry``: ``wrap_angle`` (reference
``ArucoSlam::normAngle``, src/aruco_slam.cpp:412-421), ``rodrigues`` /
``inv_rodrigues`` (reference ``cv::Rodrigues`` call sites) and the SE(2)
relative pose the EKF observation model and the RPE metric use.
"""

from __future__ import annotations

import math

import torch

Tensor = torch.Tensor


def wrap_angle(a: Tensor) -> Tensor:
    """Wrap into [-pi, pi) with the reference's single two-sided
    correction (exact for inputs within (-3 pi, 3 pi), every call site).
    Not ``remainder``: that rounds differently near the boundary."""
    two_pi = 2.0 * math.pi
    a = torch.where(a >= math.pi, a - two_pi, a)
    return torch.where(a < -math.pi, a + two_pi, a)


def se2_relative(a: Tensor, b: Tensor) -> Tensor:
    """b expressed in a's frame, ``[..., 3]`` — the EKF's z_hat
    (src/aruco_slam.cpp:127-134)."""
    dx = b[..., 0] - a[..., 0]
    dy = b[..., 1] - a[..., 1]
    dth = wrap_angle(b[..., 2] - a[..., 2])
    c, s = torch.cos(a[..., 2]), torch.sin(a[..., 2])
    return torch.stack([dx * c + dy * s, -dx * s + dy * c, dth], dim=-1)


def _skew(x: Tensor, y: Tensor, z: Tensor) -> Tensor:
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def rodrigues(rvec: Tensor) -> Tensor:
    """Axis-angle ``[..., 3]`` -> rotation ``[..., 3, 3]``; the series form
    I + skew(rvec) below theta 1e-8."""
    theta = torch.linalg.vector_norm(rvec, dim=-1, keepdim=True)
    small = theta < 1e-8
    axis = rvec / torch.where(small, torch.ones_like(theta), theta)
    K = _skew(axis[..., 0], axis[..., 1], axis[..., 2])
    th = theta[..., None]
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device).expand(K.shape)
    R = eye + torch.sin(th) * K + (1.0 - torch.cos(th)) * (K @ K)
    R_small = eye + _skew(rvec[..., 0], rvec[..., 1], rvec[..., 2])
    return torch.where(small[..., None], R_small, R)


def inv_rodrigues(R: Tensor) -> Tensor:
    """Rotation ``[..., 3, 3]`` -> axis-angle ``[..., 3]``. theta from
    atan2(sin, cos); near pi the axis comes from the largest diagonal pivot
    with its sign aligned to the skew part."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    w = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    )
    sin_theta = 0.5 * torch.linalg.vector_norm(w, dim=-1)
    theta = torch.atan2(sin_theta, cos_theta)
    small = theta < 1e-6
    near_pi = math.pi - theta < 5e-3
    scale = torch.where(
        small,
        torch.full_like(theta, 0.5),
        theta / torch.where(small, torch.ones_like(theta), 2.0 * sin_theta),
    )
    generic = w * scale[..., None]

    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    sym = 0.25 * (R + R.transpose(-1, -2))

    def axis_from_pivot(p):
        a_p = torch.sqrt(torch.clamp((diag[..., p] + 1.0) * 0.5, min=1e-12))
        comps = [sym[..., p, i] / a_p for i in range(3)]
        comps[p] = a_p
        return torch.stack(comps, dim=-1)

    pivot = torch.argmax(diag, dim=-1)
    cand = torch.stack([axis_from_pivot(p) for p in range(3)], dim=-2)
    idx = pivot[..., None, None].expand(*pivot.shape, 1, 3)
    axis_pi = torch.gather(cand, -2, idx)[..., 0, :]
    axis_pi = axis_pi / torch.linalg.vector_norm(axis_pi, dim=-1, keepdim=True)
    flip = torch.sum(axis_pi * w, dim=-1, keepdim=True) < 0.0
    axis_pi = torch.where(flip, -axis_pi, axis_pi)
    return torch.where(near_pi[..., None], axis_pi * theta[..., None], generic)


def homography_from_4pts(src: Tensor, dst: Tensor) -> Tensor:
    """Exact homography mapping 4 source points to 4 destination points:
    ``src, dst [..., 4, 2]`` -> ``[..., 3, 3]`` with H[2, 2] = 1, by the
    8x8 DLT solve."""
    x, y = src[..., 0], src[..., 1]
    u, v = dst[..., 0], dst[..., 1]
    zeros = torch.zeros_like(x)
    ones = torch.ones_like(x)
    ru = torch.stack([x, y, ones, zeros, zeros, zeros, -u * x, -u * y], dim=-1)
    rv = torch.stack([zeros, zeros, zeros, x, y, ones, -v * x, -v * y], dim=-1)
    A = torch.cat([ru, rv], dim=-2)  # [..., 8, 8]
    b = torch.cat([u, v], dim=-1)[..., None]  # [..., 8, 1]
    h = torch.linalg.solve(A, b)[..., 0]
    return torch.cat([h, torch.ones_like(h[..., :1])], dim=-1).reshape(*h.shape[:-1], 3, 3)


def apply_homography(H: Tensor, pts: Tensor) -> Tensor:
    """Projective transform: ``H [..., 3, 3]`` applied to ``pts [..., N, 2]``."""
    ph = torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)  # [..., N, 3]
    out = ph @ H.transpose(-1, -2)
    return out[..., :2] / out[..., 2:3]
