"""The PnP front-end's plain reference: a frozen copy of the port's
``ops.pnp`` and ``ops.frontend`` (square-marker pose from 4 pixel corners:
a homography start and its planar flip, 2 Gauss-Newton steps on each, the
better one finishing; then the robot-frame observation, the
reprojection-error covariance and the range and covariance gates), in the
dtype of its input, for a pinhole camera without distortion.

It runs over every frame of a sequence at once: the front-end has no
state, so a replay's observations are one call.
"""

from __future__ import annotations

import math

import torch

Tensor = torch.Tensor


def wrap(a: Tensor) -> Tensor:
    """Into [-pi, pi) with one two-sided correction (the estimator's)."""
    a = torch.where(a >= math.pi, a - 2.0 * math.pi, a)
    return torch.where(a < -math.pi, a + 2.0 * math.pi, a)


def _skew(x, y, z):
    o = torch.zeros_like(x)
    return torch.stack([torch.stack([o, -z, y], -1), torch.stack([z, o, -x], -1),
                        torch.stack([-y, x, o], -1)], -2)


def rodrigues(rvec: Tensor) -> Tensor:
    theta = torch.linalg.vector_norm(rvec, dim=-1, keepdim=True)
    small = theta < 1e-8
    axis = rvec / torch.where(small, torch.ones_like(theta), theta)
    K = _skew(axis[..., 0], axis[..., 1], axis[..., 2])
    th = theta[..., None]
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device).expand(K.shape)
    R = eye + torch.sin(th) * K + (1.0 - torch.cos(th)) * (K @ K)
    return torch.where(small[..., None], eye + _skew(rvec[..., 0], rvec[..., 1], rvec[..., 2]), R)


def inv_rodrigues(R: Tensor) -> Tensor:
    """Axis-angle of R (the generic branch and the near-pi pivot branch)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    w = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], -1)
    sin_t = 0.5 * torch.linalg.vector_norm(w, dim=-1)
    theta = torch.atan2(sin_t, cos_t)
    small = theta < 1e-6
    scale = torch.where(small, torch.full_like(theta, 0.5),
                        theta / torch.where(small, torch.ones_like(theta), 2.0 * sin_t))
    generic = w * scale[..., None]
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], -1)
    sym = 0.25 * (R + R.transpose(-1, -2))

    def pivot_axis(p):
        a = torch.sqrt(torch.clamp((diag[..., p] + 1.0) * 0.5, min=1e-12))
        comps = [sym[..., p, i] / a for i in range(3)]
        comps[p] = a
        return torch.stack(comps, -1)

    pivot = torch.argmax(diag, dim=-1)
    cand = torch.stack([pivot_axis(p) for p in range(3)], -2)
    axis = torch.gather(cand, -2, pivot[..., None, None].expand(*pivot.shape, 1, 3))[..., 0, :]
    axis = axis / torch.linalg.vector_norm(axis, dim=-1, keepdim=True)
    axis = torch.where(torch.sum(axis * w, -1, keepdim=True) < 0.0, -axis, axis)
    return torch.where((math.pi - theta < 5e-3)[..., None], axis * theta[..., None], generic)


def _solve_spd6(A: Tensor, b: Tensor) -> Tensor:
    """A x = b by an unrolled Cholesky, pivots floored at 1e-30."""
    n = 6
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = torch.sqrt(torch.clamp(s, min=1e-30)) if i == j else s / L[j][j]
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, -1)


def _homography_unit_square(q: Tensor) -> Tensor:
    x0, y0, x1, y1 = q[..., 0, 0], q[..., 0, 1], q[..., 1, 0], q[..., 1, 1]
    x2, y2, x3, y3 = q[..., 2, 0], q[..., 2, 1], q[..., 3, 0], q[..., 3, 1]
    sx, sy = x0 - x1 + x2 - x3, y0 - y1 + y2 - y3
    dx1, dx2, dy1, dy2 = x1 - x2, x3 - x2, y1 - y2, y3 - y2
    inv_det = 1.0 / (dx1 * dy2 - dx2 * dy1)
    g = (sx * dy2 - sy * dx2) * inv_det
    h = (sy * dx1 - sx * dy1) * inv_det
    return torch.stack([torch.stack([x1 - x0 + g * x1, x3 - x0 + h * x3, x0], -1),
                        torch.stack([y1 - y0 + g * y1, y3 - y0 + h * y3, y0], -1),
                        torch.stack([g, h, torch.ones_like(g)], -1)], -2)


def _unit(v):
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def _homography_init(cn: Tensor, length: float):
    """Zhang's decomposition of the square's homography, onto SO(3)."""
    h, L = length / 2.0, length
    A_inv = torch.tensor([[1.0 / L, 0.0, h / L], [0.0, -1.0 / L, h / L], [0.0, 0.0, 1.0]],
                         dtype=cn.dtype, device=cn.device)
    H = _homography_unit_square(cn) @ A_inv
    h1, h2, h3 = H[..., :, 0], H[..., :, 1], H[..., :, 2]
    lam = 2.0 / (torch.linalg.vector_norm(h1, dim=-1, keepdim=True)
                 + torch.linalg.vector_norm(h2, dim=-1, keepdim=True))
    r1, r2, t = h1 * lam, h2 * lam, h3 * lam
    flip = torch.where(t[..., 2:3] < 0, -1.0, 1.0).to(cn.dtype)  # in front of the camera
    r1, r2, t = r1 * flip, r2 * flip, t * flip
    r1n = _unit(r1)
    r2o = r2 - torch.sum(r2 * r1n, -1, keepdim=True) * 0.5 * r1n
    r1o = _unit(r1n - torch.sum(r1n * r2o, -1, keepdim=True) * 0.5 * r2o
                / torch.sum(r2o * r2o, -1, keepdim=True))
    r2o = _unit(r2o - torch.sum(r2o * r1o, -1, keepdim=True) * r1o)
    return torch.stack([r1o, r2o, torch.linalg.cross(r1o, r2o, dim=-1)], -1), t


def _planar_flip(R: Tensor, t: Tensor) -> Tensor:
    v, n = _unit(t), R[..., :, 2]
    axis_raw = torch.linalg.cross(v, n, dim=-1)
    s = torch.linalg.vector_norm(axis_raw, dim=-1, keepdim=True)
    theta = torch.atan2(s, torch.sum(v * n, -1, keepdim=True))
    return rodrigues(axis_raw / torch.clamp(s, min=1e-9) * (-2.0 * theta)) @ R


def _transform(R, t, pts):
    return pts @ R.transpose(-1, -2) + t[..., None, :]


def _gauss_newton(R, t, cn, obj, iters):
    eye6 = 1e-9 * torch.eye(6, dtype=t.dtype, device=t.device)
    X, Y, Z = obj[:, 0], obj[:, 1], obj[:, 2]
    skewX = _skew(X, Y, Z)  # [4, 3, 3]

    def residual(R, t):
        pc = _transform(R, t, obj)
        return (pc[..., :2] / pc[..., 2:3] - cn).flatten(-2), pc

    r, pc = residual(R, t)
    for _ in range(iters):
        x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
        iz = 1.0 / z
        o = torch.zeros_like(x)
        dpdc = torch.stack([torch.stack([iz, o, -x * iz * iz], -1),
                            torch.stack([o, iz, -y * iz * iz], -1)], -2)
        J = torch.cat([dpdc @ (-(R[..., None, :, :] @ skewX)), dpdc], -1).flatten(-3, -2)
        Jt = J.transpose(-1, -2)
        delta = _solve_spd6(Jt @ J + eye6, (Jt @ r[..., None])[..., 0])
        R_new = R @ rodrigues(-delta[..., :3])
        t_new = t - delta[..., 3:]
        r_new, pc_new = residual(R_new, t_new)
        better = torch.sum(r_new**2, -1) < torch.sum(r**2, -1)
        R = torch.where(better[..., None, None], R_new, R)
        t = torch.where(better[..., None], t_new, t)
        r = torch.where(better[..., None], r_new, r)
        pc = torch.where(better[..., None, None], pc_new, pc)
    return R, t, torch.sum(r**2, -1)


def frontend(corners: Tensor, valid: Tensor, cam: dict, est: dict):
    """Corners ``[..., 4, 2]`` (pixels) -> (z [..., 3], R [..., 3, 3], keep
    [...]) in the corners' dtype: the port's ``observations_from_corners``
    with its gates, ``||tvec|| <= useful_distance_m`` and ``||R||_F <= 1``."""
    length, iters = est["marker_length_m"], est["pnp_refine_iters"]
    dt, dev = corners.dtype, corners.device
    h = length / 2.0
    obj = torch.tensor([[-h, h, 0.0], [h, h, 0.0], [h, -h, 0.0], [-h, -h, 0.0]], dtype=dt,
                       device=dev)
    cn = torch.stack([(corners[..., 0] - cam["cx"]) / cam["fx"],
                      (corners[..., 1] - cam["cy"]) / cam["fy"]], -1)
    R0, t0 = _homography_init(cn, length)
    settle = min(2, iters)
    Ra, ta, ra = _gauss_newton(R0, t0, cn, obj, settle)
    Rb, tb, rb = _gauss_newton(_planar_flip(R0, t0), t0, cn, obj, settle)
    pick_b = rb < ra
    R1 = torch.where(pick_b[..., None, None], Rb, Ra)
    t1 = torch.where(pick_b[..., None], tb, ta)
    Rm, tvec, _ = _gauss_newton(R1, t1, cn, obj, max(iters - settle, 1))
    rvec = inv_rodrigues(Rm)
    Rr = rodrigues(rvec)
    pc = _transform(Rr, tvec, obj)
    proj = torch.stack([cam["fx"] * pc[..., 0] / pc[..., 2] + cam["cx"],
                        cam["fy"] * pc[..., 1] / pc[..., 2] + cam["cy"]], -1)
    rms = torch.mean(torch.sum((proj - corners) ** 2, -1), -1)
    # the observation in the robot frame (camera on the robot's centre)
    z = torch.stack([tvec[..., 2], -tvec[..., 0],
                     wrap(torch.atan2(-Rr[..., 0, 2], Rr[..., 2, 2]))], -1)
    diag = torch.linalg.vector_norm(corners[..., 0, :] - corners[..., 2, :], dim=-1)
    rng = torch.linalg.vector_norm(tvec, dim=-1)
    err = (rms / diag) * (rng / length)
    R = torch.diag_embed(torch.stack([err * est["R_x"] + 1e-2, err * est["R_y"] + 1e-2,
                                      err * est["R_theta"] + 1e-3], -1))
    keep = valid & (rng <= est["useful_distance_m"]) & (torch.linalg.matrix_norm(R) <= 1.0)
    return z, R, keep, rng
