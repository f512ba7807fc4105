"""Trajectory / map evaluation (L4): ATE, RPE, landmark map error —
counterparts of ``aruco_slam_tpu.utils.metrics`` for one trajectory."""

from __future__ import annotations

import torch

from aruco_slam_tpu_torch.ops import geometry

Tensor = torch.Tensor


def ate(est_xy: Tensor, true_xy: Tensor, align: bool = False) -> Tensor:
    """Absolute trajectory error: RMSE of the 2-D position error, after a
    least-squares SE(2) alignment when ``align``."""
    est, true = est_xy[..., :2], true_xy[..., :2]
    if align:
        est = align_se2(est, true)
    return torch.sqrt(torch.mean(torch.sum((est - true) ** 2, dim=-1)))


def align_se2(src: Tensor, dst: Tensor) -> Tensor:
    """Least-squares rotation+translation aligning src points [F, 2] to dst."""
    mu_s, mu_d = src.mean(dim=0), dst.mean(dim=0)
    C = (src - mu_s).T @ (dst - mu_d)
    theta = torch.atan2(C[0, 1] - C[1, 0], C[0, 0] + C[1, 1])
    c, s = torch.cos(theta), torch.sin(theta)
    R = torch.stack([torch.stack([c, -s]), torch.stack([s, c])])
    return (src - mu_s) @ R.T + mu_d


def rpe(est_pose: Tensor, true_pose: Tensor, delta: int = 10):
    """Relative pose error over a frame gap: (translation RMSE, rot RMSE)."""
    de = geometry.se2_relative(est_pose[:-delta], est_pose[delta:])
    dt = geometry.se2_relative(true_pose[:-delta], true_pose[delta:])
    err = de - dt
    trans = torch.sqrt(torch.mean(torch.sum(err[..., :2] ** 2, dim=-1)))
    rot = torch.sqrt(torch.mean(geometry.wrap_angle(err[..., 2]) ** 2))
    return trans, rot


def map_error(est_lms, est_ids, active, true_lms, true_ids):
    """Per-landmark position RMSE matched by marker id. Returns
    (rmse, n_matched)."""
    hit = est_ids[:, None] == true_ids[None, :]  # [max_lm, L]
    matched = hit.any(dim=1) & active
    ref = true_lms[torch.argmax(hit.to(torch.int32), dim=1)]
    err2 = torch.sum((est_lms[:, :2] - ref[:, :2]) ** 2, dim=-1)
    n = matched.sum()
    rmse = torch.sqrt(
        torch.where(matched, err2, torch.zeros_like(err2)).sum()
        / torch.clamp(n, min=1)
    )
    return rmse, n
