"""Pose-graph optimization (L5), the landmark-free case of the factor-graph
back-end — counterpart of ``aruco_slam_tpu.models.pose_graph``.

A pose graph is a :class:`~aruco_slam_tpu_torch.models.ba.BAProblem` with
only relative-pose factors (odometry chain + loop closures); the Schur stage
has nothing to eliminate and the solver reduces to preconditioned CG on the
pose block. :func:`build` makes the host problem, :func:`solve` runs
``models.ba`` on it on a device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from aruco_slam_tpu_torch import convert
from aruco_slam_tpu_torch.models import ba
from aruco_slam_tpu_torch.models.ba import BAProblem


class PoseGraph(NamedTuple):
    problem: BAProblem  # numpy arrays


def build(
    initial_poses: np.ndarray,  # [K, 3]
    odometry: np.ndarray,  # [K-1, 3] relative motions i -> i+1
    odo_info: float | np.ndarray = 1e4,
    closures: list | None = None,  # [(i, j, z_rel [3], info 3x3 or float)]
    prior_info: float = 1e8,
    dtype=np.float32,
) -> PoseGraph:
    """The chain of ``odometry`` factors (information ``odo_info``, a float
    for an isotropic weight or a 3x3 matrix), then the ``closures`` in
    order, and a prior on pose 0."""
    K = len(initial_poses)
    eye = np.eye(3)

    def info3(w):
        return np.asarray(w * eye if np.isscalar(w) else w, float)

    closures = closures or []
    m = K - 1 + len(closures)
    odo_w = [info3(odo_info)] * (K - 1) + [info3(c[3]) for c in closures]
    problem = BAProblem(
        poses=np.asarray(initial_poses, dtype),
        landmarks=np.zeros((1, 3), dtype),
        obs_kf=np.zeros((1,), np.int32),
        obs_lm=np.zeros((1,), np.int32),
        obs_z=np.zeros((1, 3), dtype),
        obs_w=np.zeros((1, 3, 3), dtype),
        obs_valid=np.zeros((1,), bool),
        odo_i=np.asarray([*range(K - 1), *(int(c[0]) for c in closures)], np.int32),
        odo_j=np.asarray([*range(1, K), *(int(c[1]) for c in closures)], np.int32),
        odo_z=np.asarray([np.asarray(z, float) for z in odometry]
                         + [np.asarray(c[2], float) for c in closures], dtype).reshape(m, 3),
        odo_w=np.asarray(odo_w, dtype).reshape(m, 3, 3),
        odo_valid=np.ones((m,), bool),
        prior_w=(prior_info * eye).astype(dtype),
    )
    return PoseGraph(problem=problem)


def solve(graph: PoseGraph, iters: int = 8, cg_iters: int = 80, damping: float = 1e-4,
          device=None):
    """Returns (optimized poses [K, 3] on ``device`` (None: the card),
    BAStats)."""
    problem = convert.ba_problem_from_numpy(graph.problem, device)
    poses, _, stats = ba.solve(problem, iters=iters, cg_iters=cg_iters, damping=damping)
    return poses, stats
