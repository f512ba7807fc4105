"""High-level pipelines (L4/L5 composition): filter -> smoother — counterpart
of ``aruco_slam_tpu.pipeline``.

Run the single-stream EKF pass (``runner.replay``: K6 on the card), then
refine trajectory + map with the Schur-complement BA back-end
(:func:`ekf_then_ba`) or with a pose graph of marker re-observations
(:func:`ekf_then_pose_graph`), initialized from the filter's output. The
graphs are built on the host (numpy) and solved on ``device``.
"""

from __future__ import annotations

import numpy as np

from aruco_slam_tpu_torch import convert, runner
from aruco_slam_tpu_torch.models import ba, ekf, graph_builder, pose_graph
from aruco_slam_tpu_torch.utils.config import SlamConfig


def _ekf_pass(seq, config: SlamConfig, camera, level: str, device):
    """The EKF replay of ``seq`` on ``device`` and its trajectory [F, 3]
    (float32, host)."""
    if camera is None:
        camera = seq.camera()  # the calibration the sequence carries
    data = runner.replay_data_from_sequence(seq, level, device)
    result = runner.replay(data, config, camera, level)
    return result, result.trajectory.cpu().numpy()


def ekf_then_ba(
    seq,
    config: SlamConfig,
    camera=None,
    level: str = "obs",
    keyframe_stride: int = 1,
    ba_iters: int = 20,
    cg_iters: int = 200,
    damping: float = 1e-4,
    adaptive: bool = True,
    deflate_gauge: bool = True,
    device=None,
):
    """Full offline pipeline on ``device`` (None: the card). Returns a dict
    with the EKF result, the (numpy) BA problem, refined poses/landmarks
    (tensors), landmark ids and BA stats.

    The defaults are the JAX package's, from its config-2 study: gauge
    deflation lets 20 GN x 200 CG match what plain GN needed 60 x 400 for;
    ``keyframe_stride=1`` stiffens the flat "slow bend" valley of the
    marker-SLAM posterior; adaptive LM guards the stride-1 system against
    cost-increasing steps at low damping."""
    ekf_result, traj = _ekf_pass(seq, config, camera, level, device)
    lms, ids, active = (t[0].cpu().numpy() for t in ekf.get_map(ekf_result.final_state, config))
    init_landmarks = {int(ids[k]): lms[k] for k in range(len(ids)) if active[k]}

    problem, lm_ids = graph_builder.build_from_sequence(
        seq, config, keyframe_stride=keyframe_stride,
        init_poses=traj, init_landmarks=init_landmarks,
    )
    packed, static = ba.prepare(problem)
    poses, landmarks, stats = ba.solve(
        convert.ba_problem_from_numpy(packed, device), iters=ba_iters, cg_iters=cg_iters,
        damping=damping, adaptive=adaptive, deflate_gauge=deflate_gauge, **static,
    )
    return {
        "ekf_result": ekf_result,
        "problem": problem,
        "poses": poses,
        "landmarks": landmarks,
        "landmark_ids": lm_ids,
        "stats": stats,
    }


def _se2_compose(a, b):
    """SE(2) compose a ⊕ b (numpy, batched on leading dims)."""
    c, s = np.cos(a[..., 2]), np.sin(a[..., 2])
    return np.stack(
        [
            a[..., 0] + c * b[..., 0] - s * b[..., 1],
            a[..., 1] + s * b[..., 0] + c * b[..., 1],
            np.arctan2(np.sin(a[..., 2] + b[..., 2]), np.cos(a[..., 2] + b[..., 2])),
        ],
        axis=-1,
    )


def _se2_inverse(a):
    c, s = np.cos(a[..., 2]), np.sin(a[..., 2])
    return np.stack(
        [
            -(c * a[..., 0] + s * a[..., 1]),
            -(-s * a[..., 0] + c * a[..., 1]),
            -a[..., 2],
        ],
        axis=-1,
    )


def chain_closures(obs_kf, obs_lm, obs_z, obs_w):
    """The marker chain closures, vectorised: for each observation n in
    index order, a relative-pose factor to the previous observation a of
    the same marker when their keyframes differ: z = z_a ⊕ z_n^{-1},
    information (R_a + R_n)^{-1}. Returns (i [C], j [C], z [C, 3],
    info [C, 3, 3]) in the JAX package's loop order."""
    order = np.argsort(obs_lm, kind="stable")
    prev = np.full(len(obs_lm), -1)
    same = obs_lm[order[1:]] == obs_lm[order[:-1]]
    prev[order[1:][same]] = order[:-1][same]
    n = np.nonzero(prev >= 0)[0]
    a = prev[n]
    keep = obs_kf[a] != obs_kf[n]
    a, n = a[keep], n[keep]
    obs_R = np.linalg.inv(obs_w + 1e-12 * np.eye(3))
    z = _se2_compose(obs_z[a], _se2_inverse(obs_z[n]))
    return obs_kf[a], obs_kf[n], z, np.linalg.inv(obs_R[a] + obs_R[n])


def recompose_landmarks(poses, obs_kf, obs_lm, obs_z, obs_w, L: int):
    """Landmarks [L, 3] from optimized ``poses`` (float64, host): the
    information-weighted mean of pose_k ⊕ z_k over each marker's
    observations — the xy block solved with the 2x2 position information,
    the angle the trace-weighted circular mean."""
    lm_world = _se2_compose(poses[obs_kf], obs_z)  # [N, 3]
    w2 = obs_w[:, :2, :2]
    tr = np.trace(obs_w, axis1=1, axis2=2)
    acc_w = np.zeros((L, 2, 2))
    acc_xy = np.zeros((L, 2))
    acc_cs = np.zeros((L, 2))
    np.add.at(acc_w, obs_lm, w2)
    np.add.at(acc_xy, obs_lm, (w2 @ lm_world[:, :2, None])[:, :, 0])
    np.add.at(acc_cs, obs_lm, tr[:, None] * np.stack(
        [np.cos(lm_world[:, 2]), np.sin(lm_world[:, 2])], axis=-1))
    landmarks = np.zeros((L, 3))
    landmarks[:, :2] = np.linalg.solve(acc_w + 1e-12 * np.eye(2), acc_xy[:, :, None])[:, :, 0]
    landmarks[:, 2] = np.arctan2(acc_cs[:, 1], acc_cs[:, 0])
    return landmarks


def ekf_then_pose_graph(
    seq,
    config: SlamConfig,
    camera=None,
    level: str = "obs",
    keyframe_stride: int = 1,
    iters: int = 12,
    cg_iters: int = 100,
    damping: float = 1e-4,
    device=None,
):
    """Loop closure via marker re-observation + POSE-GRAPH optimization on
    ``device`` (None: the card), the formulation BASELINE.md config 2 names.
    The landmark block is eliminated before the solve: each marker seen at
    keyframes i and j yields a relative-pose factor z_ij = z_i ⊕ z_j^{-1}
    (:func:`chain_closures`: each observation linked to the marker's
    previous one, which bounds a keyframe's factor count by its markers and
    still closes loops). After the adaptive, gauge-deflated pose solve the
    landmarks are recomposed from the optimized poses
    (:func:`recompose_landmarks`)."""
    ekf_result, traj = _ekf_pass(seq, config, camera, level, device)
    problem, lm_ids = graph_builder.build_from_sequence(
        seq, config, keyframe_stride=keyframe_stride, init_poses=traj,
    )
    obs_kf = np.asarray(problem.obs_kf)
    obs_lm = np.asarray(problem.obs_lm)
    obs_z = np.asarray(problem.obs_z, np.float64)
    obs_w = np.asarray(problem.obs_w, np.float64)
    L = np.asarray(problem.landmarks).shape[0]

    ci, cj, cz, cw = chain_closures(obs_kf, obs_lm, obs_z, obs_w)
    chain = pose_graph.build(problem.poses, problem.odo_z, odo_info=problem.odo_w[0]).problem
    # the chain keeps each factor's own information; the closures follow it
    g_problem = chain._replace(
        odo_i=np.concatenate([chain.odo_i, ci.astype(np.int32)]),
        odo_j=np.concatenate([chain.odo_j, cj.astype(np.int32)]),
        odo_z=np.concatenate([chain.odo_z, cz.astype(np.float32)]),
        odo_w=np.concatenate([np.asarray(problem.odo_w), cw.astype(np.float32)]),
        odo_valid=np.ones(len(chain.odo_i) + len(ci), bool),
    )
    packed, static = ba.prepare(g_problem)
    poses, _, stats = ba.solve(
        convert.ba_problem_from_numpy(packed, device), iters=iters, cg_iters=cg_iters,
        damping=damping, adaptive=True, deflate_gauge=True, **static,
    )
    landmarks = recompose_landmarks(poses.cpu().numpy().astype(np.float64),
                                    obs_kf, obs_lm, obs_z, obs_w, L)
    return {
        "ekf_result": ekf_result,
        "poses": poses,
        "landmarks": landmarks.astype(np.float32),
        "landmark_ids": lm_ids,
        "stats": stats,
        "n_closures": len(ci),
    }
