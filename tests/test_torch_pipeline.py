"""The port's graph builder, pose graph and filter -> smoother pipelines
against the JAX package on the CPU, on a 20 s / 12-marker sequence and one
small loop tour.

- ``graph_builder.build_from_sequence`` (fixed and ``odo_info="auto"``
  weights, EKF initialization) and ``synthetic_ba_problem``: identical
  arrays.
- ``pose_graph.build``: identical; ``pose_graph.solve``: within 1e-4.
- ``pipeline.chain_closures`` and ``recompose_landmarks`` (vectorised)
  against the JAX pipeline's per-observation loops, kept here as the
  reference: the same closures in the same order.
- ``ekf_then_ba`` and ``ekf_then_pose_graph``: landmark ids and closure
  counts equal, poses and landmarks within 1e-3.
"""

import dataclasses

import numpy as np
import pytest
import torch

from aruco_slam_tpu import pipeline as jpipeline
from aruco_slam_tpu.models import graph_builder as jgb
from aruco_slam_tpu.models import pose_graph as jpg
from aruco_slam_tpu.sim import synthetic as jsyn
from aruco_slam_tpu.utils import config as jconfig
from aruco_slam_tpu_torch import convert, pipeline
from aruco_slam_tpu_torch.io.sequence import Sequence
from aruco_slam_tpu_torch.models import ba, graph_builder, pose_graph

torch.set_num_threads(1)

TOL = 1e-3
JCFG = jconfig.SlamConfig(ekf=jconfig.EkfConfig(max_landmarks=32, max_observations_per_frame=16))
CFG = convert.config_from_dict(dataclasses.asdict(JCFG))


def _port_seq(jseq):
    return Sequence(**{f.name: getattr(jseq, f.name) for f in dataclasses.fields(Sequence)})


@pytest.fixture(scope="module")
def seqs():
    """(JAX sequence, the port's) pairs: 20 s among 12 markers, and a
    90 s tour of a 30-marker arena that comes back to its start."""
    small = jsyn.generate_sequence(
        jsyn.SimParams(duration=20.0, seed=5, encoder_noise=1.0, max_obs=8),
        marker_map=jsyn.make_arena(n_markers=12),
    )
    tour = jsyn.generate_sequence(
        jsyn.SimParams(duration=90.0, profile="tour", tour_width=9.0, tour_height=7.0,
                       tour_inset=1.2, encoder_noise=0.4, fov_deg=90.0,
                       max_view_angle_deg=85.0, seed=11, max_obs=8),
        marker_map=jsyn.make_arena(n_markers=30, width=9.0, height=7.0),
    )
    return {"small": (small, _port_seq(small)), "tour": (tour, _port_seq(tour))}


def _same_problem(got, want):
    for f in ba.BAProblem._fields:
        a, b = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("odo_info", [1e4, "auto"])
def test_build_from_sequence_identical(seqs, odo_info):
    jseq, seq = seqs["small"]
    rng = np.random.default_rng(0)
    init_poses = rng.normal(size=(seq.num_frames, 3))
    init_lms = {int(i): rng.normal(size=3) for i in np.unique(seq.obs_ids[seq.obs_valid])[::2]}
    for kw in (dict(keyframe_stride=2), dict(init_poses=init_poses, init_landmarks=init_lms)):
        got, ids = graph_builder.build_from_sequence(seq, CFG, odo_info=odo_info, **kw)
        want, jids = jgb.build_from_sequence(jseq, JCFG, odo_info=odo_info, **kw)
        _same_problem(got, want)
        np.testing.assert_array_equal(ids, jids)


def test_synthetic_ba_problem_identical():
    got = graph_builder.synthetic_ba_problem(50, 20, obs_per_kf=5, seed=3)
    want = jgb.synthetic_ba_problem(50, 20, obs_per_kf=5, seed=3)
    _same_problem(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


def _loop_closures(problem):
    """The JAX pipeline's closure loop (aruco_slam_tpu/pipeline.py:183-195)."""
    obs_kf, obs_lm = np.asarray(problem.obs_kf), np.asarray(problem.obs_lm)
    obs_z = np.asarray(problem.obs_z, np.float64)
    obs_w = np.asarray(problem.obs_w, np.float64)
    closures, prev = [], {}
    obs_R = np.linalg.inv(obs_w + 1e-12 * np.eye(3))
    for n in range(len(obs_kf)):
        m = int(obs_lm[n])
        if m in prev:
            a = prev[m]
            i, j = int(obs_kf[a]), int(obs_kf[n])
            if i != j:
                z_ij = jpipeline._se2_compose(obs_z[a], jpipeline._se2_inverse(obs_z[n]))
                closures.append((i, j, z_ij, np.linalg.inv(obs_R[a] + obs_R[n])))
        prev[m] = n
    return closures


def _loop_landmarks(poses, problem):
    """The JAX pipeline's recomposition loop (aruco_slam_tpu/pipeline.py:226-242)."""
    obs_kf, obs_lm = np.asarray(problem.obs_kf), np.asarray(problem.obs_lm)
    obs_z = np.asarray(problem.obs_z, np.float64)
    obs_w = np.asarray(problem.obs_w, np.float64)
    L = problem.landmarks.shape[0]
    lm_world = jpipeline._se2_compose(poses[obs_kf], obs_z)
    acc_w, acc_xy, acc_cs = np.zeros((L, 2, 2)), np.zeros((L, 2)), np.zeros((L, 2))
    for n in range(len(obs_kf)):
        m = int(obs_lm[n])
        w2 = obs_w[n][:2, :2]
        acc_w[m] += w2
        acc_xy[m] += w2 @ lm_world[n, :2]
        tr = np.trace(obs_w[n])
        acc_cs[m, 0] += tr * np.cos(lm_world[n, 2])
        acc_cs[m, 1] += tr * np.sin(lm_world[n, 2])
    out = np.zeros((L, 3))
    out[:, :2] = np.linalg.solve(acc_w + 1e-12 * np.eye(2), acc_xy[:, :, None])[:, :, 0]
    out[:, 2] = np.arctan2(acc_cs[:, 1], acc_cs[:, 0])
    return out


@pytest.mark.parametrize("which", ["small", "tour"])
def test_vectorised_closures_and_landmarks_match_the_loops(seqs, which):
    _, seq = seqs[which]
    problem, _ = graph_builder.build_from_sequence(
        seq, CFG, init_poses=seq.true_pose_frames)
    want = _loop_closures(problem)
    got = pipeline.chain_closures(
        problem.obs_kf, problem.obs_lm, problem.obs_z.astype(np.float64),
        problem.obs_w.astype(np.float64))
    assert len(got[0]) == len(want) > 50
    np.testing.assert_array_equal(got[0], [c[0] for c in want])
    np.testing.assert_array_equal(got[1], [c[1] for c in want])
    np.testing.assert_array_equal(got[2], [c[2] for c in want])
    np.testing.assert_array_equal(got[3], [c[3] for c in want])
    poses = np.asarray(problem.poses, np.float64)
    lms = pipeline.recompose_landmarks(
        poses, problem.obs_kf, problem.obs_lm, problem.obs_z.astype(np.float64),
        problem.obs_w.astype(np.float64), problem.landmarks.shape[0])
    np.testing.assert_allclose(lms, _loop_landmarks(poses, problem), rtol=1e-12, atol=1e-12)


def _drifting_loop(K=30, seed=3):
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 2 * np.pi, K, endpoint=False)
    true = np.stack([2 * np.cos(t), 2 * np.sin(t), np.arctan2(np.cos(t), -np.sin(t))], axis=1)

    def rel(a, b):
        c, s = np.cos(a[2]), np.sin(a[2])
        dx, dy = b[0] - a[0], b[1] - a[1]
        return np.array([dx * c + dy * s, -dx * s + dy * c,
                         np.arctan2(np.sin(b[2] - a[2]), np.cos(b[2] - a[2]))])

    odo = np.stack([rel(true[i], true[i + 1]) for i in range(K - 1)])
    odo += rng.normal(scale=0.01, size=odo.shape) + np.array([0.005, 0, 0.003])
    init = np.zeros((K, 3))
    init[0] = true[0]
    for i in range(K - 1):
        c, s = np.cos(init[i, 2]), np.sin(init[i, 2])
        init[i + 1] = [init[i, 0] + c * odo[i, 0] - s * odo[i, 1],
                       init[i, 1] + s * odo[i, 0] + c * odo[i, 1], init[i, 2] + odo[i, 2]]
    closures = [
        (K - 1, 0, rel(true[-1], true[0]), 1e4),
        (K // 2, 2, rel(true[K // 2], true[2]), np.diag([1e3, 2e3, 5e3])),
    ]
    return true, init, odo, closures


def test_pose_graph_build_identical_and_solve_matches_jax():
    true, init, odo, closures = _drifting_loop()
    got = pose_graph.build(init, odo, odo_info=1e4, closures=closures)
    want = jpg.build(init, odo, odo_info=1e4, closures=closures)
    _same_problem(got.problem, want.problem)
    _same_problem(pose_graph.build(init, odo, odo_info=np.eye(3) * 50).problem,
                  jpg.build(init, odo, odo_info=np.eye(3) * 50).problem)
    poses, stats = pose_graph.solve(got, device="cpu")
    jposes, jstats = jpg.solve(want)
    np.testing.assert_allclose(poses.numpy(), np.asarray(jposes), atol=1e-4)
    np.testing.assert_allclose(stats.cost_history.numpy(), np.asarray(jstats.cost_history),
                               rtol=1e-4)
    err = lambda p: np.linalg.norm(p[:, :2] - true[:, :2], axis=1).mean()  # noqa: E731
    assert err(poses.numpy()) < 0.5 * err(init)


def _assert_pipeline(got, want):
    np.testing.assert_array_equal(got["landmark_ids"], want["landmark_ids"])
    np.testing.assert_allclose(got["poses"].numpy(), np.asarray(want["poses"]), atol=TOL)
    lms = got["landmarks"]
    lms = lms.numpy() if isinstance(lms, torch.Tensor) else lms
    np.testing.assert_allclose(lms, np.asarray(want["landmarks"]), atol=TOL)
    np.testing.assert_allclose(float(got["stats"].final_cost),
                               float(want["stats"].final_cost), rtol=1e-3)


@pytest.mark.parametrize("which,stride", [("small", 1), ("tour", 2)])
def test_ekf_then_ba_matches_jax(seqs, which, stride):
    jseq, seq = seqs[which]
    kw = dict(keyframe_stride=stride, ba_iters=5, cg_iters=60)
    got = pipeline.ekf_then_ba(seq, CFG, device="cpu", **kw)
    want = jpipeline.ekf_then_ba(jseq, JCFG, **kw)
    _same_problem(got["problem"]._replace(poses=want["problem"].poses,
                                          landmarks=want["problem"].landmarks), want["problem"])
    np.testing.assert_allclose(got["problem"].poses, want["problem"].poses, atol=TOL)
    _assert_pipeline(got, want)
    assert float(got["stats"].final_cost) < float(got["stats"].initial_cost)


@pytest.mark.parametrize("which,stride", [("small", 1), ("tour", 2)])
def test_ekf_then_pose_graph_matches_jax(seqs, which, stride):
    jseq, seq = seqs[which]
    kw = dict(keyframe_stride=stride, iters=5, cg_iters=60)
    got = pipeline.ekf_then_pose_graph(seq, CFG, device="cpu", **kw)
    want = jpipeline.ekf_then_pose_graph(jseq, JCFG, **kw)
    assert got["n_closures"] == want["n_closures"] > 50
    _assert_pipeline(got, want)
    assert got["landmarks"].dtype == np.float32
