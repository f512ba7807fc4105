"""The whole slice: the port's batched replay (plain versions of K1 and K2
on the CPU) against both JAX batched paths — the kernel-driven
``_replay_batch_kernel`` (interpret mode, PnP kernel on) and the vmapped
``_replay_batch_jit`` — at the measurement and corner levels: trajectory
to atol 1e-4, n_landmarks / slot_ids / dropped exact."""

import dataclasses

import numpy as np
import pytest
import torch

from aruco_slam_tpu import runner as jrunner
from aruco_slam_tpu.ops.camera import CameraIntrinsics as JCamera
from aruco_slam_tpu.sim import synthetic as jsyn
from aruco_slam_tpu.utils import config as jconfig
from aruco_slam_tpu_torch import convert, runner
from aruco_slam_tpu_torch.ops.camera import CameraIntrinsics
from aruco_slam_tpu_torch.sim import synthetic

torch.set_num_threads(1)

DIST = [-0.28, 0.07, 1.2e-3, -8e-4, 0.018]
JCFG = jconfig.SlamConfig(
    ekf=jconfig.EkfConfig(max_landmarks=8, max_observations_per_frame=6)
)
CFG = convert.config_from_dict(dataclasses.asdict(JCFG))


def _sequences(dist, n=2, duration=3.0):
    jcam = JCamera.create(600.0, 600.0, 320.0, 240.0, dist=dist)
    return jcam, [
        jsyn.generate_sequence(
            jsyn.SimParams(duration=duration, seed=s, max_obs=6),
            level="corners", camera=jcam,
        )
        for s in range(n)
    ]


def _assert_same(ours, ref, atol=1e-4):
    np.testing.assert_allclose(
        ours.trajectory.numpy(), np.asarray(ref.trajectory), atol=atol
    )
    np.testing.assert_array_equal(ours.n_landmarks.numpy(), np.asarray(ref.n_landmarks))
    fs, rs = ours.final_state, ref.final_state
    np.testing.assert_array_equal(fs.slot_ids.numpy(), np.asarray(rs.slot_ids))
    np.testing.assert_array_equal(fs.dropped.numpy(), np.asarray(rs.dropped))


@pytest.mark.parametrize("level,dist", [("obs", None), ("corners", None), ("corners", DIST)])
def test_replay_batch_matches_both_jax_paths(level, dist):
    _, seqs = _sequences(dist)
    cam = seqs[0].camera()  # the sequence's own calibration, on both sides
    jdata = jrunner.build_batch_data(seqs, 3, level)  # 3 lanes over 2 sequences
    ours = runner.replay_batch(
        runner.build_batch_data(seqs, 3, level, "cpu"), CFG,
        convert.camera_from_numpy(cam.fx, cam.fy, cam.cx, cam.cy, cam.dist), level,
    )
    camera = cam if level == "corners" else None
    ref_k = jrunner._replay_batch_kernel(
        jdata, JCFG, camera, level, interpret=True, pnp_kernel=level == "corners"
    )
    _assert_same(ours, ref_k)
    ref_v = jrunner._replay_batch_jit(jdata, JCFG, camera, level)
    _assert_same(ours, ref_v)
    assert int(ours.n_landmarks[:, -1].min()) > 0


def test_replay_single_and_evaluate_match_jax():
    jcam, seqs = _sequences(DIST, n=1)
    seq = seqs[0]
    cam = convert.camera_from_numpy(jcam.fx, jcam.fy, jcam.cx, jcam.cy, jcam.dist)
    res = runner.replay(runner.replay_data_from_sequence(seq, "corners", "cpu"), CFG, cam,
                        "corners")
    batched = runner.replay_batch(runner.build_batch_data(seqs, 1, "corners", "cpu"), CFG, cam,
                                  "corners")
    np.testing.assert_array_equal(res.trajectory.numpy(), batched.trajectory[0].numpy())
    ours = runner.evaluate_sequence(seq, CFG, level="obs", device="cpu")
    ref = jrunner.evaluate_sequence(seq, JCFG, level="obs")
    assert ours.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(ours[k], ref[k], atol=1e-4, err_msg=k)


def test_lanes_independent_of_batch_size():
    cam = CameraIntrinsics.create(600.0, 600.0, 320.0, 240.0, dist=DIST)
    seqs = [
        synthetic.generate_sequence(
            synthetic.SimParams(duration=2.0, seed=s, max_obs=6), level="corners", camera=cam
        )
        for s in range(2)
    ]
    small = runner.replay_batch(runner.build_batch_data(seqs, 2, "corners", "cpu"), CFG, cam,
                                "corners")
    big = runner.replay_batch(runner.build_batch_data(seqs, 5, "corners", "cpu"), CFG, cam,
                              "corners")
    for lanes in (slice(0, 2), slice(2, 4)):
        np.testing.assert_array_equal(big.trajectory[lanes].numpy(), small.trajectory.numpy())
        np.testing.assert_array_equal(
            big.final_state.sigma[lanes].numpy(), small.final_state.sigma.numpy()
        )
