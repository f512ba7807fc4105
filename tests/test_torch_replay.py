"""The whole slice: the port's batched replay (plain versions of K1 and K2
on the CPU) against both JAX batched paths — the kernel-driven
``_replay_batch_kernel`` (interpret mode, PnP kernel on) and the vmapped
``_replay_batch_jit`` — at the measurement and corner levels: trajectory
to atol 1e-4, n_landmarks / slot_ids / dropped exact; and a zero-frame
single-stream replay under every update backend against JAX's."""

import dataclasses

import numpy as np
import pytest
import torch

from aruco_slam_tpu import runner as jrunner
from aruco_slam_tpu.models import ekf as jekf
from aruco_slam_tpu.ops.camera import CameraIntrinsics as JCamera
from aruco_slam_tpu.sim import synthetic as jsyn
from aruco_slam_tpu.utils import config as jconfig
from aruco_slam_tpu_torch import convert, runner
from aruco_slam_tpu_torch.models import ekf
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


@pytest.mark.parametrize("backend,fused", [("auto", False), ("pallas", False), ("xla", False),
                                           ("auto", True)])
def test_zero_frame_replay_matches_jax(backend, fused):
    """``replay`` of a sequence cut to 0 frames at obs level, under every
    ``update_backend`` and with ``fused_update``, against JAX's
    ``replay_sequence``: trajectory [0, 3], n_landmarks [0], and the final
    state the initial one (no step is made for an empty replay)."""
    jcfg = dataclasses.replace(JCFG, ekf=dataclasses.replace(
        JCFG.ekf, update_backend=backend, fused_update=fused))
    cfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    seq = jsyn.generate_sequence(jsyn.SimParams(duration=1.0, seed=0, max_obs=6), level="obs")
    cut = dataclasses.replace(seq, enc_w=seq.enc_w[:0], enc_dt=seq.enc_dt[:0],
                              obs_ids=seq.obs_ids[:0], obs_z=seq.obs_z[:0],
                              obs_R=seq.obs_R[:0], obs_valid=seq.obs_valid[:0],
                              true_pose_frames=seq.true_pose_frames[:0],
                              true_pose_enc=seq.true_pose_enc[:0])
    ours = runner.replay(runner.replay_data_from_sequence(cut, "obs", "cpu"), cfg)
    ref = jrunner.replay_sequence(cut, jcfg, level="obs")
    assert tuple(ours.trajectory.shape) == np.asarray(ref.trajectory).shape == (0, 3)
    assert tuple(ours.pose_cov.shape) == np.asarray(ref.pose_cov).shape == (0, 3, 3)
    assert tuple(ours.n_landmarks.shape) == np.asarray(ref.n_landmarks).shape == (0,)
    init = ekf.init_state(cfg, 1, "cpu")
    jinit = jekf.init_state(jcfg)
    for name, got, want, jgot, jwant in zip(ekf.EkfState._fields, ours.final_state, init,
                                            ref.final_state, jinit):
        assert torch.equal(got, want), name
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(jgot), err_msg=name)
        np.testing.assert_array_equal(np.asarray(jgot), np.asarray(jwant), err_msg=name)
