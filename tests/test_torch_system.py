"""The port's streaming ``SlamSystem`` and single-sequence replay against
the JAX package on the CPU (the K6 and CCL wrappers take their plain
versions for CPU tensors).

- ``SlamSystem``: the two call patterns of the JAX package's own system
  tests — interleaved ``add_encoder`` / ``add_observations`` over 100
  frames, and one rendered frame through ``add_image``. Pose, map and
  covariance to 1e-4; ids exact; detections' corners to 1e-3 px.
- ``replay`` / ``replay_sequence`` / ``evaluate_sequence`` at the
  measurement and corner levels against the JAX functions: trajectory to
  1e-4; landmarks, slots and drops exact."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aruco_slam_tpu import runner as jrunner
from aruco_slam_tpu.ops.camera import CameraIntrinsics as JCamera
from aruco_slam_tpu.sim import renderer as jrenderer
from aruco_slam_tpu.sim import synthetic as jsyn
from aruco_slam_tpu.system import SlamSystem as JSlamSystem
from aruco_slam_tpu.utils import config as jconfig
from aruco_slam_tpu_torch import convert, runner
from aruco_slam_tpu_torch.io.sequence import Sequence
from aruco_slam_tpu_torch.system import SlamSystem

torch.set_num_threads(1)

TOL = 1e-4
CORNER_TOL = 1e-3  # the detector's parity bound (tests/test_torch_detector.py)
DIST = [-0.28, 0.07, 1.2e-3, -8e-4, 0.018]


def _cfg(jcfg):
    return convert.config_from_dict(dataclasses.asdict(jcfg))


def _same_system(ours, ref):
    np.testing.assert_allclose(ours.pose(), np.asarray(ref.pose()), atol=TOL)
    lms, ids = ours.landmark_map()
    jlms, jids = ref.landmark_map()
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_allclose(lms, jlms, atol=TOL)
    a, b = ours.pose_with_covariance(), ref.pose_with_covariance()
    np.testing.assert_allclose(a["covariance6x6"], b["covariance6x6"], atol=TOL)
    np.testing.assert_allclose(a["position"], b["position"], atol=TOL)
    assert [m["aruco_id"] for m in ours.mapped_markers()] == \
        [m["aruco_id"] for m in ref.mapped_markers()]


def test_system_encoder_then_observations_matches_jax():
    seq = jsyn.generate_sequence(jsyn.SimParams(duration=10.0, seed=21, max_obs=8))
    jcfg = jconfig.SlamConfig(ekf=jconfig.EkfConfig(max_landmarks=16,
                                                    max_observations_per_frame=8))
    ours, ref = SlamSystem(_cfg(jcfg), device="cpu"), JSlamSystem(jcfg)
    epf = seq.enc_per_frame
    enc_w = seq.enc_w.reshape(-1, epf, 2)
    enc_dt = seq.enc_dt.reshape(-1, epf)
    for f in range(seq.num_frames):
        for e in range(epf):
            for s in (ours, ref):
                s.add_encoder(enc_w[f, e, 0], enc_w[f, e, 1], enc_dt[f, e])
        for s in (ours, ref):
            s.add_observations(seq.obs_ids[f], seq.obs_z[f], seq.obs_R[f], seq.obs_valid[f])
    _same_system(ours, ref)
    assert np.linalg.norm(ours.pose()[:2] - seq.true_pose_frames[-1, :2]) < 0.2
    assert len(ours.landmark_map()[1]) >= 3


def test_system_image_path_matches_jax():
    jcam = JCamera.create(600.0, 600.0, 320.0, 240.0)
    jcfg = jconfig.SlamConfig(ekf=jconfig.EkfConfig(max_landmarks=32,
                                                    max_observations_per_frame=24))
    stack = jrenderer.build_marker_stack(jsyn.make_arena(n_markers=20))
    cam_pos, R_wc = jrenderer.camera_pose_from_robot(jnp.asarray((2.55, -2.0, 1.2), jnp.float32))
    img = np.asarray(jrenderer.render_frame(cam_pos, R_wc, stack, jcam))
    ref = JSlamSystem(jcfg, camera=jcam)
    ours = SlamSystem(_cfg(jcfg), camera=convert.camera_from_numpy(
        jcam.fx, jcam.fy, jcam.cx, jcam.cy, jcam.dist), device="cpu")
    assert ours.detected_markers() == [] and ours.marked_image() is None
    for s in (ours, ref):
        s.add_encoder(0.0, 0.0, 0.01)
        s.add_encoder(1.0, 1.0, 0.05)
        s.add_image(img)
    det, jdet = ours.detected_markers(), ref.detected_markers()
    assert len(det) >= 1
    assert [d["id"] for d in det] == [d["id"] for d in jdet]
    np.testing.assert_allclose([d["corners_px"] for d in det], [d["corners_px"] for d in jdet],
                               atol=CORNER_TOL)
    marked, jmarked = ours.marked_image(), np.asarray(ref.marked_image())
    assert marked.shape == img.shape and (marked == 255).sum() > 20
    # outlines are drawn at rounded corners: sub-1e-3 px differences may
    # move a pixel only where a corner sits on a .5 boundary
    assert (marked != jmarked).mean() < 1e-4
    _same_system(ours, ref)
    assert len(ours.mapped_markers()) >= 1
    ours.reset()
    assert ours.mapped_markers() == [] and ours.detected_markers() == []


@pytest.fixture(scope="module")
def seqs():
    """One corner-level sequence as the JAX package's and as the port's
    ``Sequence`` (the same arrays and the same camera in its meta)."""
    jcam = JCamera.create(600.0, 600.0, 320.0, 240.0, dist=DIST)
    jseq = jsyn.generate_sequence(jsyn.SimParams(duration=3.0, seed=3, max_obs=6),
                                  level="corners", camera=jcam)
    return jseq, Sequence(**{f.name: getattr(jseq, f.name) for f in dataclasses.fields(Sequence)})


JCFG = jconfig.SlamConfig(ekf=jconfig.EkfConfig(max_landmarks=8, max_observations_per_frame=6))


def _assert_replay(ours, ref):
    np.testing.assert_allclose(ours.trajectory.numpy(), np.asarray(ref.trajectory), atol=TOL)
    np.testing.assert_allclose(ours.pose_cov.numpy(), np.asarray(ref.pose_cov), atol=TOL)
    np.testing.assert_array_equal(ours.n_landmarks.numpy(), np.asarray(ref.n_landmarks))
    fs, rs = ours.final_state, ref.final_state
    np.testing.assert_array_equal(fs.slot_ids[0].numpy(), np.asarray(rs.slot_ids))
    np.testing.assert_array_equal(fs.dropped[0].numpy(), np.asarray(rs.dropped))


@pytest.mark.parametrize("level", ["obs", "corners"])
def test_single_replay_matches_jax(seqs, level):
    jseq, seq = seqs
    ref = jrunner.replay_sequence(jseq, JCFG, level=level)
    ours = runner.replay_sequence(seq, _cfg(JCFG), level=level, device="cpu")
    _assert_replay(ours, ref)
    assert int(ours.n_landmarks[-1]) > 0
    # the same replay through replay() and through the plain versions
    data = runner.replay_data_from_sequence(seq, level, "cpu")
    cam = seq.camera() if level == "corners" else None
    again = runner.replay(data, _cfg(JCFG), cam, level)
    assert torch.equal(again.trajectory, ours.trajectory)
    plain = runner.replay_reference(data, _cfg(JCFG), cam, level)
    assert torch.equal(plain.trajectory, ours.trajectory)


def test_evaluate_sequence_matches_jax(seqs):
    jseq, seq = seqs
    ours = runner.evaluate_sequence(seq, _cfg(JCFG), level="corners", device="cpu")
    ref = jrunner.evaluate_sequence(jseq, JCFG, level="corners")
    assert ours.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(ours[k], ref[k], atol=TOL, err_msg=k)


def test_replay_sequence_refuses_asq(seqs):
    seq = seqs[1]
    asq = dataclasses.replace(seq, meta={**seq.meta, "images_asq_path": "frames.asq"})
    with pytest.raises(NotImplementedError, match="asq"):
        runner.replay_sequence(asq, _cfg(JCFG), level="images", device="cpu")
