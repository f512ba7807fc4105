"""The image-level slice against the JAX package: the port's renderer
against the JAX renderer, ``detect_frames`` with shape-bucket padding, and
``replay_batch`` / ``evaluate_sequence`` at level "images" (the plain
versions of K3, K1 and K2 on the CPU).

Both detectors get the same numpy frames, the JAX renderer's, so a renderer
difference can neither hide nor fake a detector fault. Tolerances: the two
renderers differ on at most RENDER_MISMATCH of the pixels, every one of
them at a marker edge; detections have equal ids and validity and corners
within 1e-3 px; trajectories agree to 1e-4, n_landmarks and slot_ids
exactly."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aruco_slam_tpu import runner as jrunner
from aruco_slam_tpu.ops import detector as jdet
from aruco_slam_tpu.ops.camera import CameraIntrinsics as JCamera
from aruco_slam_tpu.sim import renderer as jrenderer
from aruco_slam_tpu.sim import synthetic as jsyn
from aruco_slam_tpu.utils import config as jconfig
from aruco_slam_tpu_torch import convert, runner
from aruco_slam_tpu_torch.io.sequence import Sequence
from aruco_slam_tpu_torch.ops import detector
from aruco_slam_tpu_torch.ops.camera import CameraIntrinsics
from aruco_slam_tpu_torch.sim import renderer, synthetic

torch.set_num_threads(1)

# Measured on the CPU: no pixel differs on the frames below, nor on 32 more
# random poses of the arena. float32 ray casting summed in another order
# (another device or BLAS) may flip a pixel whose ray grazes a cell
# boundary, so the bound allows 30 pixels of a 640x480 frame, all at edges.
RENDER_MISMATCH = 1e-4
CORNER_TOL = 1e-3  # px
TRAJ_TOL = 1e-4
DIST = [-0.28, 0.07, 1.2e-3, -8e-4, 0.018]
PARAMS = dict(duration=2.0, frames_per_sec=5.0)
JCFG = jconfig.SlamConfig(
    ekf=jconfig.EkfConfig(max_landmarks=16, max_observations_per_frame=16)
)
CFG = convert.config_from_dict(dataclasses.asdict(JCFG))
DET_CFG = detector.DetectorConfig()
JDET_CFG = jdet.DetectorConfig()


@pytest.fixture(scope="module")
def jseqs():
    """Two JAX image-level sequences of 10 frames each."""
    jcam = JCamera.create(600.0, 600.0, 320.0, 240.0)
    return [
        jsyn.generate_sequence(jsyn.SimParams(seed=s, **PARAMS), level="images", camera=jcam)
        for s in range(2)
    ]


def _port_sequence(jseq) -> Sequence:
    return Sequence(**{f.name: getattr(jseq, f.name) for f in dataclasses.fields(Sequence)})


def _port_camera(jseq) -> CameraIntrinsics:
    c = jseq.camera()
    return convert.camera_from_numpy(c.fx, c.fy, c.cx, c.cy, c.dist)


def _edge_pixels(img: np.ndarray) -> np.ndarray:
    """Pixels whose 3x3 neighbourhood holds more than one value."""
    p = np.pad(img, 1, mode="edge")
    win = np.lib.stride_tricks.sliding_window_view(p, (3, 3))
    return win.min(axis=(-1, -2)) != win.max(axis=(-1, -2))


def _assert_mismatch_at_edges(ours: np.ndarray, ref: np.ndarray) -> None:
    assert ours.shape == ref.shape and ours.dtype == ref.dtype == np.uint8
    diff = ours != ref
    assert diff.mean() <= RENDER_MISMATCH, f"{int(diff.sum())} of {diff.size} pixels differ"
    for o, r, d in zip(ours, ref, diff):
        assert not (d & ~(_edge_pixels(r) & _edge_pixels(o))).any()


def test_generated_image_sequence_matches_jax(jseqs):
    """The port's generator at level "images": every array but the frames
    identical, the frames within the renderer bound."""
    cam = CameraIntrinsics.create(600.0, 600.0, 320.0, 240.0)
    ours = synthetic.generate_sequence(synthetic.SimParams(seed=0, **PARAMS), level="images",
                                       camera=cam, device="cpu")
    ref = jseqs[0]
    for f in dataclasses.fields(Sequence):
        if f.name in ("images", "meta"):
            continue
        a, b = getattr(ours, f.name), getattr(ref, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    assert ours.meta["level"] == ref.meta["level"] == "images"
    _assert_mismatch_at_edges(ours.images, np.asarray(ref.images))
    assert (ours.images != renderer.BACKGROUND).mean() > 0.01  # markers in view


def test_renderer_matches_jax_on_a_distorted_camera():
    arena = jsyn.make_arena(n_markers=20)
    poses = np.array([(2.55, -2.0, 1.2), (2.0, -2.5, 2.5), (1.0, -1.0, 0.3), (3.5, -3.0, -2.0)],
                     np.float32)
    jcam = JCamera.create(600.0, 600.0, 320.0, 240.0, dist=DIST)
    stack = jrenderer.build_marker_stack(arena)
    render = jax.jit(lambda p: jrenderer.render_frame(*jrenderer.camera_pose_from_robot(p),
                                                      stack, jcam))
    ref = np.stack([np.asarray(render(jnp.asarray(p))) for p in poses])
    cam = CameraIntrinsics.create(600.0, 600.0, 320.0, 240.0, dist=DIST)
    ours = renderer.render_poses(poses, synthetic.make_arena(n_markers=20), cam,
                                 device="cpu").numpy()
    _assert_mismatch_at_edges(ours, ref)


def test_detect_frames_pads_to_the_bucket_like_jax(jseqs):
    """A 400x600 crop is edge-padded to the 480x640 bucket on both sides;
    the port's chunk of 3 against JAX's 16 also shows that results do not
    depend on the chunk."""
    crop = np.ascontiguousarray(np.asarray(jseqs[0].images)[:6, :400, :600])
    ids, corners, valid = (np.asarray(x) for x in jrunner.detect_frames(crop, JDET_CFG, 16))
    ours = runner.detect_frames(torch.as_tensor(crop), DET_CFG, chunk=3)
    assert tuple(ours[1].shape) == corners.shape
    np.testing.assert_array_equal(ours[0].numpy(), ids)
    np.testing.assert_array_equal(ours[2].numpy(), valid)
    np.testing.assert_allclose(ours[1].numpy()[valid], corners[valid], atol=CORNER_TOL)
    assert valid.sum() >= 6
    assert (corners[valid][..., 0] <= 599.5).all() and (corners[valid][..., 1] <= 399.5).all()


def test_pad_to_bucket_replicates_the_edge_and_keeps_uint8():
    img = torch.arange(2 * 3 * 4, dtype=torch.uint8).reshape(2, 3, 4)
    out = runner._pad_to_bucket(img, 5, 6)
    assert out.dtype == torch.uint8 and tuple(out.shape) == (2, 5, 6)
    np.testing.assert_array_equal(out.numpy(), np.pad(img.numpy(), ((0, 0), (0, 2), (0, 2)),
                                                      mode="edge"))
    assert runner._pad_to_bucket(img, 3, 4) is img
    assert runner._bucket_shape(400, 600, DET_CFG.shape_buckets) == (480, 640)
    assert runner._bucket_shape(480, 640, DET_CFG.shape_buckets) == (480, 640)
    assert runner._bucket_shape(1100, 1930, DET_CFG.shape_buckets) == (1104, 2048)


def test_replay_batch_images_matches_jax(jseqs):
    """B = 3 lanes over the 2 sequences, through the detector, K1 and K2."""
    jcam = jseqs[0].camera()
    ref = jrunner.replay_batch(jrunner.build_batch_data(jseqs, 3, "images"), JCFG, jcam, "images")
    data = runner.build_batch_data(jseqs, 3, "images", "cpu")
    assert data.images.dtype == torch.uint8 and tuple(data.images.shape) == (3, 10, 480, 640)
    ours = runner.replay_batch(data, CFG, _port_camera(jseqs[0]), "images")
    np.testing.assert_allclose(ours.trajectory.numpy(), np.asarray(ref.trajectory),
                               atol=TRAJ_TOL)
    np.testing.assert_array_equal(ours.n_landmarks.numpy(), np.asarray(ref.n_landmarks))
    np.testing.assert_array_equal(ours.final_state.slot_ids.numpy(),
                                  np.asarray(ref.final_state.slot_ids))
    assert int(ours.n_landmarks[:, -1].min()) > 0
    # the reference entry point takes the same plain versions on the CPU
    plain = runner.replay_batch_reference(data, CFG, _port_camera(jseqs[0]), "images")
    assert torch.equal(plain.trajectory, ours.trajectory)


def test_evaluate_sequence_images_matches_jax(jseqs):
    ref = jrunner.evaluate_sequence(jseqs[1], JCFG, level="images")
    seq = _port_sequence(jseqs[1])
    ours = runner.evaluate_sequence(seq, CFG, level="images", device="cpu")
    assert ours.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(ours[k], ref[k], atol=TRAJ_TOL, err_msg=k)
    single = runner.replay(runner.replay_data_from_sequence(seq, "images", "cpu"), CFG,
                           seq.camera(), "images")
    # (10 frames are too few for an RPE: it is NaN on both sides)
    np.testing.assert_equal(runner.evaluate_sequence(seq, CFG, level="images", result=single),
                            ours)
