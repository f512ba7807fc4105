"""The port's L0/L2 ops against the JAX package on the CPU: geometry,
linalg and camera functions (atol 1e-6), and the plain version of the K1
PnP front-end against the JAX K1 kernel in interpret mode and against the
JAX XLA front-end (the JAX package's own contract: keep equal, z and R to
atol 2e-5, R rtol 2e-4 — tests/test_pallas_kernels.py:312-317)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aruco_slam_tpu.ops import camera as jcamera
from aruco_slam_tpu.ops import frontend as jfrontend
from aruco_slam_tpu.ops import geometry as jgeometry
from aruco_slam_tpu.ops import linalg as jlinalg
from aruco_slam_tpu.ops.kernels import pnp_frontend as jpk
from aruco_slam_tpu.sim import synthetic as jsyn
from aruco_slam_tpu.utils import config as jconfig
from aruco_slam_tpu_torch import convert
from aruco_slam_tpu_torch.ops import camera, geometry, linalg
from aruco_slam_tpu_torch.ops.kernels import pnp_frontend

torch.set_num_threads(1)

ATOL = 1e-6
DIST = [-0.28, 0.07, 1.2e-3, -8e-4, 0.018]
JCFG = jconfig.SlamConfig(
    ekf=jconfig.EkfConfig(max_landmarks=16, max_observations_per_frame=8)
)
CFG = convert.config_from_dict(dataclasses.asdict(JCFG))


def both(fn_t, fn_j, *arrays):
    out_t = fn_t(*(torch.as_tensor(np.array(a)) for a in arrays))
    out_j = fn_j(*(jnp.asarray(a) for a in arrays))
    return np.asarray(out_t), np.asarray(out_j)


def test_wrap_angle_two_sided_rule():
    a = np.array(
        [-3 * np.pi + 1e-3, -np.pi, -np.pi - 1e-7, np.pi, np.pi - 1e-7, 0.0, 5.0, -5.0, 9.0],
        np.float32,
    )
    t, j = both(geometry.wrap_angle, jgeometry.wrap_angle, a)
    np.testing.assert_array_equal(t, j)


def test_rodrigues_round_trip_matches():
    rng = np.random.default_rng(1)
    axes = rng.normal(size=(64, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    angles = np.concatenate([rng.uniform(0, np.pi, 56), [0.0, 1e-9, 1e-4, np.pi - 1e-3,
                                                         np.pi - 4e-3, 3.0, 2.0, 1.0]])
    rvec = (axes * angles[:, None]).astype(np.float32)
    t, j = both(geometry.rodrigues, jgeometry.rodrigues, rvec)
    np.testing.assert_allclose(t, j, atol=ATOL)
    t2, j2 = both(geometry.inv_rodrigues, jgeometry.inv_rodrigues, j)
    np.testing.assert_allclose(t2, j2, atol=ATOL)
    a, b = np.zeros((4, 3), np.float32), np.random.default_rng(2).normal(size=(4, 3)).astype(np.float32)
    t3, j3 = both(geometry.se2_relative, jgeometry.se2_relative, a + b[::-1], b)
    np.testing.assert_allclose(t3, j3, atol=ATOL)


def test_linalg_matches():
    rng = np.random.default_rng(3)
    X = rng.normal(size=(32, 6, 6)).astype(np.float32)
    A6 = (X @ X.transpose(0, 2, 1) + 6 * np.eye(6, dtype=np.float32)).astype(np.float32)
    b6 = rng.normal(size=(32, 6)).astype(np.float32)
    A3 = A6[:, :3, :3]
    t, j = both(linalg.inv3x3, jlinalg.inv3x3, A3)
    np.testing.assert_allclose(t, j, atol=ATOL)
    t, j = both(lambda a: linalg.cholesky_unrolled(a, 6),
                lambda a: jlinalg.cholesky_unrolled(a, 6), A6)
    np.testing.assert_allclose(t, j, atol=ATOL)
    t, j = both(lambda a, b: linalg.solve_spd(a, b, 6),
                lambda a, b: jlinalg.solve_spd(a, b, 6), A6, b6)
    np.testing.assert_allclose(t, j, atol=ATOL)
    quad = (np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
            + rng.uniform(-0.2, 0.2, (32, 4, 2)).astype(np.float32))
    t, j = both(linalg.homography_unit_square, jlinalg.homography_unit_square, quad)
    np.testing.assert_allclose(t, j, atol=ATOL)


@pytest.mark.parametrize("dist", [None, DIST])
def test_camera_matches(dist):
    rng = np.random.default_rng(4)
    cam = camera.CameraIntrinsics.create(600.0, 590.0, 320.0, 240.0, dist=dist)
    jcam = jcamera.CameraIntrinsics.create(600.0, 590.0, 320.0, 240.0, dist=dist)
    pts = rng.uniform(-0.5, 0.5, (64, 2)).astype(np.float32)
    t, j = both(lambda p: camera.distort_normalized(p, cam.dist),
                lambda p: jcamera.distort_normalized(p, jcam.dist), pts)
    np.testing.assert_allclose(t, j, atol=ATOL)
    t, j = both(lambda p: camera.undistort_normalized(p, cam.dist),
                lambda p: jcamera.undistort_normalized(p, jcam.dist), pts)
    np.testing.assert_allclose(t, j, atol=ATOL)
    pc = np.concatenate([pts, rng.uniform(0.5, 3.0, (64, 1))], axis=1).astype(np.float32)
    t, j = both(lambda p: camera.project_points(p, cam),
                lambda p: jcamera.project_points(p, jcam), pc)
    np.testing.assert_allclose(t, j, atol=1e-4)  # pixels: ~600x the normalized 1e-6
    px = rng.uniform(0, 640, (64, 2)).astype(np.float32)
    t, j = both(lambda p: camera.pixels_to_normalized(p, cam),
                lambda p: jcamera.pixels_to_normalized(p, jcam), px)
    np.testing.assert_allclose(t, j, atol=ATOL)
    np.testing.assert_array_equal(cam.matrix, np.asarray(jcam.matrix))


def _corner_frames(dist, seed):
    """5 frames x 8 slots of corners from one synthetic sequence, with
    padding slots (zero corners) and one garbage slot per frame."""
    jcam = jcamera.CameraIntrinsics.create(600.0, 600.0, 320.0, 240.0, dist=dist)
    seq = jsyn.generate_sequence(
        jsyn.SimParams(duration=4.0, seed=seed, max_obs=8), level="corners", camera=jcam
    )
    corners = seq.corners_px[10:15].copy()
    valid = seq.obs_valid[10:15].copy()
    corners[:, -1] = [[1e9, 0.0], [0.0, 0.0], [np.inf, 1.0], [np.nan, 2.0]]
    valid[:, -1] = True  # garbage marked valid: the gates must drop it
    return jcam, seq.obs_ids[10:15], corners, valid


@pytest.mark.parametrize("dist,seed", [(None, 2), (DIST, 3)])
def test_pnp_frontend_plain_matches_jax_kernel_and_xla(dist, seed):
    jcam, ids, corners, valid = _corner_frames(dist, seed)
    assert valid[:, :-1].sum() > 10  # real markers in the window
    cam = convert.camera_from_numpy(jcam.fx, jcam.fy, jcam.cx, jcam.cy, jcam.dist)
    z, R, keep = pnp_frontend.pnp_frontend_batch(
        torch.as_tensor(corners), torch.as_tensor(valid), cam, CFG
    )
    z, R, keep = z.numpy(), R.numpy(), keep.numpy()
    zk, Rk, keepk = jpk.pnp_frontend_batch(
        jnp.asarray(corners), jnp.asarray(valid), jcam, JCFG, interpret=True
    )
    ref = jax.vmap(
        lambda i_, c_, v_: jfrontend.observations_from_corners(i_, c_, v_, jcam, JCFG)
    )(jnp.asarray(ids), jnp.asarray(corners), jnp.asarray(valid))
    assert not keep[:, -1].any()
    for zj, Rj, kj in ((zk, Rk, keepk), (ref.z, ref.R, ref.valid)):
        kj = np.asarray(kj)
        np.testing.assert_array_equal(keep, kj)
        np.testing.assert_allclose(z[keep], np.asarray(zj)[keep], atol=2e-5)
        np.testing.assert_allclose(R[keep], np.asarray(Rj)[keep], atol=2e-5, rtol=2e-4)
