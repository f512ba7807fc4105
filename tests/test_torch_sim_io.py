"""The port's numpy-only copies (config, map I/O, sequence container,
synthetic generator) held equal to the JAX package's originals."""

import dataclasses

import numpy as np
import pytest
import torch

from aruco_slam_tpu.io import map_io as jmap_io
from aruco_slam_tpu.io.sequence import Sequence as JSequence
from aruco_slam_tpu.ops.camera import CameraIntrinsics as JCamera
from aruco_slam_tpu.sim import synthetic as jsyn
from aruco_slam_tpu.utils import config as jconfig
from aruco_slam_tpu_torch import convert
from aruco_slam_tpu_torch.io import map_io
from aruco_slam_tpu_torch.io.sequence import Sequence
from aruco_slam_tpu_torch.ops.camera import CameraIntrinsics
from aruco_slam_tpu_torch.sim import synthetic
from aruco_slam_tpu_torch.utils import config

torch.set_num_threads(1)

DIST = [-0.28, 0.07, 1.2e-3, -8e-4, 0.018]
_SEQ_FIELDS = (
    "enc_w", "enc_dt", "obs_ids", "obs_z", "obs_R", "obs_valid", "corners_px",
    "true_pose_frames", "true_pose_enc", "true_landmarks", "true_landmark_ids",
)


def test_slam_config_defaults_equal():
    assert dataclasses.asdict(config.SlamConfig()) == dataclasses.asdict(
        jconfig.SlamConfig()
    )


def test_config_round_trips_through_dict():
    j = jconfig.SlamConfig(
        ekf=jconfig.EkfConfig(max_landmarks=32, max_observations_per_frame=16),
        compat=jconfig.CompatConfig(reject_divergent=True),
        t_r2c_x=0.1,
    )
    port = convert.config_from_dict(dataclasses.asdict(j))
    assert dataclasses.asdict(port) == dataclasses.asdict(j)
    assert port.ekf.max_landmarks == 32 and port.compat.reject_divergent


def test_load_config_matches_on_reference_layout(tmp_path):
    raw = {
        "covariance": {"Q_k": 0.02},
        "odom": {"b": 0.1},
        "topic": {"image": "/camera/image_raw"},
        "const": {"USEFUL_DISTANCE_THRESHOLD": 4.0},
    }
    assert dataclasses.asdict(config.load_config(dict(raw))) == dataclasses.asdict(
        jconfig.load_config(dict(raw))
    )
    path = tmp_path / "p.yaml"
    path.write_text("odom:\n  kl: 0.06\n")
    assert config.load_config(str(path)).odom.kl == 0.06
    with pytest.raises(config.ConfigError):
        config.load_config({"odom": {"wheel": 1.0}})


def test_map_io_matches(tmp_path):
    lines = [
        "# id length x y z roll pitch yaw\n", "\n",
        "1 0.27 1.0 2.0\n", "2 0.27 1.0 2.0 0.3 0.1\n",
        "3 0.27 1.0 2.0 0.3 0.1 0.2 0.5\n", "4 0.27 1 2 0.3 0.1 0.2\n",
    ]
    a, b = map_io.parse_map_lines(lines), jmap_io.parse_map_lines(lines)
    for name in ("ids", "lengths", "positions", "rpys"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    path = tmp_path / "map.txt"
    map_io.save_map(str(path), a)
    np.testing.assert_array_equal(jmap_io.load_map(str(path)).positions, a.positions)


@pytest.mark.parametrize("level,dist", [("obs", None), ("corners", None), ("corners", DIST)])
def test_generate_sequence_identical(level, dist):
    params = dict(duration=3.0, seed=5, max_obs=6)
    ours = synthetic.generate_sequence(
        synthetic.SimParams(**params), level=level,
        camera=CameraIntrinsics.create(600.0, 600.0, 320.0, 240.0, dist=dist),
    )
    ref = jsyn.generate_sequence(
        jsyn.SimParams(**params), level=level,
        camera=JCamera.create(600.0, 600.0, 320.0, 240.0, dist=dist),
    )
    for name in _SEQ_FIELDS:
        a, b = getattr(ours, name), getattr(ref, name)
        if b is None:
            assert a is None, name
            continue
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert ours.enc_per_frame == ref.enc_per_frame
    assert ours.meta["camera_K"] == ref.meta["camera_K"]
    assert ours.meta["camera_D"] == ref.meta["camera_D"]


def test_sequence_npz_crosses_packages(tmp_path):
    cam = CameraIntrinsics.create(600.0, 610.0, 320.0, 240.0, dist=DIST)
    seq = synthetic.generate_sequence(
        synthetic.SimParams(duration=1.0, seed=1, max_obs=4), level="corners", camera=cam
    )
    path = str(tmp_path / "seq.npz")
    seq.save(path)
    ref = JSequence.load(path)
    back = Sequence.load(path)
    for name in _SEQ_FIELDS:
        np.testing.assert_array_equal(getattr(ref, name), getattr(seq, name))
        np.testing.assert_array_equal(getattr(back, name), getattr(seq, name))
    assert back.camera() == cam
    jcam = ref.camera()
    assert convert.camera_from_numpy(jcam.fx, jcam.fy, jcam.cx, jcam.cy, jcam.dist) == cam
