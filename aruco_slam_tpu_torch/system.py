"""Online SLAM system (L4) — the reference's ``ArucoSlam`` class surface,
counterpart of ``aruco_slam_tpu.system.SlamSystem``.

=====================================  =====================================
reference (include/aruco_slam/...)      here
=====================================  =====================================
``ArucoSlam(inite_data)``               ``SlamSystem(config)``
``setCameraParameters(K, dist)``        ``set_camera(camera)``
``addEncoder(wl, wr)`` (wall-clock dt)  ``add_encoder(wl, wr, dt)`` (explicit dt)
``addImage(img)``                       ``add_image(img)`` / ``add_corners`` /
                                        ``add_observations``
``toRosPose()``                         ``pose_with_covariance()``
``toRosMappedMarkers()``                ``mapped_markers()``
``toRosDetectedMarkers()``              ``detected_markers()``
``getMarkedImg()``                      ``marked_image()``
=====================================  =====================================

The state (a batch of one) lives on ``device``, the card unless the caller
asks for another. Each frame's update is ``runner.frame_update_for(config,
batched=False)``: K6 by default. ``add_image`` detects one frame through the
frame-batched detector (K3 on the card), then runs the torch front-end.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from aruco_slam_tpu_torch import viz
from aruco_slam_tpu_torch.models import ekf
from aruco_slam_tpu_torch.ops import frontend
from aruco_slam_tpu_torch.ops.camera import CameraIntrinsics
from aruco_slam_tpu_torch.ops.detector import DetectorConfig, Detections, detect_markers
from aruco_slam_tpu_torch.runner import frame_update_for
from aruco_slam_tpu_torch.utils.config import SlamConfig
from aruco_slam_tpu_torch.utils.device import resolve


class SlamSystem:
    def __init__(
        self,
        config: SlamConfig | None = None,
        camera: Optional[CameraIntrinsics] = None,
        detector_config: DetectorConfig = DetectorConfig(),
        device=None,
    ):
        self.config = config or SlamConfig()
        self.camera = camera
        self.detector_config = detector_config
        self.device = resolve(device)
        # the two kernel-bearing steps (a caller may swap in the plain versions)
        self._update = frame_update_for(self.config, batched=False)
        self._detect = detect_markers
        self.reset()

    def _tensor(self, x, dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=dtype).to(self.device)[None]

    # -- inputs ------------------------------------------------------------

    def set_camera(self, camera: CameraIntrinsics) -> None:
        """Reference ``setCameraParameters`` (aruco_slam.h:129-133)."""
        self.camera = camera

    def add_encoder(self, wl: float, wr: float, dt: float) -> None:
        """EKF predict from one encoder tick. The reference used wall-clock
        receive time for dt (quirk (a)); here dt is explicit."""
        c = torch.tensor([[wl, wr, dt]], dtype=torch.float32).to(self.device)
        self.state = ekf.predict(self.state, ekf.Control(c[:, 0], c[:, 1], c[:, 2]), self.config)

    def add_image(self, img) -> None:
        """Full per-frame pipeline: detect -> PnP -> gate -> EKF update
        (reference ``addImage`` + ``getObservations``). ``img`` is one
        grayscale ``[H, W]`` or BGR ``[H, W, 3]`` frame, numpy or a tensor."""
        if self.camera is None:
            raise RuntimeError("set_camera first (reference parses CameraInfo)")
        if not isinstance(img, torch.Tensor):
            img = torch.from_numpy(np.array(img))  # a copy: the caller may reuse its buffer
        img = img.to(self.device)
        det = self._detect(img, self.detector_config)
        self.last_detections = det
        self._last_image = img
        frame = frontend.observations_from_corners(
            det.ids[None], det.corners[None], det.valid[None], self.camera, self.config
        )
        self.state = self._update(self.state, frame, self.config)

    def add_corners(self, ids, corners_px, valid) -> None:
        """PnP-level input (detector bypassed)."""
        frame = frontend.observations_from_corners(
            self._tensor(ids, torch.int32), self._tensor(corners_px, torch.float32),
            self._tensor(valid, torch.bool), self.camera, self.config,
        )
        self.state = self._update(self.state, frame, self.config)

    def add_observations(self, ids, z, R, valid) -> None:
        """Measurement-level input."""
        frame = ekf.FrameObservations(
            ids=self._tensor(ids, torch.int32), z=self._tensor(z, torch.float32),
            R=self._tensor(R, torch.float32), valid=self._tensor(valid, torch.bool),
        )
        self.state = self._update(self.state, frame, self.config)

    # -- outputs -----------------------------------------------------------

    def pose(self) -> np.ndarray:
        return self.state.mu[0, :3].cpu().numpy()

    def pose_with_covariance(self) -> dict:
        return viz.pose_with_covariance(self.state)

    def mapped_markers(self) -> list:
        return viz.mapped_markers(self.state, self.config)

    def detected_markers(self) -> list:
        if self.last_detections is None:
            return []
        return viz.detected_marker_records(
            self.last_detections, self.config.aruco.marker_length
        )

    def marked_image(self) -> Optional[np.ndarray]:
        """Reference ``getMarkedImg``: last frame with detections drawn."""
        if self._last_image is None or self.last_detections is None:
            return None
        return viz.draw_detections(self._last_image, self.last_detections)

    def landmark_map(self):
        """(landmarks [n, 3], aruco_ids [n]) for the active slots."""
        return viz.landmarks(self.state, self.config)

    def reset(self) -> None:
        self.state = ekf.init_state(self.config, 1, self.device)
        self.last_detections: Optional[Detections] = None
        self._last_image = None
