"""Sequence container (L3) — the numpy-only copy of
``aruco_slam_tpu.io.sequence``.

Timestamped encoder + camera-frame streams at three levels of fidelity on
one timeline: ``obs_*`` (direct (x, y, theta) marker observations),
``corners_px`` (per-marker pixel corners) and ``images`` (rendered uint8
frames for the detector). The npz format is the JAX package's, so a
sequence saved by either package loads in the other. The ``.asq`` image
container is not ported yet (ROADMAP Queue 1).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

_ARRAY_FIELDS = (
    "enc_w", "enc_dt", "obs_ids", "obs_z", "obs_R", "obs_valid",
    "corners_px", "images", "true_pose_frames", "true_pose_enc",
    "true_landmarks", "true_landmark_ids",
)

_NOT_PORTED = "the .asq image container is not ported yet (ROADMAP Queue 1)"


@dataclass
class Sequence:
    """One recorded/synthesized run, numpy on the host. Shapes: F frames,
    E = F * enc_per_frame encoder ticks, M max markers per frame."""

    enc_w: np.ndarray  # [E, 2] (wl, wr)
    enc_dt: np.ndarray  # [E]
    enc_per_frame: int

    obs_ids: np.ndarray  # [F, M] int32, -1 = padding
    obs_z: np.ndarray  # [F, M, 3]
    obs_R: np.ndarray  # [F, M, 3, 3]
    obs_valid: np.ndarray  # [F, M] bool

    corners_px: Optional[np.ndarray] = None  # [F, M, 4, 2]
    images: Optional[np.ndarray] = None  # [F, H, W] uint8

    true_pose_frames: Optional[np.ndarray] = None  # [F, 3]
    true_pose_enc: Optional[np.ndarray] = None  # [E, 3]
    true_landmarks: Optional[np.ndarray] = None  # [L, 3] planar (x, y, yaw)
    true_landmark_ids: Optional[np.ndarray] = None  # [L]

    meta: dict = field(default_factory=dict)

    def set_camera(self, camera) -> None:
        """Record the generating camera's intrinsics in ``meta``: the
        reference reads K and D from the CameraInfo stream per run
        (src/aruco_slam_node.cpp:121-130), so a sequence carries its own
        calibration."""
        self.meta["camera_K"] = [
            float(x) for x in np.asarray(camera.matrix).reshape(-1)
        ]
        self.meta["camera_D"] = [float(x) for x in camera.dist]

    def camera(self):
        """The sequence's own camera (the port's :class:`CameraIntrinsics`),
        or None if the sequence carries no calibration."""
        if "camera_K" not in self.meta:
            return None
        from aruco_slam_tpu_torch.ops.camera import CameraIntrinsics

        return CameraIntrinsics.from_camera_info(
            self.meta["camera_K"], self.meta.get("camera_D")
        )

    @property
    def num_frames(self) -> int:
        return self.obs_ids.shape[0]

    @property
    def max_obs(self) -> int:
        return self.obs_ids.shape[1]

    def save(self, path: str, image_format: str = "npz") -> None:
        """Write the sequence as a compressed npz archive."""
        if image_format != "npz":
            raise NotImplementedError(f"image_format={image_format!r}: {_NOT_PORTED}")
        data = {
            name: getattr(self, name)
            for name in _ARRAY_FIELDS
            if getattr(self, name) is not None
        }
        data["enc_per_frame"] = np.asarray(self.enc_per_frame)
        meta_json = {}
        for k, v in self.meta.items():
            if isinstance(v, np.ndarray):
                data[f"meta_arr_{k}"] = v
            else:
                meta_json[k] = list(v) if isinstance(v, tuple) else v
        data["meta_json"] = np.asarray(json.dumps(meta_json))
        np.savez_compressed(path, **data)

    @classmethod
    def load(cls, path: str) -> "Sequence":
        with np.load(path, allow_pickle=False) as f:
            kw = {k: f[k] for k in f.files}
        kw["enc_per_frame"] = int(kw["enc_per_frame"])
        meta = {}
        if "meta_json" in kw:
            meta.update(json.loads(str(kw.pop("meta_json"))))
        for k in [k for k in kw if k.startswith("meta_arr_")]:
            meta[k[len("meta_arr_"):]] = kw.pop(k)
        if "images_asq" in meta:
            raise NotImplementedError(f"{path} streams from .asq: {_NOT_PORTED}")
        kw["meta"] = meta
        return cls(**kw)


def stack_sequences(seqs: list) -> Sequence:
    """Stack equal-shape sequences along a new leading batch axis."""
    out = {}
    for name in _ARRAY_FIELDS:
        vals = [getattr(s, name) for s in seqs]
        out[name] = None if any(v is None for v in vals) else np.stack(vals)
    return Sequence(enc_per_frame=seqs[0].enc_per_frame, **out)
