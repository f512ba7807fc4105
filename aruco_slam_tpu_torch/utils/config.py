"""Typed configuration system — the numpy-free copy of
``aruco_slam_tpu.utils.config``.

The same frozen dataclasses with the same defaults (parameter names mirror
the reference's ``parameters.yaml``). ``yaml`` is imported inside
:func:`load_config` only, so importing the config needs nothing beyond the
standard library. ``tests/test_torch_sim_io.py`` holds the two copies equal.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Mapping

ARUCO_ORIGINAL_DICT_ID = 16  # cv::aruco::DICT_ARUCO_ORIGINAL (parameters.yaml:16)


@dataclass(frozen=True)
class NoiseConfig:
    """EKF noise coefficients (parameters.yaml:4-8)."""

    Q_k: float = 0.01
    R_x: float = 100.0
    R_y: float = 100.0
    R_theta: float = 10.0


@dataclass(frozen=True)
class OdomConfig:
    """Differential-drive geometry (parameters.yaml:10-13)."""

    kl: float = 0.05  # left wheel radius [m]
    kr: float = 0.05  # right wheel radius [m]
    b: float = 0.09  # half wheelbase [m]


@dataclass(frozen=True)
class ArucoConfig:
    """Marker dictionary + size (parameters.yaml:15-17)."""

    markers_dictionary: int = ARUCO_ORIGINAL_DICT_ID
    marker_length: float = 0.27
    # PnP Gauss-Newton trip count (settle-2 dual start + finish).
    pnp_refine_iters: int = 6


@dataclass(frozen=True)
class FrameConfig:
    """Frame names (parameters.yaml:19-22); kept for config parity."""

    world_frame: str = "world"
    camera_frame_optical: str = "camera_frame_optical"
    robot_frame_base: str = "base_link"


@dataclass(frozen=True)
class CompatConfig:
    """Per-quirk compatibility switches. Each flag reproduces (True) or
    fixes (False) a documented reference quirk; defaults reproduce the
    reference's effective behaviour."""

    # Quirk (b): process noise uses kl for BOTH wheels (src/aruco_slam.cpp:62).
    process_noise_uses_kl_for_both_wheels: bool = True
    # Quirk (c): skip the correction when a marker was seen last frame with
    # a near-identical measurement (src/aruco_slam.cpp:192-198).
    stationary_gate: bool = True
    stationary_gate_eps: float = 0.01
    # Quirk (d): divergence check is log-only (src/aruco_slam.cpp:156-175).
    reject_divergent: bool = False
    divergence_ze_norm: float = 1.0
    divergence_k_norm: float = 10.0


@dataclass(frozen=True)
class EkfConfig:
    """Capacity and numerics of the fixed-shape EKF state."""

    max_landmarks: int = 64
    max_observations_per_frame: int = 16
    # Re-symmetrize sigma after each frame's updates (f32 hygiene).
    symmetrize_sigma: bool = True
    # The frame update runner.frame_update_for selects: the block-LDL form,
    # or "auto" / "pallas" (the hand-written kernels) or "xla" (the plain
    # sequential update). The batched replay always runs K2.
    fused_update: bool = False
    update_backend: str = "auto"


@dataclass(frozen=True)
class SlamConfig:
    """Top-level config — union of the reference's parameters.yaml sections."""

    covariance: NoiseConfig = field(default_factory=NoiseConfig)
    odom: OdomConfig = field(default_factory=OdomConfig)
    aruco: ArucoConfig = field(default_factory=ArucoConfig)
    frame: FrameConfig = field(default_factory=FrameConfig)
    compat: CompatConfig = field(default_factory=CompatConfig)
    ekf: EkfConfig = field(default_factory=EkfConfig)
    # Effective reference default is 3.0 (aruco_slam.h:58): the yaml key
    # was never read.
    useful_distance_threshold: float = 3.0
    # Robot->camera planar translation (src/aruco_slam.cpp:359-360).
    t_r2c_x: float = 0.0
    t_r2c_y: float = 0.0
    map_file: str | None = None


class ConfigError(ValueError):
    pass


_DATACLASSES = {
    c.__name__: c
    for c in (
        NoiseConfig, OdomConfig, ArucoConfig, FrameConfig, CompatConfig,
        EkfConfig, SlamConfig,
    )
}


def _resolve(ftype):
    if isinstance(ftype, str):
        return _DATACLASSES.get(ftype, ftype)
    return ftype


def build(cls, data: Mapping[str, Any], path: str = "config"):
    """Build dataclass ``cls`` from a nested mapping; unknown keys raise."""
    if not isinstance(data, Mapping):
        raise ConfigError(f"{path}: expected mapping, got {type(data).__name__}")
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for key, value in data.items():
        if key not in fields:
            raise ConfigError(
                f"{path}: unknown key {key!r} (valid: {sorted(fields)})"
            )
        ftype = _resolve(fields[key].type)
        if dataclasses.is_dataclass(ftype):
            kwargs[key] = build(ftype, value, f"{path}.{key}")
        else:
            kwargs[key] = value
    return cls(**kwargs)


# Sections of the reference parameters.yaml mapped onto the schema, so the
# reference's own config file loads unchanged.
_REFERENCE_KEY_MAP = {
    "topic": None,  # ROS topics — no message bus here; ignored
    "const": ("useful_distance_threshold", "USEFUL_DISTANCE_THRESHOLD"),
    "map": ("map_file", "map_file"),
}


def load_config(path_or_dict) -> SlamConfig:
    """Load a :class:`SlamConfig` from YAML (path or pre-parsed dict)."""
    if isinstance(path_or_dict, Mapping):
        raw = dict(path_or_dict)
    else:
        import yaml

        with open(path_or_dict) as f:
            raw = yaml.safe_load(f) or {}
        if not isinstance(raw, Mapping):
            raise ConfigError(f"{path_or_dict}: top level must be a mapping")
        raw = dict(raw)

    flat: dict[str, Any] = {}
    for section, mapping in _REFERENCE_KEY_MAP.items():
        if section in raw:
            value = raw.pop(section)
            if mapping is None:
                continue
            target, src_key = mapping
            if isinstance(value, Mapping) and src_key in value:
                flat[target] = value[src_key]
    raw.update(flat)
    return build(SlamConfig, raw, "config")
