"""Output records (L4) — the part of ``aruco_slam_tpu.viz`` that
:class:`~aruco_slam_tpu_torch.system.SlamSystem` uses: the reference's rviz
surface without ROS, in numpy on the host.

- :func:`pose_with_covariance`    — ``toRosPose`` (src/aruco_slam.cpp:378-410)
  with the 3-DoF -> 6x6 covariance packing at {0,1,5,6,7,11,30,31,35}
- :func:`mapped_markers`          — ``toRosMappedMarkers`` (:265-281)
- :func:`detected_marker_records` — ``toRosDetectedMarkers`` (:336-347)
- :func:`draw_detections`         — ``getMarkedImg`` (:318-319)

A state here is the port's ``EkfState`` with a batch axis of one (its
tensors may lie on any device); detections are one frame's, unbatched.
"""

from __future__ import annotations

import numpy as np


def _host(x) -> np.ndarray:
    """A tensor (any device) or array as a host numpy array."""
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def pose_with_covariance(state) -> dict:
    """Pose + covariance record with the reference's 6x6 packing
    (rows/cols x, y, z, rot_x, rot_y, rot_z; planar entries only)."""
    mu = _host(state.mu[0, :3])
    sigma = _host(state.sigma[0, :3, :3])
    cov6 = np.zeros(36)
    cov6[[0, 1, 5, 6, 7, 11, 30, 31, 35]] = sigma.reshape(-1)
    return {
        "frame_id": "world",
        "position": (float(mu[0]), float(mu[1]), 0.1),  # z=0.1 as reference
        "yaw": float(mu[2]),
        "covariance6x6": cov6,
    }


def landmarks(state, config):
    """(landmarks [n, 3], aruco_ids [n]) of the active slots, on the host."""
    n = int(_host(state.n_landmarks)[0])
    lms = _host(state.mu[0, 3:]).reshape(config.ekf.max_landmarks, 3)
    return lms[:n], _host(state.slot_ids[0])[:n]


def mapped_markers(state, config) -> list[dict]:
    """Estimated landmark map as CUBE marker records (reference colors:
    r=1, g=0.5, b=1, a=0.5; pose z=0.3; orientation RPY(0, 1.5708, theta))."""
    lms, ids = landmarks(state, config)
    length = config.aruco.marker_length
    return [
        {
            "id": int(k),
            "aruco_id": int(ids[k]),
            "frame_id": "world",
            "type": "CUBE",
            "scale": (length, length, 0.01),
            "color_rgba": (1.0, 0.5, 1.0, 0.5),
            "position": (float(lms[k, 0]), float(lms[k, 1]), 0.3),
            "rpy": (0.0, 1.5708, float(lms[k, 2])),
            "lifetime": 0.0,
        }
        for k in range(len(ids))
    ]


def detected_marker_records(detections, marker_length: float) -> list[dict]:
    """Live detections (red, 0.1 s lifetime) — reference :336-347."""
    ids = _host(detections.ids)
    valid = _host(detections.valid)
    corners = _host(detections.corners)
    return [
        {
            "id": int(ids[k]),
            "frame_id": "base_link",
            "type": "CUBE",
            "scale": (marker_length, marker_length, 0.01),
            "color_rgba": (1.0, 0.0, 0.0, 1.0),
            "corners_px": corners[k].tolist(),
            "lifetime": 0.1,
        }
        for k in range(len(ids))
        if valid[k]
    ]


def _draw_line(img, p0, p1, value):
    """Line on a uint8 image by rounded linspace samples (no cv2)."""
    x0, y0 = int(round(p0[0])), int(round(p0[1]))
    x1, y1 = int(round(p1[0])), int(round(p1[1]))
    n = max(abs(x1 - x0), abs(y1 - y0), 1)
    xs = np.linspace(x0, x1, n + 1).round().astype(int)
    ys = np.linspace(y0, y1, n + 1).round().astype(int)
    h, w = img.shape[:2]
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[ok], xs[ok]] = value
    return img


# 3x5 dot-matrix digit glyphs for the id labels (row-major, top to bottom)
_DIGIT_3X5 = {
    "0": "111101101101111", "1": "010110010010111", "2": "111001111100111",
    "3": "111001111001111", "4": "101101111001001", "5": "111100111001111",
    "6": "111100111101111", "7": "111001001001001", "8": "111101111101111",
    "9": "111101111001111",
}


def _stamp_text(img, text: str, origin, value, scale: int = 2) -> None:
    """Stamp digits as 3x5 dot-matrix glyphs at ``origin`` (x, y)."""
    h, w = img.shape[:2]
    x0, y0 = int(round(origin[0])), int(round(origin[1]))
    for ch in text:
        glyph = _DIGIT_3X5.get(ch)
        if glyph is None:
            x0 += 4 * scale
            continue
        for r in range(5):
            for c in range(3):
                if glyph[r * 3 + c] == "1":
                    ys = y0 + r * scale
                    xs = x0 + c * scale
                    img[
                        max(0, ys): max(0, min(h, ys + scale)),
                        max(0, xs): max(0, min(w, xs + scale)),
                    ] = value
        x0 += 4 * scale


def draw_detections(img, detections, value: int = 255) -> np.ndarray:
    """Annotated frame (the ``getMarkedImg`` equivalent): marker outlines,
    a cross on corner 0 (the pattern's top-left) and the marker id stamped
    right of each outline, as ``cv::aruco::drawDetectedMarkers`` does."""
    out = np.array(_host(img), copy=True)
    ids = _host(detections.ids)
    valid = _host(detections.valid)
    corners = _host(detections.corners)
    for k in range(len(ids)):
        if not valid[k]:
            continue
        quad = corners[k]
        for a in range(4):
            _draw_line(out, quad[a], quad[(a + 1) % 4], value)
        c0 = quad[0]
        _draw_line(out, c0 + (-3, -3), c0 + (3, 3), value)
        _draw_line(out, c0 + (-3, 3), c0 + (3, -3), value)
        x = quad[:, 0].max() + 3
        y = quad[:, 1].mean() - 5
        _stamp_text(out, str(int(ids[k])), (x, y), value)
    return out
