"""Synthetic marker-SLAM worlds and sequences (L3) — counterpart of
``aruco_slam_tpu.sim.synthetic``; numpy on the host, except the image
level, which renders through ``sim.renderer`` on a given device.

For the same :class:`SimParams` and camera it returns obs and corner
arrays identical to the JAX package's generator, and images that differ
from its renderer's in at most a few marker-edge pixels
(``tests/test_torch_sim_io.py``, ``tests/test_torch_image_replay.py``).

Replaces the reference's external Gazebo environment (slam.launch pulls the
world/robot/controller from other packages, launch/slam.launch:12-41) with a
deterministic generator:

- rectangular marker arenas in the ``map/map.txt`` idiom (vertical wall
  markers facing inward, reference map/map.txt:2-8),
- differential-drive trajectories driven by (v, omega) profiles converted
  to wheel angular velocities through the same kinematics the EKF assumes
  (reference src/aruco_slam.cpp:35-42),
- observation streams at the measurement level (x, y, theta + noise), the
  pixel-corner level (full 3-D projection through the camera model) or the
  image level (rendered 640x480 grayscale frames).

Planar marker yaw convention: the azimuth of the marker's outward face
normal. This is exactly what the reference's observed theta
(atan2(-R02, R22), src/aruco_slam.cpp:361) measures relative to the robot
heading — derivation in ``map_to_planar``'s docstring.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np

from aruco_slam_tpu_torch.io.map_io import MarkerMap
from aruco_slam_tpu_torch.io.sequence import Sequence


def rpy_matrix_np(roll, pitch, yaw):
    cr, sr = np.cos(roll), np.sin(roll)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    return np.array(
        [
            [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
            [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
            [-sp, cp * sr, cp * cr],
        ]
    )


def map_to_planar(marker_map: MarkerMap) -> np.ndarray:
    """MarkerMap -> planar landmark states [(x, y, phi)].

    phi is the azimuth of the marker's face normal (marker-frame z-axis in
    world). With the camera optical frame (z forward, x right, y down) rigid
    on a robot at heading theta, the reference's observed angle
    atan2(-R02, R22) equals wrap(phi - theta): the face normal in camera
    coords is (sin(theta - phi), 0, cos(theta - phi)) for a vertical marker,
    so the EKF's landmark theta estimates exactly this phi.
    """
    out = []
    for i in range(len(marker_map)):
        R = rpy_matrix_np(*marker_map.rpys[i])
        n = R @ np.array([0.0, 0.0, 1.0])
        phi = np.arctan2(n[1], n[0])
        out.append((marker_map.positions[i, 0], marker_map.positions[i, 1], phi))
    return np.asarray(out)


def planar_to_map(planar: np.ndarray, ids=None, marker_length=0.27, z=0.3) -> MarkerMap:
    """Planar landmarks [(x, y, phi)] -> MarkerMap with vertical markers.

    Orientation: marker z-axis (face normal) horizontal at azimuth phi,
    marker y-axis up — expressed as fixed-axis RPY for the map.txt schema.
    """
    n = len(planar)
    rpys = np.zeros((n, 3))
    for i, (_, _, phi) in enumerate(planar):
        # R columns: x_m = (-sin phi, cos phi, 0), y_m = (0,0,1),
        # z_m = (cos phi, sin phi, 0).  As ZYX euler: yaw=phi, pitch=pi/2? —
        # solve directly: R = Rz(phi) @ Ry(pi/2) gives columns
        # x=(0,0,-1)... simpler to use roll=-pi/2 about the new x:
        # Rz(phi + pi/2) @ Rx(pi/2) has columns x=(-sin a, cos a, 0),
        # y=(0,0,1)... verify: a = phi:
        # Rz(a): x->(cos a, sin a,0), Rx(pi/2): maps y->z, z->-y.
        # R = Rz(a) @ Rx(pi/2): col x = (cos a, sin a, 0)? We want
        # x_m=(-sin phi, cos phi, 0) so a = phi + pi/2.
        rpys[i] = (np.pi / 2, 0.0, phi + np.pi / 2)
    positions = np.concatenate([planar[:, :2], np.full((n, 1), z)], axis=1)
    return MarkerMap(
        ids=np.arange(n, dtype=np.int32) if ids is None else np.asarray(ids, np.int32),
        lengths=np.full((n,), marker_length),
        positions=positions,
        rpys=rpys,
    )


def make_arena(
    n_markers: int = 20,
    width: float = 5.1,
    height: float = 4.7,
    marker_length: float = 0.27,
    z: float = 0.3,
) -> MarkerMap:
    """Rectangular arena with markers spread along the walls facing inward —
    a scaled-up version of the reference's 7-marker world (map/map.txt)."""
    per = 2 * (width + height)
    planar = []
    for i in range(n_markers):
        s = (i + 0.5) / n_markers * per
        if s < width:  # bottom wall (y = -height), facing +y
            planar.append((s, -height, np.pi / 2))
        elif s < width + height:  # right wall (x = width), facing -x
            planar.append((width, -height + (s - width), np.pi))
        elif s < 2 * width + height:  # top wall (y = 0), facing -y
            planar.append((width - (s - width - height), 0.0, -np.pi / 2))
        else:  # left wall (x = 0), facing +x
            planar.append((0.0, -(per - s), 0.0))
    return planar_to_map(np.asarray(planar), marker_length=marker_length, z=z)


@dataclass
class SimParams:
    """Generator knobs. Defaults give a reference-like run: a wobbly loop
    inside the arena at ~0.3 m/s, 100 Hz encoders, 10 Hz frames."""

    duration: float = 60.0
    enc_rate: float = 100.0
    frames_per_sec: float = 10.0
    # drive profile: "loop" = circle with sinusoidal wobble; "tour" =
    # rounded-rectangle perimeter tour (for large arenas / loop closure)
    profile: str = "loop"
    v0: float = 0.3
    omega0: float = 0.25
    omega_wobble: float = 0.15
    wobble_period: float = 11.0
    # tour profile geometry: rectangle inset from the arena walls
    tour_width: float = 5.1
    tour_height: float = 4.7
    tour_inset: float = 1.0
    tour_corner_radius: float = 0.6
    # Default start puts the v0/omega0 loop (radius ~1.2 m) in the middle of
    # the default 5.1 x 4.7 arena.
    start_pose: tuple = (2.55, -3.55, 0.0)
    # Robot geometry (must match the SlamConfig used for estimation)
    kl: float = 0.05
    kr: float = 0.05
    b: float = 0.09
    # Observation model
    max_obs: int = 16
    max_range: float = 3.0
    fov_deg: float = 70.0
    max_view_angle_deg: float = 70.0
    t_r2c: tuple = (0.0, 0.0)
    # Noise (measurement level); sigmas scale with distance like the
    # reference's reprojection-based heuristic (src/aruco_slam.cpp:466-470)
    sigma_xy: float = 0.01
    sigma_theta: float = 0.02
    noise_dist_scale: float = 0.5
    encoder_noise: float = 0.0
    seed: int = 0


def _wheel_speeds(v, omega, p: SimParams):
    """(v, omega) -> wheel angular velocities via the differential-drive
    inverse kinematics of src/aruco_slam.cpp:35-42."""
    vl = v - omega * p.b
    vr = v + omega * p.b
    return vl / p.kl, vr / p.kr


def _integrate(pose, wl, wr, dt, p: SimParams):
    """Ground-truth motion: same midpoint-arc model the EKF predicts with."""
    dsl = p.kl * dt * wl
    dsr = p.kr * dt * wr
    dth = (dsr - dsl) / (2 * p.b)
    ds = 0.5 * (dsr + dsl)
    tmp = pose[2] + 0.5 * dth
    x = pose[0] + ds * np.cos(tmp)
    y = pose[1] + ds * np.sin(tmp)
    th = np.arctan2(np.sin(pose[2] + dth), np.cos(pose[2] + dth))
    return np.array([x, y, th])


def _to_start_frame(poses: np.ndarray, start: np.ndarray) -> np.ndarray:
    """Express SE(2) states (poses or planar landmarks) in the frame of the
    start pose: out = start^-1 o pose."""
    c, s = np.cos(start[2]), np.sin(start[2])
    dx = poses[..., 0] - start[0]
    dy = poses[..., 1] - start[1]
    th = poses[..., 2] - start[2]
    th = np.arctan2(np.sin(th), np.cos(th))
    return np.stack([dx * c + dy * s, -dx * s + dy * c, th], axis=-1)


def _tour_profile(p: SimParams):
    """Rounded-rectangle perimeter tour: piecewise (straight | corner-arc)
    omega schedule at constant v, cycling until the duration runs out.

    Drives counter-clockwise around a rectangle of tour_width x tour_height
    inset by tour_inset, corners rounded with tour_corner_radius — close
    enough to every wall that the 3 m range gate (reference effective
    threshold) sees each wall's markers, with a full loop closure per lap.
    """
    r = p.tour_corner_radius
    w = p.tour_width - 2 * p.tour_inset - 2 * r
    h = p.tour_height - 2 * p.tour_inset - 2 * r
    if w <= 0 or h <= 0:
        raise ValueError("tour rectangle too small for inset + corner radius")
    quarter = np.pi * r / 2
    # segments: [straight w, arc, straight h, arc, straight w, arc, straight h, arc]
    seg_len = [w, quarter, h, quarter, w, quarter, h, quarter]
    seg_omega = [0.0, p.v0 / r, 0.0, p.v0 / r, 0.0, p.v0 / r, 0.0, p.v0 / r]
    cum = np.cumsum(seg_len)
    total = cum[-1]

    def omega_of_t(t):
        s = (p.v0 * t) % total
        k = int(np.searchsorted(cum, s, side="right"))
        return seg_omega[min(k, 7)]

    # start at the bottom-left end of the bottom straight, heading +x,
    # in arena coordinates (arena spans x in [0, W], y in [-H, 0])
    start = (p.tour_inset + r, -(p.tour_height - p.tour_inset), 0.0)
    return omega_of_t, start


def generate_sequence(
    params: SimParams,
    marker_map: MarkerMap | None = None,
    level: str = "obs",
    camera=None,
    device=None,
) -> Sequence:
    """Generate a full sequence. ``level``: "obs" (measurement-space),
    "corners" (adds the pixel-corner stream projected through ``camera``)
    or "images" (corners, plus frames rendered on ``device``; None: the
    card)."""
    if level not in ("obs", "corners", "images"):
        raise ValueError(f"level must be 'obs', 'corners' or 'images', got {level!r}")
    p = params
    rng = np.random.default_rng(p.seed)
    if marker_map is None:
        marker_map = make_arena()
    landmarks = map_to_planar(marker_map)
    lm_ids = np.asarray(marker_map.ids, np.int32)

    epf = int(round(p.enc_rate / p.frames_per_sec))
    n_frames = int(p.duration * p.frames_per_sec)
    n_enc = n_frames * epf
    dt = 1.0 / p.enc_rate

    # --- drive ------------------------------------------------------------
    enc_w = np.zeros((n_enc, 2))
    enc_dt = np.full((n_enc,), dt)
    true_pose_enc = np.zeros((n_enc, 3))
    if p.profile == "tour":
        omega_of_t, start_override = _tour_profile(p)
    else:
        omega_of_t, start_override = None, None
    pose = np.asarray(
        start_override if start_override is not None else p.start_pose, float
    )
    for e in range(n_enc):
        t = e * dt
        if e == 0:
            wl = wr = 0.0  # first tick is the reference's is_init_ latch
        elif omega_of_t is not None:
            wl, wr = _wheel_speeds(p.v0, omega_of_t(t), p)
        else:
            omega = p.omega0 + p.omega_wobble * np.sin(2 * np.pi * t / p.wobble_period)
            wl, wr = _wheel_speeds(p.v0, omega, p)
        enc_w[e] = (wl, wr)
        pose = _integrate(pose, wl, wr, dt, p)
        true_pose_enc[e] = pose
    if p.encoder_noise > 0:
        enc_w[1:] += rng.normal(scale=p.encoder_noise, size=enc_w[1:].shape)

    frame_idx = (np.arange(n_frames) + 1) * epf - 1
    true_pose_frames = true_pose_enc[frame_idx]

    # --- observe ----------------------------------------------------------
    m = p.max_obs
    obs_ids = np.full((n_frames, m), -1, np.int32)
    obs_z = np.zeros((n_frames, m, 3), np.float32)
    obs_R = np.tile(np.eye(3, dtype=np.float32), (n_frames, m, 1, 1))
    obs_valid = np.zeros((n_frames, m), bool)

    half_fov = np.deg2rad(p.fov_deg) / 2
    max_view = np.deg2rad(p.max_view_angle_deg)

    for f in range(n_frames):
        x, y, th = true_pose_frames[f]
        c, s = np.cos(th), np.sin(th)
        dxy = landmarks[:, :2] - (x, y)
        rel_x = dxy[:, 0] * c + dxy[:, 1] * s
        rel_y = -dxy[:, 0] * s + dxy[:, 1] * c
        dist = np.hypot(rel_x, rel_y)
        bearing = np.arctan2(rel_y, rel_x)
        # viewing angle between the ray robot->marker and the face normal
        ray = -dxy / np.maximum(dist, 1e-9)[:, None]
        normal = np.stack([np.cos(landmarks[:, 2]), np.sin(landmarks[:, 2])], axis=1)
        view_cos = np.sum(ray * normal, axis=1)
        visible = (
            (dist <= p.max_range)
            & (dist > 0.15)
            & (np.abs(bearing) <= half_fov)
            & (view_cos >= np.cos(max_view))
        )
        cand = np.nonzero(visible)[0]
        cand = cand[np.argsort(dist[cand])][:m]
        for j, li in enumerate(cand):
            d = dist[li]
            sx = p.sigma_xy * (1 + p.noise_dist_scale * d)
            sth = p.sigma_theta * (1 + p.noise_dist_scale * d)
            rel_th = np.arctan2(
                np.sin(landmarks[li, 2] - th), np.cos(landmarks[li, 2] - th)
            )
            # Robot-frame relative coordinates, NO t_r2c term: the camera
            # offset cancels in the reference pipeline (tvec_z measured from
            # the camera is rel_x - t_x; the node adds t_x back,
            # src/aruco_slam.cpp:359) — emitting rel_x + t_x here would
            # double-count it vs the corner/PnP path.
            z = np.array(
                [
                    rel_x[li] + rng.normal(scale=sx),
                    rel_y[li] + rng.normal(scale=sx),
                    rel_th + rng.normal(scale=sth),
                ],
                np.float32,
            )
            z[2] = np.arctan2(np.sin(z[2]), np.cos(z[2]))
            obs_ids[f, j] = lm_ids[li]
            obs_z[f, j] = z
            # True sampling covariance. (The corner-level pipeline instead
            # computes the reference's reprojection-error heuristic with its
            # +1e-2/+1e-3 floors in ops.frontend — those floors are a
            # property of that estimator, not of the measurements.)
            obs_R[f, j] = np.diag([sx**2, sx**2, sth**2]).astype(np.float32)
            obs_valid[f, j] = True

    # Express ground truth in the estimator's frame (anchored at the start
    # pose, where the EKF mean begins at zero — reference ctor
    # src/aruco_slam.cpp:13-14). Arena-frame truth is kept in meta.
    start = np.asarray(
        start_override if start_override is not None else p.start_pose, float
    )
    true_pose_frames_est = _to_start_frame(true_pose_frames, start)
    true_pose_enc_est = _to_start_frame(true_pose_enc, start)
    landmarks_est = _to_start_frame(landmarks, start)

    seq = Sequence(
        enc_w=enc_w.astype(np.float32),
        enc_dt=enc_dt.astype(np.float32),
        enc_per_frame=epf,
        obs_ids=obs_ids,
        obs_z=obs_z,
        obs_R=obs_R,
        obs_valid=obs_valid,
        true_pose_frames=true_pose_frames_est.astype(np.float32),
        true_pose_enc=true_pose_enc_est.astype(np.float32),
        true_landmarks=landmarks_est.astype(np.float32),
        true_landmark_ids=lm_ids,
        meta={
            "level": level,
            "start_pose": tuple(start),
            "true_pose_frames_world": true_pose_frames,
        },
    )

    if level in ("corners", "images"):
        seq = add_corner_stream(seq, marker_map, params, camera)
    if level == "images":
        seq = add_image_stream(seq, marker_map, params, camera, device=device)
    if camera is not None:
        # intrinsics travel WITH the sequence (the reference reads them from
        # the CameraInfo stream, src/aruco_slam_node.cpp:121-130)
        seq.set_camera(camera)
    return seq


def add_image_stream(
    seq: Sequence, marker_map: MarkerMap, p: SimParams, camera,
    height: int = 480, width: int = 640, device=None,
) -> Sequence:
    """Render every frame through the full camera model (``sim.renderer``,
    on ``device``; None: the card) — the image-level data source for the
    detector."""
    from aruco_slam_tpu_torch.sim import renderer

    images = renderer.render_sequence_frames(
        seq, marker_map, camera, t_r2c=p.t_r2c, height=height, width=width, device=device
    )
    return replace(seq, images=images, meta={**seq.meta, "level": "images"})


def camera_to_host(camera) -> tuple:
    """Camera intrinsics as host floats (fx, fy, cx, cy, dist[5])."""
    return (
        float(np.asarray(camera.fx)),
        float(np.asarray(camera.fy)),
        float(np.asarray(camera.cx)),
        float(np.asarray(camera.cy)),
        np.asarray(camera.dist, np.float64),
    )


def project_points_np(points_cam: np.ndarray, host_camera: tuple) -> np.ndarray:
    """Host-side (numpy) pinhole + Brown-Conrady projection, matching
    ops.camera.project_points — keeps sequence generation off-device."""
    fx, fy, cx, cy, dist = host_camera
    k1, k2, p1, p2, k3 = dist
    xn = points_cam[..., 0] / points_cam[..., 2]
    yn = points_cam[..., 1] / points_cam[..., 2]
    r2 = xn * xn + yn * yn
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = xn * radial + 2 * p1 * xn * yn + p2 * (r2 + 2 * xn * xn)
    yd = yn * radial + 2 * p2 * xn * yn + p1 * (r2 + 2 * yn * yn)
    return np.stack([fx * xd + cx, fy * yd + cy], axis=-1)


def marker_object_points_np(length: float) -> np.ndarray:
    h = length / 2.0
    return np.array(
        [[-h, h, 0.0], [h, h, 0.0], [h, -h, 0.0], [-h, -h, 0.0]], np.float64
    )


def add_corner_stream(seq: Sequence, marker_map: MarkerMap, p: SimParams, camera):
    """Project marker corners through the full 3-D camera model for each
    frame's visible markers, producing the PnP-level stream. Pure numpy."""
    n_frames, m = seq.obs_ids.shape
    corners = np.zeros((n_frames, m, 4, 2), np.float32)
    id_to_row = {int(i): k for k, i in enumerate(marker_map.ids)}
    cam_height = 0.3
    host_cam = camera_to_host(camera)
    # Project in the arena frame where the marker_map lives (robot<->marker
    # relative geometry is frame-invariant).
    poses_world = seq.meta.get("true_pose_frames_world", seq.true_pose_frames)

    for f in range(n_frames):
        x, y, th = poses_world[f]
        c, s = np.cos(th), np.sin(th)
        # camera optical axes in world: z=heading, x=right, y=down
        R_wc = np.array([[s, 0, c], [-c, 0, s], [0, -1, 0]])
        cam_pos = np.array(
            [x + c * p.t_r2c[0] - s * p.t_r2c[1], y + s * p.t_r2c[0] + c * p.t_r2c[1], cam_height]
        )
        for j in range(m):
            if not seq.obs_valid[f, j]:
                continue
            row = id_to_row[int(seq.obs_ids[f, j])]
            R_wm = rpy_matrix_np(*marker_map.rpys[row])
            obj = marker_object_points_np(float(marker_map.lengths[row]))
            world = obj @ R_wm.T + marker_map.positions[row]
            cam = (world - cam_pos) @ R_wc
            corners[f, j] = project_points_np(cam, host_cam)
    return replace(seq, corners_px=corners, meta={**seq.meta, "level": "corners"})
