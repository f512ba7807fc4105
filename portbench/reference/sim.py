"""The benchmark's own sequence generator: a frozen copy of the port's
``sim.synthetic`` (arena, drive, observations, corner stream), written over
whole arrays so that making a cell's data costs milliseconds.

A deployment (``configs/<name>.json``) fixes the arena, the drive and the
sensors; a traffic mix (``traffic/<name>.json``) fixes how many lanes and
distinct sequences a run replays. Every random draw comes from the run's
seed: the drive's starting time along its profile and the measurement
noise per distinct sequence on the host, the encoder noise per lane on the
device (:func:`lane_encoders`).

Conventions are the port's: planar landmarks are (x, y, azimuth of the
marker's face normal), the first encoder tick of a sequence is the
estimator's latch (both wheels 0), the frame is taken at the last tick of
its block, and observations are in the robot frame (x forward, y left).
"""

from __future__ import annotations

import numpy as np
import torch


def rpy_matrix(roll, pitch, yaw) -> np.ndarray:
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


class Arena:
    """Wall markers facing inward: planar states, ids, and each marker's
    world rotation, centre and side length (for corners and rendering)."""

    def __init__(self, n_markers: int, width: float, height: float, marker_length: float,
                 marker_z: float):
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
        planar = np.asarray(planar)
        # vertical markers: x axis along the wall, y up, z (the face) at phi
        self.R_wm = np.stack([rpy_matrix(np.pi / 2, 0.0, phi + np.pi / 2) for phi in planar[:, 2]])
        # the face normal's azimuth, as the estimator's landmark angle
        normal = self.R_wm[:, :, 2]
        self.planar = np.stack([planar[:, 0], planar[:, 1],
                                np.arctan2(normal[:, 1], normal[:, 0])], axis=-1)
        self.ids = np.arange(n_markers, dtype=np.int32)
        self.positions = np.concatenate([planar[:, :2], np.full((n_markers, 1), marker_z)], 1)
        self.lengths = np.full(n_markers, marker_length)

    @classmethod
    def from_config(cls, cfg: dict) -> "Arena":
        a = cfg["arena"]
        return cls(a["markers"], a["width_m"], a["height_m"], a["marker_length_m"],
                   a["marker_z_m"])


def _omega(t: np.ndarray, drive: dict) -> np.ndarray:
    """Commanded turn rate at times ``t``: the wobbly loop or the
    rounded-rectangle tour of the port's generator."""
    v0 = drive["speed_mps"]
    if drive["profile"] == "loop":
        return drive["omega0"] + drive["omega_wobble"] * np.sin(
            2 * np.pi * t / drive["wobble_period_s"])
    r = drive["corner_radius_m"]
    w = drive["tour_width_m"] - 2 * drive["inset_m"] - 2 * r
    h = drive["tour_height_m"] - 2 * drive["inset_m"] - 2 * r
    quarter = np.pi * r / 2
    seg_len = np.array([w, quarter, h, quarter, w, quarter, h, quarter])
    seg_omega = np.array([0.0, v0 / r] * 4)
    cum = np.cumsum(seg_len)
    k = np.searchsorted(cum, (v0 * t) % cum[-1], side="right")
    return seg_omega[np.minimum(k, 7)]


def _start_pose(drive: dict, arena: dict) -> np.ndarray:
    if drive["profile"] == "loop":
        return np.asarray(drive["start_pose"], float)
    r = drive["corner_radius_m"]
    return np.array([drive["inset_m"] + r, -(drive["tour_height_m"] - drive["inset_m"]), 0.0])


def drive_sequence(cfg: dict, offset_s: float):
    """True wheel speeds ``[T, 2]`` (tick 0 the latch) and world poses at
    each frame ``[F, 3]`` of a run that joins the drive profile
    ``offset_s`` seconds after its canonical start: the profile is driven
    from its start pose for ``offset_s`` seconds first, unrecorded."""
    d, s = cfg["drive"], cfg["sensors"]
    epf = int(round(s["encoder_hz"] / s["camera_hz"]))
    frames = int(round(cfg["duration_s"] * s["camera_hz"]))
    dt = 1.0 / s["encoder_hz"]
    lead = int(round(offset_s / dt))
    n = lead + frames * epf
    t = np.arange(n) * dt
    v0, b = d["speed_mps"], cfg["robot"]["half_wheelbase_m"]
    kl, kr = cfg["robot"]["wheel_radius_m"], cfg["robot"]["wheel_radius_m"]
    omega = _omega(t, d)
    wl, wr = (v0 - omega * b) / kl, (v0 + omega * b) / kr
    wl[lead], wr[lead] = 0.0, 0.0  # the recorded run's first tick: the latch
    # the midpoint-arc model the estimator predicts with, integrated in
    # float64 over the whole drive
    dsl, dsr = kl * dt * wl, kr * dt * wr
    dth = (dsr - dsl) / (2 * b)
    ds = 0.5 * (dsr + dsl)
    start = _start_pose(d, cfg["arena"])
    th_before = start[2] + np.concatenate([[0.0], np.cumsum(dth)[:-1]])
    x = start[0] + np.cumsum(ds * np.cos(th_before + 0.5 * dth))
    y = start[1] + np.cumsum(ds * np.sin(th_before + 0.5 * dth))
    th = np.arctan2(np.sin(th_before + dth), np.cos(th_before + dth))
    poses = np.stack([x, y, th], axis=-1)[lead:]
    wheels = np.stack([wl, wr], axis=-1)[lead:]
    frame_idx = (np.arange(frames) + 1) * epf - 1
    return wheels, poses[frame_idx]


def observe(cfg: dict, arena: Arena, poses: np.ndarray, rng: np.random.Generator):
    """The markers each frame sees (nearest first, at most ``max_obs``) and
    their noisy robot-frame measurements with the sampling covariance.
    Returns ids [F, M] int32 (-1 padding), z [F, M, 3], R [F, M, 3, 3]
    float32, valid [F, M] bool."""
    s = cfg["sensors"]
    m = s["max_obs"]
    lm = arena.planar
    x, y, th = poses[:, 0:1], poses[:, 1:2], poses[:, 2:3]
    c, sn = np.cos(th), np.sin(th)
    dx, dy = lm[None, :, 0] - x, lm[None, :, 1] - y  # [F, L]
    rel_x, rel_y = dx * c + dy * sn, -dx * sn + dy * c
    dist = np.hypot(rel_x, rel_y)
    bearing = np.arctan2(rel_y, rel_x)
    ray = -np.stack([dx, dy], -1) / np.maximum(dist, 1e-9)[..., None]
    normal = np.stack([np.cos(lm[:, 2]), np.sin(lm[:, 2])], -1)
    view_cos = np.sum(ray * normal[None], -1)
    visible = ((dist <= s["visible_range_m"]) & (dist > 0.15)
               & (np.abs(bearing) <= np.deg2rad(s["fov_deg"]) / 2)
               & (view_cos >= np.cos(np.deg2rad(s["max_view_angle_deg"]))))
    order = np.argsort(np.where(visible, dist, np.inf), axis=1, kind="stable")[:, :m]
    F = poses.shape[0]
    valid = np.take_along_axis(visible, order, 1)
    d = np.take_along_axis(dist, order, 1)
    sx = s["sigma_xy_m"] * (1 + s["noise_dist_scale"] * d)
    sth = s["sigma_theta_rad"] * (1 + s["noise_dist_scale"] * d)
    rel_th = lm[order, 2] - th
    rel_th = np.arctan2(np.sin(rel_th), np.cos(rel_th))
    noise = rng.standard_normal((F, order.shape[1], 3))
    z = np.stack([np.take_along_axis(rel_x, order, 1) + sx * noise[..., 0],
                  np.take_along_axis(rel_y, order, 1) + sx * noise[..., 1],
                  rel_th + sth * noise[..., 2]], -1)
    z[..., 2] = np.arctan2(np.sin(z[..., 2]), np.cos(z[..., 2]))
    R = np.zeros((F, order.shape[1], 3, 3))
    R[..., 0, 0], R[..., 1, 1], R[..., 2, 2] = sx**2, sx**2, sth**2
    eye = np.broadcast_to(np.eye(3), R.shape)
    ids = np.where(valid, arena.ids[order], -1).astype(np.int32)
    z = np.where(valid[..., None], z, 0.0).astype(np.float32)
    R = np.where(valid[..., None, None], R, eye).astype(np.float32)
    pad = m - order.shape[1]  # fewer markers than slots: the rest are padding
    if pad:
        ids = np.pad(ids, ((0, 0), (0, pad)), constant_values=-1)
        z = np.pad(z, ((0, 0), (0, pad), (0, 0)))
        R = np.concatenate([R, np.broadcast_to(np.eye(3, dtype=np.float32), (F, pad, 3, 3))], 1)
        valid = np.pad(valid, ((0, 0), (0, pad)))
    return ids, z, R, valid


def camera_frames(poses: np.ndarray, cam_height: float):
    """Camera centres [F, 3] and axes in world [F, 3, 3] (columns: x right,
    y down, z along the heading) of robot poses, the camera on the robot's
    centre."""
    c, s = np.cos(poses[:, 2]), np.sin(poses[:, 2])
    zero, one = np.zeros_like(c), np.ones_like(c)
    R_wc = np.stack([np.stack([s, zero, c], -1), np.stack([-c, zero, s], -1),
                     np.stack([zero, -one, zero], -1)], -2)
    pos = np.stack([poses[:, 0], poses[:, 1], np.full_like(c, cam_height)], -1)
    return pos, R_wc


def corners(cfg: dict, arena: Arena, poses: np.ndarray, ids: np.ndarray, valid: np.ndarray):
    """Pixel corners [F, M, 4, 2] float32 of the observed markers: each
    marker's square (TL, TR, BR, BL at (-+L/2, +-L/2, 0)) projected through
    the pinhole camera, exactly (no pixel noise); zero in padded slots."""
    cam = cfg["camera"]
    pos, R_wc = camera_frames(poses, cfg["sensors"]["camera_height_m"])
    row = np.where(valid, ids, 0)
    h = arena.lengths[row][..., None] / 2  # [F, M, 1]
    obj = np.stack([np.concatenate([-h, h], -1), np.concatenate([h, h], -1),
                    np.concatenate([h, -h], -1), np.concatenate([-h, -h], -1)], -2)
    obj = np.concatenate([obj, np.zeros_like(obj[..., :1])], -1)  # [F, M, 4, 3]
    world = np.einsum("fmij,fmkj->fmki", arena.R_wm[row], obj) + arena.positions[row][:, :, None]
    rel = world - pos[:, None, None]
    pc = np.einsum("fmki,fij->fmkj", rel, R_wc)  # camera coordinates
    u = cam["fx"] * pc[..., 0] / pc[..., 2] + cam["cx"]
    v = cam["fy"] * pc[..., 1] / pc[..., 2] + cam["cy"]
    out = np.stack([u, v], -1)
    return np.where(valid[..., None, None], out, 0.0).astype(np.float32)


def base_sequences(cfg: dict, level: str, distinct: int, seed: int,
                   join_s: float | None = None) -> dict:
    """``distinct`` sequences of the deployment, stacked: each joins its
    drive at a start time drawn from ``(seed, index)`` within the profile's
    first lap, or at ``join_s`` where given (then every seed sees the same
    markers in the same frames, and the seed draws only the noise), and
    draws its own measurement noise. Host numpy arrays:
    wheels [D, T, 2], poses [D, F, 3] (world), ids, z, R, valid [D, F, M...]
    and, at the corner and image levels, corners [D, F, M, 4, 2]."""
    arena = Arena.from_config(cfg)
    out = {k: [] for k in ("wheels", "poses", "ids", "z", "R", "valid", "corners")}
    for d in range(distinct):
        rng = np.random.default_rng([seed, d])
        offset = float(rng.uniform(0.0, cfg["drive"]["lap_s"]))
        if join_s is not None:
            offset = float(join_s)
        wheels, poses = drive_sequence(cfg, offset)
        ids, z, R, valid = observe(cfg, arena, poses, rng)
        for k, v in (("wheels", wheels), ("poses", poses), ("ids", ids), ("z", z), ("R", R),
                     ("valid", valid)):
            out[k].append(v)
        if level in ("corners", "images"):
            out["corners"].append(corners(cfg, arena, poses, ids, valid))
    return {k: np.stack(v) for k, v in out.items() if v}


def lane_encoders(wheels: torch.Tensor, lanes: int, noise: float, epf: int, dt: float,
                  gen: torch.Generator) -> tuple:
    """Per-lane encoder readings on the wheels' device: lane b replays
    sequence ``b % D`` with its own Gaussian noise on every tick but the
    latch. Returns (enc_w [B, F, epf, 2] float32, enc_dt [B, F, epf])."""
    D, T, _ = wheels.shape
    base = wheels.index_select(0, torch.arange(lanes, device=wheels.device) % D)
    draw = torch.randn(lanes, T, 2, generator=gen, device=wheels.device, dtype=torch.float64)
    draw[:, 0] = 0.0
    enc_w = (base + noise * draw).to(torch.float32).reshape(lanes, T // epf, epf, 2)
    return enc_w, torch.full(enc_w.shape[:3], dt, device=wheels.device)
