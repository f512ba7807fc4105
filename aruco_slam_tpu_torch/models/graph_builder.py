"""Factor-graph construction (L5): sequences -> BAProblem — the numpy-only
copy of ``aruco_slam_tpu.models.graph_builder`` (same arrays, held equal by
``tests/test_torch_pipeline.py``).

Keyframes from camera frames, odometry factors integrated from the encoder
stream between frames (the EKF predict's midpoint-arc model, reference
src/aruco_slam.cpp:35-42), marker factors from the observation stream with
landmark slots assigned by first appearance (global ArUco ids = trivial
data association, reference :423-435). Initial values come from dead
reckoning + first-observation composition, as the EKF initializes new
landmarks (reference :210-225). The problem it returns holds numpy arrays,
as the JAX builder's does: ``convert.ba_problem_from_numpy`` puts it on a
device."""

from __future__ import annotations

import numpy as np

from aruco_slam_tpu_torch.models.ba import BAProblem


def _integrate_odo(enc_w, enc_dt, kl, kr, b, q_k=None, kl_both=True):
    """Integrate one inter-frame encoder block into a relative SE(2) motion.

    With ``q_k`` given, also propagates the 3x3 motion covariance through
    the same process-noise model the EKF predict uses (reference
    src/aruco_slam.cpp:55-73) — giving each odometry factor a *calibrated*
    information matrix instead of a hand-tuned constant."""
    x = y = th = 0.0
    P = np.zeros((3, 3))
    for (wl, wr), dt in zip(enc_w, enc_dt):
        dsl, dsr = kl * dt * wl, kr * dt * wr
        dth = (dsr - dsl) / (2 * b)
        ds = 0.5 * (dsr + dsl)
        tmp = th + 0.5 * dth
        c, s = np.cos(tmp), np.sin(tmp)
        if q_k is not None:
            H = np.array([[1, 0, -ds * s], [0, 1, ds * c], [0, 0, 1.0]])
            if kl_both:  # quirk (b): reference uses kl for both wheels
                wkh = (0.5 * kl * dt) * np.array([[c, c], [s, s], [1 / b, -1 / b]])
            else:
                wkh = (0.5 * dt) * np.array(
                    [[kl * c, kr * c], [kl * s, kr * s], [kl / b, -kr / b]]
                )
            sigma_u = np.diag([q_k * abs(wl), q_k * abs(wr)])
            P = H @ P @ H.T + wkh @ sigma_u @ wkh.T
        x += ds * c
        y += ds * s
        th = np.arctan2(np.sin(th + dth), np.cos(th + dth))
    if q_k is None:
        return np.array([x, y, th])
    return np.array([x, y, th]), P


def build_from_sequence(
    seq,
    config,
    keyframe_stride: int = 1,
    odo_info: float | str = 1e4,
    prior_info: float = 1e8,
    dtype=np.float32,
    init_poses=None,
    init_landmarks=None,
) -> tuple[BAProblem, np.ndarray]:
    """Returns (problem, landmark_ids) — landmark_ids maps landmark slot ->
    ArUco id for evaluation against ground truth.

    ``odo_info`` is the odometry factor information: a float for a fixed
    isotropic weight (default 1e4, empirically strong on the benchmark
    tours), or "auto" to propagate the EKF process-noise model through each
    inter-keyframe encoder block and use its inverse (principled, but only
    better when the config's Q_k actually matches the data's noise law).

    ``init_poses`` ([F, 3], indexed by frame) and ``init_landmarks``
    (dict aruco_id -> [3]) override the dead-reckoned initialization —
    pass the EKF trajectory/map for the filter->smoother pipeline (a long
    drifty chain initialized from raw odometry can trap Gauss-Newton in a
    bent local minimum)."""
    odom = config.odom
    epf = seq.enc_per_frame
    enc_w = seq.enc_w.reshape(-1, epf, 2)
    enc_dt = seq.enc_dt.reshape(-1, epf)
    f_idx = np.arange(0, seq.num_frames, keyframe_stride)
    K = len(f_idx)

    # odometry between consecutive keyframes + dead-reckoned initial poses.
    # Skip the first tick overall: it is the reference's is_init_ latch.
    auto_w = odo_info == "auto"
    q_k = config.covariance.Q_k if auto_w else None
    odo = np.zeros((K - 1, 3))
    odo_ws = np.zeros((K - 1, 3, 3))
    poses = np.zeros((K, 3))
    # Initial pose of keyframe 0: integrate from sequence start
    pose0_blocks = enc_w[: f_idx[0] + 1], enc_dt[: f_idx[0] + 1]
    d0 = _integrate_odo(
        np.concatenate(pose0_blocks[0])[1:],
        np.concatenate(pose0_blocks[1])[1:],
        odom.kl, odom.kr, odom.b,
    )
    poses[0] = d0
    eye3 = np.eye(3)
    for n in range(K - 1):
        lo, hi = f_idx[n] + 1, f_idx[n + 1] + 1
        w = np.concatenate(enc_w[lo:hi])
        dt = np.concatenate(enc_dt[lo:hi])
        if auto_w:
            odo[n], P = _integrate_odo(
                w, dt, odom.kl, odom.kr, odom.b, q_k=q_k,
                kl_both=config.compat.process_noise_uses_kl_for_both_wheels,
            )
            odo_ws[n] = np.linalg.inv(P + 1e-8 * eye3)
        else:
            odo[n] = _integrate_odo(w, dt, odom.kl, odom.kr, odom.b)
            odo_ws[n] = odo_info * eye3
        c, s = np.cos(poses[n, 2]), np.sin(poses[n, 2])
        poses[n + 1] = [
            poses[n, 0] + c * odo[n, 0] - s * odo[n, 1],
            poses[n, 1] + s * odo[n, 0] + c * odo[n, 1],
            np.arctan2(np.sin(poses[n, 2] + odo[n, 2]), np.cos(poses[n, 2] + odo[n, 2])),
        ]

    if init_poses is not None:
        poses = np.asarray(init_poses, float)[f_idx]

    # marker observations on keyframes
    lm_slot: dict[int, int] = {}
    obs_kf, obs_lm, obs_z, obs_w = [], [], [], []
    lm_init = []
    for n, f in enumerate(f_idx):
        for j in range(seq.max_obs):
            if not seq.obs_valid[f, j]:
                continue
            aid = int(seq.obs_ids[f, j])
            z = seq.obs_z[f, j]
            if aid not in lm_slot:
                lm_slot[aid] = len(lm_slot)
                if init_landmarks is not None and aid in init_landmarks:
                    lm_init.append(list(np.asarray(init_landmarks[aid], float)))
                else:
                    c, s = np.cos(poses[n, 2]), np.sin(poses[n, 2])
                    lm_init.append(
                        [
                            poses[n, 0] + c * z[0] - s * z[1],
                            poses[n, 1] + s * z[0] + c * z[1],
                            np.arctan2(np.sin(poses[n, 2] + z[2]), np.cos(poses[n, 2] + z[2])),
                        ]
                    )
            obs_kf.append(n)
            obs_lm.append(lm_slot[aid])
            obs_z.append(z)
            obs_w.append(np.linalg.inv(seq.obs_R[f, j].astype(np.float64)))

    L = len(lm_slot)
    N = len(obs_kf)
    lm_ids = np.empty(L, np.int32)
    for aid, slot in lm_slot.items():
        lm_ids[slot] = aid

    eye = np.eye(3)
    problem = BAProblem(
        poses=poses.astype(dtype),
        landmarks=np.asarray(lm_init, dtype).reshape(L, 3),
        obs_kf=np.asarray(obs_kf, np.int32),
        obs_lm=np.asarray(obs_lm, np.int32),
        obs_z=np.asarray(obs_z, dtype).reshape(N, 3),
        obs_w=np.asarray(obs_w, dtype).reshape(N, 3, 3),
        obs_valid=np.ones(N, bool),
        odo_i=np.arange(K - 1, dtype=np.int32),
        odo_j=np.arange(1, K, dtype=np.int32),
        odo_z=odo.astype(dtype),
        odo_w=odo_ws.astype(dtype),
        odo_valid=np.ones(K - 1, bool),
        prior_w=(prior_info * eye).astype(dtype),
    )
    return problem, lm_ids


def synthetic_ba_problem(
    n_keyframes: int,
    n_landmarks: int,
    obs_per_kf: int = 8,
    obs_sigma: float = 0.02,
    odo_sigma: float = 0.01,
    init_noise: float = 0.1,
    seed: int = 0,
    dtype=np.float32,
) -> tuple[BAProblem, np.ndarray, np.ndarray]:
    """Random trajectory + landmark field with noisy factors; returns
    (problem, true_poses, true_landmarks). Scales to the 1k/500 and 10k/5k
    BASELINE.md configs."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 8 * np.pi, n_keyframes)
    radius = 6.0 + 1.5 * np.sin(t * 0.37)
    true_poses = np.stack(
        [radius * np.cos(t), radius * np.sin(t), np.arctan2(np.cos(t), -np.sin(t))],
        axis=1,
    )
    ang = rng.uniform(0, 2 * np.pi, n_landmarks)
    rad = rng.uniform(7.5, 10.0, n_landmarks)
    true_lms = np.stack(
        [rad * np.cos(ang), rad * np.sin(ang), rng.uniform(-np.pi, np.pi, n_landmarks)],
        axis=1,
    )

    # observations: each keyframe observes obs_per_kf nearest landmarks
    d2 = (
        (true_poses[:, None, 0] - true_lms[None, :, 0]) ** 2
        + (true_poses[:, None, 1] - true_lms[None, :, 1]) ** 2
    )
    nearest = np.argsort(d2, axis=1)[:, :obs_per_kf]  # [K, O]
    obs_kf = np.repeat(np.arange(n_keyframes), obs_per_kf)
    obs_lm = nearest.reshape(-1)
    pk = true_poses[obs_kf]
    lk = true_lms[obs_lm]
    c, s = np.cos(pk[:, 2]), np.sin(pk[:, 2])
    dx, dy = lk[:, 0] - pk[:, 0], lk[:, 1] - pk[:, 1]
    z = np.stack(
        [
            dx * c + dy * s,
            -dx * s + dy * c,
            np.arctan2(np.sin(lk[:, 2] - pk[:, 2]), np.cos(lk[:, 2] - pk[:, 2])),
        ],
        axis=1,
    )
    z += rng.normal(scale=obs_sigma, size=z.shape)

    # odometry along the chain
    p0, p1 = true_poses[:-1], true_poses[1:]
    c0, s0 = np.cos(p0[:, 2]), np.sin(p0[:, 2])
    ddx, ddy = p1[:, 0] - p0[:, 0], p1[:, 1] - p0[:, 1]
    odo = np.stack(
        [
            ddx * c0 + ddy * s0,
            -ddx * s0 + ddy * c0,
            np.arctan2(np.sin(p1[:, 2] - p0[:, 2]), np.cos(p1[:, 2] - p0[:, 2])),
        ],
        axis=1,
    )
    odo += rng.normal(scale=odo_sigma, size=odo.shape)

    eye = np.eye(3)
    problem = BAProblem(
        poses=(true_poses + rng.normal(scale=init_noise, size=true_poses.shape)).astype(dtype),
        landmarks=(true_lms + rng.normal(scale=init_noise, size=true_lms.shape)).astype(dtype),
        obs_kf=obs_kf.astype(np.int32),
        obs_lm=obs_lm.astype(np.int32),
        obs_z=z.astype(dtype),
        obs_w=np.tile((eye / obs_sigma**2).astype(dtype), (len(z), 1, 1)),
        obs_valid=np.ones(len(z), bool),
        odo_i=np.arange(n_keyframes - 1, dtype=np.int32),
        odo_j=np.arange(1, n_keyframes, dtype=np.int32),
        odo_z=odo.astype(dtype),
        odo_w=np.tile((eye / odo_sigma**2).astype(dtype), (len(odo), 1, 1)),
        odo_valid=np.ones(len(odo), bool),
        prior_w=(1e8 * eye).astype(dtype),
    )
    # anchor initial pose 0 at truth so gauge comparison is direct
    problem = problem._replace(
        poses=problem.poses.copy()
    )
    problem.poses[0] = true_poses[0]
    return problem, true_poses, true_lms
