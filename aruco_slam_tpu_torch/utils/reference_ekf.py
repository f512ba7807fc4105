"""Test oracle: literal float64 NumPy transcription of the reference EKF
semantics (growing dense matrices, sequential updates), used to verify that
the fixed-capacity masked scan implementation is numerically equivalent.

Behavior transcribed from reference src/aruco_slam.cpp:
- predict: :21-74 (midpoint-arc mean, Hx/F/Qk covariance, kl-for-both-wheels
  quirk at :62)
- update loop: :92-262 (priority-queue order, stale linearization mean at
  :88, stationary gate at :192-198 whose "update" branch is an empty-block
  no-op, landmark augmentation at :208-260)

This is deliberately the *naive* dense formulation — the production code
must match it, not the other way around.
"""

import numpy as np


def wrap(a):
    if a >= np.pi:
        a -= 2 * np.pi
    if a < -np.pi:
        a += 2 * np.pi
    return a


class ReferenceEKF:
    def __init__(self, Q_k=0.01, R_x=100.0, R_y=100.0, R_theta=10.0,
                 kl=0.05, kr=0.05, b=0.09, stationary_gate=True):
        self.Q_k, self.R_x, self.R_y, self.R_theta = Q_k, R_x, R_y, R_theta
        self.kl, self.kr, self.b = kl, kr, b
        self.stationary_gate = stationary_gate
        self.mu = np.zeros(3)
        self.sigma = np.zeros((3, 3))
        self.id_map = {}  # aruco_id -> landmark index
        self.last_observed = {}  # aruco_id -> last_observation (vec3)
        self.initialized = False

    def add_encoder(self, wl, wr, dt):
        if not self.initialized:
            self.initialized = True
            return
        delta_sl = self.kl * dt * wl
        delta_sr = self.kr * dt * wr
        delta_theta = (delta_sr - delta_sl) / (2 * self.b)
        delta_s = 0.5 * (delta_sr + delta_sl)
        tmp_th = self.mu[2] + 0.5 * delta_theta
        c, s = np.cos(tmp_th), np.sin(tmp_th)
        self.mu[0] += delta_s * c
        self.mu[1] += delta_s * s
        self.mu[2] = wrap(self.mu[2] + delta_theta)

        H_xi = np.array([[1, 0, -delta_s * s], [0, 1, delta_s * c], [0, 0, 1.0]])
        wkh = (0.5 * self.kl * dt) * np.array(
            [[c, c], [s, s], [1 / self.b, -1 / self.b]]
        )
        N = len(self.mu)
        F = np.zeros((N, 3))
        F[:3, :3] = np.eye(3)
        Hx = np.eye(N)
        Hx[:3, :3] = H_xi
        sigma_u = np.diag([self.Q_k * abs(wl), self.Q_k * abs(wr)])
        Qk = wkh @ sigma_u @ wkh.T
        self.sigma = Hx @ self.sigma @ Hx.T + F @ Qk @ F.T

    def add_frame(self, observations):
        """observations: list of (aruco_id, z vec3, R 3x3) in arrival order."""
        if not self.initialized:
            return
        # Priority queue: ascending landmark index, new (-1) first; ties by
        # arrival order (deterministic stand-in for heap order).
        obs = []
        for arrival, (aid, z, R) in enumerate(observations):
            idx = self.id_map.get(aid, -1)
            obs.append((idx, arrival, aid, np.asarray(z, float), np.asarray(R, float)))
        obs.sort(key=lambda o: (o[0], o[1]))

        mu_stale = self.mu.copy()
        new_observed = {}
        for idx, _, aid, z, Rk in obs:
            if idx >= 0:
                N = len(self.mu)
                F = np.zeros((6, N))
                F[:3, :3] = np.eye(3)
                F[3:, 3 + 3 * idx: 6 + 3 * idx] = np.eye(3)
                mx, my, mth = mu_stale[3 + 3 * idx: 6 + 3 * idx]
                x, y, th = mu_stale[:3]
                st, ct = np.sin(th), np.cos(th)
                gdx, gdy = mx - x, my - y
                gdth = wrap(mth - th)
                z_hat = np.array([gdx * ct + gdy * st, -gdx * st + gdy * ct, gdth])
                ze = z - z_hat
                ze[2] = wrap(ze[2])
                Gxm = np.array(
                    [
                        [-ct, -st, -gdx * st + gdy * ct, ct, st, 0],
                        [st, -ct, -gdx * ct - gdy * st, -st, ct, 0],
                        [0, 0, -1, 0, 0, 1],
                    ]
                )
                Gx = Gxm @ F
                S = Gx @ self.sigma @ Gx.T + Rk
                K = self.sigma @ Gx.T @ np.linalg.inv(S)
                gated = False
                if self.stationary_gate and aid in self.last_observed:
                    gated = np.linalg.norm(self.last_observed[aid] - z) < 0.01
                if gated:
                    # mu_.topLeftCorner(3,0) += ... : empty block, no-op.
                    # last_observation_ left unset -> zeros convention.
                    new_observed[aid] = np.zeros(3)
                else:
                    new_observed[aid] = z.copy()
                    self.mu = self.mu + K @ ze
                    self.sigma = (np.eye(N) - K @ Gx) @ self.sigma
            else:
                st, ct = np.sin(mu_stale[2]), np.cos(mu_stale[2])
                # Reference downcasts to float here (float sinth, :210-211)
                st, ct = np.float32(st), np.float32(ct)
                N = len(self.mu)
                map_x = mu_stale[0] + ct * z[0] - st * z[1]
                map_y = mu_stale[1] + st * z[0] + ct * z[1]
                map_th = wrap(mu_stale[2] + z[2])
                self.mu = np.concatenate([self.mu, [map_x, map_y, map_th]])
                dx, dy = map_x - mu_stale[0], map_y - mu_stale[1]
                sigma_s = self.sigma[:3, :3]
                Gsk = np.array(
                    [
                        [-ct, -st, -st * dx + ct * dy],
                        [st, -ct, -dx * ct - dy * st],
                        [0, 0, -1],
                    ]
                )
                Gmi = np.array([[ct, st, 0], [-st, ct, 0], [0, 0, 1.0]])
                sigma_mm = Gmi @ (Gsk @ sigma_s @ Gsk.T + Rk).T @ Gmi.T
                sigma_mx = -Gmi @ Gsk @ self.sigma[:3, :]
                tmp = np.zeros((N + 3, N + 3))
                tmp[:N, :N] = self.sigma
                tmp[:N, N:] = sigma_mx.T
                tmp[N:, :N] = sigma_mx
                tmp[N:, N:] = sigma_mm
                self.sigma = tmp
                # std::map::insert keeps the FIRST entry for a duplicate id
                # (src/aruco_slam.cpp:256) — setdefault matches that.
                self.id_map.setdefault(aid, (len(self.mu) - 3) // 3 - 1)
                new_observed[aid] = np.zeros(3)  # uninitialized convention
        self.last_observed = new_observed
