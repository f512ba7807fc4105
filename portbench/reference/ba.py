"""The bundle-adjustment plain reference: the back end of the port's
``pipeline.ekf_then_ba`` as it is published (the factor graph of
``models/graph_builder.build_from_sequence``'s docstring, the solver of
``models/ba.py``'s docstring and the JAX package's equations), written anew
in the dtype of its inputs with plain tensor operations.

The graph, from one recorded sequence and the filter's answer on it:

- keyframes every ``stride`` frames from frame 0, each starting at the
  filter's pose after its frame;
- an odometry factor between consecutive keyframes: the encoder ticks of
  the frames after the first keyframe's up to the second's, integrated
  by the midpoint arc from a zero pose (so the run's first tick, the
  estimator's latch, lies in no factor), information 1e4 I;
- a prior of information 1e8 I holding keyframe 0 at its start;
- a marker factor, information R^-1, for every valid observation on a
  keyframe, in frame then slot order; landmarks numbered by first
  appearance in that order, each starting at the filter's map entry of
  its id (or, where the filter holds none, at its first observation
  composed onto its keyframe's pose).

The solve: ``iters`` Levenberg-Marquardt steps from damping ``damping``,
each linearized at the current state with the damping added to every
diagonal block; landmarks eliminated by the Schur complement; the reduced
camera system solved by ``cg_iters`` iterations of block-Jacobi
preconditioned CG, with the global rotation about keyframe 0 deflated
(its component solved directly, the Krylov space kept S-orthogonal to it);
the landmarks back-substituted. A step is kept where the cost does not
rise, and the damping then halves down to its floor; else it rises ten
times, up to 1e4. The cost history holds the start and the kept cost
after each step.

Departures from the port's solver, each with no effect on the answer
beyond rounding: every keyed sum is ``index_add_`` over the factors in
their index order (no keyframe-major packing, no shifted adds along the
odometry chain); blocks are inverted by ``torch.linalg.inv``, not by the
adjugate; angles are wrapped by ``ekf.wrap``; the graph is built with whole
array operations. Run on the CPU, where ``index_add_`` adds in index order,
the answer is the same on every run.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from portbench.reference.ekf import wrap

ODO_INFO = 1e4
PRIOR_INFO = 1e8
DAMPING_CAP = 1e4
TINY = 1e-30  # the floor of a CG denominator's magnitude


class Graph(NamedTuple):
    """K keyframes, L landmarks, N marker factors, M odometry factors."""

    poses: torch.Tensor  # [K, 3] start
    landmarks: torch.Tensor  # [L, 3] start
    ids: np.ndarray  # [L] the marker id of each landmark
    obs_kf: torch.Tensor  # [N]
    obs_lm: torch.Tensor  # [N]
    obs_z: torch.Tensor  # [N, 3]
    obs_w: torch.Tensor  # [N, 3, 3]
    odo_i: torch.Tensor  # [M]
    odo_j: torch.Tensor  # [M]
    odo_z: torch.Tensor  # [M, 3]
    odo_w: torch.Tensor  # [M, 3, 3]
    prior_w: torch.Tensor  # [3, 3]


def _odometry(enc_w: np.ndarray, enc_dt: np.ndarray, f_idx: np.ndarray, est: dict) -> np.ndarray:
    """Each consecutive keyframe pair's relative motion [K - 1, 3] from the
    ticks of the frames between them (float64)."""
    K, T = len(f_idx), enc_w.shape[1]
    stride = int(f_idx[1] - f_idx[0]) if K > 1 else 1
    span = slice(1, (K - 1) * stride + 1)
    w = enc_w[span].reshape(K - 1, stride * T, 2)
    dt = enc_dt[span].reshape(K - 1, stride * T)
    r, b = est["wheel_radius_m"], est["half_wheelbase_m"]
    dsl, dsr = r * dt * w[..., 0], r * dt * w[..., 1]
    dth = (dsr - dsl) / (2.0 * b)
    ds = 0.5 * (dsr + dsl)
    mid = np.cumsum(dth, 1) - 0.5 * dth
    th = dth.sum(1)
    return np.stack([np.sum(ds * np.cos(mid), 1), np.sum(ds * np.sin(mid), 1),
                     np.arctan2(np.sin(th), np.cos(th))], -1)


def build(enc_w, enc_dt, ids, z, R, valid, est: dict, stride: int, traj, slot_ids, mu,
          dtype=torch.float64, device="cpu") -> Graph:
    """The graph of one sequence (host arrays: ``enc_w [F, T, 2]``,
    ``enc_dt [F, T]``, ``ids``, ``z``, ``R``, ``valid`` ``[F, M, ...]``) from
    the filter's trajectory ``traj [F, 3]`` and final map (``slot_ids [S]``,
    ``mu [3 + 3 S]``), in ``dtype`` on ``device``."""
    f64 = np.float64
    F = ids.shape[0]
    f_idx = np.arange(0, F, stride)
    K = len(f_idx)
    poses = np.asarray(traj, f64)[f_idx]
    odo = _odometry(np.asarray(enc_w, f64), np.asarray(enc_dt, f64), f_idx, est)
    n, j = np.nonzero(np.asarray(valid)[f_idx])  # keyframe, then slot order
    aid = np.asarray(ids)[f_idx][n, j].astype(np.int64)
    uniq, first = np.unique(aid, return_index=True)
    by_first = np.argsort(first, kind="stable")
    rank = np.empty(len(uniq), np.int64)
    rank[by_first] = np.arange(len(uniq))
    obs_lm = rank[np.searchsorted(uniq, aid)]
    lm_ids = uniq[by_first]
    obs_z = np.asarray(z, f64)[f_idx][n, j]
    obs_w = np.linalg.inv(np.asarray(R, f64)[f_idx][n, j])
    held = {int(i): np.asarray(mu, f64)[3 + 3 * s:6 + 3 * s]
            for s, i in enumerate(np.asarray(slot_ids)) if i >= 0}
    landmarks = np.zeros((len(lm_ids), 3))
    for lm, i in enumerate(lm_ids):
        if int(i) in held:
            landmarks[lm] = held[int(i)]
        else:  # composed from its first observation
            k = first[by_first[lm]]
            p, zz = poses[n[k]], obs_z[k]
            c, s = np.cos(p[2]), np.sin(p[2])
            landmarks[lm] = (p[0] + c * zz[0] - s * zz[1], p[1] + s * zz[0] + c * zz[1],
                             np.arctan2(np.sin(p[2] + zz[2]), np.cos(p[2] + zz[2])))

    def t(x, dt=dtype):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dt, device=device)

    eye = np.eye(3)
    return Graph(poses=t(poses), landmarks=t(landmarks), ids=lm_ids.astype(np.int32),
                 obs_kf=t(n, torch.long), obs_lm=t(obs_lm, torch.long), obs_z=t(obs_z),
                 obs_w=t(obs_w), odo_i=t(np.arange(K - 1), torch.long),
                 odo_j=t(np.arange(1, K), torch.long), odo_z=t(odo),
                 odo_w=t(np.broadcast_to(ODO_INFO * eye, (K - 1, 3, 3))),
                 prior_w=t(PRIOR_INFO * eye))


def _mv(A, v):
    """Batched ``A @ v`` for ``A [..., 3, 3]``, ``v [..., 3]``."""
    return (A @ v[..., None])[..., 0]


def _relative(pose, target):
    """``target`` in ``pose``'s frame, and its Jacobians in both."""
    th = pose[:, 2]
    c, s = torch.cos(th), torch.sin(th)
    dx, dy = target[:, 0] - pose[:, 0], target[:, 1] - pose[:, 1]
    h = torch.stack([dx * c + dy * s, -dx * s + dy * c, wrap(target[:, 2] - th)], -1)
    o, i = torch.zeros_like(c), torch.ones_like(c)
    Jp = torch.stack([torch.stack([-c, -s, -dx * s + dy * c], -1),
                      torch.stack([s, -c, -dx * c - dy * s], -1),
                      torch.stack([o, o, -i], -1)], -2)
    Jt = torch.stack([torch.stack([c, s, o], -1), torch.stack([-s, c, o], -1),
                      torch.stack([o, o, i], -1)], -2)
    return h, Jp, Jt


def _residual(z, h):
    r = z - h
    return torch.cat([r[:, :2], wrap(r[:, 2:])], 1)


def _keyed(vals, idx, n):
    """Sums of ``vals`` rows by key ``idx`` into ``n`` rows, in index order."""
    return vals.new_zeros(n, *vals.shape[1:]).index_add_(0, idx, vals)


def cost(g: Graph, poses, landmarks):
    """0.5 x the weighted squared residuals of every factor and the prior."""
    h, _, _ = _relative(poses[g.obs_kf], landmarks[g.obs_lm])
    r = _residual(g.obs_z, h)
    ho, _, _ = _relative(poses[g.odo_i], poses[g.odo_j])
    ro = _residual(g.odo_z, ho)
    r0 = _residual(poses[:1], g.poses[:1])
    quad = torch.sum(r * _mv(g.obs_w, r)) + torch.sum(ro * _mv(g.odo_w, ro)) \
        + torch.sum(r0 * _mv(g.prior_w[None], r0))
    return 0.5 * quad


def gauge_mode(poses):
    """The rotation of every keyframe about keyframe 0, normalized."""
    d = poses[:, :2] - poses[0, :2]
    v = torch.stack([-d[:, 1], d[:, 0], torch.ones_like(d[:, 0])], -1)
    return v / torch.sqrt(torch.sum(v * v))


def _safe(d):
    return torch.where(d.abs() < TINY, torch.full_like(d, TINY), d)


def step(g: Graph, poses, landmarks, lam, cg_iters: int, deflate: bool):
    """One damped Gauss-Newton step: the new poses and landmarks."""
    K, L = poses.shape[0], landmarks.shape[0]
    eye = torch.eye(3, dtype=poses.dtype, device=poses.device)
    h, Jp, Jl = _relative(poses[g.obs_kf], landmarks[g.obs_lm])
    r = _residual(g.obs_z, h)
    JpW, JlW = Jp.transpose(1, 2) @ g.obs_w, Jl.transpose(1, 2) @ g.obs_w
    Apl = JpW @ Jl  # [N, 3, 3]: the pose-landmark block of each factor
    ho, Ji, Jj = _relative(poses[g.odo_i], poses[g.odo_j])
    ro = _residual(g.odo_z, ho)
    JiW, JjW = Ji.transpose(1, 2) @ g.odo_w, Jj.transpose(1, 2) @ g.odo_w
    Hij = JiW @ Jj
    Hpp = _keyed(JpW @ Jp, g.obs_kf, K) + _keyed(JiW @ Ji, g.odo_i, K) \
        + _keyed(JjW @ Jj, g.odo_j, K)
    Hpp[0] = Hpp[0] + g.prior_w
    Hpp = Hpp + lam * eye
    Hll_inv = torch.linalg.inv(_keyed(JlW @ Jl, g.obs_lm, L) + lam * eye)
    bp = _keyed(_mv(JpW, r), g.obs_kf, K) + _keyed(_mv(JiW, ro), g.odo_i, K) \
        + _keyed(_mv(JjW, ro), g.odo_j, K)
    bp[0] = bp[0] + _mv(g.prior_w, _residual(g.poses[:1], poses[:1])[0])
    bl = _keyed(_mv(JlW, r), g.obs_lm, L)
    Apl_t = Apl.transpose(1, 2)

    def S(v):  # the reduced camera system's product, never formed
        out = _mv(Hpp, v) + _keyed(_mv(Hij, v[g.odo_j]), g.odo_i, K) \
            + _keyed(_mv(Hij.transpose(1, 2), v[g.odo_i]), g.odo_j, K)
        u = _mv(Hll_inv, _keyed(_mv(Apl_t, v[g.obs_kf]), g.obs_lm, L))
        return out - _keyed(_mv(Apl, u[g.obs_lm]), g.obs_kf, K)

    rhs = bp - _keyed(_mv(Apl, _mv(Hll_inv, bl)[g.obs_lm]), g.obs_kf, K)
    Minv = torch.linalg.inv(Hpp)
    if deflate:
        v = gauge_mode(poses)
        Sv = S(v)
        vSv = _safe(torch.sum(v * Sv))
        a0 = torch.sum(v * rhs) / vSv
        x, res = v * a0, rhs - Sv * a0

        def project(y):
            return y - v * (torch.sum(Sv * y) / vSv)
    else:
        x, res = torch.zeros_like(rhs), rhs

        def project(y):
            return y
    zz = project(_mv(Minv, res))
    p, rz = zz, torch.sum(res * zz)
    for _ in range(cg_iters):
        Sp = S(p)
        alpha = rz / _safe(torch.sum(p * Sp))
        x = x + alpha * p
        res = res - alpha * Sp
        zz = project(_mv(Minv, res))
        rz_next = torch.sum(res * zz)
        p = zz + (rz_next / _safe(rz)) * p
        rz = rz_next
    dl = _mv(Hll_inv, bl - _keyed(_mv(Apl_t, x[g.obs_kf]), g.obs_lm, L))
    new_poses, new_landmarks = poses + x, landmarks + dl
    return (torch.cat([new_poses[:, :2], wrap(new_poses[:, 2:])], 1),
            torch.cat([new_landmarks[:, :2], wrap(new_landmarks[:, 2:])], 1))


def solve(g: Graph, iters: int, cg_iters: int, damping: float, adaptive: bool = True,
          deflate_gauge: bool = True):
    """(poses [K, 3], landmarks [L, 3], cost history [iters + 1])."""
    poses, landmarks = g.poses, g.landmarks
    lam = damping
    last = cost(g, poses, landmarks)
    history = [last]
    for _ in range(iters):
        new_poses, new_landmarks = step(g, poses, landmarks, lam, cg_iters, deflate_gauge)
        c = cost(g, new_poses, new_landmarks)
        if not adaptive or bool(c <= last):
            poses, landmarks, last = new_poses, new_landmarks, c
            lam = max(lam * 0.5, damping) if adaptive else lam
        else:
            lam = min(lam * 10.0, DAMPING_CAP)
        history.append(last)
    return poses, landmarks, torch.stack(history)
