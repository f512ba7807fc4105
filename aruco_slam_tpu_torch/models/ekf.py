"""EKF-SLAM core (L1), batch-first — counterpart of
``aruco_slam_tpu.models.ekf`` (reference ``ArucoSlam``, src/aruco_slam.cpp).

Every tensor carries a leading batch axis B (one lane per replayed
sequence). The state is fixed-capacity: ``max_landmarks`` slots with an
active count; inactive rows/columns of sigma stay exactly zero, which
leaves the gain and covariance updates equal to the reference's growing
matrices. A frame's observations are processed in the reference's
priority-queue order (new markers first, then ascending slot, ties by
arrival), each linearized at the frame-start mean (the reference's stale
``mu`` copy, src/aruco_slam.cpp:88). Branches are masked arithmetic over
the batch (``torch.where``), so lanes never diverge in control flow.

The batched covariance predict plus :func:`apply_sorted` is the plain
version of the K2 kernel (``ops/kernels/ekf_update_batched.py``), and
:func:`update` that of K6 (``ops/kernels/ekf_update.py``).
:func:`update_fused` is the block-LDL form of :func:`update` for a single
stream.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from aruco_slam_tpu_torch.ops import geometry, linalg
from aruco_slam_tpu_torch.utils.config import SlamConfig
from aruco_slam_tpu_torch.utils.device import resolve

Tensor = torch.Tensor

# sort key of an invalid observation: after every valid one
_BIG_KEY = 2_000_000_000


class EkfState(NamedTuple):
    """Joint Gaussian over (pose, landmarks) plus bookkeeping, for B lanes.
    ``N = 3 + 3 * max_landmarks``; L = max_landmarks."""

    mu: Tensor  # [B, N]
    sigma: Tensor  # [B, N, N]; inactive rows/cols are zero
    slot_ids: Tensor  # [B, L] int32 marker id per slot, -1 if empty
    n_landmarks: Tensor  # [B] int32
    last_obs: Tensor  # [B, L, 3] last accepted measurement per slot
    seen_prev: Tensor  # [B, L] bool: processed in the previous frame
    initialized: Tensor  # [B] bool: first-encoder latch (:24-29)
    diverged: Tensor  # [B] int32 log-only divergence hits (:156-175)
    dropped: Tensor  # [B] int32 observations dropped at capacity


class FrameObservations(NamedTuple):
    """One frame's marker observations per lane, padded to width M."""

    ids: Tensor  # [B, M] int32 (-1 for padding)
    z: Tensor  # [B, M, 3] (x, y, theta) in the robot frame
    R: Tensor  # [B, M, 3, 3]
    valid: Tensor  # [B, M] bool


class Control(NamedTuple):
    """Encoder ticks: wheel angular velocities + dt, [B] or [B, T]."""

    wl: Tensor
    wr: Tensor
    dt: Tensor


def init_state(
    config: SlamConfig, batch: int, device=None, dtype=torch.float32
) -> EkfState:
    """Fresh state: pose at the origin with zero covariance (reference
    ctor, src/aruco_slam.cpp:13-16), on ``device`` (None: the card)."""
    device = resolve(device)
    max_lm = config.ekf.max_landmarks
    n = 3 + 3 * max_lm
    i32 = dict(dtype=torch.int32, device=device)
    return EkfState(
        mu=torch.zeros(batch, n, dtype=dtype, device=device),
        sigma=torch.zeros(batch, n, n, dtype=dtype, device=device),
        slot_ids=torch.full((batch, max_lm), -1, **i32),
        n_landmarks=torch.zeros(batch, **i32),
        last_obs=torch.zeros(batch, max_lm, 3, dtype=dtype, device=device),
        seen_prev=torch.zeros(batch, max_lm, dtype=torch.bool, device=device),
        initialized=torch.zeros(batch, dtype=torch.bool, device=device),
        diverged=torch.zeros(batch, **i32),
        dropped=torch.zeros(batch, **i32),
    )


# ---------------------------------------------------------------------------
# Predict (reference addEncoder, src/aruco_slam.cpp:21-74)
# ---------------------------------------------------------------------------


def predict_compose(pose0: Tensor, initialized: Tensor, controls: Control,
                    config: SlamConfig):
    """Compose a block of T encoder ticks ``[B, T]`` into (pose [B, 3],
    A [B, 3, 3], Q [B, 3, 3]): the integrated midpoint-arc pose and the
    folded covariance transform sigma' = blockdiag(A, I) sigma
    blockdiag(A, I)^T + blockdiag(Q, 0). A lane that is not yet
    ``initialized`` spends its first tick on the latch."""
    odom, cov = config.odom, config.covariance
    dtype, device = pose0.dtype, pose0.device
    B = pose0.shape[0]
    eye3 = torch.eye(3, dtype=dtype, device=device).expand(B, 3, 3)
    pose, A, Q = pose0, eye3, torch.zeros(B, 3, 3, dtype=dtype, device=device)
    init = initialized
    for k in range(controls.wl.shape[1]):
        wl, wr, dt = controls.wl[:, k], controls.wr[:, k], controls.dt[:, k]
        delta_sl = odom.kl * dt * wl
        delta_sr = odom.kr * dt * wr
        delta_theta = (delta_sr - delta_sl) / (2.0 * odom.b)
        delta_s = 0.5 * (delta_sr + delta_sl)
        tmp_th = pose[:, 2] + 0.5 * delta_theta
        c, s = torch.cos(tmp_th), torch.sin(tmp_th)
        new_pose = torch.stack(
            [
                pose[:, 0] + delta_s * c,
                pose[:, 1] + delta_s * s,
                geometry.wrap_angle(pose[:, 2] + delta_theta),
            ],
            dim=-1,
        )
        H = eye3.clone()
        H[:, 0, 2] = -delta_s * s
        H[:, 1, 2] = delta_s * c
        # Quirk (b): the reference scales both wheel columns by kl (:60-62).
        if config.compat.process_noise_uses_kl_for_both_wheels:
            wkh = (0.5 * odom.kl * dt)[:, None, None] * torch.stack(
                [
                    torch.stack([c, c], dim=-1),
                    torch.stack([s, s], dim=-1),
                    torch.stack(
                        [torch.full_like(c, 1.0 / odom.b),
                         torch.full_like(c, -1.0 / odom.b)], dim=-1,
                    ),
                ],
                dim=-2,
            )
        else:
            wkh = (0.5 * dt)[:, None, None] * torch.stack(
                [
                    torch.stack([odom.kl * c, odom.kr * c], dim=-1),
                    torch.stack([odom.kl * s, odom.kr * s], dim=-1),
                    torch.stack(
                        [torch.full_like(c, odom.kl / odom.b),
                         torch.full_like(c, -odom.kr / odom.b)], dim=-1,
                    ),
                ],
                dim=-2,
            )
        sigma_u = torch.diag_embed(
            torch.stack([cov.Q_k * torch.abs(wl), cov.Q_k * torch.abs(wr)], dim=-1)
        )
        Qk = wkh @ sigma_u @ wkh.transpose(-1, -2)
        A_new = H @ A
        Q_new = H @ Q @ H.transpose(-1, -2) + Qk
        pose = torch.where(init[:, None], new_pose, pose)
        A = torch.where(init[:, None, None], A_new, A)
        Q = torch.where(init[:, None, None], Q_new, Q)
        init = torch.ones_like(init)
    return pose, A, Q


def apply_predict(sigma: Tensor, A: Tensor, Q: Tensor) -> Tensor:
    """sigma <- blockdiag(A, I) sigma blockdiag(A, I)^T + blockdiag(Q, 0):
    the pose rows, then the pose columns, then Q into the pose block."""
    sigma = sigma.clone()
    sigma[:, :3, :] = A @ sigma[:, :3, :]
    sigma[:, :, :3] = sigma[:, :, :3] @ A.transpose(-1, -2)
    sigma[:, :3, :3] += Q
    return sigma


def predict_block(state: EkfState, controls: Control, config: SlamConfig) -> EkfState:
    """Fused predict over a block of encoder ticks: one [N, N] touch per
    block, algebraically identical to folding :func:`predict`."""
    pose, A, Q = predict_compose(state.mu[:, :3], state.initialized, controls, config)
    mu = state.mu.clone()
    mu[:, :3] = pose
    return state._replace(
        mu=mu, sigma=apply_predict(state.sigma, A, Q),
        initialized=torch.ones_like(state.initialized),
    )


def predict(state: EkfState, control: Control, config: SlamConfig) -> EkfState:
    """EKF predict from one encoder tick per lane (``control`` fields [B])."""
    return predict_block(
        state, Control(control.wl[:, None], control.wr[:, None], control.dt[:, None]),
        config,
    )


# ---------------------------------------------------------------------------
# Update (reference addImage, src/aruco_slam.cpp:76-287)
# ---------------------------------------------------------------------------


def lookup_slots(slot_ids: Tensor, ids: Tensor) -> Tensor:
    """Marker ids ``[B, M]`` -> state slots (-1 if unknown): the
    reference's ``aruco_id_map`` lookup (src/aruco_slam.cpp:423-435) as a
    comparison. ``argmax`` takes int32 (it refuses bool)."""
    hit = slot_ids[:, None, :] == ids[:, :, None]  # [B, M, L]
    idx = torch.argmax(hit.to(torch.int32), dim=-1).to(torch.int32)
    return torch.where(hit.any(dim=-1), idx, torch.full_like(idx, -1))


def sort_observations(frame: FrameObservations, slots: Tensor):
    """Order each lane's observations as the reference's priority queue:
    key ``slot * M + arrival`` (new markers, slot -1, first), invalid last.
    Returns the sorted (frame, slots)."""
    M = frame.ids.shape[1]
    arrival = torch.arange(M, dtype=torch.int32, device=slots.device)
    key = torch.where(frame.valid, slots * M + arrival, _BIG_KEY)
    perm = torch.argsort(key, dim=1, stable=True)

    def take(x):
        idx = perm.reshape(*perm.shape, *([1] * (x.dim() - 2)))
        return torch.gather(x, 1, idx.expand(*perm.shape, *x.shape[2:]))

    return (
        FrameObservations(take(frame.ids), take(frame.z), take(frame.R),
                          take(frame.valid)),
        take(slots),
    )


def _rot_t(c: Tensor, s: Tensor) -> Tensor:
    """R(theta)^T per lane: [[c, s, 0], [-s, c, 0], [0, 0, 1]]."""
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack(
        [
            torch.stack([c, s, zero], dim=-1),
            torch.stack([-s, c, zero], dim=-1),
            torch.stack([zero, zero, one], dim=-1),
        ],
        dim=-2,
    )


def _pose_jacobian(c: Tensor, s: Tensor, dx: Tensor, dy: Tensor) -> Tensor:
    """d(z_hat)/d(pose) of the relative-pose observation (:140-143)."""
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack(
        [
            torch.stack([-c, -s, -dx * s + dy * c], dim=-1),
            torch.stack([s, -c, -dx * c - dy * s], dim=-1),
            torch.stack([zero, zero, -one], dim=-1),
        ],
        dim=-2,
    )


def apply_sorted(
    state: EkfState, frame: FrameObservations, slots: Tensor, config: SlamConfig
) -> EkfState:
    """Run a frame's observations, already in processing order with their
    frame-start ``slots``, through the sequential masked update; then
    symmetrize sigma. Per observation and lane exactly one branch applies:
    a known landmark's rank-3 correction (stale mean, stationary gate,
    divergence count or reject), a new landmark's augmentation, or a
    capacity drop. ``state.mu`` is the frame-start mean."""
    cfg = config.compat
    max_lm = config.ekf.max_landmarks
    mu, sigma = state.mu, state.sigma
    dtype, device = mu.dtype, mu.device
    B, N = mu.shape
    M = frame.ids.shape[1]
    lm_iota = torch.arange(max_lm, device=device)
    blk = torch.arange(3, device=device)
    n_iota = torch.arange(N, device=device)

    mu0 = mu  # stale linearization point (src/aruco_slam.cpp:88)
    x0, y0, th0 = mu0[:, 0], mu0[:, 1], mu0[:, 2]
    sth, cth = torch.sin(th0), torch.cos(th0)
    Rt = _rot_t(cth, sth)  # Gl of the known update
    # The reference downcasts the insert's sin/cos to float (float sinth,
    # src/aruco_slam.cpp:210-211); a no-op in float32.
    sth_i = sth.to(torch.float32).to(dtype)
    cth_i = cth.to(torch.float32).to(dtype)
    Gmi = _rot_t(cth_i, sth_i)

    frozen_last, frozen_seen = state.last_obs, state.seen_prev
    slot_ids, n_lm = state.slot_ids, state.n_landmarks
    new_last = frozen_last
    new_seen = torch.zeros_like(frozen_seen)
    diverged, dropped = state.diverged, state.dropped

    for i in range(M):
        slot, valid, ob_id = slots[:, i], frame.valid[:, i], frame.ids[:, i]
        z, Rk = frame.z[:, i].to(dtype), frame.R[:, i].to(dtype)
        is_known = slot >= 0
        has_room = n_lm < max_lm
        eff = torch.where(is_known, slot, n_lm).long()
        eff_c = torch.clamp(eff, max=max_lm - 1)  # a drop's slot is unused
        rows = 3 + 3 * eff_c[:, None] + blk  # [B, 3]
        E = (n_iota[None, None, :] == rows[:, :, None]).to(dtype)  # [B, 3, N]

        # ---- known landmark (src/aruco_slam.cpp:108-207) ----
        m = torch.gather(mu0, 1, rows)
        gdx, gdy = m[:, 0] - x0, m[:, 1] - y0
        gdth = geometry.wrap_angle(m[:, 2] - th0)
        ze = torch.stack(
            [
                z[:, 0] - (gdx * cth + gdy * sth),
                z[:, 1] - (-gdx * sth + gdy * cth),
                geometry.wrap_angle(z[:, 2] - gdth),
            ],
            dim=-1,
        )
        Gp = _pose_jacobian(cth, sth, gdx, gdy)
        sig_lm = torch.gather(sigma, 1, rows[:, :, None].expand(B, 3, N))
        Bm = Gp @ sigma[:, :3, :] + Rt @ sig_lm  # [B, 3, N] = Gx sigma
        BE = torch.gather(Bm, 2, rows[:, None, :].expand(B, 3, 3))
        S = Bm[:, :, :3] @ Gp.transpose(-1, -2) + BE @ Rt.transpose(-1, -2) + Rk
        KT = linalg.inv3x3(S) @ Bm  # [B, 3, N] rows of K^T
        k_norm2 = torch.sum(KT * KT, dim=(1, 2))
        div_hit = (torch.sum(ze * ze, dim=-1) >= cfg.divergence_ze_norm**2) | (
            k_norm2 >= cfg.divergence_k_norm**2
        )
        gate = torch.zeros_like(valid)
        if cfg.stationary_gate:
            seen_p = torch.gather(frozen_seen, 1, eff_c[:, None])[:, 0]
            last_p = torch.gather(frozen_last, 1, eff_c[:, None, None].expand(B, 1, 3))[:, 0]
            d2 = torch.sum((last_p - z) ** 2, dim=-1)
            gate = seen_p & (d2 < cfg.stationary_gate_eps**2)
        reject = div_hit if cfg.reject_divergent else torch.zeros_like(valid)

        do_known = valid & is_known
        do_new = valid & ~is_known & has_room
        do_drop = valid & ~is_known & ~has_room
        apply_known = do_known & ~gate & ~reject

        mu_known = mu + (ze[:, None, :] @ KT)[:, 0]
        sigma_known = sigma - KT.transpose(-1, -2) @ Bm

        # ---- new landmark (src/aruco_slam.cpp:208-260) ----
        map_x = x0 + cth_i * z[:, 0] - sth_i * z[:, 1]
        map_y = y0 + sth_i * z[:, 0] + cth_i * z[:, 1]
        map_th = geometry.wrap_angle(th0 + z[:, 2])
        mu_new = mu + (torch.stack([map_x, map_y, map_th], dim=-1)[:, None, :] @ E)[:, 0]
        Gsk = _pose_jacobian(cth_i, sth_i, map_x - x0, map_y - y0)
        inner = Gsk @ sigma[:, :3, :3] @ Gsk.transpose(-1, -2) + Rk
        smm = Gmi @ inner.transpose(-1, -2) @ Gmi.transpose(-1, -2)
        smx = -(Gmi @ Gsk) @ sigma[:, :3, :]  # [B, 3, N]
        Et = E.transpose(-1, -2)
        sigma_new = sigma + Et @ smx + smx.transpose(-1, -2) @ E + Et @ (smm @ E)

        mu = torch.where(apply_known[:, None], mu_known,
                         torch.where(do_new[:, None], mu_new, mu))
        sigma = torch.where(apply_known[:, None, None], sigma_known,
                            torch.where(do_new[:, None, None], sigma_new, sigma))

        # ---- bookkeeping ----
        sel = lm_iota[None, :] == eff[:, None]  # [B, L]
        slot_ids = torch.where(do_new[:, None] & sel, ob_id[:, None], slot_ids)
        n_lm = n_lm + do_new.to(torch.int32)
        write = (do_known | do_new)[:, None] & sel
        # known -> z (zeros on a gated hit); new -> zeros (the reference
        # pushes it uninitialized, quirk (c))
        nlo = torch.where((do_known & ~gate)[:, None], z, torch.zeros_like(z))
        new_last = torch.where(write[:, :, None], nlo[:, None, :], new_last)
        new_seen = new_seen | write
        diverged = diverged + (do_known & div_hit).to(torch.int32)
        dropped = dropped + do_drop.to(torch.int32)

    if config.ekf.symmetrize_sigma:
        sigma = 0.5 * (sigma + sigma.transpose(-1, -2))
    return state._replace(
        mu=mu, sigma=sigma, slot_ids=slot_ids, n_landmarks=n_lm,
        last_obs=new_last, seen_prev=new_seen, diverged=diverged, dropped=dropped,
    )


def update(state: EkfState, frame: FrameObservations, config: SlamConfig) -> EkfState:
    """Process one frame's observations per lane in the reference's queue
    order. A lane with no encoder tick yet keeps its state (the addImage
    early-out, src/aruco_slam.cpp:84-85)."""
    slots = lookup_slots(state.slot_ids, frame.ids)
    frame_s, slots_s = sort_observations(frame, slots)
    return keep_uninitialized(apply_sorted(state, frame_s, slots_s, config), state)


def keep_uninitialized(new: EkfState, state: EkfState) -> EkfState:
    """``new`` for a lane that has had an encoder tick, ``state`` for one
    that has not (the addImage early-out, src/aruco_slam.cpp:84-85)."""
    init = state.initialized

    def pick(a, b):
        return torch.where(init.reshape(-1, *([1] * (a.dim() - 1))), a, b)

    return EkfState(*(pick(a, b) for a, b in zip(new, state)))


# ---------------------------------------------------------------------------
# Fused frame update — the frame's sequential corrections in the
# observed-slot subspace, one [N, N] covariance touch per frame.
# ---------------------------------------------------------------------------


def update_fused(state: EkfState, frame: FrameObservations, config: SlamConfig) -> EkfState:
    """Block-LDL reformulation of :func:`update` for a single stream
    (batch of one), algebraically exact: counterpart of the JAX package's
    ``ekf.update_fused``, whose docstring derives it.

    Every observation of a frame is linearized at the frame-start mean, so
    innovations, Jacobians, insert poses and gates are known upfront. The
    inserts (a prefix of the sorted order) are congruences that stay in the
    family sigma0 + Y V Q' + Q V' Y' + Q W Q' over the observed-slot
    selector Q [N, a], a = 3 + 3M; the known corrections are one block-LDL
    elimination of the stacked innovation matrix, whose Schur diagonals D_i
    are the sequential S_i (inverted as ``inv3x3(0.5 (D + D'))``), with the
    reject-divergent decision taken inside the elimination. Requires at most
    one observation per marker id per frame."""
    if state.mu.shape[0] != 1:
        raise ValueError(f"update_fused is single-stream: batch must be 1, got {state.mu.shape[0]}")
    max_lm = config.ekf.max_landmarks
    cfg = config.compat
    mu0, S0 = state.mu[0], state.sigma[0]
    dtype, dev = mu0.dtype, mu0.device
    N = mu0.shape[0]
    i32 = torch.int32

    # --- identical ordering to `update` ---------------------------------
    obs, slots = sort_observations(frame, lookup_slots(state.slot_ids, frame.ids))
    ids_s, valid_s, slots_s = obs.ids[0], obs.valid[0], slots[0]
    z_s, R_s = obs.z[0].to(dtype), obs.R[0].to(dtype)
    M = ids_s.shape[0]
    a = 3 + 3 * M
    k = 3 * M
    n0 = state.n_landmarks[0]

    # --- upfront bookkeeping (all from frame-start state) ---------------
    known = valid_s & (slots_s >= 0)
    new_mask = valid_s & (slots_s < 0)
    new_i = new_mask.to(i32)
    new_rank = torch.cumsum(new_i, 0, dtype=i32) - new_i
    inserted = new_mask & (n0 + new_rank < max_lm)
    assigned = torch.clamp(n0 + new_rank, 0, max_lm - 1)
    eff_slot = torch.where(slots_s >= 0, slots_s, assigned)
    n_dropped = (new_mask & ~inserted).sum().to(i32)

    # Observed-slot selector Q [N, a]: the pose block, then one 3-block per
    # sorted observation (an invalid one's block may alias a real column;
    # its V, W and C entries stay exactly zero).
    blk = torch.arange(3, device=dev)
    col_idx = torch.cat([blk, (3 + 3 * eff_slot[:, None] + blk).reshape(-1)])
    Q = (col_idx[None, :] == torch.arange(N, device=dev)[:, None]).to(dtype)
    Y = S0 @ Q  # [N, a]
    T = Q.T @ Y  # [a, a]
    muQ = mu0 @ Q  # [a]

    x, y, th = mu0[0], mu0[1], mu0[2]
    sth, cth = torch.sin(th), torch.cos(th)
    Rt = _rot_t(cth[None], sth[None])[0]  # Gl of the known update, Gmi of the insert
    cm, sm = cth.expand(M), sth.expand(M)

    lm = muQ[3:].reshape(M, 3)  # each observation's landmark at frame start
    gdx, gdy = lm[:, 0] - x, lm[:, 1] - y
    gdth = geometry.wrap_angle(lm[:, 2] - th)
    ze = z_s - torch.stack([gdx * cth + gdy * sth, -gdx * sth + gdy * cth, gdth], dim=1)
    ze = torch.cat([ze[:, :2], geometry.wrap_angle(ze[:, 2:])], dim=1)
    Gp = _pose_jacobian(cm, sm, gdx, gdy)  # [M, 3, 3]

    # insert pieces (reference :210-253), all from mu0
    ins_dx = cth * z_s[:, 0] - sth * z_s[:, 1]
    ins_dy = sth * z_s[:, 0] + cth * z_s[:, 1]
    p_new = torch.stack([x + ins_dx, y + ins_dy, geometry.wrap_angle(th + z_s[:, 2])], dim=1)
    Gsk = _pose_jacobian(cm, sm, ins_dx, ins_dy)
    M3 = -(Rt[None] @ Gsk)  # [M, 3, 3]
    w_add = Rt[None] @ R_s @ Rt.T[None]  # the insert's measurement-noise block

    # stationary gate (quirk (c)) from the frozen previous-frame records
    lm_iota = torch.arange(max_lm, device=dev)
    sel = (lm_iota[None, :] == eff_slot[:, None]) & known[:, None]  # [M, L]
    f_seen = (sel & state.seen_prev[0][None, :]).any(dim=1)
    f_last = sel.to(dtype) @ state.last_obs[0]
    gate = torch.zeros_like(known)
    if cfg.stationary_gate:
        gate = known & f_seen & (
            torch.linalg.vector_norm(f_last - z_s, dim=1) < cfg.stationary_gate_eps
        )
    ze_div = torch.linalg.vector_norm(ze, dim=1) >= cfg.divergence_ze_norm

    eye_a = torch.eye(a, dtype=dtype, device=dev)
    eye3 = torch.eye(3, dtype=dtype, device=dev)

    # --- phase A: the insert prefix as a congruence chain on (V, W) ------
    V = torch.zeros(a, a, dtype=dtype, device=dev)
    W = torch.zeros(a, a, dtype=dtype, device=dev)
    acc_b = torch.zeros(a, dtype=dtype, device=dev)
    T3 = T[:, :3]
    for j in range(M):
        c0, c1 = 3 + 3 * j, 6 + 3 * j
        insf = inserted[j].to(dtype)
        P3 = eye_a[:, :3] + V[:, :3]  # [a, 3]
        B3 = V.T @ T3 + W[:, :3]  # [a, 3]
        C33 = (T @ P3 + B3)[:3, :]  # pose block of Q' sigma Q
        m3 = insf * M3[j]
        V[:, c0:c1] += P3 @ m3.T
        rowj = m3 @ B3.T  # [3, a]
        W[c0:c1, :] += rowj
        W[:, c0:c1] += rowj.T
        W[c0:c1, c0:c1] += m3 @ C33 @ m3.T + insf * w_add[j]
        acc_b[c0:c1] += insf * p_new[j]

    # --- phase B: the known corrections as one block-LDL elimination -----
    QS = (eye_a + V.T) @ Y.T + (T @ V + W) @ Q.T  # [a, N] = Q' sigma_ins
    kf = known.to(dtype)
    C = kf[:, None, None] * (Gp @ QS[:3][None] + Rt[None] @ QS[3:].reshape(M, 3, N))
    Cm = C.reshape(k, N)
    CQ = Cm @ Q  # [k, a]
    Sb = torch.einsum("kp,jqp->kjq", CQ[:, :3], Gp) + torch.einsum(
        "kjp,qp->kjq", CQ[:, 3:].reshape(k, M, 3), Rt
    )
    Sb = (Sb * kf[None, :, None]).reshape(k, k)
    Rblk = kf[:, None, None] * R_s + (1.0 - kf)[:, None, None] * eye3
    for j in range(M):
        Sb[3 * j: 3 * j + 3, 3 * j: 3 * j + 3] += Rblk[j]

    use_pre = known & ~gate  # reject-divergent refines this in the loop
    below = torch.arange(k, device=dev)[:, None]
    Srem = Sb
    Lmat = torch.eye(k, dtype=dtype, device=dev)
    Linv = torch.eye(k, dtype=dtype, device=dev)
    Dinv_all = torch.zeros(M, 3, 3, dtype=dtype, device=dev)
    used_f = torch.zeros(M, dtype=dtype, device=dev)
    div_flags = torch.zeros_like(known)
    for i in range(M):
        r0, r1 = 3 * i, 3 * i + 3
        Dblk = Srem[r0:r1, r0:r1]
        Dinv = linalg.inv3x3(0.5 * (Dblk + Dblk.T))
        Dinv_all[i] = Dinv
        if i > 0:
            Linv[r0:r1, :r0] = -(Lmat[r0:r1, :r0] @ Linv[:r0, :r0])
        if cfg.reject_divergent:
            # the gain norm decides *before* the observation is used
            k2 = torch.sum((Dinv @ (Linv[r0:r1, :r1] @ Cm[:r1])) ** 2)
            div_i = ze_div[i] | (torch.sqrt(torch.clamp(k2, min=0.0)) >= cfg.divergence_k_norm)
            div_flags[i] = div_i
            use_i = use_pre[i] & ~div_i
        else:
            use_i = use_pre[i]
        uf = use_i.to(dtype)
        used_f[i] = uf
        colf = Srem[:, r0:r1] * (below >= r0).to(dtype)
        LD = uf * (colf @ Dinv)  # [k, 3]
        Lmat[:, r0:r1] += LD * (below >= r1).to(dtype)
        Srem = Srem - LD @ colf.T

    chat_b = (Linv @ Cm).reshape(M, 3, N)  # L^-1 C
    if cfg.reject_divergent:
        div = div_flags
    else:
        k2 = torch.sum((Dinv_all @ chat_b) ** 2, dim=(1, 2))
        div = ze_div | (torch.sqrt(torch.clamp(k2, min=0.0)) >= cfg.divergence_k_norm)
    div_cnt = (known & div).sum().to(i32)

    used_chat = used_f[:, None, None] * chat_b
    Cu = used_chat.reshape(k, N)
    DC = (Dinv_all @ used_chat).reshape(k, N)
    dz = (Dinv_all @ (used_f[:, None] * ze)[..., None])[..., 0].reshape(k)

    # --- one full-state application -------------------------------------
    YV = Y @ V
    QW = Q @ W
    sigma = S0 + YV @ Q.T + Q @ YV.T + QW @ Q.T - Cu.T @ DC
    mu = mu0 + Q @ acc_b + Cu.T @ dz
    if config.ekf.symmetrize_sigma:
        sigma = 0.5 * (sigma + sigma.T)

    # --- bookkeeping, as the sequential path ----------------------------
    processed = known | inserted
    proc_sel = (lm_iota[None, :] == eff_slot[:, None]) & processed[:, None]
    new_last_val = torch.where((known & ~gate)[:, None], z_s, torch.zeros_like(z_s))
    touched = proc_sel.any(dim=0)
    last_obs = torch.where(touched[:, None], proc_sel.to(dtype).T @ new_last_val,
                           state.last_obs[0])
    ins_sel = (lm_iota[None, :] == assigned[:, None]) & inserted[:, None]
    slot_ids = torch.where(ins_sel.any(dim=0), (ins_sel * ids_s[:, None]).sum(dim=0).to(i32),
                           state.slot_ids[0])
    new = EkfState(
        mu=mu[None], sigma=sigma[None], slot_ids=slot_ids[None],
        n_landmarks=(n0 + inserted.sum().to(i32))[None], last_obs=last_obs[None],
        seen_prev=touched[None], initialized=state.initialized,
        diverged=state.diverged + div_cnt, dropped=state.dropped + n_dropped,
    )
    return keep_uninitialized(new, state)


# ---------------------------------------------------------------------------
# Output accessors (reference toRosPose / toRosMappedMarkers)
# ---------------------------------------------------------------------------


def get_pose(state: EkfState):
    """Robot pose (x, y, theta) [B, 3] and its covariance [B, 3, 3]."""
    return state.mu[:, :3], state.sigma[:, :3, :3]


def get_map(state: EkfState, config: SlamConfig):
    """Landmarks [B, L, 3], ids [B, L], active mask [B, L]."""
    max_lm = config.ekf.max_landmarks
    lms = state.mu[:, 3:].reshape(-1, max_lm, 3)
    active = torch.arange(max_lm, device=lms.device)[None, :] < state.n_landmarks[:, None]
    return lms, state.slot_ids, active
