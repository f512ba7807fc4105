"""The kernels' least times on the card: a frozen copy of ``chip_smoke.py``'s
byte and operation counts for K1 (PnP front-end), K2 (the batched EKF frame
step), K3 (threshold, close and label) and K6 (the single-stream frame
step), computed from a cell's inputs; and the bundle-adjustment solve's
(:func:`ba_solve`), from its problem's sizes and iteration counts.

A bound is the larger of the bytes over the HBM rate and the operations
over the float32 rate of an NVIDIA H100 SXM at 700 W (data sheet). Bytes
are counted once each way; operations from the algorithm, for the work
these inputs need: the valid lanes, the known observations, and each
lane's active square of sigma (3 + 3 landmarks held). Constants marked
ESTIMATE are hand counts of a kernel's arithmetic from its source, not
measurements.
"""

from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# ESTIMATE: K1 runs 8 Gauss-Newton iterations (2 settle on each of 2 starts,
# 4 to finish) of about 1,100 operations (4 points: projection, 2x6
# Jacobian rows, J^T J and J^T r; the 6x6 Cholesky and solves; the pose
# update), plus the undistortion of 4 corners and the homography start.
K1_OPS_PER_LANE = 10_000
# ESTIMATE: the compose per encoder tick: the midpoint arc (about 15), sin
# and cos (about 20 each), H A and H Q H^T (63) and the 3x2 noise product
# (about 30).
COMPOSE_OPS_PER_TICK = 150
# ESTIMATE: the predict's operations per row of the active square.
PREDICT_OPS_PER_ROW = 30
# ESTIMATE: per pixel, the threshold about 5 (block sum, window mean,
# compare), the 3x3 closing 18, and each CCL round 17 (8-neighbour min,
# four directional run scans).
CCL_THRESHOLD_OPS, CCL_CLOSE_OPS, CCL_ROUND_OPS = 5, 18, 17


def bound_s(n_bytes, n_ops):
    """Seconds: the larger of the two times."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S)


def k1_launch(lanes: int, n_valid: int) -> float:
    """K1 over ``lanes`` (lane, slot) pairs of which ``n_valid`` hold a
    marker: every lane reads its valid flag (1 B) and writes z, R and keep
    (49 B); a valid one also reads its corners (32 B) and runs the solve."""
    return bound_s(lanes * 50 + n_valid * 32, n_valid * K1_OPS_PER_LANE)


def landmark_counts(ids: np.ndarray, valid: np.ndarray, L: int):
    """Per sequence and frame of ``ids [D, F, M]`` / ``valid``: the
    landmarks held after the frame (at most ``L``) and the frame's
    observations of landmarks held before it."""
    D, F, _ = ids.shape
    held = np.zeros((D, F), np.int64)
    known = np.zeros((D, F), np.int64)
    for d in range(D):
        seen = set()
        for f in range(F):
            obs = ids[d, f][valid[d, f]]
            known[d, f] = sum(int(i) in seen for i in obs)
            for i in obs:
                if len(seen) < L:
                    seen.add(int(i))
            held[d, f] = len(seen)
    return held, known


def ekf_launch(held: np.ndarray, known: np.ndarray, lanes: np.ndarray, L: int, M: int,
               ticks: int) -> float:
    """An EKF frame step over lanes with ``held`` landmarks after the frame
    and ``known`` corrections (arrays over the distinct sequences, each
    replayed by ``lanes`` lanes): each lane's active square of sigma and
    its mu read and written once, the bookkeeping and observations read,
    the ticks read (12 B each) and the replay's rows written (52 B);
    6 na^2 operations per known observation, the predict and the compose."""
    na = 3 + 3 * held.astype(np.float64)
    n_bytes = np.sum(lanes * ((2 * na * na + 2 * na) * 4 + 2 * L * (4 + 12 + 1)
                              + M * (4 + 12 + 36 + 1) + 12 * ticks + 52))
    n_ops = np.sum(lanes * (6 * na * na * known + PREDICT_OPS_PER_ROW * na
                            + COMPOSE_OPS_PER_TICK * ticks))
    return bound_s(n_bytes, n_ops)


def ccl_union_launch(frames: int, h: int, w: int, rounds: int, closed_rounds: int) -> float:
    """K3 on ``frames`` frames: the frame read (1 B a pixel), the two masks
    and two label planes written (1 + 4 + 1 + 4 B)."""
    px = frames * h * w
    return bound_s(11 * px, (CCL_THRESHOLD_OPS + CCL_CLOSE_OPS
                             + (rounds + closed_rounds) * CCL_ROUND_OPS) * px)


def replay_bounds(ids: np.ndarray, valid: np.ndarray, lanes: np.ndarray, L: int, M: int,
                  ticks: int, corner_level: bool) -> dict:
    """One replay's bound seconds per kernel family: the EKF step and, where
    the replay starts from corners, K1, a launch each a frame. ``ids`` and
    ``valid`` are the distinct sequences' ``[D, F, M]`` host arrays,
    ``lanes[d]`` the lanes that replay sequence d."""
    held, known = landmark_counts(ids, valid, L)
    F = ids.shape[1]
    out = {"ekf": sum(ekf_launch(held[:, f], known[:, f], lanes, L, M, ticks)
                      for f in range(F))}
    if corner_level:
        out["pnp"] = sum(k1_launch(int(lanes.sum()) * M, int((lanes * valid[:, f].sum(-1)).sum()))
                         for f in range(F))
    return out


# The bundle-adjustment solve (``models/ba.py``, float32): counts of the
# work the algorithm needs, whatever runs it (torch operations, a CUDA
# graph or one fused kernel). A 3x3 block is 36 B, a 3-vector 12 B, an
# index 4 B; a 3x3 matrix-vector product 15 operations, a 3x3 product 45.
# Marker factor: two indices, z and the information (56 B); an odometry
# factor: z and the information (48 B).
OBS_BYTES, ODO_BYTES, BLOCK_BYTES, VEC_BYTES = 56, 48, 36, 12
# ESTIMATE: a factor's linearization: the relative pose, its residual and
# two 3x3 Jacobians (about 60 with sin and cos), J^T W twice (90), the
# three blocks J^T W J (135), the two right-hand sides (30) and the keyed
# sums (24).
LIN_OPS_PER_FACTOR = 340
# ESTIMATE: a factor's cost: the relative pose and residual (about 50) and
# r^T W r (20).
COST_OPS_PER_FACTOR = 70
INV3_OPS = 40  # ESTIMATE: a 3x3 inverse by the adjugate


def ba_solve(K: int, L: int, N: int, M: int, gn: int, cg: int, adaptive: bool,
             deflate: bool) -> float:
    """One solve of K keyframes, L landmarks, N marker and M odometry
    factors: ``gn`` damped Gauss-Newton steps of ``cg`` PCG iterations each.

    Bytes, each step: the linearization reads the state and every factor
    and writes the pose-landmark blocks (N), the pose blocks (K), the
    odometry blocks (M), the inverted landmark blocks (L), the reduced
    right-hand side (K) and the landmarks' (L); each PCG iteration reads
    the blocks of S's product (pose, odometry, pose-landmark with its
    indices, inverted landmark) and the preconditioner's inverted pose
    blocks once, and reads and writes the iterate, residual and direction
    (with the gauge mode and its product where deflated); the
    back-substitution reads the pose-landmark blocks, indices, the step and
    the landmark blocks and writes the new state; with ``adaptive`` the
    cost of the new state reads it and every factor again. Operations
    likewise: every 3x3 product and matrix-vector product, sum and inverse
    the algorithm takes."""
    state = (K + L) * VEC_BYTES
    factors = N * OBS_BYTES + M * ODO_BYTES
    lin_bytes = state + factors + (N + K + M + L) * BLOCK_BYTES + (K + L) * VEC_BYTES
    cg_bytes = ((2 * K + M + L + N) * BLOCK_BYTES + N * 8
                + (6 + (2 if deflate else 0)) * K * VEC_BYTES)
    back_bytes = N * (BLOCK_BYTES + 8) + (K + L) * VEC_BYTES + L * BLOCK_BYTES + 2 * state
    cost_bytes = state + factors if adaptive else 0
    n_bytes = gn * (lin_bytes + cg * cg_bytes + back_bytes + cost_bytes)
    lin_ops = (N + M) * LIN_OPS_PER_FACTOR + (K + L) * INV3_OPS
    # S p: the pose blocks (15 K), odometry both ways (30 M), Apl^T, Hll^-1
    # and Apl (15 N + 15 L + 15 N) with the keyed sums (6 N); the
    # preconditioner (15 K); two dot products and three updates (30 K);
    # the deflation's projection (12 K)
    cg_ops = 36 * N + 15 * L + 30 * M + (60 + (12 if deflate else 0)) * K
    back_ops = 36 * N + 15 * L + 6 * (K + L)
    cost_ops = (N + M) * COST_OPS_PER_FACTOR if adaptive else 0
    n_ops = gn * (lin_ops + cg * cg_ops + back_ops + cost_ops)
    return bound_s(n_bytes, n_ops)
