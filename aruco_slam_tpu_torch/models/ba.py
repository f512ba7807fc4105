"""Factor-graph back-end (L5): bundle adjustment over SE(2) keyframes and
marker landmarks — counterpart of ``aruco_slam_tpu.models.ba``.

A sparse Gauss-Newton / Levenberg-Marquardt solver over

- **marker factors**   z = h(pose_k, lm_l) + noise, h the EKF's robot-frame
  relative observation (reference src/aruco_slam.cpp:127-134);
- **odometry factors** z = pose_i ⊖ pose_j between keyframes;
- a **prior** on pose 0 fixing the gauge.

The normal equations are never formed. Landmarks are eliminated by the
Schur complement (each 3x3 Hll block inverts in closed form) and the reduced
camera system S dp = bs is solved matrix-free by preconditioned CG: every
S @ v is a batch of 3x3 products plus keyed sums over keyframes and
landmarks.

What differs from the JAX module, and why:

- :func:`prepare` returns ``(packed, static)``: the keyframe-major packing
  (``kf_width``: every keyframe-keyed sum a reshape-sum) and the odometry
  chain detection (``odo_chain``: shifted pad-adds). The JAX gather tables
  (``GatherTables``, ``build_tables``, the degree-class buckets, the
  associative-scan landmark sum) and ``solve(unroll=...)`` are not ported:
  they exist because XLA:TPU runs scatter serially and pays per scan
  boundary. So :func:`solve` takes no ``tables``.
- Every other keyed sum (landmarks; keyframes and odometry endpoints where
  nothing is packed) is a segment sum over a stable sort of the key, built
  once per solve (:class:`Segments`): the same order on every run, where
  ``index_add_`` on CUDA float32 would sum in the order its atomics land.
- The GN and CG loops are Python loops of fixed-shape tensor ops with no
  read back to the host: the denominators and the LM accept/reject are
  ``torch.where``, and the cost history stays on the device until
  :func:`solve` returns.
- The GN step takes a ``reduce`` hook, called once a linearization and
  once a Schur matvec, through which ``parallel.dist_ba`` sums the shards
  of a distributed solve (the JAX package's ``shard_map`` body repeats the
  step instead).

The arithmetic runs in the problem's dtype (float32 on the card; float64
on the CPU for the dense-oracle tests). Tensors stay where the problem's
are.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from aruco_slam_tpu_torch.ops import geometry, linalg
from aruco_slam_tpu_torch.utils.device import host

Tensor = torch.Tensor


class BAProblem(NamedTuple):
    """Fixed-shape factor graph. K keyframes, L landmarks, N marker
    observations, M odometry/relative-pose factors. Tensors (or numpy
    arrays, as the graph builders return them)."""

    poses: Tensor  # [K, 3] initial keyframe poses
    landmarks: Tensor  # [L, 3] initial landmark states
    obs_kf: Tensor  # [N] keyframe index
    obs_lm: Tensor  # [N] landmark index
    obs_z: Tensor  # [N, 3] measured relative (x, y, theta)
    obs_w: Tensor  # [N, 3, 3] information matrices (R^{-1})
    obs_valid: Tensor  # [N] bool
    odo_i: Tensor  # [M]
    odo_j: Tensor  # [M]
    odo_z: Tensor  # [M, 3]
    odo_w: Tensor  # [M, 3, 3]
    odo_valid: Tensor  # [M] bool
    prior_w: Tensor  # [3, 3] information anchoring pose 0 at its init value


class BAStats(NamedTuple):
    initial_cost: Tensor
    final_cost: Tensor
    cost_history: Tensor  # [iters+1]


class Segments(NamedTuple):
    """A keyed sum's plan: the stable sort of the keys and the count per
    key, so ``segment_reduce`` sums each key's rows in index order."""

    order: Tensor  # [n] int64
    lengths: Tensor  # [S] int64


class SumPlan(NamedTuple):
    """How the solver takes each keyed sum of one problem. ``kf`` is None
    under the keyframe-major packing (``kf_width``), ``odo_i`` / ``odo_j``
    under the chain odometry (``odo_chain``)."""

    lm: Segments
    kf: Optional[Segments]
    odo_i: Optional[Segments]
    odo_j: Optional[Segments]
    kf_width: Optional[int]
    odo_chain: bool


def segments(ids: Tensor, num_segments: int) -> Segments:
    """The :class:`Segments` of ``ids`` (values in [0, num_segments))."""
    ids = ids.long()
    lengths = torch.zeros(num_segments, dtype=torch.long, device=ids.device)
    lengths.index_add_(0, ids, torch.ones_like(ids))
    return Segments(torch.argsort(ids, stable=True), lengths)


def seg_sum(vals: Tensor, seg: Segments) -> Tensor:
    """``segment_sum(vals, ids)`` over the leading axis: [n, ...] -> [S, ...]."""
    return torch.segment_reduce(vals.index_select(0, seg.order), "sum",
                                lengths=seg.lengths, unsafe=True)


def sum_plan(problem: BAProblem, kf_width: Optional[int] = None,
             odo_chain: bool = False) -> SumPlan:
    """The keyed sums' plan of ``problem`` (tensors); built once per solve."""
    K = problem.poses.shape[0]
    L = problem.landmarks.shape[0]
    return SumPlan(
        lm=segments(problem.obs_lm, L),
        kf=None if kf_width is not None else segments(problem.obs_kf, K),
        odo_i=None if odo_chain else segments(problem.odo_i, K),
        odo_j=None if odo_chain else segments(problem.odo_j, K),
        kf_width=kf_width,
        odo_chain=odo_chain,
    )


def prepare(problem: BAProblem):
    """Pack a host (numpy) problem for the solver. Returns
    ``(packed, static)``, ``packed`` a numpy :class:`BAProblem` and
    ``static`` the options to splat into :func:`solve`:

    - observations are permuted into a keyframe-major dense layout
      ([K, kf_width] slots, zero-weight pads), so every keyframe-keyed sum
      is a reshape + dense sum and the ``v[obs_kf]`` gather a broadcast
      (``kf_width``);
    - the odometry chain (odo_i == 0..K-2, odo_j == 1..K-1, what the graph
      builders emit) is detected and summed by shifted pad-adds
      (``odo_chain``).

    The same solution as the unpacked solve up to summation order."""
    K = np.asarray(problem.poses).shape[0]
    N = np.asarray(problem.obs_kf).shape[0]
    valid = np.asarray(problem.obs_valid)
    vrows = np.nonzero(valid)[0]
    kf_v = np.asarray(problem.obs_kf)[vrows]
    counts = np.bincount(kf_v, minlength=K)
    O = max(1, int(counts.max()))
    perm = np.full((K, O), N, np.int64)
    order = np.argsort(kf_v, kind="stable")
    rows_sorted = vrows[order]
    kf_sorted = kf_v[order]
    seg_start = np.zeros(K + 1, np.int64)
    np.cumsum(counts, out=seg_start[1:])
    within = np.arange(len(kf_sorted)) - seg_start[kf_sorted]
    perm[kf_sorted, within] = rows_sorted
    perm = perm.reshape(-1)

    def g(arr):
        a = np.asarray(arr)
        padded = np.concatenate([a, np.zeros((1, *a.shape[1:]), a.dtype)])
        return padded[perm]

    packed = problem._replace(
        obs_kf=np.repeat(np.arange(K, dtype=np.int32), O),
        obs_lm=g(problem.obs_lm).astype(np.int32),
        obs_z=g(problem.obs_z),
        obs_w=g(problem.obs_w),
        obs_valid=(perm != N),
    )
    return packed, {"kf_width": O, "odo_chain": odo_is_chain(problem)}


def odo_is_chain(problem: BAProblem) -> bool:
    """Whether the odometry factors are the chain odo_i == 0..K-2,
    odo_j == 1..K-1, all valid (what the graph builders emit). Reads the
    indices on the host."""
    K = problem.poses.shape[0]
    oi, oj, ov = (np.asarray(host(x)) for x in (problem.odo_i, problem.odo_j, problem.odo_valid))
    M = len(oi)
    return bool(
        M == K - 1
        and np.array_equal(oi, np.arange(M))
        and np.array_equal(oj, np.arange(1, M + 1))
        and ov.all()
    )


def _matvec(A: Tensor, v: Tensor) -> Tensor:
    """Batched ``A @ v`` for ``A [..., 3, 3]``, ``v [..., 3]``."""
    return (A @ v[..., None])[..., 0]


def _wrap_last(r: Tensor) -> Tensor:
    """``r`` with its angle (last component) wrapped, in place."""
    r[..., 2] = geometry.wrap_angle(r[..., 2])
    return r


def _obs_jacobians(pose: Tensor, target: Tensor):
    """h(pose, target) = target in pose frame; returns (h, Jp, Jt): the
    analytic 3x6 observation Jacobian halves of the EKF (reference Gxm,
    src/aruco_slam.cpp:140-143), batched."""
    x, y, th = pose[..., 0], pose[..., 1], pose[..., 2]
    s, c = torch.sin(th), torch.cos(th)
    dx = target[..., 0] - x
    dy = target[..., 1] - y
    h = torch.stack(
        [dx * c + dy * s, -dx * s + dy * c, geometry.wrap_angle(target[..., 2] - th)],
        dim=-1,
    )
    zero = torch.zeros_like(c)
    one = torch.ones_like(c)
    Jp = torch.stack(
        [
            torch.stack([-c, -s, -dx * s + dy * c], dim=-1),
            torch.stack([s, -c, -dx * c - dy * s], dim=-1),
            torch.stack([zero, zero, -one], dim=-1),
        ],
        dim=-2,
    )
    Jt = torch.stack(
        [
            torch.stack([c, s, zero], dim=-1),
            torch.stack([-s, c, zero], dim=-1),
            torch.stack([zero, zero, one], dim=-1),
        ],
        dim=-2,
    )
    return h, Jp, Jt


def _residuals(problem: BAProblem, poses: Tensor, landmarks: Tensor):
    """All weighted residual blocks + Jacobians at the current estimate:
    ((r_obs, Jp, Jl, w_obs), (r_odo, Ji, Jj, w_odo)); invalid factors
    weigh zero."""
    h, Jp, Jl = _obs_jacobians(poses[problem.obs_kf], landmarks[problem.obs_lm])
    r_obs = _wrap_last(problem.obs_z - h)
    w_obs = torch.where(problem.obs_valid[:, None, None], problem.obs_w, 0.0)
    ho, Ji, Jj = _obs_jacobians(poses[problem.odo_i], poses[problem.odo_j])
    r_odo = _wrap_last(problem.odo_z - ho)
    w_odo = torch.where(problem.odo_valid[:, None, None], problem.odo_w, 0.0)
    return (r_obs, Jp, Jl, w_obs), (r_odo, Ji, Jj, w_odo)


def _quad(r: Tensor, w: Tensor) -> Tensor:
    """sum_n r_n^T w_n r_n."""
    return torch.sum(r[:, None, :] @ w @ r[:, :, None])


def _prior_cost(problem: BAProblem, poses: Tensor, prior_pose: Tensor) -> Tensor:
    r0 = _wrap_last(poses[0] - prior_pose)
    return r0 @ problem.prior_w @ r0


def cost(problem: BAProblem, poses: Tensor, landmarks: Tensor, prior_pose: Tensor) -> Tensor:
    """0.5 * the weighted squared residuals, the prior on pose 0 included."""
    (r_obs, _, _, w_obs), (r_odo, _, _, w_odo) = _residuals(problem, poses, landmarks)
    return 0.5 * (_quad(r_obs, w_obs) + _quad(r_odo, w_odo)
                  + _prior_cost(problem, poses, prior_pose))


def _kf_sum(vals: Tensor, plan: SumPlan, K: int) -> Tensor:
    """Keyframe-keyed sum: a dense reshape-sum under the keyframe-major
    packing, else a segment sum."""
    if plan.kf_width is not None:
        return vals.reshape(K, plan.kf_width, *vals.shape[1:]).sum(dim=1)
    return seg_sum(vals, plan.kf)


def _obs_blocks(obs_parts, plan: SumPlan, K: int):
    """obs_linear_blocks body from already-evaluated residual parts."""
    r_obs, Jp, Jl, w_obs = obs_parts
    JpW = Jp.transpose(-1, -2) @ w_obs  # [N, 3, 3] = Jp^T W
    JlW = Jl.transpose(-1, -2) @ w_obs
    App = JpW @ Jp
    All = JlW @ Jl
    Apl = JpW @ Jl
    bp_obs = _matvec(JpW, r_obs)
    bl_obs = _matvec(JlW, r_obs)
    Hpp_diag = _kf_sum(App, plan, K)
    Hll = seg_sum(All, plan.lm)
    bp = _kf_sum(bp_obs, plan, K)
    bl = seg_sum(bl_obs, plan.lm)
    return Hpp_diag, Hll, Apl, bp, bl


def obs_linear_blocks(problem: BAProblem, poses: Tensor, landmarks: Tensor,
                      plan: Optional[SumPlan] = None):
    """Marker-factor linear blocks (the shardable part of the problem).

    Sign convention: residual r = z - h, Jacobians J of h, so the normal
    equations are (J^T W J) d = + J^T W r.

    Returns (Hpp_diag_obs [K,3,3], Hll [L,3,3], Apl [N,3,3], bp_obs [K,3],
    bl [L,3]), keyed by the problem's own landmark indices, so a shard of
    observations + its landmark block computes these alone; only
    Hpp_diag_obs and bp_obs need a sum across shards. ``plan``: the
    problem's :func:`sum_plan` (default: unpacked)."""
    plan = plan if plan is not None else sum_plan(problem)
    obs_parts, _ = _residuals(problem, poses, landmarks)
    return _obs_blocks(obs_parts, plan, poses.shape[0])


def _chain_pad_i(x: Tensor) -> Tensor:
    """Place per-factor values at their i endpoint (0..K-2) of a K-row
    output: pad one zero row at the end."""
    return torch.cat([x, x.new_zeros(1, *x.shape[1:])])


def _chain_pad_j(x: Tensor) -> Tensor:
    """Place per-factor values at their j endpoint (1..K-1)."""
    return torch.cat([x.new_zeros(1, *x.shape[1:]), x])


def _odo_blocks(odo_parts, plan: SumPlan):
    """odo_linear_blocks body from already-evaluated residual parts."""
    r_odo, Ji, Jj, w_odo = odo_parts
    JiW = Ji.transpose(-1, -2) @ w_odo
    JjW = Jj.transpose(-1, -2) @ w_odo
    Hij = JiW @ Jj  # [M, 3, 3] off-diagonal block (i, j)
    bi = _matvec(JiW, r_odo)
    bj = _matvec(JjW, r_odo)
    if plan.odo_chain:
        Hpp_diag = _chain_pad_i(JiW @ Ji) + _chain_pad_j(JjW @ Jj)
        bp = _chain_pad_i(bi) + _chain_pad_j(bj)
    else:
        Hpp_diag = seg_sum(JiW @ Ji, plan.odo_i) + seg_sum(JjW @ Jj, plan.odo_j)
        bp = seg_sum(bi, plan.odo_i) + seg_sum(bj, plan.odo_j)
    return Hpp_diag, Hij, bp


def odo_linear_blocks(problem: BAProblem, poses: Tensor, landmarks: Tensor,
                      plan: Optional[SumPlan] = None):
    """Odometry/relative-pose linear blocks (Hpp_diag_odo [K,3,3],
    Hij [M,3,3], bp_odo [K,3]): replicated, cheap. ``plan`` as in
    :func:`obs_linear_blocks`."""
    plan = plan if plan is not None else sum_plan(problem)
    _, odo_parts = _residuals(problem, poses, landmarks)
    return _odo_blocks(odo_parts, plan)


def _linearize(problem: BAProblem, poses: Tensor, landmarks: Tensor, damping,
               plan: SumPlan, prior_pose: Optional[Tensor] = None) -> dict:
    """The blocks of the Schur-CG solve, and the entering state's cost
    (``cost_in``) from the same residuals."""
    return _linearize_reduced(problem, poses, landmarks, damping, plan, prior_pose)[0]


def _linearize_reduced(problem: BAProblem, poses: Tensor, landmarks: Tensor, damping,
                       plan: SumPlan, prior_pose: Optional[Tensor] = None, reduce=None):
    """(:func:`_linearize`'s blocks, the reduced rhs's correction
    Hpl Hll^-1 bl keyed by keyframe). ``reduce`` (a sharded solve): sums
    (Hpp_obs, bp_obs, the correction) over the shards in one collective;
    ``cost_in`` is then the shard's."""
    K = poses.shape[0]
    obs_parts, odo_parts = _residuals(problem, poses, landmarks)
    Hpp_obs, Hll, Apl, bp_obs, bl = _obs_blocks(obs_parts, plan, K)
    # LM damping on both diagonals
    eye = torch.eye(3, dtype=poses.dtype, device=poses.device)
    Hll_inv = linalg.inv3x3(Hll + damping * eye)
    back = _kf_sum(_matvec(Apl, _matvec(Hll_inv, bl)[problem.obs_lm]), plan, K)
    if reduce is not None:
        Hpp_obs, bp_obs, back = reduce(Hpp_obs, bp_obs, back)
    Hpp_odo, Hij, bp_odo = _odo_blocks(odo_parts, plan)
    Hpp_diag = Hpp_obs + Hpp_odo
    bp = bp_obs + bp_odo
    Hpp_diag[0] += problem.prior_w  # the prior on pose 0 (gauge)
    Hpp_diag = Hpp_diag + damping * eye

    r_obs, _, _, w_obs = obs_parts
    r_odo, _, _, w_odo = odo_parts
    c = _quad(r_obs, w_obs) + _quad(r_odo, w_odo)
    if prior_pose is not None:
        c = c + _prior_cost(problem, poses, prior_pose)
    return dict(Hpp_diag=Hpp_diag, Hll_inv=Hll_inv, Apl=Apl, Hij=Hij, bp=bp, bl=bl,
                cost_in=0.5 * c), back


def _obs_broadcast(v: Tensor, problem: BAProblem, plan: SumPlan) -> Tensor:
    """``v[obs_kf]``: a broadcast under the keyframe-major packing."""
    if plan.kf_width is not None:
        K = v.shape[0]
        return v[:, None, :].expand(K, plan.kf_width, 3).reshape(-1, 3)
    return v[problem.obs_kf]


def _schur_matvec(lin: dict, problem: BAProblem, v: Tensor, plan: SumPlan,
                  reduce=None) -> Tensor:
    """S @ v with S = Hpp - Hpl Hll^-1 Hlp, matrix-free; v [K, 3].
    ``reduce`` (a sharded solve): sums the landmark terms over the shards."""
    K = v.shape[0]
    out = _matvec(lin["Hpp_diag"], v)
    # odometry coupling: out_i += Hij v_j ; out_j += Hij^T v_i
    Hij = lin["Hij"]
    if plan.odo_chain:
        out = out + _chain_pad_i(_matvec(Hij, v[1:])) \
            + _chain_pad_j(_matvec(Hij.transpose(-1, -2), v[:-1]))
    else:
        out = out + seg_sum(_matvec(Hij, v[problem.odo_j]), plan.odo_i)
        out = out + seg_sum(_matvec(Hij.transpose(-1, -2), v[problem.odo_i]), plan.odo_j)
    # - Hpl Hll^-1 Hlp v
    t = _matvec(lin["Apl"].transpose(-1, -2), _obs_broadcast(v, problem, plan))
    u = _matvec(lin["Hll_inv"], seg_sum(t, plan.lm))  # [L, 3]
    back = _kf_sum(_matvec(lin["Apl"], u[problem.obs_lm]), plan, K)
    if reduce is not None:
        (back,) = reduce(back)
    return out - back


def gauge_rotation_mode(poses: Tensor) -> Tensor:
    """The near-flat eigen-direction of the reduced camera system: a global
    rotation of all keyframes about the anchored pose 0. Per keyframe k the
    generator is (-(y_k - y_0), x_k - x_0, 1); normalized."""
    d = poses[:, :2] - poses[0, :2]
    v = torch.stack([-d[:, 1], d[:, 0], torch.ones_like(d[:, 0])], dim=-1)
    return v / torch.linalg.vector_norm(v)


def _safe(d: Tensor) -> Tensor:
    """A denominator kept off zero, on the device."""
    return torch.where(d.abs() < 1e-30, 1e-30, d)


def _pcg(lin: dict, problem: BAProblem, rhs: Tensor, iters: int, plan: SumPlan,
         deflate: Optional[Tensor] = None, reduce=None):
    """Preconditioned CG on the reduced system, block-Jacobi preconditioner
    from the Hpp diagonal blocks. Returns (x, res_hist [iters]).

    ``deflate`` (optional [K, 3]): its 1-D component of the solution is
    computed up front (alpha = v.b / v.Sv) and the Krylov space is kept
    S-orthogonal to it, so a near-flat mode no longer throttles CG.
    ``reduce``: as in :func:`_schur_matvec`."""
    Minv = linalg.inv3x3(lin["Hpp_diag"])

    if deflate is not None:
        v = deflate
        Sv = _schur_matvec(lin, problem, v, plan, reduce)
        safe_vSv = _safe(torch.sum(v * Sv))
        a0 = torch.sum(v * rhs) / safe_vSv
        x = v * a0
        r = rhs - Sv * a0

        def project(z):
            return z - v * (torch.sum(Sv * z) / safe_vSv)
    else:
        x = torch.zeros_like(rhs)
        r = rhs

        def project(z):
            return z

    z = project(_matvec(Minv, r))
    p = z
    rz = torch.sum(r * z)
    res = []
    for _ in range(iters):
        Sp = _schur_matvec(lin, problem, p, plan, reduce)
        alpha = rz / _safe(torch.sum(p * Sp))
        x = x + alpha * p
        r = r - alpha * Sp
        z = project(_matvec(Minv, r))
        rz_new = torch.sum(r * z)
        p = z + (rz_new / _safe(rz)) * p
        rz = rz_new
        res.append(torch.sum(r * r))
    res_hist = torch.stack(res) if res else rhs.new_zeros(0)
    return x, res_hist


def _gn_step(problem: BAProblem, poses: Tensor, landmarks: Tensor, lam: Tensor,
             prior_pose: Tensor, plan: SumPlan, cg_iters: int, deflate_gauge: bool,
             reduce=None):
    """One Schur-CG Gauss-Newton step: (new_poses, new_landmarks, cost_in).
    ``reduce``: as in :func:`_linearize_reduced`, and once per Schur matvec (a
    sharded solve's collectives; ``cost_in`` is then the shard's)."""
    lin, back = _linearize_reduced(problem, poses, landmarks, lam, plan, prior_pose, reduce)
    # the prior residual into bp[0]
    r0 = _wrap_last(prior_pose - poses[0])
    bp = lin["bp"]
    bp[0] += problem.prior_w @ r0
    # reduced rhs: bs = bp - Hpl Hll^-1 bl
    bs = bp - back
    deflate = gauge_rotation_mode(poses) if deflate_gauge else None
    dp, _ = _pcg(lin, problem, bs, cg_iters, plan, deflate, reduce)
    # back-substitute landmarks: dl = Hll^-1 (bl - Hlp dp)
    t = _matvec(lin["Apl"].transpose(-1, -2), _obs_broadcast(dp, problem, plan))
    dl = _matvec(lin["Hll_inv"], lin["bl"] - seg_sum(t, plan.lm))
    return _wrap_last(poses + dp), _wrap_last(landmarks + dl), lin["cost_in"]


def solve(
    problem: BAProblem,
    iters: int = 10,
    cg_iters: int = 50,
    damping: float = 1e-6,
    adaptive: bool = False,
    deflate_gauge: bool = False,
    kf_width: Optional[int] = None,
    odo_chain: bool = False,
):
    """Gauss-Newton / Levenberg-Marquardt with Schur-complement CG on a
    problem of tensors. Returns (poses, landmarks, BAStats).

    ``adaptive``: LM accept/reject — re-evaluate the cost after each step;
    on increase reject the step and raise the damping 10x (capped at 1e4),
    on decrease accept and relax it 2x toward the ``damping`` floor. With
    ``adaptive=False``, fixed-damping GN.

    ``deflate_gauge``: deflate the near-flat global-rotation gauge mode out
    of CG and solve its 1-D component directly (:func:`gauge_rotation_mode`).

    ``kf_width`` / ``odo_chain``: from :func:`prepare`, for a packed
    problem."""
    prior_pose = problem.poses[0]
    lam_floor = problem.poses.new_full((), damping)
    plan = sum_plan(problem, kf_width, odo_chain)
    poses, landmarks, lam = problem.poses, problem.landmarks, lam_floor
    if adaptive:
        last = cost(problem, poses, landmarks, prior_pose)
        history = [last]
        for _ in range(iters):
            new_poses, new_landmarks, _ = _gn_step(
                problem, poses, landmarks, lam, prior_pose, plan, cg_iters, deflate_gauge)
            c = cost(problem, new_poses, new_landmarks, prior_pose)
            accept = c <= last
            poses = torch.where(accept, new_poses, poses)
            landmarks = torch.where(accept, new_landmarks, landmarks)
            lam = torch.where(accept, torch.maximum(lam * 0.5, lam_floor),
                              torch.clamp(lam * 10.0, max=1e4))
            last = torch.where(accept, c, last)
            history.append(last)
    else:
        # the entering-state cost of each linearization is the cost after
        # the previous step; one evaluation after the loop ends the history
        history = []
        for _ in range(iters):
            poses, landmarks, c_in = _gn_step(
                problem, poses, landmarks, lam, prior_pose, plan, cg_iters, deflate_gauge)
            history.append(c_in)
        history.append(cost(problem, poses, landmarks, prior_pose))
    history = torch.stack(history)
    return poses, landmarks, BAStats(
        initial_cost=history[0], final_cost=history[-1], cost_history=history
    )
