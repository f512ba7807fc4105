"""Distributed bundle adjustment (L6) — counterpart of
``aruco_slam_tpu.parallel.dist_ba`` (BASELINE.md config 5), over a
``torch.distributed`` process group.

The layout is the JAX package's:

- **Landmarks are partitioned** across the ranks (LPT on observation
  counts, :func:`partition_problem`); every rank owns ``Ls`` landmark slots.
- **Observations live with their landmark's owner**, so each landmark's
  Schur elimination (its 3x3 Hll inverse, bl, back-substitution) is local.
- **Keyframe poses are replicated**, as are the odometry factors and the
  prior.

Every rank runs :func:`solve_dist` on its shard, and the ranks meet only at
JAX's points, each one ``mesh.all_reduce``: the shard's marker cost in each
cost evaluation; ONE packed sum per Gauss-Newton step of the step's
marker Hpp diagonal [K, 3, 3], marker rhs [K, 3] and reduced-rhs correction
[K, 3]; one [K, 3] sum per Schur matvec. A solve therefore issues
``iters * (cg_iters + 2) + 1`` all-reduces per rank (``iters`` more under
``deflate_gauge``), and after the loop one all-gather of the landmarks.

The step itself is the port's single-device one (``ba._gn_step`` with the
collective as its ``reduce`` hook). The JAX package's gather tables
(``kf_rows``, ``lm_sort_rows``, ``lm_flags``, ``lm_ends``) are not ported:
each rank plans its keyed sums from its own observations (``ba.sum_plan``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from aruco_slam_tpu_torch import convert
from aruco_slam_tpu_torch.models import ba
from aruco_slam_tpu_torch.models.ba import BAProblem
from aruco_slam_tpu_torch.parallel import mesh

Tensor = torch.Tensor


class ShardedBAProblem(NamedTuple):
    """A host-partitioned problem (numpy). D shards on the leading axis of
    the sharded fields; Ls landmark slots and Ns observation slots a shard
    (the unused ones zero, their observations not valid)."""

    poses: np.ndarray  # [K, 3] replicated
    landmarks: np.ndarray  # [D, Ls, 3]
    obs_kf: np.ndarray  # [D, Ns]
    obs_lm: np.ndarray  # [D, Ns] the landmark's slot within its shard
    obs_z: np.ndarray  # [D, Ns, 3]
    obs_w: np.ndarray  # [D, Ns, 3, 3]
    obs_valid: np.ndarray  # [D, Ns]
    odo_i: np.ndarray  # [M] replicated
    odo_j: np.ndarray
    odo_z: np.ndarray
    odo_w: np.ndarray
    odo_valid: np.ndarray
    prior_w: np.ndarray  # [3, 3]


_SHARDED = ("landmarks", "obs_kf", "obs_lm", "obs_z", "obs_w", "obs_valid")


def partition_problem(problem: BAProblem, n_shards: int) -> tuple[ShardedBAProblem, np.ndarray]:
    """Partition the landmarks over ``n_shards`` and route each valid
    observation to its landmark's owner. Returns (sharded, lm_perm):
    ``lm_perm`` maps a global landmark slot to its row in the concatenated
    [D * Ls] landmarks that :func:`solve_dist` returns.

    The assignment is the JAX package's LPT (longest processing time) on
    observation counts with a capacity of ceil(L / D) landmarks a shard,
    landmark by landmark in decreasing count, so both packages give the
    same shards."""
    L = problem.landmarks.shape[0]
    Ls = -(-L // n_shards)

    obs_kf = np.asarray(problem.obs_kf)
    obs_lm = np.asarray(problem.obs_lm)
    obs_valid = np.asarray(problem.obs_valid)
    counts_lm = np.bincount(obs_lm[obs_valid], minlength=L)
    lm_owner = np.empty(L, np.int64)
    lm_local = np.empty(L, np.int64)
    loads = np.zeros(n_shards, np.int64)
    filled = np.zeros(n_shards, np.int64)
    for lm in np.argsort(-counts_lm, kind="stable"):
        open_shards = np.nonzero(filled < Ls)[0]
        d = open_shards[np.argmin(loads[open_shards])]
        lm_owner[lm] = d
        lm_local[lm] = filled[d]
        filled[d] += 1
        loads[d] += counts_lm[lm]

    owner = lm_owner[obs_lm]
    Ns = max(1, max(int(np.sum((owner == d) & obs_valid)) for d in range(n_shards)))

    def shard_field(arr, sel):
        out = np.zeros((Ns, *arr.shape[1:]), dtype=arr.dtype)
        out[: sel.sum()] = arr[sel]
        return out

    landmarks = np.asarray(problem.landmarks)
    local_lm = lm_local[obs_lm].astype(np.int32)
    fields = {name: [] for name in _SHARDED}
    for d in range(n_shards):
        sel = (owner == d) & obs_valid
        fields["obs_kf"].append(shard_field(obs_kf, sel))
        fields["obs_lm"].append(shard_field(local_lm, sel))
        fields["obs_z"].append(shard_field(np.asarray(problem.obs_z), sel))
        fields["obs_w"].append(shard_field(np.asarray(problem.obs_w), sel))
        fields["obs_valid"].append(np.arange(Ns) < sel.sum())
        block = np.zeros((Ls, 3), landmarks.dtype)
        mine = np.nonzero(lm_owner == d)[0]
        block[lm_local[mine]] = landmarks[mine]
        fields["landmarks"].append(block)
    sharded = ShardedBAProblem(
        **{name: np.stack(v) for name, v in fields.items()},
        **{name: np.asarray(getattr(problem, name))
           for name in ShardedBAProblem._fields if name not in _SHARDED},
    )
    return sharded, lm_owner * Ls + lm_local


def shard(sharded: ShardedBAProblem, rank: int, device=None) -> BAProblem:
    """Shard ``rank`` as a tensor :class:`BAProblem` on ``device`` (None:
    the card), keyed by its own landmark slots: the ``local`` argument of
    :func:`solve_dist`."""
    return convert.ba_problem_from_numpy(BAProblem(**{
        name: getattr(sharded, name)[rank] if name in _SHARDED else getattr(sharded, name)
        for name in BAProblem._fields
    }), device)


def _cost(local: BAProblem, poses: Tensor, landmarks: Tensor, prior_pose: Tensor,
          group) -> Tensor:
    """The whole problem's cost: the shards' marker costs summed over the
    ranks (one all-reduce), the replicated odometry and prior added."""
    (r_obs, _, _, w_obs), (r_odo, _, _, w_odo) = ba._residuals(local, poses, landmarks)
    (c_obs,) = mesh.all_reduce(ba._quad(r_obs, w_obs), group=group)
    return 0.5 * (c_obs + ba._quad(r_odo, w_odo) + ba._prior_cost(local, poses, prior_pose))


def solve_dist(local: BAProblem, iters: int = 10, cg_iters: int = 50, damping: float = 1e-6,
               adaptive: bool = False, deflate_gauge: bool = False, group=None):
    """Distributed Schur-CG Gauss-Newton, run by every rank of ``group``
    (None: the default group) on its shard (:func:`shard`). Returns
    (poses [K, 3], landmarks [D * Ls, 3], cost_history [iters + 1]), the
    same on every rank; ``landmarks[lm_perm]`` is in global slot order.

    ``adaptive`` / ``deflate_gauge`` are :func:`ba.solve`'s (LM
    accept/reject; the gauge-rotation mode deflated out of the CG). The
    history is the cost after each step (the entering cost under
    ``adaptive`` when a step is rejected), as the JAX package's."""
    reduce = functools.partial(mesh.all_reduce, group=group)
    plan = ba.sum_plan(local, odo_chain=ba.odo_is_chain(local))
    prior_pose = local.poses[0]
    lam_floor = local.poses.new_full((), damping)
    poses, landmarks, lam = local.poses, local.landmarks, lam_floor
    last = _cost(local, poses, landmarks, prior_pose, group)
    history = [last]
    for _ in range(iters):
        new_poses, new_landmarks, _ = ba._gn_step(
            local, poses, landmarks, lam, prior_pose, plan, cg_iters, deflate_gauge, reduce)
        c = _cost(local, new_poses, new_landmarks, prior_pose, group)
        if adaptive:
            accept = c <= last
            poses = torch.where(accept, new_poses, poses)
            landmarks = torch.where(accept, new_landmarks, landmarks)
            lam = torch.where(accept, torch.maximum(lam * 0.5, lam_floor),
                              torch.clamp(lam * 10.0, max=1e4))
            last = torch.where(accept, c, last)
        else:
            poses, landmarks, last = new_poses, new_landmarks, c
        history.append(last)
    return poses, mesh.all_gather(landmarks, group=group), torch.stack(history)
