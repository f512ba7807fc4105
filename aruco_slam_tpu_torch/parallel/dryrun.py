"""The entry points of the JAX package's ``__graft_entry__``, ported:

- :func:`entry`: one single-chip EKF-SLAM frame step and its example
  inputs;
- :func:`dryrun_multichip`: one sharded step of every multi-rank path, on
  ``n`` ranks of ``torch.distributed`` (:func:`launch.run_ranks`) instead
  of an n-device mesh.

Each rank of the dry run runs three legs:

(a) data-parallel batched replay (:func:`runner.replay_sharded`) of n
    synthetic 1 s sequences, one lane a rank;
(b) the distributed Schur-complement BA (:func:`dist_ba.solve_dist`) on
    ``synthetic_ba_problem(4n, 2n, 3)`` (2 observations a keyframe at
    n = 1), 2 GN x 8 CG;
(c) rendered 640x480 frames detected sharded (:func:`runner.detect_frames`
    with the group), then the corner-level replay sharded.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from aruco_slam_tpu_torch import runner
from aruco_slam_tpu_torch.models import ekf, graph_builder
from aruco_slam_tpu_torch.ops.camera import CameraIntrinsics
from aruco_slam_tpu_torch.ops.detector import DetectorConfig
from aruco_slam_tpu_torch.ops.kernels import ekf_update
from aruco_slam_tpu_torch.parallel import dist_ba, launch
from aruco_slam_tpu_torch.sim import synthetic
from aruco_slam_tpu_torch.utils.config import EkfConfig, SlamConfig
from aruco_slam_tpu_torch.utils.device import resolve


def _example_frame(m: int, rng: np.random.Generator, dev: torch.device) -> ekf.FrameObservations:
    """A frame of ``m`` slots, the first 4 valid (markers 0-3), drawn as
    the JAX package's ``__graft_entry__._example_frame`` draws it."""
    ids = np.full((m,), -1, np.int32)
    ids[:4] = np.arange(4)
    z = rng.uniform(0.3, 2.0, size=(m, 3)).astype(np.float32)
    R = np.tile(np.eye(3, dtype=np.float32) * 0.05, (m, 1, 1))
    valid = np.zeros((m,), bool)
    valid[:4] = True
    return ekf.FrameObservations(*(torch.as_tensor(x, device=dev)[None]
                                   for x in (ids, z, R, valid)))


def entry(device=None) -> tuple:
    """(fn, example_args): one EKF-SLAM frame step on ``device`` (None: the
    card), a predict over 10 encoder ticks and then the sequential masked
    update of 8 observation slots, on an initialized state of 32 landmark
    slots. ``fn`` is :func:`ekf_update.frame_step` (K6 on the card, its
    plain version on the CPU): ``fn(*example_args)`` returns the new
    state. The inputs are those of the JAX package's ``entry()``, from
    ``np.random.default_rng(0)`` in the same order."""
    dev = resolve(device)
    cfg = SlamConfig(ekf=EkfConfig(max_landmarks=32, max_observations_per_frame=8))
    rng = np.random.default_rng(0)
    state = ekf.init_state(cfg, 1, dev)
    state = state._replace(initialized=torch.ones_like(state.initialized))
    epf = 10
    w = torch.as_tensor(rng.uniform(0.5, 2.0, size=(epf, 2)).astype(np.float32), device=dev)
    controls = ekf.Control(w[None, :, 0], w[None, :, 1],
                           torch.full((1, epf), 0.01, device=dev))
    return ekf_update.frame_step, (state, _example_frame(8, rng, dev), controls, cfg)


class DryRun(NamedTuple):
    """What one rank saw."""

    device: torch.device
    replay_shape: tuple  # (a) trajectory [n, F, 3]
    ba_poses_shape: tuple  # (b) [4n, 3]
    ba_history: np.ndarray  # (b) [3]
    detections: int  # (c) valid detections over all frames
    image_replay_shape: tuple  # (c) trajectory [n, F, 3]


def _rank(rank: int, world: int, dev: torch.device) -> DryRun:
    group = dist.group.WORLD
    cfg = SlamConfig(ekf=EkfConfig(max_landmarks=8, max_observations_per_frame=4))
    seqs = [synthetic.generate_sequence(synthetic.SimParams(duration=1.0, seed=s, max_obs=4))
            for s in range(world)]
    out = runner.replay_sharded(runner.build_batch_data(seqs, device="cpu"), cfg, device=dev)
    if not bool(torch.isfinite(out.trajectory).all()):
        raise AssertionError("(a) sharded replay: non-finite trajectory")

    problem, _, _ = graph_builder.synthetic_ba_problem(  # one rank sees its 2 landmarks
        n_keyframes=4 * world, n_landmarks=2 * world, obs_per_kf=min(3, 2 * world), seed=0)
    sharded, _ = dist_ba.partition_problem(problem, world)
    poses, _, history = dist_ba.solve_dist(dist_ba.shard(sharded, rank, dev), iters=2,
                                           cg_iters=8, damping=1e-4)
    if not bool(torch.isfinite(poses).all()):
        raise AssertionError("(b) distributed BA: non-finite poses")

    cam = CameraIntrinsics.create(600.0, 600.0, 320.0, 240.0)
    icfg = SlamConfig(ekf=EkfConfig(max_landmarks=16, max_observations_per_frame=8))
    img_seqs = [
        synthetic.generate_sequence(
            synthetic.SimParams(duration=0.6, seed=s, frames_per_sec=5.0, max_obs=8),
            level="images", camera=cam, device=dev)
        for s in range(2)
    ]
    data = runner.build_batch_data(img_seqs, world, "images", dev)
    ids, corners, valid = runner.detect_frames(data.images, DetectorConfig(), group=group)
    corner_data = runner._corner_data_from_detections(data, ids, corners, valid)
    img_out = runner.replay_sharded(corner_data, icfg, cam, "corners", device=dev)
    if not bool(torch.isfinite(img_out.trajectory).all()):
        raise AssertionError("(c) image-level sharded replay: non-finite trajectory")
    return DryRun(dev, tuple(out.trajectory.shape), tuple(poses.shape),
                  history.cpu().numpy(), int(valid.sum()), tuple(img_out.trajectory.shape))


def dryrun_multichip(n: int, device=None) -> tuple:
    """Run the three legs on ``n`` ranks on ``device`` (None: the card;
    ``nccl`` when every rank has a card, else ``gloo``) and return each
    rank's :class:`DryRun`. Raises if a rank fails."""
    return tuple(launch.run_ranks(_rank, n, device=device))
