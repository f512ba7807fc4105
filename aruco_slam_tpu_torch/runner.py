"""Offline replay runner (L4): deterministic, timestamp-driven, batched.

Counterpart of ``aruco_slam_tpu.runner``'s batched kernel path
(``replay_batch`` -> ``_replay_batch_kernel``). The frame loop is a Python
loop over F frames with the state kept on the device; per frame:

1. compose the frame's encoder ticks into (pose, A, Q) (``ekf.predict_compose``);
2. at corner level, the PnP front-end over every (lane, slot) — K1,
   ``ops.kernels.pnp_frontend``;
3. look up each observation's frame-start slot and sort by (slot, arrival);
4. one EKF frame step — K2, ``ops.kernels.ekf_update_batched``.

Nothing in the loop reads a tensor back to the host. On CPU tensors both
kernels take their plain versions, which is how the tests run it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from aruco_slam_tpu_torch.io.sequence import Sequence
from aruco_slam_tpu_torch.models import ekf
from aruco_slam_tpu_torch.ops.camera import CameraIntrinsics
from aruco_slam_tpu_torch.ops.kernels import ekf_update_batched, pnp_frontend
from aruco_slam_tpu_torch.utils import metrics
from aruco_slam_tpu_torch.utils.config import SlamConfig

Tensor = torch.Tensor


class ReplayData(NamedTuple):
    """Replay input: F frames, epf encoder ticks per frame, M marker slots
    per frame; a leading batch axis B where the function says so."""

    enc_w: Tensor  # [F, epf, 2] float32
    enc_dt: Tensor  # [F, epf] float32
    obs_ids: Tensor  # [F, M] int32
    obs_z: Tensor  # [F, M, 3] float32 (measurement level)
    obs_R: Tensor  # [F, M, 3, 3] float32
    obs_valid: Tensor  # [F, M] bool
    corners_px: Optional[Tensor] = None  # [F, M, 4, 2] float32 (corner level)


class ReplayResult(NamedTuple):
    trajectory: Tensor  # [B, F, 3] pose after each frame's update
    pose_cov: Tensor  # [B, F, 3, 3]
    n_landmarks: Tensor  # [B, F]
    final_state: ekf.EkfState


_FIELDS = (
    ("enc_w", torch.float32), ("enc_dt", torch.float32),
    ("obs_ids", torch.int32), ("obs_z", torch.float32),
    ("obs_R", torch.float32), ("obs_valid", torch.bool),
)


def _check_level(level: str) -> None:
    if level not in ("obs", "corners"):
        raise NotImplementedError(
            f"level={level!r}: image-level replay waits for the detector port "
            "(ROADMAP Queue 1, item 6)"
        )


def _to_data(get, level: str, device) -> ReplayData:
    fields = {
        name: torch.as_tensor(np.ascontiguousarray(get(name)), device=device).to(dtype)
        for name, dtype in _FIELDS
    }
    corners = None
    if level == "corners":
        corners = torch.as_tensor(
            np.ascontiguousarray(get("corners_px"), np.float32), device=device
        )
    return ReplayData(**fields, corners_px=corners)


def replay_data_from_sequence(seq: Sequence, level: str = "obs", device=None) -> ReplayData:
    """One sequence's replay input (no batch axis)."""
    _check_level(level)
    f, epf = seq.num_frames, seq.enc_per_frame
    shaped = {
        "enc_w": seq.enc_w.reshape(f, epf, 2),
        "enc_dt": seq.enc_dt.reshape(f, epf),
    }
    return _to_data(lambda n: shaped.get(n, getattr(seq, n)), level, device)


def build_batch_data(seqs, batch: int | None = None, level: str = "obs",
                     device=None) -> ReplayData:
    """Stack sequences into a batched ReplayData on ``device``, tiling to
    ``batch`` lanes (ceil-repeat + slice), as the JAX package does."""
    _check_level(level)
    if batch is None:
        batch = len(seqs)
    f, epf = seqs[0].num_frames, seqs[0].enc_per_frame
    reps = -(-batch // len(seqs))

    def stack(name):
        arr = np.concatenate([np.stack([getattr(s, name) for s in seqs])] * reps)[:batch]
        if name == "enc_w":
            return arr.reshape(batch, f, epf, 2)
        if name == "enc_dt":
            return arr.reshape(batch, f, epf)
        return arr

    return _to_data(stack, level, device)


def replay_batch(
    data: ReplayData,
    config: SlamConfig,
    camera: Optional[CameraIntrinsics] = None,
    level: str = "obs",
) -> ReplayResult:
    """Multi-sequence replay: every field of ``data`` carries a leading
    batch axis B. ``level`` "obs" replays the measurement stream, "corners"
    runs the PnP front-end on ``corners_px`` with ``camera``. The kernels
    run for CUDA tensors, their plain versions for CPU tensors."""
    return _replay_batch(
        data, config, camera, level,
        pnp_frontend.pnp_frontend_batch, ekf_update_batched.frame_step_batched,
    )


def replay_batch_reference(
    data: ReplayData,
    config: SlamConfig,
    camera: Optional[CameraIntrinsics] = None,
    level: str = "obs",
) -> ReplayResult:
    """:func:`replay_batch` through the plain versions of both kernels on
    any device: what a GPU run of the kernels is held against."""
    return _replay_batch(
        data, config, camera, level,
        pnp_frontend.pnp_frontend_reference, ekf_update_batched.frame_step_reference,
    )


def _replay_batch(data, config, camera, level, pnp_fn, step_fn) -> ReplayResult:
    _check_level(level)
    if level == "corners" and camera is None:
        raise ValueError("corner-level replay needs the camera")
    B, F, _ = data.obs_ids.shape
    device = data.obs_ids.device
    dtype = torch.float32

    # time-major once per replay, so each frame's slice is contiguous
    def tm(x):
        return x.transpose(0, 1).contiguous()

    enc_w, enc_dt = tm(data.enc_w), tm(data.enc_dt)
    ids_f, valid_f = tm(data.obs_ids), tm(data.obs_valid)
    if level == "corners":
        corners_f = tm(data.corners_px)
    else:
        z_f, R_f = tm(data.obs_z), tm(data.obs_R)

    state = ekf.init_state(config, B, device, dtype)
    traj, covs, n_lm = [], [], []
    for f in range(F):
        if level == "corners":
            z, R, valid = pnp_fn(corners_f[f], valid_f[f], camera, config)
        else:
            z, R, valid = z_f[f], R_f[f], valid_f[f]
        frame = ekf.FrameObservations(ids_f[f], z, R, valid)
        controls = ekf.Control(enc_w[f, :, :, 0], enc_w[f, :, :, 1], enc_dt[f])
        state = step_fn(state, *frame_step_inputs(state, frame, controls, config),
                        config=config)
        state = state._replace(initialized=torch.ones_like(state.initialized))
        traj.append(state.mu[:, :3])
        covs.append(state.sigma[:, :3, :3])
        n_lm.append(state.n_landmarks)
    return ReplayResult(
        trajectory=torch.stack(traj, dim=1),
        pose_cov=torch.stack(covs, dim=1),
        n_landmarks=torch.stack(n_lm, dim=1),
        final_state=state,
    )


def frame_step_inputs(state: ekf.EkfState, frame: ekf.FrameObservations,
                      controls: ekf.Control, config: SlamConfig):
    """The torch glue before a frame step: compose the frame's encoder
    ticks, look up each observation's frame-start slot, sort, and sanitise.
    Returns the K2 arguments (pose, A, Q, ids, z, R9, valid, slots)."""
    B, M = frame.ids.shape
    pose, A, Q = ekf.predict_compose(
        state.mu[:, :3], state.initialized, controls, config
    )
    obs, slots = ekf.sort_observations(frame, ekf.lookup_slots(state.slot_ids, frame.ids))
    # Sanitize invalid slots: the kernel skips them, but a NaN from PnP on
    # padded corners must not reach any arithmetic.
    ok = obs.valid[..., None]
    eye9 = torch.eye(3, dtype=state.mu.dtype, device=state.mu.device).reshape(9)
    z = torch.where(ok, obs.z, 0.0).to(state.mu.dtype)
    R9 = torch.where(ok, obs.R.reshape(B, M, 9), eye9).to(state.mu.dtype)
    return pose, A.reshape(B, 9), Q.reshape(B, 9), obs.ids, z, R9, obs.valid, slots


def replay(
    data: ReplayData,
    config: SlamConfig,
    camera: Optional[CameraIntrinsics] = None,
    level: str = "obs",
) -> ReplayResult:
    """One sequence (``data`` without a batch axis) as a batch of one.
    Trajectory [F, 3], pose_cov [F, 3, 3], n_landmarks [F]; the final state
    keeps its batch axis of one."""
    res = replay_batch(
        ReplayData(*(None if x is None else x[None] for x in data)),
        config, camera, level,
    )
    return ReplayResult(res.trajectory[0], res.pose_cov[0], res.n_landmarks[0],
                        res.final_state)


def evaluate_sequence(
    seq: Sequence,
    config: SlamConfig,
    camera: Optional[CameraIntrinsics] = None,
    level: str = "obs",
    result: Optional[ReplayResult] = None,
    device=None,
) -> dict:
    """Replay + score against the sequence's ground truth (host-side).
    Pass ``result`` (from :func:`replay`) to score an existing replay."""
    if camera is None:
        camera = seq.camera()
    if result is None:
        result = replay(replay_data_from_sequence(seq, level, device), config,
                        camera, level)
    traj = result.trajectory.detach().cpu()
    st = result.final_state
    out = {"n_landmarks": int(st.n_landmarks[0])}
    if seq.true_pose_frames is not None:
        true = torch.as_tensor(seq.true_pose_frames)
        out["ate"] = float(metrics.ate(traj, true))
        out["ate_aligned"] = float(metrics.ate(traj, true, align=True))
        t_rpe, r_rpe = metrics.rpe(traj, true)
        out["rpe_trans"] = float(t_rpe)
        out["rpe_rot"] = float(r_rpe)
    if seq.true_landmarks is not None:
        lms, ids, active = ekf.get_map(st, config)
        rmse, n = metrics.map_error(
            lms[0].cpu(), ids[0].cpu(), active[0].cpu(),
            torch.as_tensor(seq.true_landmarks),
            torch.as_tensor(seq.true_landmark_ids),
        )
        out["map_rmse"] = float(rmse)
        out["map_matched"] = int(n)
    out["diverged"] = int(st.diverged[0])
    out["dropped"] = int(st.dropped[0])
    return out
