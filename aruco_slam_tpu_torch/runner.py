"""Offline replay runner (L4): deterministic, timestamp-driven, batched or
single-stream.

Counterpart of ``aruco_slam_tpu.runner``. The batched path
(``replay_batch``, the JAX ``_replay_batch_kernel``): at image level the frames
first pass through the batched detector (:func:`detect_frames`: K3, the
fused threshold/close/CCL kernel, and the detector's torch stages, chunk by
chunk), which turns them into corner data. The frame loop is then a Python
loop over F frames with the state kept on the device; per frame:

1. compose the frame's encoder ticks into (pose, A, Q) (``ekf.predict_compose``);
2. at corner level, the PnP front-end over every (lane, slot) — K1,
   ``ops.kernels.pnp_frontend``;
3. look up each observation's frame-start slot and sort by (slot, arrival);
4. one EKF frame step — K2, ``ops.kernels.ekf_update_batched``.

The single-stream path (``replay`` / ``replay_sequence``, the JAX
``_replay_jit``) runs per frame the fused predict over the frame's encoder
ticks and then the update that :func:`frame_update_for` picks: K6,
``ops.kernels.ekf_update``, by default.

Nothing in either loop reads a tensor back to the host. On CPU tensors every
kernel takes its plain version, which is how the tests run it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from aruco_slam_tpu_torch.io.sequence import Sequence
from aruco_slam_tpu_torch.models import ekf
from aruco_slam_tpu_torch.ops.camera import CameraIntrinsics
from aruco_slam_tpu_torch.ops.detector import DetectorConfig, detect_markers_batch, to_grayscale
from aruco_slam_tpu_torch.ops.frontend import observations_from_corners
from aruco_slam_tpu_torch.ops.kernels import ekf_update, ekf_update_batched, pnp_frontend
from aruco_slam_tpu_torch.utils import metrics
from aruco_slam_tpu_torch.utils.config import SlamConfig
from aruco_slam_tpu_torch.utils.device import resolve

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
    images: Optional[Tensor] = None  # [F, H, W] uint8 (image level)


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


_LEVELS = ("obs", "corners", "images")


def _check_level(level: str) -> None:
    if level not in _LEVELS:
        raise ValueError(f"level must be one of {_LEVELS}, got {level!r}")


def _to_data(get, level: str, device) -> ReplayData:
    fields = {
        name: torch.as_tensor(np.ascontiguousarray(get(name)), device=device).to(dtype)
        for name, dtype in _FIELDS
    }
    extra = {}
    if level == "corners":
        extra["corners_px"] = torch.as_tensor(
            np.ascontiguousarray(get("corners_px"), np.float32), device=device
        )
    if level == "images":
        extra["images"] = torch.as_tensor(np.ascontiguousarray(get("images")), device=device)
    return ReplayData(**fields, **extra)


def replay_data_from_sequence(seq: Sequence, level: str = "obs", device=None) -> ReplayData:
    """One sequence's replay input (no batch axis), on ``device`` (None:
    the card)."""
    _check_level(level)
    f, epf = seq.num_frames, seq.enc_per_frame
    shaped = {
        "enc_w": seq.enc_w.reshape(f, epf, 2),
        "enc_dt": seq.enc_dt.reshape(f, epf),
    }
    return _to_data(lambda n: shaped.get(n, getattr(seq, n)), level, resolve(device))


def build_batch_data(seqs, batch: int | None = None, level: str = "obs",
                     device=None) -> ReplayData:
    """Stack sequences into a batched ReplayData on ``device`` (None: the
    card), tiling to ``batch`` lanes (ceil-repeat + slice), as the JAX
    package does."""
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

    return _to_data(stack, level, resolve(device))


def _bucket_shape(h: int, w: int, buckets: tuple) -> tuple:
    """Smallest enclosing shape bucket (``DetectorConfig.shape_buckets``),
    or the JAX package's (8, 128)-aligned ceiling past them all; an exact
    bucket hit pads nothing. The port keeps the JAX rule so that both pad a
    frame alike: the padding is part of what the threshold sees."""
    for bh, bw in buckets:
        if h <= bh and w <= bw:
            return bh, bw
    return -(-h // 8) * 8, -(-w // 128) * 128


def _pad_to_bucket(flat: Tensor, bh: int, bw: int) -> Tensor:
    """Edge-replicate a ``[N, h, w]`` stack up to ``[N, bh, bw]`` by a
    clamped-index gather, keeping its dtype. Edge, not zero: a zero pad
    beside bright content reads as foreground to the adaptive threshold."""
    h, w = flat.shape[-2:]
    if (bh, bw) == (h, w):
        return flat
    rows = torch.clamp(torch.arange(bh, device=flat.device), max=h - 1)
    cols = torch.clamp(torch.arange(bw, device=flat.device), max=w - 1)
    return flat.index_select(1, rows).index_select(2, cols)


def _merge_detection_chunks(outs, n: int, h: int, w: int, bh: int, bw: int):
    """Concatenate per-chunk detections and drop those that lie, even
    partly, in a bucket's padded margin."""
    ids = torch.cat([o.ids for o in outs])[:n]
    corners = torch.cat([o.corners for o in outs])[:n]
    valid = torch.cat([o.valid for o in outs])[:n]
    if (bh, bw) != (h, w):
        inside = ((corners[..., 0] <= w - 0.5) & (corners[..., 1] <= h - 0.5)).all(dim=-1)
        valid = valid & inside
    return ids, corners, valid


def detect_frames(images: Tensor, det_cfg: DetectorConfig = DetectorConfig(),
                  chunk: int = 16, reference: bool = False):
    """Batched detection over a stack of frames ``[..., H, W]`` (colour
    ``[..., H, W, 3]`` is converted to luma, BGR order), ``chunk`` frames
    per detector call. A frame's detections do not depend on the chunk, so
    the last chunk is not padded. Frames that are not a shape bucket are
    edge-padded to the smallest enclosing one, and detections that touch
    the padding are dropped. ``reference`` runs the plain detector.

    Returns (ids [..., K], corners [..., K, 4, 2], valid [..., K])."""
    if images.dim() >= 3 and images.shape[-1] == 3:
        images = to_grayscale(images)
    lead = images.shape[:-2]
    h, w = images.shape[-2:]
    bh, bw = _bucket_shape(h, w, det_cfg.shape_buckets)
    flat = _pad_to_bucket(images.reshape(-1, h, w), bh, bw)
    n = flat.shape[0]
    outs = [detect_markers_batch(flat[i: i + chunk], det_cfg, reference)
            for i in range(0, n, chunk)]
    ids, corners, valid = _merge_detection_chunks(outs, n, h, w, bh, bw)
    K = ids.shape[-1]
    return ids.reshape(*lead, K), corners.reshape(*lead, K, 4, 2), valid.reshape(*lead, K)


def _corner_data_from_detections(data: ReplayData, ids, corners, valid) -> ReplayData:
    return data._replace(
        obs_ids=ids, corners_px=corners, obs_valid=valid, images=None,
        obs_z=torch.zeros(*ids.shape, 3, dtype=corners.dtype, device=corners.device),
        obs_R=torch.zeros(*ids.shape, 3, 3, dtype=corners.dtype, device=corners.device),
    )


def replay_batch(
    data: ReplayData,
    config: SlamConfig,
    camera: Optional[CameraIntrinsics] = None,
    level: str = "obs",
    det_cfg: DetectorConfig = DetectorConfig(),
    det_chunk: int = 16,
) -> ReplayResult:
    """Multi-sequence replay: every field of ``data`` carries a leading
    batch axis B. ``level`` "obs" replays the measurement stream, "corners"
    runs the PnP front-end on ``corners_px`` with ``camera``, "images"
    detects markers in ``images`` first (``det_chunk`` frames per detector
    call). The kernels run for CUDA tensors, their plain versions for CPU
    tensors."""
    if level == "images":
        data = _corner_data_from_detections(
            data, *detect_frames(data.images, det_cfg, det_chunk)
        )
        level = "corners"
    return _replay_batch(
        data, config, camera, level,
        pnp_frontend.pnp_frontend_batch, ekf_update_batched.frame_step_batched,
    )


def replay_batch_reference(
    data: ReplayData,
    config: SlamConfig,
    camera: Optional[CameraIntrinsics] = None,
    level: str = "obs",
    det_cfg: DetectorConfig = DetectorConfig(),
    det_chunk: int = 16,
) -> ReplayResult:
    """:func:`replay_batch` through the plain versions of every kernel
    (detector CCL, K1, K2) on any device: what a GPU run of the kernels is
    held against."""
    if level == "images":
        data = _corner_data_from_detections(
            data, *detect_frames(data.images, det_cfg, det_chunk, reference=True)
        )
        level = "corners"
    return _replay_batch(
        data, config, camera, level,
        pnp_frontend.pnp_frontend_reference, ekf_update_batched.frame_step_reference,
    )


def _replay_batch(data, config, camera, level, pnp_fn, step_fn) -> ReplayResult:
    _check_level(level)
    if level == "corners" and camera is None:
        raise ValueError("corner-level replay needs the camera")
    B, F, _ = data.obs_ids.shape
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

    state = ekf.init_state(config, B, data.obs_ids.device, dtype)
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
    return (pose.contiguous(), A.reshape(B, 9).contiguous(), Q.reshape(B, 9), obs.ids, z, R9,
            obs.valid, slots)


def frame_update_for(config: SlamConfig, batched: bool):
    """The frame update ``(state, frame, config) -> state`` that a
    configuration selects (``EkfConfig.fused_update``, ``update_backend``):
    the JAX package's policy, read for this card.

    - ``fused_update``: ``ekf.update_fused``, the block-LDL form
      (single-stream);
    - ``update_backend == "xla"``: ``ekf.update``, the plain sequential
      update;
    - ``"auto"`` or ``"pallas"`` (the hand-written kernel), batched: K2 with
      no encoder ticks (:func:`update_batched`);
    - ``"auto"`` or ``"pallas"``, single-stream: K6
      (``ops.kernels.ekf_update.frame_update``), at every ``max_landmarks``.

    The kernels take their plain versions for CPU tensors."""
    if config.ekf.fused_update:
        return ekf.update_fused
    backend = config.ekf.update_backend
    if backend == "xla":
        return ekf.update
    if backend not in ("auto", "pallas"):
        raise ValueError(f"update_backend must be 'auto', 'pallas' or 'xla', got {backend!r}")
    return update_batched if batched else ekf_update.frame_update


def update_batched(state: ekf.EkfState, frame: ekf.FrameObservations,
                   config: SlamConfig) -> ekf.EkfState:
    """``ekf.update`` for B lanes through K2: its frame step with no
    encoder ticks (A = I and Q = 0 leave sigma exactly as it was). A lane
    with no encoder tick yet keeps its state."""
    none = torch.zeros(frame.ids.shape[0], 0, dtype=state.mu.dtype, device=state.mu.device)
    args = frame_step_inputs(state, frame, ekf.Control(none, none, none), config)
    return ekf.keep_uninitialized(
        ekf_update_batched.frame_step_batched(state, *args, config=config), state
    )


def replay(
    data: ReplayData,
    config: SlamConfig,
    camera: Optional[CameraIntrinsics] = None,
    level: str = "obs",
    det_cfg: DetectorConfig = DetectorConfig(),
    det_chunk: int = 16,
) -> ReplayResult:
    """One sequence (``data`` without a batch axis): per frame the fused
    predict over the frame's encoder ticks, then the update of
    ``frame_update_for(config, batched=False)``, K6 by default. At corner
    level the front-end is ``ops.frontend.observations_from_corners``, as
    in the JAX single-stream replay; at image level the frames are detected
    first (:func:`detect_frames`). Trajectory [F, 3], pose_cov [F, 3, 3],
    n_landmarks [F]; the final state keeps its batch axis of one."""
    if level == "images":
        data = _corner_data_from_detections(
            data, *detect_frames(data.images, det_cfg, det_chunk)
        )
        level = "corners"
    return _replay_single(data, config, camera, level, frame_update_for(config, batched=False))


def replay_reference(
    data: ReplayData,
    config: SlamConfig,
    camera: Optional[CameraIntrinsics] = None,
    level: str = "obs",
    det_cfg: DetectorConfig = DetectorConfig(),
    det_chunk: int = 16,
) -> ReplayResult:
    """:func:`replay` through the plain versions on any device: the plain
    detector and the plain sequential update ``ekf.update``, whatever the
    config's backend. What a GPU run of the single-stream path is held
    against."""
    if level == "images":
        data = _corner_data_from_detections(
            data, *detect_frames(data.images, det_cfg, det_chunk, reference=True)
        )
        level = "corners"
    return _replay_single(data, config, camera, level, ekf.update)


def _replay_single(data, config, camera, level, update_fn) -> ReplayResult:
    _check_level(level)
    if level == "corners" and camera is None:
        raise ValueError("corner-level replay needs the camera")
    state = ekf.init_state(config, 1, data.obs_ids.device)
    traj, covs, n_lm = [], [], []
    for f in range(data.obs_ids.shape[0]):
        ew = data.enc_w[f][None]
        state = ekf.predict_block(
            state, ekf.Control(ew[..., 0], ew[..., 1], data.enc_dt[f][None]), config
        )
        ids, valid = data.obs_ids[f][None], data.obs_valid[f][None]
        if level == "corners":
            frame = observations_from_corners(ids, data.corners_px[f][None], valid, camera, config)
        else:
            frame = ekf.FrameObservations(ids, data.obs_z[f][None], data.obs_R[f][None], valid)
        state = update_fn(state, frame, config)
        traj.append(state.mu[0, :3])
        covs.append(state.sigma[0, :3, :3])
        n_lm.append(state.n_landmarks[0])
    return ReplayResult(
        trajectory=torch.stack(traj),
        pose_cov=torch.stack(covs),
        n_landmarks=torch.stack(n_lm),
        final_state=state,
    )


def replay_sequence(
    seq: Sequence,
    config: SlamConfig,
    camera: Optional[CameraIntrinsics] = None,
    level: str = "obs",
    det_cfg: DetectorConfig = DetectorConfig(),
    det_chunk: int = 16,
    device=None,
) -> ReplayResult:
    """:func:`replay` straight from a :class:`Sequence`, on ``device``
    (None: the card), with the sequence's own camera unless one is given."""
    if camera is None:
        camera = seq.camera()
    if level == "images" and seq.images is None and seq.meta.get("images_asq_path"):
        raise NotImplementedError(
            f"{seq.meta['images_asq_path']}: the .asq image container is not ported yet "
            "(ROADMAP Queue 1)"
        )
    data = replay_data_from_sequence(seq, level, device)
    return replay(data, config, camera, level, det_cfg, det_chunk)


def evaluate_sequence(
    seq: Sequence,
    config: SlamConfig,
    camera: Optional[CameraIntrinsics] = None,
    level: str = "obs",
    det_cfg: DetectorConfig = DetectorConfig(),
    result: Optional[ReplayResult] = None,
    device=None,
) -> dict:
    """Replay (:func:`replay_sequence`, on ``device``; None: the card) +
    score against the sequence's ground truth (host-side). Pass ``result``
    (from :func:`replay`) to score an existing replay."""
    if result is None:
        result = replay_sequence(seq, config, camera, level, det_cfg, device=device)
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
