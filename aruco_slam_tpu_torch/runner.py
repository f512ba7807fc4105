"""Offline replay runner (L4): deterministic, timestamp-driven, batched or
single-stream.

Counterpart of ``aruco_slam_tpu.runner``. The batched path
(``replay_batch``, the JAX ``_replay_batch_kernel``): at image level the frames
first pass through the batched detector (:func:`detect_frames`: K3, the
fused threshold/close/CCL kernel, and the detector's torch stages, chunk by
chunk), which turns them into corner data. The frame loop is then a Python
loop over F frames with the state kept on the device; per frame, on the
card, two launches:

1. at corner level, the PnP front-end over every (lane, slot) — K1,
   ``ops.kernels.pnp_frontend``;
2. the whole EKF frame step from the raw frame — K2,
   ``ops.kernels.ekf_update_batched``: the compose of the frame's encoder
   ticks, the slot lookup and (slot, arrival) sort, the predict, the
   sequential update, and the frame's rows of the outputs, which are
   allocated once per replay. The state alternates between two buffers.

The single-stream path (``replay`` / ``replay_sequence``, the JAX
``_replay_jit``) runs per frame the step that :func:`frame_step_for` picks:
by default K6 (``ops.kernels.ekf_update.frame_step``), the predict over the
frame's encoder ticks, the update and the frame's rows in one launch, the
frames read from the replay's time-major arrays (``ekf_update.replay_step``,
its inputs checked once); under ``update_backend
"xla"`` or ``fused_update`` the predict in torch ops and that update.

Nothing in either loop reads a tensor back to the host. On CPU tensors every
kernel takes its plain version, which is how the tests run it.

Across ranks of a ``torch.distributed`` group (``parallel.mesh``),
:func:`replay_sharded` replays a block of lanes a rank and
:func:`detect_frames` with ``group`` a block of frames a rank; both
all-gather, so every rank returns the whole result. :func:`detect_frames_asq`
streams the frames of an ``.asq`` container (``io.native_seqio``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from aruco_slam_tpu_torch.io.sequence import Sequence
from aruco_slam_tpu_torch.models import ekf
from aruco_slam_tpu_torch.ops.camera import CameraIntrinsics
from aruco_slam_tpu_torch.ops.detector import DetectorConfig, detect_markers_batch, to_grayscale
from aruco_slam_tpu_torch.ops.frontend import observations_from_corners
from aruco_slam_tpu_torch.ops.kernels import ekf_update, ekf_update_batched, pnp_frontend
from aruco_slam_tpu_torch.parallel import mesh
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
                  chunk: int = 16, reference: bool = False, group=None):
    """Batched detection over a stack of frames ``[..., H, W]`` (colour
    ``[..., H, W, 3]`` is converted to luma, BGR order), ``chunk`` frames
    per detector call. A frame's detections do not depend on the chunk, so
    the last chunk is not padded. Frames that are not a shape bucket are
    edge-padded to the smallest enclosing one, and detections that touch
    the padding are dropped. ``reference`` runs the plain detector.

    With ``group`` (a ``torch.distributed`` group, every rank passing the
    same stack) each rank detects its contiguous block of ceil(n / world)
    frames (the last block filled up with copies of the last frame) and
    the blocks are all-gathered: every rank returns the whole result, equal
    to the unsharded call's.

    Returns (ids [..., K], corners [..., K, 4, 2], valid [..., K])."""
    if images.dim() >= 3 and images.shape[-1] == 3:
        images = to_grayscale(images)
    lead = images.shape[:-2]
    h, w = images.shape[-2:]
    bh, bw = _bucket_shape(h, w, det_cfg.shape_buckets)
    flat = images.reshape(-1, h, w)
    n = flat.shape[0]
    rank, world = mesh.rank_world(group) if group is not None else (0, 1)
    per = -(-n // world)
    if world > 1:
        block = torch.clamp(torch.arange(rank * per, (rank + 1) * per), max=n - 1)
        flat = flat.index_select(0, block.to(flat.device))
    flat = _pad_to_bucket(flat, bh, bw)
    outs = [detect_markers_batch(flat[i: i + chunk], det_cfg, reference)
            for i in range(0, per, chunk)]
    ids, corners, valid = _merge_detection_chunks(outs, per, h, w, bh, bw)
    if world > 1:
        ids, corners, valid = (mesh.all_gather(x, group=group)[:n] for x in (ids, corners, valid))
    K = ids.shape[-1]
    return ids.reshape(*lead, K), corners.reshape(*lead, K, 4, 2), valid.reshape(*lead, K)


def detect_frames_asq(path: str, det_cfg: DetectorConfig = DetectorConfig(),
                      chunk: int = 16, device=None):
    """:func:`detect_frames` streamed from an ``.asq`` container
    (``io.native_seqio``) on ``device`` (None: the card): the prefetcher's
    threads read ahead while earlier chunks are detected, and the stack is
    never held whole on the host. Same bucketing, edge padding and margin
    drop as :func:`detect_frames`.

    Returns (ids [F, K], corners [F, K, 4, 2], valid [F, K])."""
    from aruco_slam_tpu_torch.io.native_seqio import NativeSequenceReader

    device = resolve(device)
    outs = []
    with NativeSequenceReader(path) as r:
        h, w = r.height, r.width
        bh, bw = _bucket_shape(h, w, det_cfg.shape_buckets)
        buf = np.empty((chunk, h, w), np.uint8)
        count = n = 0
        for _, frame in r.iter_prefetched(queue=2 * chunk):
            buf[count] = frame
            count += 1
            n += 1
            if count == chunk or n == r.n_frames:
                # A copy that has finished when it returns (pageable memory,
                # and copy=True on the CPU), so the buffer may be refilled
                # for the next chunk at once.
                frames = torch.from_numpy(buf[:count]).to(device, copy=True)
                outs.append(detect_markers_batch(_pad_to_bucket(frames, bh, bw), det_cfg))
                count = 0
    return _merge_detection_chunks(outs, n, h, w, bh, bw)


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
    tensors.

    Under ``EkfConfig.fused_update`` each lane replays on its own with the
    step that :func:`frame_step_for` selects (the predict, then
    ``ekf.update_fused``), as the JAX package's vmap of its single-stream
    scan does; every other configuration runs K1 and K2."""
    if level == "images":
        data = _corner_data_from_detections(
            data, *detect_frames(data.images, det_cfg, det_chunk)
        )
        level = "corners"
    if config.ekf.fused_update:
        return _replay_lanes(data, config, camera, level, frame_step_for(config))
    return _replay_batch(
        data, config, camera, level,
        pnp_frontend.pnp_frontend_batch, ekf_update_batched.frame_step_batched,
        ekf_update_batched.frame_step_prechecked,
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
    held against. Under ``fused_update`` it replays the lanes as
    :func:`replay_batch` does (``ekf.update_fused`` has no kernel)."""
    if level == "images":
        data = _corner_data_from_detections(
            data, *detect_frames(data.images, det_cfg, det_chunk, reference=True)
        )
        level = "corners"
    if config.ekf.fused_update:
        return _replay_lanes(data, config, camera, level, frame_step_for(config))
    return _replay_batch(
        data, config, camera, level,
        pnp_frontend.pnp_frontend_reference, ekf_update_batched.frame_step_reference,
    )


def _replay_batch(data, config, camera, level, pnp_fn, step_fn,
                  later_step_fn=None) -> ReplayResult:
    """The frame loop; ``later_step_fn``, where given, steps the frames
    after the first, whose inputs and buffers ``step_fn`` has checked."""
    _check_level(level)
    if level == "corners" and camera is None:
        raise ValueError("corner-level replay needs the camera")
    B, F, _ = data.obs_ids.shape
    dtype = torch.float32
    device = data.obs_ids.device

    # time-major once per replay, so each frame's slice is contiguous
    def tm(x):
        return x.transpose(0, 1).contiguous()

    enc_w, enc_dt = tm(data.enc_w), tm(data.enc_dt)
    ids_f, valid_f = tm(data.obs_ids), tm(data.obs_valid)
    if level == "corners":
        corners_f = tm(data.corners_px)
    else:
        z_f, R_f = tm(data.obs_z), tm(data.obs_R)

    # The outputs, written frame by frame, and two states that the frames
    # alternate between: no frame keeps a view of an earlier state.
    rows = dict(
        trajectory=torch.empty(B, F, 3, dtype=dtype, device=device),
        pose_cov=torch.empty(B, F, 3, 3, dtype=dtype, device=device),
        n_landmarks=torch.empty(B, F, dtype=torch.int32, device=device),
    )
    state = ekf.init_state(config, B, device, dtype)
    spare = ekf.init_state(config, B, device, dtype)
    for f in range(F):
        if level == "corners":
            z, R, valid = pnp_fn(corners_f[f], valid_f[f], camera, config)
        else:
            z, R, valid = z_f[f], R_f[f], valid_f[f]
        frame = ekf.FrameObservations(ids_f[f], z, R, valid)
        controls = ekf.Control(enc_w[f, :, :, 0], enc_w[f, :, :, 1], enc_dt[f])
        step = step_fn if f == 0 or later_step_fn is None else later_step_fn
        state, spare = step(state, frame, controls, config, spare,
                            ekf_update_batched.Rows(**rows, f=f)), state
    return ReplayResult(**rows, final_state=state)


def _replay_lanes(data, config, camera, level, step) -> ReplayResult:
    """A batch replayed lane by lane through the single-stream loop with
    the frame step ``step``; the rows and final states stacked along the
    batch."""
    lanes = [_replay_single(ReplayData(*(None if x is None else x[b] for x in data)),
                            config, camera, level, step)
             for b in range(data.obs_ids.shape[0])]
    return ReplayResult(
        *(torch.stack(rows) for rows in zip(*(r[:3] for r in lanes))),
        final_state=ekf.EkfState(*(torch.cat(x) for x in zip(*(r.final_state for r in lanes)))),
    )


def replay_sharded(
    data: ReplayData,
    config: SlamConfig,
    camera: Optional[CameraIntrinsics] = None,
    level: str = "obs",
    group=None,
    device=None,
) -> ReplayResult:
    """Data-parallel :func:`replay_batch` over the ranks of ``group`` (None:
    the default group; a process in no group is a world of one). Every rank
    passes the whole batch, replays its contiguous block of B / world lanes
    on ``device`` (None: the card), and returns the whole result: the
    blocks are all-gathered, with no other communication. B must be a
    multiple of the world size."""
    device = resolve(device)
    rank, world = mesh.rank_world(group)
    B = data.obs_ids.shape[0]
    if B % world:
        raise ValueError(f"a batch of {B} lanes does not split over {world} ranks")
    lanes = slice(rank * (B // world), (rank + 1) * (B // world))
    block = ReplayData(*(None if x is None else x[lanes].to(device) for x in data))
    out = replay_batch(block, config, camera, level)
    gather = functools.partial(mesh.all_gather, group=group)
    return ReplayResult(*map(gather, out[:3]),
                        final_state=ekf.EkfState(*map(gather, out.final_state)))


def frame_update_for(config: SlamConfig, batched: bool):
    """The frame update ``(state, frame, config) -> state`` that a
    configuration selects (``EkfConfig.fused_update``, ``update_backend``):
    the JAX package's policy, read for this card. ``SlamSystem`` runs it
    after its own predicts; a replay runs the whole step of
    :func:`frame_step_for` instead.

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


def frame_step_for(config: SlamConfig):
    """The single-stream frame step ``(state, frame, controls, config, out,
    rows) -> state`` that a configuration selects, with
    :func:`frame_update_for`'s policy: the predict over the frame's encoder
    ticks, then the update, and the frame's rows written.

    - ``fused_update``: ``ekf.predict_block`` then ``ekf.update_fused``;
    - ``update_backend == "xla"``: ``ekf.predict_block`` then ``ekf.update``
      (``ops.kernels.ekf_update.frame_step_reference``);
    - ``"auto"`` or ``"pallas"``: K6's frame step
      (``ops.kernels.ekf_update.frame_step``), predict and update in one
      launch, at every ``max_landmarks``.

    The first two keep the predict in torch ops, as the JAX package's XLA
    path has no kernel there. K6 takes its plain version for CPU
    tensors."""
    if config.ekf.fused_update:
        return functools.partial(ekf_update.frame_step_reference, update=ekf.update_fused)
    backend = config.ekf.update_backend
    if backend == "xla":
        return ekf_update.frame_step_reference
    if backend not in ("auto", "pallas"):
        raise ValueError(f"update_backend must be 'auto', 'pallas' or 'xla', got {backend!r}")
    return ekf_update.frame_step


def update_batched(state: ekf.EkfState, frame: ekf.FrameObservations,
                   config: SlamConfig) -> ekf.EkfState:
    """``ekf.update`` for B lanes through K2: its frame step with no
    encoder ticks (A = I and Q = 0 leave sigma exactly as it was). A lane
    with no encoder tick yet keeps its state."""
    none = torch.zeros(frame.ids.shape[0], 0, dtype=state.mu.dtype, device=state.mu.device)
    return ekf.keep_uninitialized(
        ekf_update_batched.frame_step_batched(state, frame, ekf.Control(none, none, none),
                                              config),
        state,
    )


def replay(
    data: ReplayData,
    config: SlamConfig,
    camera: Optional[CameraIntrinsics] = None,
    level: str = "obs",
    det_cfg: DetectorConfig = DetectorConfig(),
    det_chunk: int = 16,
) -> ReplayResult:
    """One sequence (``data`` without a batch axis): per frame the step of
    :func:`frame_step_for` (the predict over the frame's encoder ticks and
    the update), K6's frame step by default. At corner
    level the front-end is ``ops.frontend.observations_from_corners``, as
    in the JAX single-stream replay; at image level the frames are detected
    first (:func:`detect_frames`). Trajectory [F, 3], pose_cov [F, 3, 3],
    n_landmarks [F]; the final state keeps its batch axis of one."""
    if level == "images":
        data = _corner_data_from_detections(
            data, *detect_frames(data.images, det_cfg, det_chunk)
        )
        level = "corners"
    return _replay_single(data, config, camera, level, frame_step_for(config))


def replay_reference(
    data: ReplayData,
    config: SlamConfig,
    camera: Optional[CameraIntrinsics] = None,
    level: str = "obs",
    det_cfg: DetectorConfig = DetectorConfig(),
    det_chunk: int = 16,
) -> ReplayResult:
    """:func:`replay` through the plain versions on any device: the plain
    detector, ``ekf.predict_block`` and the plain sequential update
    ``ekf.update`` (``ekf_update.frame_step_reference``), whatever the
    config's backend. What a GPU run of the single-stream path is held
    against."""
    if level == "images":
        data = _corner_data_from_detections(
            data, *detect_frames(data.images, det_cfg, det_chunk, reference=True)
        )
        level = "corners"
    return _replay_single(data, config, camera, level, ekf_update.frame_step_reference)


def _replay_single(data, config, camera, level, step) -> ReplayResult:
    """The single-stream frame loop: per frame ``step(state, frame,
    controls, config, None, rows)`` (:func:`frame_step_for`'s protocol) with
    ``rows.f`` the frame. At corner level ``frame`` is the frame's PnP
    output [1, M]; at obs level it is frame ``rows.f`` of the replay's
    time-major arrays, and K6's step (``ekf_update.frame_step``) runs as
    ``ekf_update.replay_step``: checked once, then one launch a frame at
    that index, with no per-frame tensor."""
    _check_level(level)
    if level == "corners" and camera is None:
        raise ValueError("corner-level replay needs the camera")
    F = data.obs_ids.shape[0]
    state = ekf.init_state(config, 1, data.obs_ids.device)
    # The outputs, written frame by frame by the step: a view of a frame's
    # state would keep its whole [N, N] sigma alive until the end.
    rows = ekf_update.Rows(state.mu.new_empty(F, 3), state.sigma.new_empty(F, 3, 3),
                           state.n_landmarks.new_empty(F))
    controls = ekf.Control(data.enc_w[..., 0], data.enc_w[..., 1], data.enc_dt)
    frames = ekf.FrameObservations(data.obs_ids, data.obs_z, data.obs_R, data.obs_valid)
    rep = None
    if level == "obs" and step is ekf_update.frame_step and F:  # no frame: no step to make
        rep = ekf_update.replay_step(state, frames, controls, config, rows)
    for f in range(F):
        if rep is not None:
            state = rep(f)
            continue
        rows.f = f
        if level == "corners":
            ids, valid = data.obs_ids[f][None], data.obs_valid[f][None]
            frame = observations_from_corners(ids, data.corners_px[f][None], valid, camera, config)
            ticks = ekf.Control(*(x[f][None] for x in controls))
        else:
            frame, ticks = frames, controls
        state = step(state, frame, ticks, config, None, rows)
    return ReplayResult(rows.trajectory, rows.pose_cov, rows.n_landmarks, state)


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
    (None: the card), with the sequence's own camera unless one is given.
    At image level, a sequence whose frames are in an ``.asq`` container
    streams them through :func:`detect_frames_asq`."""
    if camera is None:
        camera = seq.camera()
    if level == "images" and seq.images is None and seq.meta.get("images_asq_path"):
        data = _corner_data_from_detections(
            replay_data_from_sequence(seq, "obs", device),
            *detect_frames_asq(seq.meta["images_asq_path"], det_cfg, det_chunk, device),
        )
        return replay(data, config, camera, "corners")
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
