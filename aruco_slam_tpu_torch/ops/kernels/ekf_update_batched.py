"""K2: the whole EKF frame step of B replay lanes as one CUDA launch per frame
(``csrc/ekf_frame_batched.cu``), from the raw frame: the compose of the
frame's encoder ticks, the slot lookup, the (slot, arrival) sort, the
covariance predict, the sequential observation updates and the symmetrize,
with the latch set and, in a replay, the frame's rows of the trajectory,
pose covariance and landmark count written.

Counterpart of ``aruco_slam_tpu.ops.kernels.ekf_update_batched`` together
with the glue that ``aruco_slam_tpu.runner._replay_batch_kernel`` runs
around it every frame. Three variants, whose kind is chosen by the state's
size alone and whose CTAs a lane by the size and the batch
(:func:`variant`), so that no ``max_landmarks`` is refused:

- ``"smem"``: one CTA per lane, its sigma in shared memory (max_landmarks
  up to :data:`MAX_SMEM_LANDMARKS`);
- ``"cluster"``: K6's cluster body on a cluster of G CTAs per lane, each
  CTA holding a stripe of the frame's active block in shared memory (up to
  :data:`MAX_CLUSTER_LANDMARKS`);
- ``"device"``: the same program with each CTA's whole shared memory as its
  stripe area; a lane whose frame's active block does not fit the
  cluster's shared memory runs in place in the output sigma in device
  memory (any larger state). The choice is the kernel's, per lane.

Both cluster kinds copy the rest of sigma, past the frame's active block,
from input to output.

The plain version is :func:`frame_step_reference`: the torch glue
(:func:`frame_step_inputs`), ``ekf.apply_predict`` and ``ekf.apply_sorted``.
The wrapper takes it for a CPU tensor and launches the kernel, or raises,
for a CUDA tensor; a refused launch raises ``RuntimeError`` and nothing
retries on another variant. Per call the wrapper makes one device launch
and no other device work: the launch plans are cached per device and size,
the workspace of a frame wider than :data:`MAX_SHARED_OBS` (the prologue's
slots and order in device memory) per device, stream and shape, and the
outputs are the caller's buffers or views of one allocation. A frame of
any width takes one launch.
"""

from __future__ import annotations

import ctypes
import itertools
import operator
from typing import NamedTuple, Optional

import torch

from aruco_slam_tpu_torch.models import ekf
from aruco_slam_tpu_torch.ops.kernels import _build, ekf_update
from aruco_slam_tpu_torch.utils.config import SlamConfig

Tensor = torch.Tensor

VARIANTS = ("smem", "cluster", "device")
# Kernel launches by variant since import (or since a caller reset them).
LAUNCHES = dict.fromkeys(VARIANTS, 0)

# A block's shared memory on Hopper: 227 KB (232,448 bytes); the warps
# whose Gram partials the smem and device variants keep.
MAX_SHARED_BYTES = 232_448
_MAX_WARPS = 32
# The widest frame whose prologue slots and order (2M int32 a CTA) live in
# shared memory; a wider frame keeps them in device memory, a region a CTA
# of the launch's workspace [B, G, 2, M] (csrc: kMaxSharedObs). The variant's
# kind is chosen for this width, so that it holds for every frame. Not a
# limit on M.
MAX_SHARED_OBS = ekf_update.MAX_SHARED_OBS

_P = ctypes.c_void_p
_I = ctypes.c_int

_plans: dict = {}  # (device index, variant, N, M, CTAs) -> (shared bytes, resident)
_choices: dict = {}  # (device index, N, M, B) -> (variant, CTAs, shared bytes)
_workspaces: dict = {}  # (device index, stream, B, CTAs, M) -> slots and order [B, G, 2, M]
_stream = ekf_update._stream


class Rows(NamedTuple):
    """A replay's per-frame outputs, which the step writes at frame ``f``."""

    trajectory: Tensor  # [B, F, 3] float32
    pose_cov: Tensor  # [B, F, 3, 3] float32
    n_landmarks: Tensor  # [B, F] int32
    f: int


def stripe_width(n_dim: int, ctas: int) -> int:
    """Columns of sigma a CTA of the cluster and device variants may own:
    ceil(N / CTAs), at least the pose block's 3."""
    return max(3, -(-n_dim // ctas))


def _slot_words(n_obs: int) -> int:
    """Shared words of the prologue's slots and order: 2M up to
    :data:`MAX_SHARED_OBS` observations, none for a wider frame (csrc:
    ``shared_slot_words``)."""
    return 2 * n_obs if n_obs <= MAX_SHARED_OBS else 0


def shared_bytes(kind: str, n_dim: int, max_lm: int, n_obs: int = MAX_SHARED_OBS,
                 ctas: int = 1) -> int:
    """Shared bytes per CTA of a variant for frames of ``n_obs``
    observations (csrc: ``lane_words``, ``batched_cluster_words``). The
    smem variant: sigma, mu and mu0, the double-buffered B, the Gram
    partials, pose / A / Q, the frozen last_obs and seen, the slots and the
    order (in shared memory up to :data:`MAX_SHARED_OBS` observations, in
    device memory past it). The cluster variant on ``ctas`` CTAs a lane:
    K6's layout with a stripe of N x W (W = :func:`stripe_width`), then
    pose / A / Q. The device variant: all of a CTA's shared memory."""
    if kind == "device":
        return MAX_SHARED_BYTES
    if kind == "cluster":
        w = stripe_width(n_dim, ctas)
        return 4 * (n_dim * w + 7 * w + 3 * n_dim + 73 + _slot_words(n_obs) + 21)
    return 4 * (n_dim * n_dim + 8 * n_dim + 12 * _MAX_WARPS + 21 + 3 * max_lm
                + _slot_words(n_obs) + (max_lm + 3) // 4)


def on_chip_rows(kind: str, n_dim: int, n_obs: int, ctas: int) -> int:
    """The largest active block na (3 + 3 x landmarks, at most N) whose
    stripes of the cluster and device variants fit their plan's stripe
    area (csrc: ``cluster_frame``'s ``on_chip``): a frame of a lane whose
    block is larger runs in device memory."""
    w = stripe_width(n_dim, ctas)
    area = shared_bytes(kind, n_dim, 0, n_obs, ctas) // 4 - (7 * w + 3 * n_dim + 73
                                                             + _slot_words(n_obs) + 21)
    return max((na for na in range(3, n_dim + 1, 3) if na * stripe_width(na, ctas) <= area),
               default=0)


def min_ctas(kind: str, n_dim: int) -> int:
    """The fewest CTAs a lane of a variant can have: 1 for smem and device;
    for cluster the fewest whose N x W stripe fits a CTA (0 if none of
    1..16 does)."""
    if kind != "cluster":
        return 1
    max_lm = (n_dim - 3) // 3
    return next((g for g in range(1, ekf_update.MAX_CLUSTER + 1)
                 if shared_bytes("cluster", n_dim, max_lm, ctas=g) <= MAX_SHARED_BYTES), 0)


# Clusters of G CTAs (G = 1..16, one CTA an SM, 512 threads) that an NVIDIA
# H100 80GB HBM3 holds at once: cudaOccupancyMaxActiveClusters for the
# cluster and device variants' kernel (chip_smoke.py phase 2 prints it). The
# rule's answer on a host without a card; on the card the wrapper asks the
# card.
H100_CLUSTERS = (132, 66, 39, 30, 22, 17, 15, 15, 9, 7, 7, 7, 7, 7, 7, 7)


def _h100_clusters(kind: str, ctas: int) -> int:
    return H100_CLUSTERS[ctas - 1]


def variant(n_dim: int, lanes: int = 1, clusters=_h100_clusters) -> tuple[str, int]:
    """The variant for ``lanes`` lanes of an ``n_dim`` state and its CTAs a
    lane G. The kind by the size alone: ``"smem"`` where a lane's sigma
    fits one CTA's shared memory, else ``"cluster"`` where its N x W stripe
    fits a CTA of some cluster of at most 16, else ``"device"``. Then

        G(N, B) = max{G : G_min(N) <= G <= 16, B <= C(G)}, or G_min(N) if
                  no G has B <= C(G),

    with G_min the fewest CTAs a lane can have (:func:`min_ctas`; 1 for the
    device kind) and C(G) = ``clusters(kind, G)`` the clusters of G CTAs the
    card holds at once: the most CTAs a lane can have while the B lanes
    still run in one wave. One lane gets 16, K6's timed choice; a batch
    larger than one wave at G_min gets G_min. The smem variant has one CTA a
    lane."""
    max_lm = (n_dim - 3) // 3
    if shared_bytes("smem", n_dim, max_lm) <= MAX_SHARED_BYTES:
        return "smem", 1
    kind = "cluster" if min_ctas("cluster", n_dim) else "device"
    lo = min_ctas(kind, n_dim)
    fits = [g for g in range(lo, ekf_update.MAX_CLUSTER + 1) if lanes <= clusters(kind, g)]
    return kind, max(fits, default=lo)


# The largest maps of the two shared-memory variants (N = 3 + 3 * max_landmarks).
MAX_SMEM_LANDMARKS = max(lm for lm in range(1, 1024) if variant(3 + 3 * lm)[0] == "smem")
MAX_CLUSTER_LANDMARKS = max(lm for lm in range(1, 1024) if variant(3 + 3 * lm)[0] != "device")


def _lib():
    lib = _build.load("ekf_frame_batched")
    if lib.ekf_frame_batched_launch.argtypes is None:
        lib.ekf_frame_batched_launch.argtypes = [_I, _P, _P, _P, _P, _I, _P]
        lib.ekf_frame_batched_plan.argtypes = [_I] * 5 + [ctypes.POINTER(_I)] * 2
        lib.ekf_frame_batched_smem_bytes.argtypes = [_I] * 5
        lib.ekf_frame_batched_smem_bytes.restype = ctypes.c_longlong
        lib.ekf_frame_batched_launch.restype = _I
        lib.ekf_frame_batched_plan.restype = _I
        lib.ekf_frame_batched_error_string.argtypes = [_I]
        lib.ekf_frame_batched_error_string.restype = ctypes.c_char_p
    return lib


_STATE = ("mu", "sigma", "slot_ids", "n_landmarks", "last_obs", "seen_prev", "initialized",
          "diverged", "dropped")
_ROWS = ("rows.trajectory", "rows.pose_cov", "rows.n_landmarks")
_shape, _dtype, _device = (operator.attrgetter(a) for a in ("shape", "dtype", "device"))
_expected: dict = {}  # (B, L, M, T, F, out given) -> (names, shapes, dtypes, contiguous)


def _expect(B, L, M, T, F, with_out):
    """The (names, shapes, dtypes, contiguous) that the tensors of a call
    must have, in the order :func:`_check_inputs` lists them."""
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    N = 3 + 3 * L
    state = ((B, N), (B, N, N), (B, L), (B,), (B, L, 3), (B, L), (B,), (B,), (B,))
    state_t = (f32, f32, i32, i32, f32, b8, b8, i32, i32)
    names = _STATE + ("ids", "z", "R", "valid", "wl", "wr", "dt")
    shapes = state + ((B, M), (B, M, 3), (B, M, 3, 3), (B, M), (B, T), (B, T), (B, T))
    dtypes = state_t + (i32, f32, f32, b8, f32, f32, f32)
    contiguous = (True,) * 13 + (False,) * 3  # the ticks may be strided views
    if with_out:
        names += tuple(f"out.{n}" for n in _STATE)
        shapes, dtypes, contiguous = shapes + state, dtypes + state_t, contiguous + (True,) * 9
    if F >= 0:
        names += _ROWS
        shapes += ((B, F, 3), (B, F, 3, 3), (B, F))
        dtypes, contiguous = dtypes + (f32, f32, i32), contiguous + (True,) * 3
    return names, [torch.Size(x) for x in shapes], list(dtypes), contiguous


def _check_inputs(state, frame, controls, config, out, rows) -> None:
    """Every tensor's shape, type, device and layout, in one pass of C-level
    maps against the expectations cached per size; the first failing
    tensor is named only when one fails."""
    mu = state.mu
    if mu.dim() != 2:
        raise ValueError(f"mu must be [B, N], got {list(mu.shape)}")
    B, N = mu.shape
    L = config.ekf.max_landmarks
    if N != 3 + 3 * L:
        raise ValueError(f"mu is [B, {N}], config max_landmarks {L} needs N = {3 + 3 * L}")
    if frame.ids.dim() != 2 or controls.dt.dim() != 2:
        raise ValueError(f"ids must be [B, M] and the ticks [B, T], got "
                         f"{list(frame.ids.shape)} and {list(controls.dt.shape)}")
    M, T = frame.ids.shape[1], controls.dt.shape[1]
    ts = (*state, *frame, *controls)
    F = -1
    if out is not None:
        ts += tuple(out)
    if rows is not None:
        F = rows.trajectory.shape[1] if rows.trajectory.dim() == 3 else 0
        if not 0 <= rows.f < F:
            raise ValueError(f"row {rows.f} is outside the replay's {F} frames")
        ts += rows[:3]
    key = (B, L, M, T, F, out is not None)
    names, shapes, dtypes, contiguous = _expected.get(key) or _expected.setdefault(
        key, _expect(*key))
    if not (list(map(_shape, ts)) == shapes and list(map(_dtype, ts)) == dtypes
            and set(map(_device, ts)) == {mu.device}
            and all(map(torch.Tensor.is_contiguous, itertools.compress(ts, contiguous)))):
        for name, t, shape, dtype, contig in zip(names, ts, shapes, dtypes, contiguous):
            ekf_update._check(name, t, tuple(shape), dtype, mu.device, contig)
    # The kernel reads the state while it writes out (the cluster variant's
    # rank 0 writes slot_ids before its peers have read them).
    if out is not None and {t.untyped_storage().data_ptr() for t in state} & {
            t.untyped_storage().data_ptr() for t in out}:
        raise ValueError("out must not share memory with the input state")


def frame_step_inputs(state: ekf.EkfState, frame: ekf.FrameObservations,
                      controls: ekf.Control, config: SlamConfig):
    """The plain version's glue: compose the frame's encoder ticks, look up
    each observation's frame-start slot, sort, and sanitise. Returns
    (pose, A, Q, ids, z, R9, valid, slots), the sorted frame in the layout
    of the JAX kernel's arguments."""
    B, M = frame.ids.shape
    pose, A, Q = ekf.predict_compose(
        state.mu[:, :3], state.initialized, controls, config
    )
    obs, slots = ekf.sort_observations(frame, ekf.lookup_slots(state.slot_ids, frame.ids))
    # Sanitize invalid slots: the update skips them, but a NaN from PnP on
    # padded corners must not reach any arithmetic.
    ok = obs.valid[..., None]
    eye9 = torch.eye(3, dtype=state.mu.dtype, device=state.mu.device).reshape(9)
    z = torch.where(ok, obs.z, 0.0).to(state.mu.dtype)
    R9 = torch.where(ok, obs.R.reshape(B, M, 9), eye9).to(state.mu.dtype)
    return (pose.contiguous(), A.reshape(B, 9).contiguous(), Q.reshape(B, 9), obs.ids, z, R9,
            obs.valid, slots)


def _deliver(new: ekf.EkfState, out: Optional[ekf.EkfState], rows: Optional[Rows]):
    if rows is not None:
        rows.trajectory[:, rows.f] = new.mu[:, :3]
        rows.pose_cov[:, rows.f] = new.sigma[:, :3, :3]
        rows.n_landmarks[:, rows.f] = new.n_landmarks
    if out is None:
        return new
    for o, n in zip(out, new):
        o.copy_(n)
    return out


def frame_step_reference(state: ekf.EkfState, frame: ekf.FrameObservations,
                         controls: ekf.Control, config: SlamConfig,
                         out: Optional[ekf.EkfState] = None,
                         rows: Optional[Rows] = None) -> ekf.EkfState:
    """The plain version of :func:`frame_step_batched`, in torch ops: the
    glue, the batched covariance predict with the composed (A, Q), mu[0:3]
    <- pose, the masked sequential update over the sorted observations,
    and the latch set."""
    pose, A, Q, ids, z, R9, valid, slots = frame_step_inputs(state, frame, controls, config)
    B, M = ids.shape
    mu = state.mu.clone()
    mu[:, :3] = pose
    sigma = ekf.apply_predict(state.sigma, A.reshape(B, 3, 3), Q.reshape(B, 3, 3))
    sorted_frame = ekf.FrameObservations(ids, z, R9.reshape(B, M, 3, 3), valid)
    new = ekf.apply_sorted(state._replace(mu=mu, sigma=sigma), sorted_frame, slots, config)
    return _deliver(new._replace(initialized=torch.ones_like(state.initialized)), out, rows)


def frame_step_batched(
    state: ekf.EkfState,  # batch-major; sigma [B, N, N] float32
    frame: ekf.FrameObservations,  # [B, M] in arrival order; valid is K1's keep
    controls: ekf.Control,  # the frame's encoder ticks wl, wr, dt [B, T] (T may be 0)
    config: SlamConfig,
    out: Optional[ekf.EkfState] = None,  # buffers for the new state (not the input's)
    rows: Optional[Rows] = None,  # a replay's rows, written at frame rows.f
) -> ekf.EkfState:
    """One frame's EKF step for every lane from the raw frame: compose,
    lookup, sort, predict, the sequential update, the symmetrize; the
    latch set. Returns the new state (``out`` where given). A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel."""
    _check_inputs(state, frame, controls, config, out, rows)
    return frame_step_prechecked(state, frame, controls, config, out, rows)


def frame_step_prechecked(state, frame, controls, config, out=None, rows=None) -> ekf.EkfState:
    """:func:`frame_step_batched` without its input checks, for a caller
    whose every call has the shapes, types, devices, layout and buffers of
    an earlier call that passed them: a replay's frames after its first
    (the frames are slices of the same arrays, the states alternate
    between the same two buffers, the rows stay)."""
    if state.mu.device.type == "cpu":
        return frame_step_reference(state, frame, controls, config, out, rows)
    if state.mu.device.type != "cuda":
        raise ValueError(f"no kernel for device {state.mu.device}")
    return _launch(state, frame, controls, config, out, rows)


def _raise_on(err: int, lib, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"ekf_frame_batched {what} failed: "
                           f"{lib.ekf_frame_batched_error_string(err).decode()}")


def _plan(lib, dev_index: int, kind: str, N: int, L: int, M: int, ctas: int):
    """(shared bytes a CTA, CTAs or clusters the card holds at once) of a
    variant on ``ctas`` CTAs a lane, cached per (device, variant, N, M,
    CTAs)."""
    key = (dev_index, kind, N, M, ctas)
    plan = _plans.get(key)
    if plan is None:
        smem, resident = ctypes.c_int(), ctypes.c_int()
        err = lib.ekf_frame_batched_plan(VARIANTS.index(kind), N, L, M, ctas,
                                         ctypes.byref(smem), ctypes.byref(resident))
        _raise_on(err, lib, f"{kind} plan (N={N}, M={M}, {ctas} CTAs)")
        if smem.value != shared_bytes(kind, N, L, M, ctas):
            raise RuntimeError("shared_bytes() disagrees with the kernel's layout")
        plan = _plans[key] = (smem.value, resident.value)
    return plan


def _choose(lib, dev_index: int, N: int, L: int, M: int, B: int):
    """:func:`variant`'s answer for B lanes with the card's own cluster
    occupancy, and its shared bytes, cached per (device, N, M, B)."""
    kind, ctas = variant(N, B, lambda k, g: _plan(lib, dev_index, k, N, L, M, g)[1])
    smem, resident = _plan(lib, dev_index, kind, N, L, M, ctas)
    if resident < 1:
        raise RuntimeError(f"ekf_frame_batched: the {kind} variant with {smem} shared bytes a "
                           f"CTA on {ctas} CTAs a lane cannot be resident")
    choice = _choices[(dev_index, N, M, B)] = (kind, ctas, smem)
    return choice


def _slot_workspace(dev: torch.device, dev_index: int, stream: int, B: int, ctas: int,
                    M: int) -> Optional[Tensor]:
    """The prologue's slots and order in device memory, [B, CTAs, 2, M]
    int32 (a region a CTA), for a frame wider than :data:`MAX_SHARED_OBS`,
    per device, stream and shape; None for a narrower frame."""
    if M <= MAX_SHARED_OBS:
        return None
    key = (dev_index, stream, B, ctas, M)
    ws = _workspaces.get(key)
    if ws is None:
        try:
            ws = torch.empty(B * ctas * 2 * M, dtype=torch.int32, device=dev)
        except torch.OutOfMemoryError as e:
            raise RuntimeError(f"ekf_frame_batched: no workspace for frames of M={M} "
                               f"observations on {B} lanes x {ctas} CTAs") from e
        _workspaces[key] = ws
    return ws


def _outputs(state: ekf.EkfState) -> ekf.EkfState:
    """A new state as views of one float32 allocation, sigma first (so that
    it shares the input's 16-byte alignment, which the kernel's vector copy
    of the rest of sigma wants)."""
    B, N = state.mu.shape
    L = state.slot_ids.shape[1]
    byte_words = (B * L + B + 3) // 4  # seen_prev, then initialized
    words = B * (N + N * N + L + 1 + 3 * L + 2) + byte_words
    buf = torch.empty(words, dtype=torch.float32, device=state.mu.device)
    at = 0

    def take(n):
        nonlocal at
        at += n
        return buf[at - n: at]

    i32, u8 = torch.int32, torch.uint8
    sigma = take(B * N * N).view(B, N, N)
    mu = take(B * N).view(B, N)
    slot_ids = take(B * L).view(i32).view(B, L)
    n_lm = take(B).view(i32)
    last_obs = take(B * 3 * L).view(B, L, 3)
    div = take(B).view(i32)
    drop = take(B).view(i32)
    flags = take(byte_words).view(u8)
    return ekf.EkfState(
        mu=mu, sigma=sigma, slot_ids=slot_ids, n_landmarks=n_lm, last_obs=last_obs,
        seen_prev=flags[:B * L].view(torch.bool).view(B, L),
        initialized=flags[B * L: B * L + B].view(torch.bool),
        diverged=div, dropped=drop,
    )


def _launch(state, frame, controls, config, out, rows, choice=None):
    """One launch of the variant ``choice`` = (kind, CTAs a lane), by
    default :func:`variant`'s answer for this batch on this card."""
    B, N = state.mu.shape
    L = config.ekf.max_landmarks
    M = frame.ids.shape[1]
    T = controls.dt.shape[1]
    dev = state.mu.device
    lib = _lib()
    with torch.cuda.device(dev):
        dev_index = torch.cuda.current_device()
        if choice is None:
            kind, ctas, smem = (_choices.get((dev_index, N, M, B))
                                or _choose(lib, dev_index, N, L, M, B))
        else:
            kind, ctas = choice
            smem = _plan(lib, dev_index, kind, N, L, M, ctas)[0]
        stream = _stream(dev)
        ws = _slot_workspace(dev, dev_index, stream, B, ctas, M)
        if out is None:
            out = _outputs(state)
        traj, cov, nlm = (rows.trajectory.data_ptr(), rows.pose_cov.data_ptr(),
                          rows.n_landmarks.data_ptr()) if rows is not None else (None,) * 3
        ptrs = (ctypes.c_void_p * 29)(
            *(t.data_ptr() for t in state), *(t.data_ptr() for t in frame),
            *(t.data_ptr() for t in controls),
            out.mu.data_ptr(), out.sigma.data_ptr(), out.slot_ids.data_ptr(),
            out.n_landmarks.data_ptr(), out.last_obs.data_ptr(), out.seen_prev.data_ptr(),
            out.initialized.data_ptr(), out.diverged.data_ptr(), out.dropped.data_ptr(),
            traj, cov, nlm, None if ws is None else ws.data_ptr(),
        )
        strides = (ctypes.c_longlong * 6)(*controls.wl.stride(), *controls.wr.stride(),
                                          *controls.dt.stride())
        cc, od = config.compat, config.odom
        fcfg = (ctypes.c_float * 11)(
            cc.stationary_gate_eps**2, cc.divergence_ze_norm**2, cc.divergence_k_norm**2,
            od.kl, od.kr, 2.0 * od.b, 1.0 / od.b, od.kl / od.b, od.kr / od.b, 0.5 * od.kl,
            config.covariance.Q_k,
        )
        F, f = (rows.trajectory.shape[1], rows.f) if rows is not None else (0, 0)
        icfg = (ctypes.c_int * 12)(
            B, N, L, M, ctas, T, F, f, int(cc.stationary_gate), int(cc.reject_divergent),
            int(config.ekf.symmetrize_sigma), int(cc.process_noise_uses_kl_for_both_wheels),
        )
        err = lib.ekf_frame_batched_launch(VARIANTS.index(kind), ptrs, strides, fcfg, icfg,
                                           smem, stream)
    _raise_on(err, lib, f"{kind} launch (N={N}, M={M})")
    LAUNCHES[kind] += 1
    return out
