"""K6: the single-stream EKF frame step as one CUDA launch per frame
(``csrc/ekf_frame_update.cu``), in two variants chosen by the state's size
alone (:func:`variant`):

- ``"cluster"``: a thread-block cluster of 16 CTAs, each holding a stripe
  of the frame's active square in its shared memory for the whole frame,
  with one hardware cluster barrier per observation (max_landmarks up to
  :data:`MAX_CLUSTER_LANDMARKS`);
- ``"grid"``: a cooperative grid over the frame's active square, one stripe
  a CTA (in shared memory where it fits), as many CTAs as the square needs
  and one hand-written grid barrier per observation (every larger state).

Two entry points share the kernels:

- :func:`frame_step`: the frame's encoder-tick predict and its update,
  ``ekf.update(ekf.predict_block(state, controls, config), frame,
  config)``, and in a replay the frame's rows: what the single-stream
  replay runs every frame (the JAX replay's ``predict_block`` and
  ``frame_update`` in one launch);
- :func:`frame_update`: the update alone, counterpart of
  ``aruco_slam_tpu.ops.kernels.ekf_update.frame_update`` (``SlamSystem``).

Both take the observations in arrival order: the kernel computes the slot
lookup and the (slot, arrival) sort that the JAX function runs around its
``pallas_call``. The plain versions are :func:`frame_step_reference` and
``ekf.update``; a wrapper takes them for a CPU tensor and launches the
kernel, or raises, for a CUDA tensor. A refused launch raises
``RuntimeError``; nothing retries on the other variant.

Per call the wrapper checks its inputs and makes one device launch and no
other device work: its launch arguments are one C struct (:class:`_Args`),
the launch plans are cached per device and size, and the workspace in
device memory per device, stream, variant, size and frame width (the grid
variant's scratch and barrier words, cleared once; a frame wider than
:data:`MAX_SHARED_OBS`'s prologue slots). The new state goes to the
caller's buffers (``out``) or to views of one new allocation. A frame of
any width takes one launch.

A single-stream replay runs :func:`replay_step` instead: made once for the
replay's time-major observations and ticks, its checks run and its buffers
and launch arguments are made there, and each frame ``rep(f)`` changes only
the frame index in them, which the kernel reads the arrays at. The
replay's state is its own: mu and sigma are updated in place, and the
bookkeeping alternates between two sets of buffers.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from aruco_slam_tpu_torch.models import ekf
from aruco_slam_tpu_torch.ops.kernels import _build
from aruco_slam_tpu_torch.utils.config import SlamConfig

Tensor = torch.Tensor

# Kernel launches by variant since import (or since a caller reset them).
LAUNCHES = {"cluster": 0, "grid": 0}

# Shared memory a CTA may use on Hopper (227 KB).
MAX_SHARED_BYTES = 232_448
# The widest frame whose prologue slots and order (2M int32 a CTA) live in
# shared memory, where every plan reserves room for them; a wider frame
# keeps them in device memory, a region a CTA of the launch's workspace
# (csrc: kMaxSharedObs). Not a limit on M.
MAX_SHARED_OBS = 256
# CTAs in a cluster: 16 is above the portable 8 and needs the kernel's
# non-portable attribute (csrc: ekf_frame_update_cluster_plan).
MAX_CLUSTER = 16

_P = ctypes.c_void_p
_F = ctypes.c_float
_I = ctypes.c_int
_IP = ctypes.POINTER(ctypes.c_int)

_plans: dict = {}  # (device index, variant, N, CTAs) -> launch plan
_workspaces: dict = {}  # (device index, stream, variant, N, wide M or 0) -> workspace


class _Args(ctypes.Structure):
    """One launch's arguments (csrc: ``Args``, the same layout)."""

    _fields_ = [
        ("state", _P * 9), ("out", _P * 9), ("obs", _P * 4), ("ticks", _P * 3), ("rows", _P * 3),
        ("scratch", _P), ("bar", _P), ("slots", _P), ("stream", _P),
        ("obs_frames", ctypes.c_longlong), ("s_tick", ctypes.c_longlong * 6),
        ("variant", _I), ("N", _I), ("L", _I), ("M", _I), ("T", _I), ("f", _I), ("G", _I),
        ("W", _I), ("cap", _I), ("smem", _I), ("device", _I),
        ("stationary_gate", _I), ("reject_divergent", _I), ("symmetrize", _I), ("kl_both", _I),
        ("gate_eps2", _F), ("div_ze2", _F), ("div_k2", _F), ("kl", _F), ("kr", _F),
        ("two_b", _F), ("inv_b", _F), ("kl_over_b", _F), ("kr_over_b", _F), ("half_kl", _F),
        ("q_k", _F),
    ]


class Rows:
    """A single-stream replay's per-frame outputs, which the step writes at
    frame ``f``: trajectory [F, 3] and pose_cov [F, 3, 3] float32,
    n_landmarks [F] int32, fixed when made."""

    __slots__ = ("trajectory", "pose_cov", "n_landmarks", "f")

    def __init__(self, trajectory: Tensor, pose_cov: Tensor, n_landmarks: Tensor, f: int = 0):
        self.trajectory, self.pose_cov, self.n_landmarks, self.f = (trajectory, pose_cov,
                                                                     n_landmarks, f)


def _check(name: str, t: Tensor, shape: tuple, dtype, device, contiguous: bool = True) -> None:
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must be {list(shape)}, got {list(t.shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _lib():
    lib = _build.load("ekf_frame_update")
    if lib.ekf_frame_update_launch.argtypes is None:
        lib.ekf_frame_update_cluster_plan.argtypes = [_I, _I, _I, _IP, _IP, _IP]
        lib.ekf_frame_update_grid_plan.argtypes = [_I, _I, _IP, _IP, _IP, _IP]
        lib.ekf_frame_update_launch.argtypes = [ctypes.POINTER(_Args)]
        for fn in (lib.ekf_frame_update_cluster_plan, lib.ekf_frame_update_grid_plan,
                   lib.ekf_frame_update_launch, lib.ekf_frame_update_args_bytes):
            fn.restype = _I
        if lib.ekf_frame_update_args_bytes() != ctypes.sizeof(_Args):
            raise RuntimeError("ekf_update._Args disagrees with the kernel's Args")
        lib.ekf_frame_update_error_string.argtypes = [_I]
        lib.ekf_frame_update_error_string.restype = ctypes.c_char_p
    return lib


def cluster_shared_bytes(n_dim: int, ctas: int) -> int:
    """Shared bytes per CTA of the cluster variant: the CTA's columns of
    sigma (N x W, W = ceil(N / CTAs)), its mu entries, the double-buffered
    B columns, the whole K^T, the prologue's slots and order (room for
    :data:`MAX_SHARED_OBS` observations, so that one plan serves every
    frame: a wider frame's are in device memory) and the compose's pose, A
    and Q; csrc: ``k6_words``."""
    w = -(-n_dim // ctas)
    return 4 * (n_dim * w + 7 * w + 3 * n_dim + 9 + 64 + 2 * MAX_SHARED_OBS + 21)


def cluster_ctas(n_dim: int) -> int:
    """CTAs of the cluster variant for an ``n_dim`` state, or 0 when sigma
    fits no cluster: 16 (timed fastest at every N it takes, on an H100:
    PERF.md), never so many that a CTA holds fewer than the pose block's 3
    columns."""
    if cluster_shared_bytes(n_dim, MAX_CLUSTER) > MAX_SHARED_BYTES:
        return 0
    return max(1, min(MAX_CLUSTER, n_dim // 3))


# The largest map the cluster variant holds (N = 3 + 3 * max_landmarks).
MAX_CLUSTER_LANDMARKS = max(lm for lm in range(1, 1024) if cluster_ctas(3 + 3 * lm))


def variant(n_dim: int) -> tuple[str, int]:
    """The kernel variant for an ``n_dim`` state, by its size alone:
    ``("cluster", CTAs)`` where sigma fits a cluster's shared memory, else
    ``("grid", 0)`` (its CTAs are as many as the card holds at once)."""
    ctas = cluster_ctas(n_dim)
    return ("cluster", ctas) if ctas else ("grid", 0)


def _check_inputs(state: ekf.EkfState, frame: ekf.FrameObservations, config: SlamConfig,
                  frames: int = 1) -> None:
    """The state's and the observations' shapes, types, device and layout;
    ``frames``: the observations' leading axis (1, or a replay's F)."""
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    if state.mu.dim() != 2 or state.mu.shape[0] != 1:
        raise ValueError(f"K6 is single-stream: mu must be [1, N], got {list(state.mu.shape)}")
    N = state.mu.shape[1]
    L = config.ekf.max_landmarks
    if N != 3 + 3 * L:
        raise ValueError(f"mu is [1, {N}], config max_landmarks {L} needs N = {3 + 3 * L}")
    M = frame.ids.shape[-1]
    dev = state.mu.device
    for name, t, shape, dtype in (
        *_state_specs(state, N, L),
        ("ids", frame.ids, (frames, M), i32),
        ("z", frame.z, (frames, M, 3), f32),
        ("R", frame.R, (frames, M, 3, 3), f32),
        ("valid", frame.valid, (frames, M), b8),
    ):
        _check(name, t, shape, dtype, dev)


def _state_specs(state, N, L, prefix=""):
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    shapes = ((1, N), (1, N, N), (1, L), (1,), (1, L, 3), (1, L), (1,), (1,), (1,))
    dtypes = (f32, f32, i32, i32, f32, b8, b8, i32, i32)
    return tuple((prefix + name, t, shape, dtype) for name, t, shape, dtype in
                 zip(ekf.EkfState._fields, state, shapes, dtypes))


def _check_step(state, frame, controls, config, out, rows) -> None:
    """:func:`frame_step`'s inputs: the state and observations as
    :func:`_check_inputs` wants them, the ticks [F', T] (any strides), the
    rows and ``out``, which may share mu and sigma with the state and
    nothing else."""
    if rows is not None:
        F = rows.trajectory.shape[0] if rows.trajectory.dim() == 2 else 0
        if not 0 <= rows.f < F:
            raise ValueError(f"row {rows.f} is outside the replay's {F} frames")
    frames = frame.ids.shape[0] if frame.ids.dim() == 2 else 0
    if frames != 1 and (rows is None or frames != F):
        raise ValueError(f"the observations hold {frames} frames: one, or with rows every "
                         "frame of the replay")
    _check_inputs(state, frame, config, frames)
    dev = state.mu.device
    T = controls.dt.shape[-1]
    for name, t in zip(ekf.Control._fields, controls):
        _check(name, t, (frames, T), torch.float32, dev, contiguous=False)
    N, L = state.mu.shape[1], state.slot_ids.shape[1]
    if rows is not None:
        _check("rows.trajectory", rows.trajectory, (F, 3), torch.float32, dev)
        _check("rows.pose_cov", rows.pose_cov, (F, 3, 3), torch.float32, dev)
        _check("rows.n_landmarks", rows.n_landmarks, (F,), torch.int32, dev)
    if out is not None:
        for name, t, shape, dtype in _state_specs(out, N, L, "out."):
            _check(name, t, shape, dtype, dev)
        # The kernel reads the frame-start bookkeeping while it writes the
        # new one; mu and sigma it may update in place.
        held = {t.untyped_storage().data_ptr() for t in state}
        if any(o is not s and o.untyped_storage().data_ptr() in held
               for o, s in zip(out, (*state[:2], *(None,) * 7))):
            raise ValueError("out may share only mu and sigma (the same tensors) with the state")


def frame_update_reference(state: ekf.EkfState, frame: ekf.FrameObservations,
                           config: SlamConfig) -> ekf.EkfState:
    """The plain version of :func:`frame_update`: the sequential masked
    update, ``ekf.update``."""
    return ekf.update(state, frame, config)


def frame_update(state: ekf.EkfState, frame: ekf.FrameObservations,
                 config: SlamConfig) -> ekf.EkfState:
    """One frame's observations through the sequential EKF update for a
    single stream (batch of one), any ``max_landmarks``. A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel."""
    _check_inputs(state, frame, config)
    if state.mu.device.type == "cpu":
        return frame_update_reference(state, frame, config)
    if state.mu.device.type != "cuda":
        raise ValueError(f"no kernel for device {state.mu.device}")
    return _launch(state, frame, config, variant(state.mu.shape[1]))


def _frame_at(frame: ekf.FrameObservations, controls: ekf.Control, rows: Optional[Rows]):
    """The frame the step reads: frame ``rows.f`` of a replay's time-major
    observations and ticks, or the one frame given."""
    if frame.ids.shape[0] == 1:
        return frame, controls
    f = rows.f
    return (ekf.FrameObservations(*(x[f: f + 1] for x in frame)),
            ekf.Control(*(x[f: f + 1] for x in controls)))


def frame_step_reference(state: ekf.EkfState, frame: ekf.FrameObservations,
                         controls: ekf.Control, config: SlamConfig,
                         out: Optional[ekf.EkfState] = None, rows: Optional[Rows] = None,
                         update=None) -> ekf.EkfState:
    """The plain version of :func:`frame_step`: ``ekf.predict_block`` over
    the frame's ticks, then ``update`` (``ekf.update`` by default), and the
    frame's rows written. Returns new tensors; ``out`` only names the
    buffers the kernel would write."""
    frame, controls = _frame_at(frame, controls, rows)
    new = (update or ekf.update)(ekf.predict_block(state, controls, config), frame, config)
    if rows is not None:
        rows.trajectory[rows.f] = new.mu[0, :3]
        rows.pose_cov[rows.f] = new.sigma[0, :3, :3]
        rows.n_landmarks[rows.f] = new.n_landmarks[0]
    return new


def frame_step(state: ekf.EkfState, frame: ekf.FrameObservations, controls: ekf.Control,
               config: SlamConfig, out: Optional[ekf.EkfState] = None,
               rows: Optional[Rows] = None) -> ekf.EkfState:
    """One frame of the single-stream replay: the predict over the frame's
    encoder ticks (``controls`` [F', T], T may be 0; an uninitialized state
    spends its first tick on the latch, and the latch is set), then the
    update of its observations (arrival order), in one launch. ``frame``
    and ``controls`` hold one frame (F' = 1) or, with ``rows``, every frame
    of the replay, time-major, of which the step takes frame ``rows.f``;
    ``rows`` receive the frame's pose, pose covariance and landmark count.

    Returns the new state. On the card it goes to ``out`` where given
    (which may share mu and sigma with ``state``: the update is then in
    place). A CPU tensor takes the plain version, which returns new
    tensors. A replay's frames go through :func:`replay_step`."""
    _check_step(state, frame, controls, config, out, rows)
    if state.mu.device.type == "cpu":
        return frame_step_reference(state, frame, controls, config, out, rows)
    if state.mu.device.type != "cuda":
        raise ValueError(f"no kernel for device {state.mu.device}")
    return _launch(state, frame, config, variant(state.mu.shape[1]), controls, out, rows)


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _raise_on(err: int, lib, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"ekf_frame_update {what} failed: "
                           f"{lib.ekf_frame_update_error_string(err).decode()}")


def _plan(lib, dev_index: int, kind: str, N: int, g: int):
    """(CTAs, columns per CTA, stripe area in words, shared bytes) of a
    variant: ``g`` is the cluster's CTAs (the grid's is 0)."""
    key = (dev_index, kind, N, g)
    plan = _plans.get(key)
    if plan is None:
        a, b, c, d = ctypes.c_int(), ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        if kind == "cluster":
            # (columns per CTA, shared bytes, clusters the card holds at once)
            err = lib.ekf_frame_update_cluster_plan(N, MAX_SHARED_OBS, g, ctypes.byref(a),
                                                    ctypes.byref(b), ctypes.byref(c))
            _raise_on(err, lib, f"cluster plan (N={N}, {g} CTAs)")
            if c.value < 1:
                raise RuntimeError(f"ekf_frame_update: a cluster of {g} CTAs with "
                                   f"{b.value} shared bytes each cannot be resident")
            plan = (g, a.value, N * a.value, b.value)
        else:
            # (CTAs, widest stripe, stripe area, shared bytes)
            err = lib.ekf_frame_update_grid_plan(N, MAX_SHARED_OBS, ctypes.byref(a),
                                                 ctypes.byref(b), ctypes.byref(c),
                                                 ctypes.byref(d))
            _raise_on(err, lib, f"grid plan (N={N})")
            plan = (a.value, b.value, c.value, d.value)
        _plans[key] = plan
    return plan


def _grid_words(N: int) -> int:
    """The grid variant's words at the head of its workspace: the scratch
    [2, 3N + 9], then its two barrier words."""
    return 2 * (3 * N + 9) + 2


def _workspace(dev: torch.device, dev_index: int, stream: int, kind: str, N: int, ctas: int,
               M: int) -> Optional[Tensor]:
    """A launch's workspace in device memory, per device, stream, variant,
    size and (past :data:`MAX_SHARED_OBS`) frame width, or None where it
    needs none: the grid variant's scratch and barrier words
    (:func:`_grid_words`; cleared once, the kernel leaves the barrier at
    zero arrivals), then, for a frame wider than ``MAX_SHARED_OBS``, the
    prologue's slots and order [CTAs, 2, M] int32, a region a CTA."""
    head = _grid_words(N) if kind == "grid" else 0
    wide = M if M > MAX_SHARED_OBS else 0
    if not head and not wide:
        return None
    key = (dev_index, stream, kind, N, wide)
    ws = _workspaces.get(key)
    if ws is None:
        try:
            ws = torch.zeros(head + 2 * ctas * wide, dtype=torch.float32, device=dev)
        except torch.OutOfMemoryError as e:
            raise RuntimeError(f"ekf_frame_update: no workspace for a frame of M={M} "
                               f"observations on {ctas} CTAs (N={N})") from e
        _workspaces[key] = ws
    return ws


def _outputs(state: ekf.EkfState, latch: bool, mu_sigma: bool = True) -> ekf.EkfState:
    """A new state as views of one float32 allocation, sigma first (so that
    it shares the input's 16-byte alignment, which the kernel's vector copy
    wants). ``latch``: with its own initialized flag (the frame step sets
    it), else the input's; ``mu_sigma`` False: the input's mu and sigma
    (the frame updated in place)."""
    N, L = state.mu.shape[1], state.slot_ids.shape[1]
    byte_words = (L + 1 + 3) // 4  # seen_prev, then initialized
    words = (N * N + N if mu_sigma else 0) + L + 1 + 3 * L + 2 + byte_words
    buf = torch.empty(words, dtype=torch.float32, device=state.mu.device)
    at = 0

    def take(n):
        nonlocal at
        at += n
        return buf[at - n: at]

    i32, u8 = torch.int32, torch.uint8
    sigma = take(N * N).view(1, N, N) if mu_sigma else state.sigma
    mu = take(N).view(1, N) if mu_sigma else state.mu
    slot_ids = take(L).view(i32).view(1, L)
    n_lm = take(1).view(i32)
    last_obs = take(3 * L).view(1, L, 3)
    div = take(1).view(i32)
    drop = take(1).view(i32)
    flags = take(byte_words).view(u8)
    return ekf.EkfState(
        mu=mu, sigma=sigma, slot_ids=slot_ids, n_landmarks=n_lm, last_obs=last_obs,
        seen_prev=flags[:L].view(torch.bool).view(1, L),
        initialized=flags[L: L + 1].view(torch.bool) if latch else state.initialized,
        diverged=div, dropped=drop,
    )


def _args(kind, plan, dev_index, stream, ws, state, out, frame, controls, rows, config,
          latch) -> _Args:
    """The launch arguments of one frame (``rows.f``, or the frame given)."""
    N, L = state.mu.shape[1], state.slot_ids.shape[1]
    a = _Args()
    a.state[:] = [t.data_ptr() for t in state]
    a.out[:] = [t.data_ptr() for t in out]
    if not latch:
        a.out[6] = None
    a.obs[:] = [t.data_ptr() for t in frame]
    a.obs_frames = int(frame.ids.shape[0] > 1)
    if controls is not None:
        a.ticks[:] = [t.data_ptr() for t in controls]
        a.s_tick[:] = [s for t in controls for s in t.stride()]
        a.T = controls.dt.shape[1]
    else:
        a.T = -1
    if rows is not None:
        a.rows[:] = [rows.trajectory.data_ptr(), rows.pose_cov.data_ptr(),
                     rows.n_landmarks.data_ptr()]
        a.f = rows.f
    a.N, a.L, a.M = N, L, frame.ids.shape[1]
    a.G, a.W, a.cap, a.smem = plan
    if ws is not None:
        head = _grid_words(N) if kind == "grid" else 0
        if head:
            a.scratch = ws.data_ptr()
            a.bar = ws.data_ptr() + 4 * (head - 2)
        if a.M > MAX_SHARED_OBS:
            a.slots = ws.data_ptr() + 4 * head
    a.stream = stream
    a.variant = ("cluster", "grid").index(kind)
    a.device = dev_index
    cc, od = config.compat, config.odom
    a.stationary_gate, a.reject_divergent = int(cc.stationary_gate), int(cc.reject_divergent)
    a.symmetrize = int(config.ekf.symmetrize_sigma)
    a.kl_both = int(cc.process_noise_uses_kl_for_both_wheels)
    a.gate_eps2, a.div_ze2, a.div_k2 = (cc.stationary_gate_eps**2, cc.divergence_ze_norm**2,
                                        cc.divergence_k_norm**2)
    a.kl, a.kr, a.two_b, a.inv_b = od.kl, od.kr, 2.0 * od.b, 1.0 / od.b
    a.kl_over_b, a.kr_over_b, a.half_kl = od.kl / od.b, od.kr / od.b, 0.5 * od.kl
    a.q_k = config.covariance.Q_k
    return a


def _prepare(state, kind, g, M):
    """(library, device index, stream, plan, workspace or None) of a launch
    of variant ``kind`` on the state's card for frames of M observations."""
    lib = _lib()
    dev = state.mu.device
    N = state.mu.shape[1]
    with torch.cuda.device(dev):
        dev_index = torch.cuda.current_device()
        stream = _stream(dev)
        plan = _plan(lib, dev_index, kind, N, g)
        ws = _workspace(dev, dev_index, stream, kind, N, plan[0], M)
    return lib, dev_index, stream, plan, ws


def _launch(state, frame, config, choice, controls=None, out=None, rows=None):
    """One launch of the variant ``choice`` (``variant``'s answer): the
    frame step where ``controls`` are given, else the update alone."""
    kind, g = choice
    latch = controls is not None
    M = frame.ids.shape[1]
    lib, dev_index, stream, plan, ws = _prepare(state, kind, g, M)
    if out is None:
        out = _outputs(state, latch)
    a = _args(kind, plan, dev_index, stream, ws, state, out, frame, controls, rows, config, latch)
    _raise_on(lib.ekf_frame_update_launch(ctypes.byref(a)), lib,
              f"{kind} launch (N={state.mu.shape[1]}, M={M})")
    LAUNCHES[kind] += 1
    return out


class Replay:
    """K6 over one single-stream replay: ``rep(f)`` steps the replay's
    state through frame ``f`` of its time-major observations and ticks (the
    predict, the update and the frame's rows, as :func:`frame_step`) and
    returns it. Made by :func:`replay_step`."""

    def __init__(self, state, frames, controls, config, rows):
        self.state, self.frames, self.controls, self.config, self.rows = (
            state, frames, controls, config, rows)
        self._steps = None  # on the card: [(launch arguments, new state)], see _on_card
        self._next = 0

    def _on_card(self):
        """The three launches a replay alternates: from the caller's state
        into the replay's own buffers (the first frame), then, with mu and
        sigma in place there, the bookkeeping from one set to the other and
        back."""
        kind, g = variant(self.state.mu.shape[1])
        M = self.frames.ids.shape[1]
        lib, dev_index, stream, plan, ws = _prepare(self.state, kind, g, M)
        own = _outputs(self.state, latch=True)
        other = _outputs(own, latch=True, mu_sigma=False)
        self._lib, self._kind = lib, kind
        self._what = f"{kind} launch (N={own.mu.shape[1]}, M={M})"
        self._steps = [
            (_args(kind, plan, dev_index, stream, ws, src, dst, self.frames, self.controls,
                   self.rows, self.config, True), dst)
            for src, dst in ((self.state, own), (own, other), (other, own))]

    def __call__(self, f: int) -> ekf.EkfState:
        if not 0 <= f < self.rows.trajectory.shape[0]:
            raise ValueError(f"frame {f} is outside the replay's "
                             f"{self.rows.trajectory.shape[0]} frames")
        self.rows.f = f
        if self._steps is None:  # the plain version
            self.state = frame_step_reference(self.state, self.frames, self.controls,
                                              self.config, None, self.rows)
            return self.state
        args, new = self._steps[self._next]
        args.f = f
        _raise_on(self._lib.ekf_frame_update_launch(ctypes.byref(args)), self._lib, self._what)
        LAUNCHES[self._kind] += 1
        if self._next == 0:
            self._steps[0] = None  # the caller's state is read by the first frame only
        self._next = 1 + (self._next == 1)
        self.state = new
        return new


def replay_step(state: ekf.EkfState, frames: ekf.FrameObservations, controls: ekf.Control,
                config: SlamConfig, rows: Rows) -> Replay:
    """K6's steps for a single-stream replay from ``state``: ``frames`` and
    ``controls`` hold every frame of it, time-major ([F, M] and [F, T]),
    and ``rows`` its [F]-row outputs. The inputs are checked here, once;
    then each frame costs ``rep(f)``, one launch. The returned states are
    the replay's own: the next frame updates their mu and sigma in place,
    so only the last one stays valid. The caller's ``state`` is only read.
    CPU tensors take the plain version (new tensors each frame)."""
    rows.f = 0
    _check_step(state, frames, controls, config, None, rows)
    if frames.ids.shape[0] != rows.trajectory.shape[0]:
        raise ValueError("a replay's observations and ticks hold every frame of it")
    rep = Replay(state, frames, controls, config, rows)
    if state.mu.device.type == "cuda":
        rep._on_card()
    elif state.mu.device.type != "cpu":
        raise ValueError(f"no kernel for device {state.mu.device}")
    return rep
