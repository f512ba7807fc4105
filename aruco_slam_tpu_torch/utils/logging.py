"""Structured run records, program spans and profiling (L4 observability) —
counterpart of ``aruco_slam_tpu.utils.logging``.

- :func:`write_replay_log`: per-frame JSONL records (pose, covariance
  trace, landmark count) written once per replay from the result, the JAX
  package's records for the same result;
- :class:`Recorder` and :data:`RECORDER`: the program's spans, host time
  at the boundaries of the runner and the detector (``replay``,
  ``replay.setup``, ``replay.frame``, ``detect``, ``detect.chunk``,
  ``detect.<stage>``), kept in memory on the clock of the profiler's
  device events;
- :func:`trace`: a context manager around ``torch.profiler`` writing a
  TensorBoard / Perfetto trace of the card's activity with the program's
  spans on a host track beside it (the JAX package's wraps
  ``jax.profiler``);
- :class:`Timer`: wall-clock time of a block, the card's work included.
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import time

import numpy as np
import torch
from torch.autograd import profiler as _torch_profiler

from aruco_slam_tpu_torch.utils.device import host


def write_replay_log(path: str, result, every: int = 1) -> int:
    """Write per-frame records of a single-stream ``ReplayResult`` to JSONL,
    then one summary record. Returns the number of per-frame records."""
    traj = host(result.trajectory)
    covs = host(result.pose_cov)
    n_lm = host(result.n_landmarks)
    n = 0
    with open(path, "w") as f:
        for i in range(0, len(traj), every):
            rec = {
                "frame": i,
                "x": float(traj[i, 0]),
                "y": float(traj[i, 1]),
                "theta": float(traj[i, 2]),
                "cov_trace": float(np.trace(covs[i])),
                "n_landmarks": int(n_lm[i]),
            }
            f.write(json.dumps(rec) + "\n")
            n += 1
        summary = {
            "final": True,
            "frames": len(traj),
            "diverged": int(host(result.final_state.diverged).reshape(-1)[0]),
            "dropped": int(host(result.final_state.dropped).reshape(-1)[0]),
        }
        f.write(json.dumps(summary) + "\n")
    return n


# The recorder that the runner's and the detector's boundaries write to.
# None: recording is off; a call's root boundary then costs one call of
# recorder() (this global and torch's profiler flag), a frame step an
# ``is None`` test of a local, a detector stage a load of this global.
# Set it to a Recorder to record; :func:`trace` does, and a call that
# starts while a torch.profiler session records and none is set makes one
# that follows that session (so a traced benchmark run records).
RECORDER = None


class Span:
    """One stretch of host work. ``start`` and ``end`` are ns on
    ``time.time_ns()``'s clock, the one the profiler's device events are
    stamped in (``kineto_results.trace_start_ns()`` plus an event's
    relative time); ``parent`` is the enclosing span or None; ``call`` the
    id of the root call (``replay``, or ``detect`` called alone) it belongs
    to; ``counts`` what was counted at its boundary (``frames``, ``lanes``)
    or None. A detector stage or chunk also holds the CUDA events recorded
    at its start and end (``start_event``, ``end_event``) where the process
    has a card."""

    __slots__ = ("name", "start", "end", "parent", "call", "counts", "start_event",
                 "end_event")

    def __init__(self, name, start, parent, call, counts=None, start_event=None):
        self.name, self.start, self.end = name, start, None
        self.parent, self.call, self.counts = parent, call, counts
        self.start_event, self.end_event = start_event, None

    @property
    def ns(self) -> int:
        return self.end - self.start

    def device_ms(self):
        """The card's ms between the span's two CUDA events, or None."""
        if self.start_event is None or self.end_event is None:
            return None
        return self.start_event.elapsed_time(self.end_event)


class Recorder:
    """The program's spans of one recording, in the order they opened.

    Boundaries call :meth:`open` / :meth:`close` around a stretch (a span
    opened where none is open starts a new call id), :meth:`root` for a
    call that is always a root (it also forgets the spans that a call that
    raised left open), or :meth:`lap` for a stretch from the open span's
    start or its previous lap to now. A span is its index here;
    ``current`` is the innermost open one, -1 for none; :meth:`spans`
    gives them as :class:`Span` objects. Each field is a column of plain
    numbers and names, so recording allocates nothing the garbage
    collector tracks (an object a frame step made every collection slower
    as a recording grew). Recording launches no device work; the only CUDA
    events are those a detector stage boundary hands over.
    ``follows_profiler``: made by :func:`recorder` for a torch.profiler
    session, and dropped at the first call after it."""

    def __init__(self, follows_profiler: bool = False):
        self.names, self.starts, self.ends, self.parents, self.call_ids = [], [], [], [], []
        self.frames, self.lanes = [], []  # counts taken at the boundary (0: none)
        self.events = {}  # index -> [CUDA event at the start, at the end]
        self.calls = 0
        self.follows_profiler = follows_profiler
        self.cuda_events = torch.cuda.is_available()
        self.current = -1
        self._lap = (0, None)

    def root(self, name: str, frames: int = 0, lanes: int = 0) -> int:
        self.current = -1
        return self.open(name, frames, lanes)

    def open(self, name: str, frames: int = 0, lanes: int = 0, start_event=None) -> int:
        if self.current < 0:
            self.calls += 1
        i, now = len(self.starts), time.time_ns()
        self.names.append(name)
        self.starts.append(now)
        self.ends.append(0)
        self.parents.append(self.current)
        self.call_ids.append(self.calls)
        self.frames.append(frames)
        self.lanes.append(lanes)
        if start_event is not None:
            self.events[i] = [start_event, None]
        self.current = i
        self._lap = (now, start_event)
        return i

    def close(self, i: int, end_event=None) -> None:
        self.ends[i] = time.time_ns()
        if end_event is not None:
            self.events.setdefault(i, [None, None])[1] = end_event
        self.current = self.parents[i]

    def lap(self, name: str, end_event=None) -> int:
        start, start_event = self._lap
        i = self.open(name, start_event=start_event)
        self.starts[i] = start
        self.close(i, end_event)
        self._lap = (self.ends[i], end_event)
        return i

    def spans(self) -> list:
        """Every span as a :class:`Span`, in the order they opened (a span
        still open, or left open by a call that raised, has ``end`` None)."""
        out = []
        for i, name in enumerate(self.names):
            counts = {k: v for k, v in (("frames", self.frames[i]), ("lanes", self.lanes[i])) if v}
            p, (start_event, end_event) = self.parents[i], self.events.get(i, (None, None))
            span = Span(name, self.starts[i], out[p] if p >= 0 else None, self.call_ids[i],
                        counts or None, start_event)
            span.end, span.end_event = self.ends[i] or None, end_event
            out.append(span)
        return out

    def closed(self) -> list:
        """The spans that ended, as :meth:`spans` gives them."""
        return [s for s in self.spans() if s.end is not None]


def _profiling() -> bool:
    return bool(getattr(_torch_profiler, "_is_profiler_enabled", False))


def recorder():
    """The recorder a root call's boundaries write to, or None: the one in
    :data:`RECORDER`; where that is None and a torch.profiler session
    records, a new one that follows the session (kept in RECORDER until a
    root call starts after the session has ended)."""
    global RECORDER
    rec = RECORDER
    if rec is None:
        if _profiling():
            rec = RECORDER = Recorder(follows_profiler=True)
    elif rec.follows_profiler and not _profiling():
        rec = RECORDER = None
    return rec


def pieces(spans) -> list:
    """Each span's time less its children's, as (start, end, span) pieces
    sorted by start: at an instant inside a piece, its span is the
    innermost one open."""
    kids = {}
    for s in spans:
        if s.parent is not None:
            kids.setdefault(id(s.parent), []).append(s)
    out = []
    for s in spans:
        at = s.start
        for k in sorted(kids.get(id(s), ()), key=lambda k: k.start):
            if k.start > at:
                out.append((at, min(k.start, s.end), s))
            at = max(at, k.end)
        if s.end > at:
            out.append((at, s.end, s))
    out.sort(key=lambda p: p[0])
    return out


def self_ns(spans) -> dict:
    """Each span's ns less the part of it that its children cover, by id."""
    out = dict.fromkeys(map(id, spans), 0)
    for start, end, s in pieces(spans):
        out[id(s)] += end - start
    return out


def summary(spans) -> list:
    """One row a span name, in the order the names first opened:
    (name, count, total host ms, self host ms)."""
    own = self_ns(spans)
    rows = {}
    for s in spans:
        row = rows.setdefault(s.name, [s.name, 0, 0.0, 0.0])
        row[1] += 1
        row[2] += s.ns / 1e6
        row[3] += own[id(s)] / 1e6
    return [tuple(r) for r in rows.values()]


def stage_ms(spans) -> dict:
    """The detector's stages on the card: {stage: ms} summed over the
    ``detect.<stage>`` spans that hold CUDA events."""
    out = {}
    for s in spans:
        if s.parent is not None and s.parent.name == "detect.chunk":
            ms = s.device_ms()
            if ms is not None:
                stage = s.name.split(".", 1)[1]
                out[stage] = out.get(stage, 0.0) + ms
    return out


def span_events(spans, base_ns: int = 0, pid: int = 0) -> list:
    """The spans as Chrome-trace complete events ("X", µs since
    ``base_ns``) on thread 0, named "program spans", of process ``pid``."""
    own = self_ns(spans)
    index = {id(s): i for i, s in enumerate(spans)}
    events = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": 0,
               "args": {"name": "program spans"}}]
    for i, s in enumerate(spans):
        args = {"span": i, "call": s.call, "self_us": own[id(s)] / 1e3,
                "parent": index.get(id(s.parent), -1)}
        args.update(s.counts or {})
        events.append({"ph": "X", "cat": "program_span", "name": s.name, "pid": pid,
                       "tid": 0, "ts": (s.start - base_ns) / 1e3,
                       "dur": s.ns / 1e3, "args": args})
    return events


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a trace of the card's activity (of the host's where there is
    no card) into ``logdir`` (``*.pt.trace.json``, viewable in TensorBoard
    or Perfetto), with the program's spans of the block on a host track
    beside the kernels. Only the card is traced where there is one: a
    profile that also traced the host has dropped device events. Yields the
    block's :class:`Recorder`."""
    from torch.profiler import ProfilerActivity, profile

    global RECORDER
    activities = [ProfilerActivity.CUDA if torch.cuda.is_available() else ProfilerActivity.CPU]
    rec, prior = Recorder(), RECORDER
    RECORDER = rec
    try:
        with profile(activities=activities) as prof:
            yield rec
    finally:
        RECORDER = prior
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"{socket.gethostname()}_{os.getpid()}."
                                f"{time.time_ns() // 1_000_000}.pt.trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    doc["traceEvents"].extend(span_events(rec.closed(), doc.get("baseTimeNanoseconds", 0),
                                          os.getpid()))
    with open(path, "w") as f:
        json.dump(doc, f)


class Timer:
    """Wall-clock seconds of a ``with`` block in ``elapsed``. Where there is
    a card it synchronizes at entry and exit, so the time covers the device
    work the block queued (and none queued before it)."""

    def __init__(self):
        self.t0 = None
        self.elapsed = 0.0

    def __enter__(self):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.elapsed = time.perf_counter() - self.t0
