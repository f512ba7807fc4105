"""The port's program spans as the traced run reads them.

While a torch.profiler session records, the port's runner and detector
record their spans (``aruco_slam_tpu_torch.utils.logging``: a recorder that
follows the session), so a traced run holds, after its window, the spans of
its calls beside the profiler's device events. A program without the
recorder has none, and every reader here then returns None.

The spans' clock is ``time.time_ns()``'s, the one the profiler stamps its
device events in: ``kineto_results.trace_start_ns()`` plus an event's
relative ``time_range``. :func:`idle_by_span` and :func:`labelled_gaps`
name each stretch of an idle device by the innermost span open on the
host then, or ``outside`` where none was (the caller's own loop and its
synchronize).
"""

from __future__ import annotations

from bisect import bisect_right

OUTSIDE = "outside"


def recorded():
    """The closed spans of the port's recorder, or None where the port has
    no recorder (the parent of the change that brought it) or recorded
    nothing."""
    from aruco_slam_tpu_torch.utils import logging as log

    rec = getattr(log, "RECORDER", None)
    return (rec.closed() or None) if rec is not None else None


def traced_calls(t, spans=None) -> list | None:
    """The spans of each of the trace's ``t.calls`` calls: the last that
    many ``replay`` roots (a traced run that widened its window recorded
    the calls of each try), each with its call's spans in order."""
    spans = recorded() if spans is None else spans
    if not spans:
        return None
    roots = [s.call for s in spans if s.parent is None and s.name == "replay"]
    if len(roots) < t.calls:
        return None
    keep = set(roots[-t.calls:])
    calls = {}
    for s in spans:
        if s.call in keep:
            calls.setdefault(s.call, []).append(s)
    return [calls[c] for c in roots[-t.calls:]]


def host_frame_us(calls) -> float | None:
    """Mean host µs of a ``replay.frame`` span (one frame step of the loop)."""
    ns = [s.ns for call in calls for s in call if s.name == "replay.frame"]
    return sum(ns) / len(ns) / 1e3 if ns else None


def replay_setup_ms(calls) -> float | None:
    """Mean host ms a call spends before its first frame step, its
    ``detect`` spans taken out."""
    out = []
    for call in calls:
        root = call[0]
        first = next((s.start for s in call if s.name == "replay.frame"), root.end)
        detect = sum(s.ns for s in call if s.name == "detect")
        out.append((first - root.start - detect) / 1e6)
    return sum(out) / len(out) if out else None


def detector_host_ms_per_frame(calls) -> float | None:
    """Host ms of the ``detect.chunk`` spans per frame they detected."""
    chunks = [s for call in calls for s in call if s.name == "detect.chunk"]
    frames = sum((s.counts or {}).get("frames", 0) for s in chunks)
    return sum(s.ns for s in chunks) / 1e6 / frames if frames else None


def _owners(spans) -> tuple:
    """The spans' time in pieces, each owned by the innermost span open
    over it (``utils.logging.pieces``): (starts, ends, names), sorted."""
    from aruco_slam_tpu_torch.utils import logging as log

    cut = log.pieces(spans)
    return [p[0] for p in cut], [p[1] for p in cut], [p[2].name for p in cut]


def _shares(owners, lo: int, hi: int) -> dict:
    """ns of [lo, hi) under each owner, and under :data:`OUTSIDE`."""
    starts, ends, names = owners
    out, covered = {}, 0
    i = max(bisect_right(starts, lo) - 1, 0)
    while i < len(starts) and starts[i] < hi:
        a, b = max(starts[i], lo), min(ends[i], hi)
        if b > a:
            out[names[i]] = out.get(names[i], 0) + (b - a)
            covered += b - a
        i += 1
    if hi - lo > covered:
        out[OUTSIDE] = out.get(OUTSIDE, 0) + (hi - lo - covered)
    return out


def idle_intervals(events, window) -> list:
    """The idle stretches of the device inside ``window`` (ns, ns): the
    window less the union of the events ``(name, start_ns, end_ns)``, each
    as (start, end, the kernel that ended it or None at the window's end,
    the kernel before it or None at the window's start)."""
    w0, w1 = window
    out, last, before = [], w0, None
    for name, start, end in sorted(events, key=lambda e: e[1]):
        if end <= w0 or start >= w1:
            continue
        if start > last:
            out.append((last, start, name, before))
        if end > last:
            last, before = end, name
    if w1 > last:
        out.append((last, w1, None, before))
    return out


def idle_by_span(events, spans, window) -> dict:
    """Idle device ns inside ``window`` under each innermost span name, and
    under :data:`OUTSIDE`: they sum to the window's idle time."""
    owners, out = _owners(spans), {}
    for lo, hi, _, _ in idle_intervals(events, window):
        for name, ns in _shares(owners, lo, hi).items():
            out[name] = out.get(name, 0) + ns
    return out


def labelled_gaps(events, spans, window, short=lambda n: n, top: int = 10) -> list:
    """The ``top`` longest idle stretches as ``[label, seconds]``, the
    label ``<span>: before <kernel>`` with the innermost span that holds
    most of the stretch (or ``outside``); at the window's end ``<span>:
    after <kernel>``."""
    owners, gaps = _owners(spans), []
    for lo, hi, nxt, prev in idle_intervals(events, window):
        shares = _shares(owners, lo, hi)
        owner = max(shares.items(), key=lambda kv: kv[1])[0]
        where = f"before {short(nxt)}" if nxt is not None else (
            f"after {short(prev)}" if prev is not None else "no device event")
        gaps.append([f"{owner}: {where}", (hi - lo) / 1e9])
    gaps.sort(key=lambda g: -g[1])
    return gaps[:top]
