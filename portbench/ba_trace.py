"""What the back end's readers take from a traced call of
``pipeline.ekf_then_ba``: the device events of the trace's last call after
its last K6 event (``ekf_frame_update``: the filter's pass ends there),
and among them the solve's, those after the last host-to-device copy (the
packed problem's upload; the solve itself copies nothing from the host)."""

K6 = "ekf_frame_update"


def after_filter(t) -> list:
    """The events after the trace's last K6 event, in time order; None
    where the trace holds no K6 event."""
    events = sorted(t.events, key=lambda e: e[1])
    last = max((i for i, e in enumerate(events) if K6 in e[0]), default=None)
    return None if last is None else events[last + 1:]


def solve_events(t) -> list:
    """The solve's events: after the last host-to-device copy that follows
    the filter's pass; None where there is none."""
    after = after_filter(t)
    if not after:
        return None
    upload = max((i for i, e in enumerate(after) if "HtoD" in e[0]), default=None)
    return None if upload is None or upload + 1 == len(after) else after[upload + 1:]
