"""ba_solve_roofline: the solve's least time (``roofline.ba_solve``: its
bytes over 3.35 TB/s or its operations over 67 TFLOP/s, the larger) as a
share of the device time from the solve's first device event to its last
(``ba_trace.py``), idle gaps included, in the trace's last call."""

from portbench.ba_trace import solve_events


def read(t):
    events = solve_events(t)
    if not events or "ba_solve" not in t.bounds:
        return None
    span_s = (max(e[2] for e in events) - events[0][1]) / 1e6
    return 100.0 * t.bounds["ba_solve"] / span_s if span_s > 0 else None
