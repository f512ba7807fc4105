"""device_events_per_gn: device events (kernels, copies, sets) of the
traced back-end call after its filter's last K6 event (``ba_trace.py``:
the map read back, the problem's upload and the solve), per Gauss-Newton
step of the traffic's ``ba_iters``, from ``torch.profiler``."""

from portbench.ba_trace import after_filter


def read(t):
    after, gn = after_filter(t), t.traffic.get("ba_iters")
    return len(after) / gn if after and gn else None
