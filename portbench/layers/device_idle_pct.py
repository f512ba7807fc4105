"""device_idle_pct.<cells>: the share of the traced window (host clock,
first call to last synchronize) in which no device event ran (the union
of the profiler's device intervals)."""


def read(t):
    if not t.events or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_us() / 1e6 / t.window_s)
