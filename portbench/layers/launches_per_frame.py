"""launches_per_frame.<cells>: device events (kernels, copies, sets) of the
traced replays per frame step of their loop (``runner._replay_batch``,
after ``runner.detect_frames`` at image level; ``runner._replay_single``),
from ``torch.profiler``."""


def read(t):
    n = t.count()
    return n / (t.calls * t.frames) if n else None
