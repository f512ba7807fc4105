"""host_frame_us.<cells>: mean host µs of one frame step of the port's
replay loop (a ``replay.frame`` span of ``runner._replay_batch``: K1's and
K2's wrappers; of ``runner._replay_single``: K6's ``rep(f)``) over the
traced calls, from the port's program spans (``spans.py``). Beside the
kernels' device µs a frame step, the larger of the two sets the pace."""

from portbench import spans


def read(t):
    calls = spans.traced_calls(t)
    return None if calls is None else spans.host_frame_us(calls)
