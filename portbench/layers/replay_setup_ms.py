"""replay_setup_ms.<cells>: host ms a traced call spends from its
``replay`` span's start to its first frame step, its ``detect`` span
taken out (the time-major copies, ``init_state``, the output rows, K6's
``replay_step``; at image level also the detections' corner data), from
the port's program spans (``spans.py``). The device idles through most of
it in every call."""

from portbench import spans


def read(t):
    calls = spans.traced_calls(t)
    return None if calls is None else spans.replay_setup_ms(calls)
