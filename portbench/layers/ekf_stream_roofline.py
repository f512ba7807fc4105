"""ekf_stream_roofline: K6 (``csrc/ekf_frame_update.cu``, any variant): its
bound over the traced calls (``roofline.ekf_launch`` on the stream's
active square) as a share of its device time in the profiler."""


def read(t):
    dev = t.kernel_s("ekf_frame_update")
    if not dev or "ekf" not in t.bounds:
        return None
    return 100.0 * t.calls * t.bounds["ekf"] / dev
