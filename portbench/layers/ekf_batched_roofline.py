"""ekf_batched_roofline: K2 (``csrc/ekf_frame_batched.cu``, any variant):
its bound over the traced calls (``roofline.ekf_launch``, each lane's
active square) as a share of its device time in the profiler."""


def read(t):
    dev = t.kernel_s("ekf_frame_batched")
    if not dev or "ekf" not in t.bounds:
        return None
    return 100.0 * t.calls * t.bounds["ekf"] / dev
