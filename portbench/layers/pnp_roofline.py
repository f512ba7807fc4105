"""pnp_roofline: K1 (``csrc/pnp_frontend.cu``): its bound over the traced
calls (``roofline.k1_launch`` from the cell's inputs) as a share of its
device time in the profiler."""


def read(t):
    dev = t.kernel_s("pnp_frontend")
    if not dev or "pnp" not in t.bounds:
        return None
    return 100.0 * t.calls * t.bounds["pnp"] / dev
