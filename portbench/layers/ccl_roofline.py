"""ccl_roofline: the CCL kernels (``csrc/ccl.cu``; K3 on the detector's
path): K3's bound over the traced calls (``roofline.ccl_union_launch``) as
a share of the CCL kernels' device time in the profiler."""


def read(t):
    dev = t.kernel_s("ccl_")
    if not dev or "ccl" not in t.bounds:
        return None
    return 100.0 * t.calls * t.bounds["ccl"] / dev
