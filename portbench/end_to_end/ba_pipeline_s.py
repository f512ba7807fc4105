"""ba_pipeline_s: the median, over the window's calls, of one whole back-end
call's wall seconds (``pipeline.ekf_then_ba``: the filter's pass, the graph
built on the host, packed and solved on the card), from the call to its
``torch.cuda.synchronize()`` (host clock)."""

import statistics


def read(window) -> float:
    return statistics.median(window.seconds)
