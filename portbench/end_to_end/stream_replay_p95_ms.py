"""stream_replay_p95_ms: the 95th percentile, over every replay in the
window, of one whole replay's wall time, from the call to its
``torch.cuda.synchronize()`` (host clock; linear interpolation between
order statistics)."""

import numpy as np


def read(window) -> float:
    return float(np.percentile(np.asarray(window.seconds) * 1e3, 95))
