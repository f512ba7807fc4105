"""detector_host_ms_per_frame: host ms of the detector's calls
(``detect.chunk`` spans: one ``detect_markers_batch`` call each, K3's
launch and the torch stages' launches) per frame they detected, over the
traced calls, from the port's program spans (``spans.py``). Beside
``detector_stages_ms_per_frame``, the device's time of the same stages."""

from portbench import spans


def read(t):
    calls = spans.traced_calls(t)
    return None if calls is None else spans.detector_host_ms_per_frame(calls)
