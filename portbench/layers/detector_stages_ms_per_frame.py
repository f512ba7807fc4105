"""detector_stages_ms_per_frame: the detector's torch stages (stats, chain,
union, subpix, decode, dedup: ``ops/detector.py``), K3's span taken out,
in ms a detected frame, from the CUDA events of ``detector.STAGE_MARKS``
over the traced calls."""

STAGES = ("stats", "chain", "union", "subpix", "decode", "dedup")


def read(t):
    if not t.stage_ms:
        return None
    ms = sum(call.get(s, 0.0) for call in t.stage_ms for s in STAGES)
    return ms / (t.calls * t.detected_frames)
