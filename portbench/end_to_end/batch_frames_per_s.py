"""batch_frames_per_s (and ``batch_frames_per_s.<cells>``): lanes x frames
of every batched replay completed in the window, over the seconds from the
window's start to the last completion (host clock, each call ended by a
synchronize)."""


def read(window) -> float:
    return window.frames_per_s
