"""stream_frames_per_s: frames of every single-stream replay completed in
the window, over the seconds from the window's start to the last
completion (host clock, each call ended by a synchronize)."""


def read(window) -> float:
    return window.frames_per_s
