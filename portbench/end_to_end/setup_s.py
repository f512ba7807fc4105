"""setup_s: seconds from the process's start to the window's start (the
port imported, the cell's inputs made, one warm call of its entry, and on a
fresh checkout the build of its kernels)."""


def read(window) -> float:
    return window.setup_s
