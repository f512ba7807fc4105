"""``python3 -m portbench``: one run of one cell (``run.py``)."""

import time

_T_IMPORT = time.time()


def _process_start() -> float:
    """When this process started, from /proc where it can be read (the
    interpreter's own start counts as set-up), else when this module ran."""
    try:
        import os

        with open("/proc/self/stat") as f:
            ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(float(line.split()[1]) for line in f if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return _T_IMPORT


if __name__ == "__main__":
    import sys

    from portbench.run import main

    sys.exit(main(sys.argv[1:], min(_process_start(), _T_IMPORT)))
