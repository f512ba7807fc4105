#!/usr/bin/env python3
"""chip_smoke.py's multi-rank legs (phase 10a-10c) alone, on as many cards
as the host has: config 5 through the distributed BA, phase 3's replay
through runner.replay_sharded and phase 5's frames through sharded
detection, each against its single-process call, in the worlds named on
the command line.

    python3 tools/ranks_on_cards.py [RANKS:BACKEND ...]

The default is ``4:nccl 4:gloo``: four ranks, a card each where the host
has four (NCCL refuses two ranks on one card). It first builds the kernels
(phase 0) and prints the cards' names and power limits. Run from the
repository root.
"""

import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv) -> int:
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from aruco_slam_tpu_torch.utils.config import EkfConfig, SlamConfig

    if not torch.cuda.is_available():
        print("ranks_on_cards: no CUDA device", file=sys.stderr)
        return 2
    worlds = tuple((int(r), b) for r, b in (w.split(":") for w in (argv or ["4:nccl", "4:gloo"])))
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          f"{torch.cuda.device_count()} cards")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cfg = SlamConfig(ekf=EkfConfig(max_landmarks=32, max_observations_per_frame=cs.M))
    cs.phase0_card()
    t0 = time.perf_counter()
    cs._phase10_worlds(cfg, dev, worlds, cs._card())
    print(f"ranks_on_cards: {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
