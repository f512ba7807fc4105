"""The readings that a cell's limits are set from, on the card:

    python3 -m portbench.readings --workload NAME --seeds N [N ...] [--control]

For each seed, in one process: the cell's inputs, one call of its entry
(the timed path at the timed sizes), and the comparison with the float64
reference, as a run makes it; with ``--control``, also the control
(``control.py``, or an ``entries/`` module's ``control``): the reference
itself in TF32 put in the program's place. One JSON line a seed:
``{"seed", "program": {number: value}, "control": {...}}``.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys

import torch

from portbench import cell as cellmod
from portbench import check
from portbench.control import control_result
from portbench.spec import Spec


def _numbers(c, traffic: dict, entry, control: bool) -> dict:
    """The program's compared numbers on cell ``c`` and, with ``control``,
    the control's: through ``entry`` (an ``entries/`` module), or the
    replays' own ``cell.Program`` and ``check.py`` where it is None."""
    if entry is not None:
        with entry.Program(c) as program:
            got = entry.result(program())
        del program
        gc.collect()
        torch.cuda.empty_cache()
        ref = entry.reference(c)
        out = {"program": entry.numbers(c, got, ref)}
        if control:
            out["control"] = entry.numbers(c, entry.control(c), ref)
        return out
    lanes = cellmod.sample_lanes(c.lanes, traffic["check_lanes"], c.seed)
    idx = torch.as_tensor(lanes, device=c.device)
    with cellmod.Program(c) as program:
        got = {k: v.index_select(0, idx)
               for k, v in cellmod.result_of(program(), traffic["entry"]).items()}
        dets = program.detections
    del program
    gc.collect()
    torch.cuda.empty_cache()
    ref = check.reference(c, lanes)
    out = {"program": check.numbers(c, got, dets, ref)}
    if control:
        ctl, ctl_dets = control_result(c, lanes)
        out["control"] = check.numbers(c, ctl, ctl_dets, ref)
    return out


def readings(workload: str, seeds, control: bool, device="cuda", spec=None):
    spec = spec or Spec()
    w = spec.workload(workload)
    config, traffic = spec.config(w["config"]), spec.traffic(w["traffic"])
    import aruco_slam_tpu_torch  # noqa: F401  (TF32 off)

    entry = None if traffic["entry"] in cellmod.ENTRIES else spec.entry(traffic["entry"])
    for seed in seeds:
        c = cellmod.Cell(config, traffic, seed & (2**63 - 1), torch.device(device))
        line = {"seed": seed, **_numbers(c, traffic, entry, control)}
        print(json.dumps(line), flush=True)
        yield line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.readings")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", action="store_true")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.readings: no CUDA device", file=sys.stderr)
        return 2
    for _ in readings(args.workload, args.seeds, args.control):
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
