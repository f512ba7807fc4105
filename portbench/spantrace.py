"""One cell's traced calls with the port's program spans on the device
trace's clock: where the host was while the device idled.

    python3 -m portbench.spantrace --workload NAME --seed N [--cost-calls K]

does what a ``--trace 1`` run of ``python3 -m portbench`` does up to its
window (the cell's inputs from the seed, one warm call), and then:

1. the recorder's cost: ``--cost-calls`` calls with the port's recorder
   off, then on, then on, then off (no profiler), each call ended by a
   synchronize; host seconds a call in each state, and the new per-layer
   metrics read from the calls with it on (no profiler's cost in them);
2. the traffic's ``trace_calls`` calls under ``torch.profiler`` (the card's
   activity only, the recorder on), between two clock fences: a
   synchronize, a stamp, one ``torch.cuda._sleep`` kernel, a synchronize,
   a stamp. The device events are put on ``time.time_ns()``'s clock by the
   trace's start, then shifted, linearly in time between the fences, by
   what brings each fence's kernel inside its stamps; both fences' shifts,
   and the room their kernels left to their stamps, bound the clocks'
   residual skew;
3. prints to standard error a table of the spans (count, total and self
   host ms by name), the new per-layer metrics, the device's idle share
   of the window and its split by the innermost span open on the host
   (``spans.idle_by_span``; ``outside`` where none was), the 10th, 50th
   and 90th percentiles of a frame step's host µs, and the longest idle
   gaps labelled ``<span>: before <kernel>``;
4. prints the same as one JSON line, the last of standard output.

It needs a card; the cell's result is not compared with the reference.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from portbench import cell as cellmod
from portbench import spans as spanmod
from portbench.spec import Spec
from portbench.trace import PADS_S, Trace, _device_events

FENCE = "spin_kernel"  # torch.cuda._sleep's kernel
FENCE_CYCLES = 20_000  # about 10 us at the card's clock


def _fence() -> tuple:
    torch.cuda.synchronize()
    a = time.time_ns()
    torch.cuda._sleep(FENCE_CYCLES)
    torch.cuda.synchronize()
    return a, time.time_ns()


def _shift(stamps: tuple, event: tuple) -> int:
    """The ns that bring ``event`` (name, start_ns, end_ns) inside
    ``stamps`` (0 where it lies inside already)."""
    a, b = stamps
    if event[1] < a:
        return a - event[1]
    if event[2] > b:
        return b - event[2]
    return 0


def on_clock(prof, fences: tuple) -> tuple:
    """The profiler's device events as (name, start_ns, end_ns) on
    ``time.time_ns()``'s clock, the fences' kernels taken out; the two
    fences' shifts in ns; and each fence kernel's room to its stamps
    before and after it, in ns, before the shift."""
    base = prof.profiler.kineto_results.trace_start_ns()
    events = [(n, base + round(s * 1e3), base + round(e * 1e3))
              for n, s, e in _device_events(prof)]
    marks = sorted((e for e in events if FENCE in e[0]), key=lambda e: e[1])
    events = [e for e in events if FENCE not in e[0]]
    if len(marks) != 2:
        raise RuntimeError(f"the profiler kept {len(marks)} of the 2 fence kernels")
    s0, s1 = (_shift(f, m) for f, m in zip(fences, marks))
    t0, t1 = marks[0][1], marks[1][1]

    def at(t):
        return s0 + (s1 - s0) * (t - t0) / (t1 - t0)

    room = [(m[1] - f[0], f[1] - m[2]) for f, m in zip(fences, marks)]
    return [(n, s + round(at(s)), e + round(at(s))) for n, s, e in events], (s0, s1), room


def cost(program, calls: int) -> tuple:
    """Host seconds a call, recorder off and on, in turns off on on off,
    and the spans of the calls with it on."""
    from aruco_slam_tpu_torch.utils import logging as log

    out, rec = {"off": [], "on": []}, log.Recorder()
    for state in ("off", "on", "on", "off"):
        log.RECORDER = rec if state == "on" else None
        for _ in range(calls):
            torch.cuda.synchronize()
            t = time.perf_counter()
            program()
            torch.cuda.synchronize()
            out[state].append(time.perf_counter() - t)
    log.RECORDER = None
    return {k: sum(v) / len(v) for k, v in out.items()}, rec.closed()


def traced(program, calls: int, expected: int, part: str):
    """The calls under the profiler between two fences, widening the idle
    pads as ``trace.profile_calls`` does where events were dropped:
    (events on the host clock, the fences' shifts and room, the window's
    stamps, the recorder's spans)."""
    from torch.profiler import ProfilerActivity, profile

    from aruco_slam_tpu_torch.utils import logging as log

    for pad in PADS_S:
        rec = log.RECORDER = log.Recorder()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            first = _fence()
            w0 = time.time_ns()
            for _ in range(calls):
                program()
            torch.cuda.synchronize()
            w1 = time.time_ns()
            last = _fence()
            time.sleep(pad)
        log.RECORDER = None
        events, shifts, room = on_clock(prof, (first, last))
        got = sum(part in e[0] for e in events)
        if got >= expected:
            return events, shifts, room, (w0, w1), rec.closed()
        print(f"spantrace: the profiler kept {got} of {expected} events of {part} in a {pad} s "
              f"pad", file=sys.stderr, flush=True)
    raise RuntimeError(f"the profiler kept {got} of {expected} events of {part} in every window")


def _metrics(calls) -> dict:
    return {"host_frame_us": spanmod.host_frame_us(calls),
            "replay_setup_ms": spanmod.replay_setup_ms(calls),
            "detector_host_ms_per_frame": spanmod.detector_host_ms_per_frame(calls)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.spantrace",
                                description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--cost-calls", type=int, default=3)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("spantrace: needs a CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    from aruco_slam_tpu_torch.utils import logging as log

    spec = Spec()
    w = spec.workload(args.workload)
    config, traffic = spec.config(w["config"]), spec.traffic(w["traffic"])
    c = cellmod.Cell(config, traffic, args.seed & (2**63 - 1), "cuda")
    with cellmod.Program(c) as program:
        program()
        torch.cuda.synchronize()
        host, quiet = cost(program, args.cost_calls)
        calls = traffic["trace_calls"]
        events, shifts, room, window, spans = traced(program, calls, calls * c.frames,
                                                     "ekf_frame")
    rel = [(n, s / 1e3, e / 1e3) for n, s, e in events]
    t = Trace(rel, (window[1] - window[0]) / 1e9, calls, c.frames, c.lanes)
    by_call = spanmod.traced_calls(t, spans)
    unprofiled = spanmod.traced_calls(Trace([], 0.0, 2 * args.cost_calls, c.frames, c.lanes),
                                      quiet)
    steps = sorted(s.ns / 1e3 for call in by_call for s in call if s.name == "replay.frame")
    busy_ns = t.busy_us() * 1e3
    idle_ns = window[1] - window[0] - busy_ns
    split = spanmod.idle_by_span(events, spans, window)
    out = {
        "workload": args.workload, "seed": args.seed, "device": torch.cuda.get_device_name(0),
        "calls": calls, "window_s": t.window_s,
        "host_s_a_call": host, "recorder_cost_pct": 100 * (host["on"] / host["off"] - 1),
        "clock_shift_us": [s / 1e3 for s in shifts],
        "fence_room_us": [[r / 1e3 for r in pair] for pair in room],
        "metrics": _metrics(by_call),
        "metrics_unprofiled": _metrics(unprofiled),
        "frame_us_p10_p50_p90": [steps[int(q * (len(steps) - 1))] for q in (0.1, 0.5, 0.9)],
        "device_idle_pct": 100 * idle_ns / (window[1] - window[0]),
        "idle_pct_by_span": {k: 100 * v / (window[1] - window[0])
                             for k, v in sorted(split.items(), key=lambda kv: -kv[1])},
        "idle_gaps": spanmod.labelled_gaps(events, spans, window, Trace.short),
        "launches_per_frame": t.count() / (calls * c.frames),
        "spans": [list(r) for r in log.summary([s for call in by_call for s in call])],
    }
    print(f"spantrace: {args.workload}: {'span':16s} {'count':>7s} {'host ms':>10s} "
          f"{'self ms':>10s}", file=sys.stderr)
    for name, n, total, own in out["spans"]:
        print(f"spantrace: {args.workload}: {name:16s} {n:7d} {total:10.3f} {own:10.3f}",
              file=sys.stderr)
    for k in ("host_s_a_call", "recorder_cost_pct", "clock_shift_us", "fence_room_us", "metrics",
              "metrics_unprofiled", "frame_us_p10_p50_p90", "device_idle_pct",
              "idle_pct_by_span", "idle_gaps"):
        print(f"spantrace: {args.workload}: {k} {out[k]}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
