"""The benchmark of ``aruco_slam_tpu_torch`` on one or more NVIDIA GPUs.

    python3 -m portbench --workload NAME --seed N --seconds S --trace 0|1

runs one cell of ``BENCHMARK.json`` once, from the root of a checkout:

1. set-up: the port imported, the cell's inputs made from ``--seed``
   (``cell.Cell``), one warm call of its entry (``cell.Program`` for the
   replays, else ``entries/<entry>.py``'s), which builds the port's kernels
   into its fixed build directory on a fresh checkout;
2. ``--trace 0``: whole calls back to back, one caller, each ended by a
   synchronize, until ``--seconds`` have passed; the cell's end-to-end
   metrics (``end_to_end/<name>.py``) read that window.
   ``--trace 1``: the traffic's ``trace_calls`` calls under
   ``torch.profiler`` instead; the cell's per-layer metrics
   (``layers/<name>.py``) read that trace;
3. the window's last result compared with the plain reference
   (``check.py``, or the entry's own comparison) once the peak memory is
   read and the rest is freed;
4. the last line of standard output: one JSON object with ``correct``,
   ``attempted``, ``failed``, ``metrics``, ``device``, (traced)
   ``breakdown``, and last ``checks``, each compared number with its
   limit; the same numbers are the last lines of standard error.

It exits with a code other than 0, and prints no result, without a GPU
(or with fewer than the cell asks for), and when the process has loaded
``jax``, ``jaxlib``, ``flax`` or ``aruco_slam_tpu`` (compared by the whole
top-level name of each loaded module). A traced run whose profiler keeps
fewer device events than its calls launched, in the widest window tried,
ends likewise (``trace.PartialTrace``).
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import numpy as np
import torch

from portbench import cell as cellmod
from portbench import check, roofline, trace
from portbench.spec import Spec

FORBIDDEN = ("jax", "jaxlib", "flax", "aruco_slam_tpu")


def loaded_forbidden() -> list:
    """Top-level names of loaded modules that the benchmark must not load."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


class Window:
    """The timed window: each call's seconds (call to synchronize), the
    span from the window's start to the last completion, the work a call
    does and the set-up before the window."""

    def __init__(self, seconds: list, span_s: float, frames_per_call: int, setup_s: float):
        self.seconds, self.span_s = seconds, span_s
        self.frames_per_call, self.setup_s = frames_per_call, setup_s
        self.calls = len(seconds)
        self.frames_per_s = self.calls * frames_per_call / span_s


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_window(program, device, seconds: float):
    """Whole calls back to back until ``seconds`` have passed: (each call's
    seconds, the span to the last completion, the last output)."""
    _sync(device)
    start = time.perf_counter()
    times, end = [], start
    while end - start < seconds:
        t = time.perf_counter()
        out = program()
        _sync(device)
        end = time.perf_counter()
        times.append(end - t)
    return times, end - start, out


def _stage_ms(marks: list) -> list:
    """The detector's stage marks ``[(stage, event), ...]`` as one dict a
    detector call of {stage: ms since the previous mark}."""
    calls, prev = [], None
    for stage, event in marks:
        if stage == "start":
            calls.append({})
        elif prev is not None:
            calls[-1][stage] = prev.elapsed_time(event)
        prev = event
    return calls


def _bounds(c, ref: dict) -> dict:
    """Each kernel family's bound seconds for one call of the cell."""
    L = c.config["filter"]["max_landmarks"]
    lanes = np.bincount(c.lane_base.cpu().numpy(), minlength=c.distinct)
    if c.level == "images":
        ids, _, valid = (x.cpu().numpy() for x in ref["detections"])
    else:
        ids, valid = c.base["ids"], c.base["valid"]
    out = roofline.replay_bounds(ids, valid, lanes, L, ids.shape[-1], c.epf,
                                 c.level != "obs")
    if c.level == "images":
        from aruco_slam_tpu_torch.ops.detector import DetectorConfig

        d, cam = DetectorConfig(), c.config["camera"]
        out["ccl"] = roofline.ccl_union_launch(c.lanes * c.frames, cam["height"], cam["width"],
                                               d.ccl_rounds, d.closed_ccl_rounds)
    return out


def run(workload: str, seed: int, seconds: float, traced: bool, device="cuda",
        t_start: float | None = None, spec: Spec | None = None) -> dict:
    """One run of ``workload``; returns the result line's object."""
    t_start = time.time() if t_start is None else t_start
    spec = spec or Spec()
    w = spec.workload(workload)
    config, traffic = spec.config(w["config"]), spec.traffic(w["traffic"])
    import aruco_slam_tpu_torch  # noqa: F401  (sets true float32 products: TF32 off)
    from aruco_slam_tpu_torch.ops import detector

    device = torch.device(device)
    c = cellmod.Cell(config, traffic, seed & (2**63 - 1), device)
    entry = None if traffic["entry"] in cellmod.ENTRIES else spec.entry(traffic["entry"])
    program = cellmod.Program(c) if entry is None else entry.Program(c)
    out = program()  # warm: every shape of the window, every kernel built and loaded
    _sync(device)
    result = {"correct": False, "attempted": 0, "failed": 0, "metrics": {}}
    if not traced:
        setup_s = time.time() - t_start
        times, span, out = timed_window(program, device, seconds)
        window = Window(times, span, c.frames_per_call, setup_s)
        q = np.percentile(times, [0, 50, 100])
        print(f"portbench: {len(times)} calls in {span:.3f} s; s a call: first {times[0]:.4f}, "
              f"min {q[0]:.4f}, median {q[1]:.4f}, max {q[2]:.4f}", file=sys.stderr)
        result["attempted"] = window.calls
        for m in spec.metrics("end_to_end", workload):
            result["metrics"][m["name"]] = {"value": spec.reader("end_to_end", m["name"])(window),
                                            "unit": m["unit"]}
    else:
        def reset():
            detector.STAGE_MARKS = [] if c.level == "images" else None

        calls = traffic["trace_calls"]
        before = program.launches()
        events, span, out = trace.profile_calls(program, calls, calls * c.frames, "ekf_frame",
                                                reset)
        launched = {k: v - before[k] for k, v in program.launches().items() if v != before[k]}
        print(f"portbench: the kernel wrappers' launches in the traced window: {launched}",
              file=sys.stderr)
        marks = _stage_ms(detector.STAGE_MARKS or [])
        detector.STAGE_MARKS = None
        tr = trace.Trace(events, span, calls, c.frames, c.lanes, stage_ms=marks,
                         detected_frames=c.lanes * c.frames, traffic=traffic)
        result["attempted"] = calls
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    if entry is None:
        lanes = cellmod.sample_lanes(c.lanes, traffic["check_lanes"], c.seed)
        got = cellmod.result_of(out, traffic["entry"])
        idx = torch.as_tensor(lanes, device=device)
        got = {k: v.index_select(0, idx) for k, v in got.items()}
        detections = program.detections
    else:
        got = entry.result(out)
    program.close()
    del out, program
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    if entry is None:
        ref = check.reference(c, lanes)
        values = check.numbers(c, got, detections, ref)
        what = f"{len(lanes)} lanes"
    else:
        ref = entry.reference(c)
        values = entry.numbers(c, got, ref)
        what = f"entry {traffic['entry']}"
    print(f"portbench: the reference took {time.perf_counter() - t_ref:.1f} s for {what}",
          file=sys.stderr)
    ok, table = check.judge(values, traffic["limits"])
    if traced:
        tr.bounds = _bounds(c, ref) if entry is None else entry.bounds(c, ref)
        for m in spec.metrics("per_layer", workload):
            v = spec.reader("layers", m["name"])(tr)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
    result["correct"], result["failed"] = ok, 0 if ok else 1
    result["device"] = _device(device, w.get("chips", 1), peak)
    if traced:
        result["device"]["busy_s"] = tr.busy_us() / 1e6
        result["device"]["window_s"] = tr.window_s
        result["breakdown"] = tr.breakdown()
    result["checks"] = table
    return result


def _device(device: torch.device, chips: int, peak: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
            "memory_peak_bytes": peak}


def _power_limit() -> str:
    import shutil
    import subprocess

    if not shutil.which("nvidia-smi"):
        return "nvidia-smi not found"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else smi.stderr.strip()


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python3 -m portbench", description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, t_start: float | None = None) -> int:
    args = parse(argv)
    torch.set_num_threads(1)  # one caller: the window's host work runs on one thread
    spec = Spec()
    chips = spec.workload(args.workload).get("chips", 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    if args.trace:
        print(f"portbench: {_power_limit()}", file=sys.stderr)
    result = run(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", t_start, spec)
    bad = loaded_forbidden()
    if bad:
        print(f"portbench: the process loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, row in result["checks"].items():
        print(f"check {name}: {row['value']!r} (limit {row['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
