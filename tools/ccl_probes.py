#!/usr/bin/env python3
"""The probes P1-P3 of the JAX package's CCL and detector studies
(``benchmarks/_ccl_fixed_probe.py``, ``_det_chain_probe.py``,
``_p1080b_probe.py``) measured on the port's kernels, on one card.

- P1: where K4's time goes. On P1's 20 rendered 640x480 frames in the
  cluster body: the copy (``probes.copy_to_int32``, float32 -> int32: the
  floor), the threshold alone (``ccl.threshold_only``), K4 at 1, 2, 4 and 8
  rounds (0 rounds is the threshold alone) and K5 on the threshold's mask
  at 1, 4 and 8 rounds. On 16 rendered 1920x1080 frames in the block body:
  the copy, the threshold alone and K4 at the same rounds.
- P2: the scaled copy (``probes.scale_copy``) on P2's 32 rendered 640x480
  frames and ``img * 1.0000001`` beside it, then one detector call
  (``detect_markers_batch``, ``DetectorConfig()``) on the same frames split
  by stage (the recorder's ``detect.<stage>`` spans, CUDA events), each
  stage beside the copy's floor.
- P3: K4 (3 rounds) on a 1920x1080 frame of random bytes in the plan the
  planner picks (resident: the tiles' workspaces in shared memory) and in
  the spilled plan (``ccl.spilled_plan``: in device memory, one team on
  every SM).

The probes' inputs, calls, plain versions and bytes are chip_smoke.py's
(``_probe_steps``: its phase 4b). Each line gives the device ms a launch
(torch.profiler over 20 launches, the kernels alone; CUDA events over
back-to-back calls where the profiler saw none), ms a frame, the bytes
(each input byte read once, each output byte written once), the achieved
GB/s and its share of 3.35 TB/s. The first line is the card's name and
power limit, the last a JSON object of every number. Every result is
checked against its plain version first. Needs one CUDA card and nvcc.

    python3 tools/ccl_probes.py
"""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ccl_probes: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from aruco_slam_tpu_torch.ops import detector
    from aruco_slam_tpu_torch.ops.kernels import ccl, probes
    from aruco_slam_tpu_torch.utils import logging as slog

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    frames = cs._probe_frames(dev)
    p1, p2, hd = frames["p1"], frames["p2"], frames["hd"]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plans = {"resident": ccl.block_plan(1080, 1920, 1, sms),
             "spilled": ccl.spilled_plan(1080, 1920, sms)}

    # chip_smoke.py's probe rows, P1's copy and rounds sweep on the 1080p
    # frames too, and the copies' one PyTorch call each
    steps = cs._probe_steps(frames, plans["spilled"])
    steps["probe_copy.1080p"] = cs._probe_step("copy", lambda: probes.copy_to_int32(hd),
                                               lambda: probes.copy_to_int32_reference(hd), hd)
    steps.update(cs._rounds_steps(hd, with_k5=False))
    steps["library.copy"] = cs._probe_step("copy", lambda: p1.to(torch.int32),
                                           lambda: probes.copy_to_int32_reference(p1),
                                           p1)._replace(part="")
    steps["library.scale"] = cs._probe_step("scale", lambda: p2 * 1.0000001,
                                            lambda: probes.scale_copy_reference(p2),
                                            p2)._replace(part="")
    out, ms = {}, {}
    for name, step in steps.items():
        cs._probe_check(name, step)
        ms[name], how = cs._probe_ms(step)
        n_frames = step.img.shape[0]
        gbps = step.n_bytes / ms[name] / 1e6
        out[name] = {"ms": ms[name], "ms_per_frame": ms[name] / n_frames,
                     "bytes": step.n_bytes, "gb_per_s": gbps,
                     "share": gbps * 1e9 / cs.HBM_BYTES_PER_S, "timed_by": how,
                     "shape": list(step.img.shape)}
        print(f"{name:34s} {ms[name]:9.4f} ms ({how}), {ms[name] / n_frames:8.4f} ms a frame, "
              f"{cs._probe_rate(step.n_bytes, ms[name])}")
    for kind, copy in (("cluster", "probe_copy"), ("block", "probe_copy.1080p")):
        out[f"split.{kind}"], text = cs._probe_split(ms, kind, copy)
        print(text)

    # P2: one detector call on the same frames by stage, beside the scaled copy
    floor = ms["probe_scale"]
    cfg = detector.DetectorConfig()
    detector.detect_markers_batch(p2, cfg)  # warm
    slog.RECORDER = rec = slog.Recorder()
    torch.cuda.synchronize()
    detector.detect_markers_batch(p2, cfg)
    torch.cuda.synchronize()
    slog.RECORDER = None
    stages = slog.stage_ms(rec.closed())
    out["p2.detector_stages_ms"] = stages
    print(f"p2: one detector call on the {p2.shape[0]} frames by stage (ms, x the scaled "
          f"copy's {floor:.4f}): " + ", ".join(f"{k} {v:.3f} ({v / floor:.0f}x)"
                                              for k, v in stages.items()))

    # P3: K4 on random bytes in both plans
    res, spl = ms["threshold_label.block.random"], ms["threshold_label.block.spilled"]
    out["p3.plans"] = {name: plan._asdict() for name, plan in plans.items()}
    print(f"p3: the spilled plan takes {spl - res:.4f} ms more than the resident one "
          f"({spl / res:.2f}x)")
    print(json.dumps({"card": smi.stdout.strip(), **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
