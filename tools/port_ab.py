#!/usr/bin/env python3
"""Same-card comparison of two checkouts of the PyTorch port on the batched
corner-level main path (chip_smoke.py phase 3). Host-bound rates move by up
to 2x from one machine to the next, so two versions are compared only
inside one run, in the order A, B, B, A (each in a fresh process that
builds its own kernels).

    python3 tools/port_ab.py PATH_A PATH_B

Each PATH is the root of a checkout (it holds ``aruco_slam_tpu_torch/``).
Per run it prints one JSON line of, for ``runner.replay_batch`` over 8
synthetic sequences (seeds 0-7, 60 s, 16 marker slots) tiled to 256 lanes,
600 frames at corner level, EkfConfig(max_landmarks=32,
max_observations_per_frame=16):
  - ``fps``: frames/s (lanes x frames over the wall time), median of 3
    (host clock around a synchronize);
  - ``events_per_frame`` / ``busy``: torch.profiler over one replay, device
    events per frame and the device-busy share of its wall time;
  - ``k1_ms`` / ``k2_ms``: the device time per launch of K1 and K2 (kernels
    whose names hold ``pnp_frontend`` and ``ekf_frame``) in that profile;
  - ``peak_mib``: the replay's peak device memory above its inputs;
  - ``check_us``: K2's input checks alone (host clock, median of 5 x 2,000
    calls) on the replay's last frame, with the 16 inputs of a call;
  - ``check_all_us``: the same with every tensor the replay hands K2 (the
    parent: the 16; from the frame-step redesign on: the 16, the spare
    state and the rows, and their aliasing);
  - ``check_per_frame_us``: what the checks cost the replay per frame (the
    parent checks every frame; later versions check the first frame only).
Then a table of the medians per checkout. Needs one CUDA card.
"""

import json
import statistics
import subprocess
import sys
from pathlib import Path


def _profile(torch, fn):
    """(device events, device-busy share of the call's wall time,
    {name: [count, us]}) of one call under torch.profiler."""
    import time

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # device activity only: tracing the host too makes later profiles in
    # the process drop device events
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, by_name = [], {}
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        spans.append((evt.time_range.start, evt.time_range.end))
        item = by_name.setdefault(evt.name, [0, 0.0])
        item[0] += 1
        item[1] += evt.time_range.end - evt.time_range.start
    busy, last = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > last:
            busy += end - max(start, last)
            last = end
    return len(spans), busy / 1e6 / wall, by_name


def measure(root):
    """One run's numbers for the checkout at ``root`` (a fresh process)."""
    sys.path.insert(0, str(root))
    import time

    import torch

    from aruco_slam_tpu_torch import runner
    from aruco_slam_tpu_torch.ops.camera import CameraIntrinsics
    from aruco_slam_tpu_torch.sim import synthetic
    from aruco_slam_tpu_torch.utils.config import EkfConfig, SlamConfig

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    B, F, M = 256, 600, 16
    cam = CameraIntrinsics.create(600.0, 600.0, 320.0, 240.0)
    seqs = [synthetic.generate_sequence(synthetic.SimParams(duration=60.0, seed=s, max_obs=M),
                                        level="corners", camera=cam) for s in range(8)]
    cam = seqs[0].camera()
    data = runner.build_batch_data(seqs, B, "corners", dev)
    cfg = SlamConfig(ekf=EkfConfig(max_landmarks=32, max_observations_per_frame=M))

    def replay():
        return runner.replay_batch(data, cfg, cam, "corners")

    replay()  # warm: builds the kernels
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        replay()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    out = {"fps": B * F / statistics.median(times)}
    n_ev, out["busy"], by_name = _profile(torch, replay)
    out["events_per_frame"] = n_ev / F
    for key, part in (("k1_ms", "pnp_frontend"), ("k2_ms", "ekf_frame")):
        hits = [v for k, v in by_name.items() if part in k]
        out[key] = sum(v[1] for v in hits) / sum(v[0] for v in hits) / 1e3
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    replay()
    torch.cuda.synchronize()
    out["peak_mib"] = (torch.cuda.max_memory_allocated() - base) / 2**20
    out.update(_check_costs(torch, runner, data, cfg, replay()))
    return out


def _check_costs(torch, runner, data, cfg, res):
    """Host microseconds of K2's input checks on the replay's last frame."""
    import time

    from aruco_slam_tpu_torch.models import ekf
    from aruco_slam_tpu_torch.ops.kernels import ekf_update_batched as kb

    B, F, M = data.obs_ids.shape
    dev = data.obs_ids.device
    state = res.final_state
    ew = data.enc_w[:, F - 1]
    frame = ekf.FrameObservations(
        data.obs_ids[:, F - 1].contiguous(), torch.zeros(B, M, 3, device=dev),
        torch.eye(3, device=dev).repeat(B, M, 1, 1), data.obs_valid[:, F - 1].contiguous())
    controls = ekf.Control(ew[..., 0], ew[..., 1], data.enc_dt[:, F - 1])
    if hasattr(kb, "Rows"):  # K2 takes the raw frame and checks the replay once
        spare = ekf.init_state(cfg, B, dev)
        rows = kb.Rows(res.trajectory, res.pose_cov, res.n_landmarks, F - 1)
        one, every, per_replay = (state, frame, controls, cfg, None, None), \
            (state, frame, controls, cfg, spare, rows), True
    else:  # K2 takes the glue's sorted frame and checks every frame
        one = every = (state, *runner.frame_step_inputs(state, frame, controls, cfg), cfg)
        per_replay = False

    def host_us(args, n=2000):
        kb._check_inputs(*args)
        runs = []
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(n):
                kb._check_inputs(*args)
            runs.append((time.perf_counter() - t0) / n * 1e6)
        return statistics.median(runs)

    costs = {"check_us": host_us(one), "check_all_us": host_us(every)}
    costs["check_per_frame_us"] = costs["check_all_us"] / (F if per_replay else 1)
    return costs


def main():
    if len(sys.argv) == 3 and sys.argv[1] == "--measure":
        print(json.dumps(measure(Path(sys.argv[2]).resolve())))
        return 0
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    roots = {"A": Path(sys.argv[1]).resolve(), "B": Path(sys.argv[2]).resolve()}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())
    runs = {"A": [], "B": []}
    for which in "ABBA":
        proc = subprocess.run([sys.executable, __file__, "--measure", str(roots[which])],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout[-3000:], proc.stderr[-3000:], file=sys.stderr)
            return 1
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        runs[which].append(row)
        print(f"{which} {roots[which]}: {json.dumps(row)}", flush=True)
    print(f"{'metric':24s} {'A (median)':>14s} {'B (median)':>14s}")
    for key in runs["A"][0]:
        med = {w: statistics.median(r[key] for r in runs[w]) for w in runs}
        print(f"{key:24s} {med['A']:14.6f} {med['B']:14.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
