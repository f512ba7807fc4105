#!/usr/bin/env python3
"""Same-card comparison of two checkouts of the PyTorch port, for the paths
that K6 and the CCL family serve. Host-bound rates move by up to 2x from
one machine to the next, so two versions are compared only inside one run,
in the order A, B, B, A (each in a fresh process that builds its own
kernels).

    python3 tools/port_ab.py PATH_A PATH_B

Each PATH is the root of a checkout (it holds ``aruco_slam_tpu_torch/``).
Per run it prints one JSON line of:
  - ``c2_fps``: BASELINE config 2 (benchmarks/run_all.py config2_loop_100,
    2,100 frames, 128 landmarks) through ``runner.replay``, frames/s,
    median of 3 (host clock around a synchronize);
  - ``c2_events_per_frame`` / ``c2_busy``: torch.profiler over its first
    200 frames, device events per frame and the device-busy share of the
    profiled call's wall time;
  - ``k6_wrapper_ms`` / ``k6_alone_ms``: K6 at N = 387 on one frame of 9
    known and 4 new markers in shuffled order, ms per call over 200 calls
    and the kernel's device time (torch.profiler);
  - ``k3_ms_128`` / ``k3_ms_16``: one K3 launch on 128 and 16 rendered
    640x480 frames (CUDA events, mean of 20);
  - ``detect_ms_per_frame``: ``runner.detect_frames`` over 256 rendered
    640x480 frames at 128 frames per call.
Then a table of the medians per checkout. Needs one CUDA card.
"""

import json
import statistics
import subprocess
import sys
from pathlib import Path


def _cuda_time(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _profile(torch, fn):
    """(device events, device-busy share of the call's wall time,
    {name: [count, us]}) of one call under torch.profiler."""
    import time

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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

    import numpy as np
    import torch

    from aruco_slam_tpu_torch import runner
    from aruco_slam_tpu_torch.models import ekf
    from aruco_slam_tpu_torch.ops.camera import CameraIntrinsics
    from aruco_slam_tpu_torch.ops.detector import DetectorConfig
    from aruco_slam_tpu_torch.ops.kernels import ccl
    from aruco_slam_tpu_torch.ops.kernels import ekf_update as k6
    from aruco_slam_tpu_torch.sim import renderer, synthetic
    from aruco_slam_tpu_torch.utils.config import EkfConfig, SlamConfig

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    out = {}

    # BASELINE config 2, single stream
    cfg = SlamConfig(ekf=EkfConfig(max_landmarks=128, max_observations_per_frame=16))
    seq = synthetic.generate_sequence(
        synthetic.SimParams(duration=210.0, profile="tour", tour_width=20.0, tour_height=16.0,
                            tour_inset=1.6, encoder_noise=0.4, fov_deg=90.0,
                            max_view_angle_deg=85.0, seed=11),
        marker_map=synthetic.make_arena(n_markers=100, width=20.0, height=16.0),
    )
    data = runner.replay_data_from_sequence(seq, "obs", dev)
    runner.replay(data, cfg)  # warm
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner.replay(data, cfg)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    out["c2_fps"] = seq.num_frames / statistics.median(times)
    head = data._replace(**{k: v[:200] for k, v in data._asdict().items() if v is not None})
    n_ev, out["c2_busy"], _ = _profile(torch, lambda: runner.replay(head, cfg))
    out["c2_events_per_frame"] = n_ev / 200

    # K6 at N = 387 on one frame: 9 known, 4 new, 3 invalid, shuffled
    rng = np.random.default_rng(128)
    L, n_lm, M = 128, 100, 16
    N, na = 3 + 3 * L, 3 + 3 * n_lm
    A = rng.normal(size=(na, na)) * 0.1
    sigma = np.zeros((N, N), np.float32)
    sigma[:na, :na] = A @ A.T + 0.05 * np.eye(na)
    mu = np.zeros(N, np.float32)
    mu[:na] = rng.normal(size=na)
    slot_ids = np.full(L, -1, np.int32)
    slot_ids[:n_lm] = rng.choice(100_000, n_lm, replace=False)

    def t(x, dtype):
        return torch.as_tensor(x, dtype=dtype, device=dev)[None]

    state = ekf.init_state(cfg, 1, dev)._replace(
        mu=t(mu, torch.float32), sigma=t(sigma, torch.float32),
        slot_ids=t(slot_ids, torch.int32),
        n_landmarks=torch.tensor([n_lm], dtype=torch.int32, device=dev),
        last_obs=t(rng.normal(size=(L, 3)), torch.float32),
        seen_prev=torch.ones(1, L, dtype=torch.bool, device=dev),
        initialized=torch.ones(1, dtype=torch.bool, device=dev))
    ids = np.full(M, -1, np.int32)
    ids[:13] = np.concatenate([slot_ids[rng.choice(n_lm, 9, replace=False)],
                               200_000 + rng.choice(100_000, 4, replace=False)])
    z = (rng.normal(size=(M, 3)) * 0.5).astype(np.float32)
    Bn = (rng.normal(size=(M, 3, 3)) * 0.05).astype(np.float32)
    R = Bn @ np.transpose(Bn, (0, 2, 1)) + 0.01 * np.eye(3, dtype=np.float32)
    perm = rng.permutation(M)
    frame = ekf.FrameObservations(*(torch.as_tensor(x[perm], device=dev)[None]
                                    for x in (ids, z, R, ids >= 0)))
    call = lambda: k6.frame_update(state, frame, cfg)  # noqa: E731
    out["k6_wrapper_ms"] = _cuda_time(torch, call, 200)

    def twenty():
        for _ in range(20):
            call()

    n_ev, _, by_name = _profile(torch, twenty)
    spans = [v for k, v in by_name.items() if "ekf_frame_update" in k]
    out["k6_alone_ms"] = spans[0][1] / spans[0][0] / 1e3 if spans else None
    out["k6_events_per_call"] = n_ev / 20

    # K3 and detection on rendered 640x480 frames
    rng = np.random.default_rng(4)
    poses = np.stack([rng.uniform(0.8, 4.3, 64), rng.uniform(-3.9, -0.8, 64),
                      rng.uniform(-np.pi, np.pi, 64)], axis=1)
    vga = renderer.render_poses(poses, synthetic.make_arena(n_markers=20),
                                CameraIntrinsics.create(600.0, 600.0, 320.0, 240.0), device=dev)
    frames = vga.repeat(4, 1, 1).contiguous()  # 256
    det = DetectorConfig()
    args = (det.adaptive_radius, det.adaptive_C, det.mean_stride, det.ccl_rounds,
            det.closed_ccl_rounds)
    for n in (128, 16):
        img = frames[:n].contiguous()
        out[f"k3_ms_{n}"] = _cuda_time(torch, lambda: ccl.threshold_label_union(img, *args), 20)
    runner.detect_frames(frames, det, 128)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        runner.detect_frames(frames, det, 128)
    torch.cuda.synchronize()
    out["detect_ms_per_frame"] = (time.perf_counter() - t0) * 1e3 / (3 * frames.shape[0])
    return out


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
