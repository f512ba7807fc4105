#!/usr/bin/env python3
"""Same-card comparison of two checkouts of the PyTorch port on the batched
corner-level main path (chip_smoke.py phase 3), on K2 and K6 alone
(``--k2``), on the CCL family (``--ccl``) or on K6's single-stream frame
step and the replay that runs it (``--k6``). Host-bound rates move by up
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
With ``--k2`` it measures instead, from the same inputs in both checkouts
(chip_smoke.py's helpers, from this tree):
  - ``k2_cluster_ms``: K2 alone (torch.profiler, 20 launches) at B = 32,
    N = 387 on frame 39 of phase 2's 32 short sequences; ``k2_cluster_dense_ms``
    on 32 synthetic lanes of 100 landmarks (config 2's late tour);
  - ``k2_device_ms``: K2 alone at B = 4, N = 1,539 on frame 99 of phase 3b's
    lanes; ``k2_device_l2_ms`` on 4 synthetic lanes of 400, 60, 505 and 100
    landmarks (the first and third run in device memory);
  - ``c2_fps_128`` / ``c2_fps_512``: phase 3b's replays, 32 lanes x 300
    frames at 128 slots and 4 lanes x 100 frames at 512 (frames/s, median
    of 3, CUDA events);
  - ``k6_ms_195`` / ``k6_ms_387`` / ``k6_ms_1539``: K6 alone on phase 6's
    synthetic states (40, 100 and 300 landmarks at 64, 128 and 512 slots).

With ``--ccl`` it measures the CCL family instead (chip_smoke.py's
renderer, from this tree; DetectorConfig()'s threshold and rounds):
  - ``k3_1080p16_ms`` ... ``k5s_720p16_ms``: K3, K4, K5 and K5s alone
    (torch.profiler over 20 launches: device ms a launch of the kernels
    whose names hold ``ccl_``) at 16 and 1 rendered 1920x1080 frames and
    at 16 rendered 1280x720 frames (the block body), K5 on the raw mask and
    K5s on the closed one seeded with the raw labels; ``..._call_ms`` the
    same through the wrapper (CUDA events over 10 calls);
  - ``det_1080p_ms_per_frame``: ``runner.detect_frames`` over the 16
    1920x1080 frames in one call, ms a frame (CUDA events, median of 3);
  - ``k3_vga128_ms`` / ``k3_vga16_ms``: K3 alone in the cluster body at
    128 and 16 rendered 640x480 frames.

With ``--k6`` it measures the single-stream path (chip_smoke.py phase 7,
and phase 6's K6 states, 10 encoder ticks a frame, every observation
known: K6_STEP_TIMED), from the same inputs in both checkouts:
  - ``k6_ms_N195`` / ``k6_ms_N387`` / ``k6_ms_N1539_small`` /
    ``k6_ms_N1539_full``: K6 alone a frame (torch.profiler over 20 calls,
    device ms of the kernels whose names hold ``ekf_frame_update``) on 40
    landmarks of 64 slots, 100 of 128, 100 of 512 (a small active square
    in an N = 1,539 state) and 512 of 512 (the full square). A checkout
    with ``ekf_update.frame_step`` runs it in place (the replay's form); an
    older one runs ``frame_update`` on the predicted state (its predict is
    torch ops, outside the kernel);
  - ``k6_frame_ms_*``: the whole frame (predict and update) a call, host
    and device, CUDA events over 100 consecutive frames: the frame step
    through the replay's path (``ekf_update.replay_step``), or
    ``ekf.predict_block`` then ``frame_update``;
  - ``fps_128``: config 2's 2,100-frame ``runner.replay`` (128 slots) in
    frames/s (one timed replay after a 200-frame warm one), ``fps_512``
    its first 200 frames at 512 slots (median of 3);
  - ``events_per_frame`` / ``busy``: torch.profiler over 200 frames at 128
    slots: device events a frame and the device-busy share;
  - ``events_per_frame_512`` / ``k6_frame_ms_512``: the same 200 frames at
    512 slots, and K6's device ms a frame there.

    python3 tools/port_ab.py [--k2 | --ccl | --k6] PATH_A PATH_B

Then a table of the medians per checkout. Needs one CUDA card.
"""

import functools
import importlib.util
import json
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


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


def _smoke():
    """chip_smoke.py of this tree, as a module (its helpers import the port
    from sys.path, so they run the checkout under measure)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def measure_k2(root):
    """One ``--k2`` run's numbers for the checkout at ``root``."""
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    from aruco_slam_tpu_torch import runner
    from aruco_slam_tpu_torch.ops.camera import CameraIntrinsics
    from aruco_slam_tpu_torch.ops.kernels import ekf_update as k6
    from aruco_slam_tpu_torch.ops.kernels import ekf_update_batched as kb
    from aruco_slam_tpu_torch.utils.config import EkfConfig, SlamConfig

    cs = _smoke()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    M = cs.M

    def config(L):
        return SlamConfig(ekf=EkfConfig(max_landmarks=L, max_observations_per_frame=M))

    def k2_ms(state, frame, controls, cfg):
        return cs._kernel_ms(lambda: kb.frame_step_batched(state, frame, controls, cfg),
                             "ekf_frame_batched")[0]

    def replayed(seqs, cam, lanes, L, f):
        """The state after frames 0..f-1 of the lanes and frame f's inputs."""
        cfg = config(L)
        data = runner.build_batch_data(seqs, lanes, "corners", dev)
        head = data._replace(**{k: v[:, :f] for k, v in data._asdict().items() if v is not None})
        state = runner.replay_batch(head, cfg, cam, "corners").final_state
        return (state, *cs._k2_frame(f, data, cfg, cam), cfg)

    out = {}
    cam = CameraIntrinsics.create(600.0, 600.0, 320.0, 240.0)
    out["k2_cluster_ms"] = k2_ms(*replayed(cs._sequences(cam, range(100, 132), 5.0), cam, 32,
                                           128, 39))
    rng = np.random.default_rng(387)
    out["k2_cluster_dense_ms"] = k2_ms(*cs._k2_lanes(dev, config(128), (100,) * 32, rng),
                                       config(128))
    seqs, cam = cs._config2_arena()
    out["k2_device_ms"] = k2_ms(*replayed(seqs, cam, 4, 512, 99))
    rng = np.random.default_rng(512)
    out["k2_device_l2_ms"] = k2_ms(*cs._k2_lanes(dev, config(512), (400, 60, 505, 100), rng),
                                   config(512))
    full = runner.build_batch_data(seqs, 32, "corners", dev)
    for key, lanes, L, frames in (("c2_fps_128", 32, 128, 300), ("c2_fps_512", 4, 512, 100)):
        data = full._replace(**{k: v[:lanes, :frames] for k, v in full._asdict().items()
                                if v is not None})
        times = [cs._timed(lambda: runner.replay_batch(data, config(L), cam, "corners"))
                 for _ in range(4)][1:]  # the first builds the plans
        out[key] = lanes * frames / statistics.median(times)
    for L, n_lm in ((64, 40), (128, 100), (512, 300)):
        cfg = config(L)
        rng = np.random.default_rng(L)
        state = cs._k6_case(dev, cfg, n_lm, rng)
        frame = cs._k6_frame(state, rng)
        out[f"k6_ms_{3 + 3 * L}"] = cs._kernel_ms(lambda: k6.frame_update(state, frame, cfg),
                                                  "ekf_frame_update")[0]
    return out


def measure_k6(root):
    """One ``--k6`` run's numbers for the checkout at ``root``."""
    sys.path.insert(0, str(root))
    import dataclasses

    import numpy as np
    import torch

    from aruco_slam_tpu_torch import runner
    from aruco_slam_tpu_torch.models import ekf
    from aruco_slam_tpu_torch.ops.kernels import ekf_update as k6
    from aruco_slam_tpu_torch.utils.config import EkfConfig, SlamConfig

    cs = _smoke()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    step = getattr(k6, "frame_step", None)
    out = {}
    for tag, L, n_lm in cs.K6_STEP_TIMED:
        cfg = SlamConfig(ekf=EkfConfig(max_landmarks=L, max_observations_per_frame=cs.M))
        rng = np.random.default_rng(n_lm)
        state = cs._k6_case(dev, cfg, n_lm, rng)
        per = [cs._k6_frame(state, rng, n_known=12, n_new=0) for _ in range(101)]
        controls = cs._k6_ticks(dev, rng, 101)
        one = ekf.Control(*(x[:1] for x in controls))
        if step is not None:
            spare = ekf.init_state(cfg, 1, dev)._replace(mu=state.mu.clone(),
                                                        sigma=state.sigma.clone())
            mine = state._replace(mu=spare.mu, sigma=spare.sigma)
            kernel = functools.partial(step, mine, per[0], one, cfg, out=spare)
            frames = ekf.FrameObservations(*(torch.cat(x) for x in zip(*per)))
            rows = k6.Rows(torch.zeros(101, 3, device=dev), torch.zeros(101, 3, 3, device=dev),
                           torch.zeros(101, dtype=torch.int32, device=dev))
            rep = k6.replay_step(state, frames, controls, cfg, rows)
            box = [0]  # the next frame

            def frame():
                rep(box[0])
                box[0] += 1
        else:
            predicted = ekf.predict_block(state, one, cfg)
            kernel = functools.partial(k6.frame_update, predicted, per[0], cfg)
            box = [state, 0]

            def frame():
                f = box[1]
                box[0] = k6.frame_update(
                    ekf.predict_block(box[0], ekf.Control(*(x[f:f + 1] for x in controls)), cfg),
                    per[f], cfg)
                box[1] += 1
        out[f"k6_ms_{tag}"] = cs._kernel_ms(kernel, "ekf_frame_update")[0]
        out[f"k6_frame_ms_{tag}"] = cs._cuda_time(frame, 100)

    cfg, seq = cs._config2()
    data = runner.replay_data_from_sequence(seq, "obs", dev)
    head = data._replace(**{k: v[:200] for k, v in data._asdict().items() if v is not None})
    runner.replay(head, cfg)  # warm
    out["fps_128"] = seq.num_frames / cs._timed(lambda: runner.replay(data, cfg))
    big = dataclasses.replace(cfg, ekf=dataclasses.replace(cfg.ekf, max_landmarks=512))
    runner.replay(head, big)  # warm
    out["fps_512"] = 200 / statistics.median(cs._timed(lambda: runner.replay(head, big))
                                             for _ in range(3))
    for key, c in (("", cfg), ("_512", big)):
        n_ev, busy, by_name = _profile(torch, lambda: runner.replay(head, c))
        out[f"events_per_frame{key}"] = n_ev / 200
        out[f"busy{key}"] = busy
        out[f"k6_frame_ms{key}"] = sum(v[1] for k, v in by_name.items()
                                       if "ekf_frame_update" in k) / 200 / 1e3
    return out


def measure_ccl(root):
    """One ``--ccl`` run's numbers for the checkout at ``root``."""
    sys.path.insert(0, str(root))
    import torch

    from aruco_slam_tpu_torch import runner
    from aruco_slam_tpu_torch.ops.camera import CameraIntrinsics
    from aruco_slam_tpu_torch.ops.detector import DetectorConfig
    from aruco_slam_tpu_torch.ops.kernels import ccl
    from aruco_slam_tpu_torch.sim import renderer, synthetic

    cs = _smoke()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cfg = DetectorConfig()
    r, C, s, r1, r2 = (cfg.adaptive_radius, cfg.adaptive_C, cfg.mean_stride, cfg.ccl_rounds,
                       cfg.closed_ccl_rounds)
    hd = cs._render_hd(16, dev)
    out = {}
    for tag, img in (("1080p16", hd), ("1080p1", hd[:1].contiguous()),
                     ("720p16", cs._render_hd(16, dev, 720, 1280))):
        fg, lab, fg_c, _ = ccl.threshold_label_union_reference(img, r, C, s, r1, r2)
        seed = lab.reshape(fg.shape)
        calls = {"k3": lambda: ccl.threshold_label_union(img, r, C, s, r1, r2),
                 "k4": lambda: ccl.threshold_label(img, r, C, s, r1),
                 "k5": lambda: ccl.label_components(fg, r1),
                 "k5s": lambda: ccl.label_components(fg_c, r2, init=seed)}
        for key, call in calls.items():
            out[f"{key}_{tag}_ms"] = cs._kernel_ms(call, "ccl_")[0]
            out[f"{key}_{tag}_call_ms"] = cs._cuda_time(call, 10)
    runner.detect_frames(hd, cfg, 16)  # warm
    times = [cs._timed(lambda: runner.detect_frames(hd, cfg, 16)) for _ in range(3)]
    out["det_1080p_ms_per_frame"] = 1e3 * statistics.median(times) / 16
    vga = renderer.render_poses(cs._poses(32), synthetic.make_arena(n_markers=20),
                                CameraIntrinsics.create(600.0, 600.0, 320.0, 240.0),
                                device=dev).repeat(4, 1, 1).contiguous()
    for n in (128, 16):
        img = vga[:n].contiguous()
        out[f"k3_vga{n}_ms"] = cs._kernel_ms(
            lambda: ccl.threshold_label_union(img, r, C, s, r1, r2), "ccl_")[0]
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
    args = sys.argv[1:]
    modes = {"--measure": measure, "--measure-k2": measure_k2, "--measure-ccl": measure_ccl,
             "--measure-k6": measure_k6}
    if len(args) == 2 and args[0] in modes:
        print(json.dumps(modes[args[0]](Path(args[1]).resolve())))
        return 0
    mode = "--measure"
    if args[:1] in (["--k2"], ["--ccl"], ["--k6"]):
        mode, args = "--measure-" + args[0][2:], args[1:]
    if len(args) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    roots = {"A": Path(args[0]).resolve(), "B": Path(args[1]).resolve()}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())
    runs = {"A": [], "B": []}
    for which in "ABBA":
        proc = subprocess.run([sys.executable, __file__, mode, str(roots[which])],
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
