#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU: builds the hand-written
CUDA kernels from this checkout, holds each against its plain PyTorch version
at the main paths' shapes, then drives the main paths — batched corner-level
replay (256 lanes x 600 frames, K1 + K2), batched image-level replay (32 lanes
x 60 rendered 640x480 frames, K3 + K1 + K2), single-stream replay of BASELINE
config 2 (2,100 frames, 128 landmarks, K6) and the streaming SlamSystem (60
rendered frames, K3 + K6) — and checks each against its plain path and the
ground truth.

Run from the repository root:  python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero):
  0. the card: refuse without CUDA; print its name and power limit; build
     the four kernel sources (nvcc, sm_90a, all at once) and print ptxas's
     register report.
  1. K1 (PnP front-end) vs its plain version: B=256 x M=16 lanes of real
     corners, padded and garbage slots included, on an undistorted and a
     distorted camera. keep equal on every lane; z, R to atol 2e-5 (R rtol
     2e-4) where kept.
  2. K2 (EKF frame step) vs its plain version: B=256, N=99, M=16 over 20
     consecutive frames of real inputs (and a small-capacity config where
     landmarks drop). Integer state exact; mu, sigma to atol 5e-5 / rtol 5e-3.
  3. the main path: runner.replay_batch over 8 synthetic sequences (seeds
     0-7, 60 s) tiled to 256 lanes, EkfConfig(max_landmarks=32,
     max_observations_per_frame=16), the sequences' own camera. Each kernel
     launches exactly once per frame; landmarks and slots equal the plain
     path's on every lane and the trajectory is within TRAJ_TOL of it over
     the plain run's cut depth (the first PLAIN_FRAMES frames); frames/s.
  4. the CCL family K3, K4, K5, K5s vs their plain versions, bit for bit:
     32 rendered 640x480 frames at varied poses, 8 uniform-noise frames and
     2 rendered 1920x1080 frames; ms per 16-frame 640x480 launch beside the
     plain version's.
  5. the image-level path at bench.py's shape (BASELINE.md config 3b):
     runner.replay_batch(..., "images") over 2 rendered sequences (seeds 0
     and 1, 6 s at 10 Hz) tiled to 32 lanes, EkfConfig(max_landmarks=32,
     max_observations_per_frame=24), DetectorConfig(). K3 launches once per
     128-frame chunk, K1 and K2 once per frame; detections equal the plain
     detector's (ids, valid exact, corners to 1e-3 px); landmarks and slots
     equal the plain path's; trajectory within TRAJ_TOL; lane 0 ATE below
     0.05 m; frames/s of both paths (the plain path and the JAX default
     chunk of 16 timed once), the detection/replay split and a per-stage
     split of one chunk's detection. The two other detector
     branches run the same replay once each: closing_union=False (K4) and
     a stride the fused threshold does not take (K5, K5s).
  6. K6 (single-stream frame update) vs its plain version at max_landmarks
     64, 128 and 512 (and 5, where observations drop), M=16, both
     reject_divergent settings, over frames of new, known, gated and
     dropped observations, plus an uninitialized no-op. Integer state
     exact; mu, sigma to atol 5e-5 / rtol 5e-3. ms per launch (100
     launches) beside the plain version's and K2's at B=1, N=195.
  7. the single-stream main path: runner.replay_sequence of BASELINE config
     2 (benchmarks/run_all.py config2_loop_100: the 100-marker 20 x 16 m
     arena, 210 s tour, EkfConfig(max_landmarks=128,
     max_observations_per_frame=16), 2,100 frames at obs level) against
     runner.replay_reference. K6 launches once per frame; landmarks and
     slots equal; trajectory within TRAJ_TOL; ATE of both; frames/s (median
     of 3). Then fused_update=True (plain update_fused) against the same
     reference.
  8. the streaming SlamSystem with the default SlamConfig(): 60 frames of
     10 add_encoder calls and one add_image of a 640x480 frame rendered on
     the card, against the same calls through the plain versions (pose, map
     and every frame's detections); median ms per add_image / add_encoder.
Every kernel's bound is the larger of its bytes over 3.35 TB/s and its
operations over 67 TFLOP/s (the H100 SXM data sheet), from this run's inputs.
The second-to-last line is a JSON object of the kernels; the last line is
{"ok": true, "device": {...}}.
"""

import functools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
DIST = (-0.28, 0.07, 1.2e-3, -8e-4, 0.018)  # tests/test_pallas_kernels.py:354
B, M, F = 256, 16, 600
# Depth of phase 3's plain run: the whole script has to finish well inside
# its time limit, and the plain path runs about 10x slower than the kernels.
PLAIN_FRAMES = 150
# the image-level path: bench.py's bench_image_level (BASELINE.md config 3b)
IMG_B, IMG_SECONDS = 32, 6.0
# Frames per detector call on the card. Detections do not depend on it. The
# JAX default of 16 puts K3 on 16 of the 132 SMs and leaves the torch stages
# launch-bound; on an H100 (700 W) detection took 1.06 ms/frame at 16 and
# 0.15 ms/frame at 128, with a peak of 1.8 GiB (PERF.md, section 5).
IMG_CHUNK = 128
# Detections of the kernel path against the plain detector on the same card:
# the CCL stage is bit-identical, so everything downstream runs the same ops
# on the same bits; 1e-3 px is the CPU parity tests' bound.
CORNER_TOL = 1e-3
# Trajectory agreement of the kernel path with the plain path over 600
# frames: both are float32 with sums taken in another order, and the EKF
# carries the differences forward; 1 mm / 1 mrad is far below the
# filter's own error against the ground truth.
TRAJ_TOL = 1e-3
# NVIDIA H100 SXM peaks (data sheet): HBM bytes/s and float32 (non-tensor)
# operations/s. A kernel's bound is the larger of its two times.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Hand counts of each kernel's arithmetic from its source, per unit of work:
# K1 runs 8 Gauss-Newton iterations (2 settle on each of 2 starts, 4 to
# finish) of about 1,100 operations (4 points: projection, 2x6 Jacobian rows,
# J^T J and J^T r; the 6x6 Cholesky and solves; the pose update), plus the
# 8-step undistortion of 4 corners and the homography / Zhang start.
K1_OPS_PER_LANE = 10_000
# The CCL family per pixel: the threshold about 5 (block sum, window mean,
# compare), the 3x3 closing 18, and each CCL round 17 (8-neighbour min, four
# directional run scans).
CCL_THRESHOLD_OPS, CCL_CLOSE_OPS, CCL_ROUND_OPS = 5, 18, 17


def _bound(n_bytes, n_ops):
    """(ms, "bytes" or "operations"): the least time the card could take."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _ekf_bound(B, N, L, M, known, predict):
    """An EKF frame step's bound: sigma and mu read and written once, the
    observations and the bookkeeping read once; 6 N^2 operations per known
    observation's rank-3 update, and 30 N per lane for K2's predict."""
    state = (2 * N * N + 2 * N) * 4 + 2 * L * (4 + 12 + 1)
    obs = M * (4 + 12 + 36 + 1 + 4)
    n_bytes = B * (state + obs + (84 if predict else 0))
    return _bound(n_bytes, 6 * N * N * known + (30 * N * B if predict else 0))


def _cuda_time(fn, reps):
    """Milliseconds per call: CUDA events around ``reps`` calls, after a
    warm-up call and a synchronize."""
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


def _require(cond, what):
    if not cond:
        raise AssertionError(what)


def _max_err(a, b, mask=None):
    d = (a - b).abs()
    if mask is not None:
        d = d[mask]
    return float(d.max()) if d.numel() else 0.0


def phase0_card():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    print(smi.stdout.strip().splitlines()[0])
    from concurrent.futures import ThreadPoolExecutor

    from aruco_slam_tpu_torch.ops.kernels import _build

    names = ("pnp_frontend", "ekf_frame_batched", "ccl", "ekf_frame_update")
    with ThreadPoolExecutor(len(names)) as pool:  # one nvcc per source, all at once
        list(pool.map(_build.load, names))
    for name in names:
        report = _build.build_reports.get(name, "(reused an existing build)")
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build {name}] {line.strip()}")


def _sequences(camera, seeds, duration):
    from aruco_slam_tpu_torch.sim import synthetic

    return [
        synthetic.generate_sequence(
            synthetic.SimParams(duration=duration, seed=s, max_obs=M),
            level="corners", camera=camera,
        )
        for s in seeds
    ]


def phase1_k1(cfg, dev):
    """K1 against its plain version on the card; returns (max err, ms, plain ms)."""
    from aruco_slam_tpu_torch.ops.camera import CameraIntrinsics
    from aruco_slam_tpu_torch.ops.kernels import pnp_frontend as pk

    worst, timing = 0.0, None
    for dist in (None, DIST):
        cam = CameraIntrinsics.create(600.0, 600.0, 320.0, 240.0, dist=dist)
        seqs = _sequences(cam, range(8), 10.0)
        lane = np.arange(B)
        frame = (37 * lane) % seqs[0].num_frames  # spread lanes over the run
        corners = np.stack([seqs[b % 8].corners_px[frame[b]] for b in lane])
        valid = np.stack([seqs[b % 8].obs_valid[frame[b]] for b in lane])
        # garbage corners marked valid in a few slots: the gates must drop them
        corners[::17, -1] = [[np.inf, 0.0], [np.nan, 1.0], [1e9, 2.0], [0.0, 0.0]]
        valid[::17, -1] = True
        c = torch.as_tensor(corners, device=dev)
        v = torch.as_tensor(valid, device=dev)
        z, R, keep = pk.pnp_frontend_batch(c, v, cam, cfg)
        zr, Rr, keepr = pk.pnp_frontend_reference(c, v, cam, cfg)
        torch.cuda.synchronize()
        _require(torch.equal(keep, keepr), f"K1 keep differs on {int((keep != keepr).sum())} lanes")
        _require(not bool(keep[::17, -1].any()), "K1 kept a garbage slot")
        _require(int(keep.sum()) > B, "K1 kept too few real markers to mean anything")
        ez = _max_err(z, zr, keep)
        eR = _max_err(R, Rr, keep)
        R_ok = torch.allclose(R[keep], Rr[keep], atol=2e-5, rtol=2e-4)
        _require(ez <= 2e-5 and R_ok, f"K1 vs plain: z err {ez}, R err {eR}")
        print(f"phase 1: K1 dist={dist is not None} lanes={B * M} kept={int(keep.sum())} "
              f"max |dz|={ez:.3e} max |dR|={eR:.3e}")
        worst = max(worst, ez, eR)
        if timing is None:
            ms = _cuda_time(lambda: pk.pnp_frontend_batch(c, v, cam, cfg), 50)
            plain = _cuda_time(lambda: pk.pnp_frontend_reference(c, v, cam, cfg), 5)
            timing = (ms, plain)
    lanes = B * M  # corners 32 B + valid 1 B in; z 12 + R 36 + keep 1 B out
    bound = _bound(lanes * 82, lanes * K1_OPS_PER_LANE)
    print(f"phase 1: K1 {timing[0]:.4f} ms/launch, plain {timing[1]:.4f} ms/call, "
          f"bound {bound[0]:.5f} ms ({bound[1]})")
    return worst, timing, bound


def _k2_inputs(state, f, data, cfg, cam):
    """Frame f's K2 arguments as the main path makes them: K1 on the
    frame's corners, then the runner's glue."""
    from aruco_slam_tpu_torch import runner
    from aruco_slam_tpu_torch.models import ekf
    from aruco_slam_tpu_torch.ops.kernels import pnp_frontend as pk

    valid = data.obs_valid[:, f].contiguous()
    z, R, keep = pk.pnp_frontend_batch(data.corners_px[:, f].contiguous(), valid, cam, cfg)
    frame = ekf.FrameObservations(data.obs_ids[:, f].contiguous(), z, R, keep)
    ew = data.enc_w[:, f]
    controls = ekf.Control(ew[..., 0], ew[..., 1], data.enc_dt[:, f])
    return runner.frame_step_inputs(state, frame, controls, cfg)


def phase2_k2(cfg, dev):
    """K2 against its plain version over 20 consecutive frames; returns
    (max err, ms, plain ms) at the main-path shapes."""
    import dataclasses

    from aruco_slam_tpu_torch import runner
    from aruco_slam_tpu_torch.ops.camera import CameraIntrinsics
    from aruco_slam_tpu_torch.ops.kernels import ekf_update_batched as kb
    from aruco_slam_tpu_torch.utils.config import EkfConfig

    cam = CameraIntrinsics.create(600.0, 600.0, 320.0, 240.0)
    seqs = _sequences(cam, range(100, 132), 5.0)  # 32 distinct sequences
    data = runner.build_batch_data(seqs, B, "corners", dev)
    small = dataclasses.replace(cfg, ekf=EkfConfig(max_landmarks=4, max_observations_per_frame=M))
    worst, timing = 0.0, None
    for c in (cfg, small):
        n_dim = 3 + 3 * c.ekf.max_landmarks
        warm = runner.replay_batch(data._replace(**{
            k: v[:, :20] for k, v in data._asdict().items() if v is not None
        }), c, cam, "corners")
        state = warm.final_state
        err = 0.0
        for f in range(20, 40):
            args = _k2_inputs(state, f, data, c, cam)
            out = kb.frame_step_batched(state, *args, config=c)
            ref = kb.frame_step_reference(state, *args, config=c)
            torch.cuda.synchronize()
            for name in ("slot_ids", "n_landmarks", "seen_prev", "diverged", "dropped"):
                _require(torch.equal(getattr(out, name), getattr(ref, name)),
                         f"K2 {name} differs at frame {f} (N={n_dim})")
            for name in ("mu", "sigma", "last_obs"):
                a, r = getattr(out, name), getattr(ref, name)
                _require(torch.allclose(a, r, atol=5e-5, rtol=5e-3),
                         f"K2 {name} differs at frame {f} (N={n_dim}): {_max_err(a, r):.3e}")
                err = max(err, _max_err(a, r))
            if timing is None and f == 39:
                ms = _cuda_time(lambda: kb.frame_step_batched(state, *args, config=c), 50)
                plain = _cuda_time(lambda: kb.frame_step_reference(state, *args, config=c), 5)
                valid, slots = args[6], args[7]
                known = int((valid & (slots >= 0)).sum())
                timing = (ms, plain, _ekf_bound(B, n_dim, c.ekf.max_landmarks, M, known, True))
            state = out._replace(initialized=torch.ones_like(out.initialized))
        print(f"phase 2: K2 B={B} N={n_dim} M={M} frames 20-39: landmarks "
              f"{int(state.n_landmarks.min())}-{int(state.n_landmarks.max())}, "
              f"dropped {int(state.dropped.sum())}, max |err| {err:.3e}")
        worst = max(worst, err)
    _require(int(state.dropped.sum()) > 0, "the small-capacity run never dropped a landmark")
    print(f"phase 2: K2 {timing[0]:.4f} ms/launch, plain {timing[1]:.4f} ms/call, "
          f"bound {timing[2][0]:.5f} ms ({timing[2][1]})")
    return worst, timing


def phase3_main_path(cfg, dev):
    """The main path at full size through the kernels, against the plain path."""
    from aruco_slam_tpu_torch import runner
    from aruco_slam_tpu_torch.ops.camera import CameraIntrinsics
    from aruco_slam_tpu_torch.ops.kernels import ekf_update_batched as kb
    from aruco_slam_tpu_torch.ops.kernels import pnp_frontend as pk
    from aruco_slam_tpu_torch.utils import metrics

    seqs = _sequences(CameraIntrinsics.create(600.0, 600.0, 320.0, 240.0), range(8), 60.0)
    cam = seqs[0].camera()  # the calibration the sequences carry
    data = runner.build_batch_data(seqs, B, "corners", dev)
    _require(tuple(data.obs_ids.shape) == (B, F, M), f"data shape {tuple(data.obs_ids.shape)}")

    torch.cuda.synchronize()
    pk.LAUNCHES = 0
    kb.LAUNCHES = 0
    out = runner.replay_batch(data, cfg, cam, "corners")
    torch.cuda.synchronize()
    launches = {"pnp_frontend": pk.LAUNCHES, "ekf_frame_batched": kb.LAUNCHES}
    print(f"phase 3: launches in one {B}x{F} replay: {launches}")
    _require(launches == {"pnp_frontend": F, "ekf_frame_batched": F},
             f"expected {F} launches of each kernel, got {launches}")

    # The plain path runs the first PLAIN_FRAMES frames (its cut depth: the
    # kernel path's prefix is the same computation); so does the kernel
    # path once more, for the state at that frame.
    head = data._replace(**{k: v[:, :PLAIN_FRAMES] for k, v in data._asdict().items()
                            if v is not None})
    plain = {}
    plain_s = _timed(lambda: plain.update(
        ref=runner.replay_batch_reference(head, cfg, cam, "corners")))
    ref = plain["ref"]
    out_h = runner.replay_batch(head, cfg, cam, "corners")
    torch.cuda.synchronize()
    _require(bool(torch.isfinite(out.trajectory).all()), "non-finite trajectory")
    _require(torch.equal(out.n_landmarks[:, :PLAIN_FRAMES], ref.n_landmarks),
             "n_landmarks differ from the plain path")
    _require(torch.equal(out_h.final_state.slot_ids, ref.final_state.slot_ids),
             "slot_ids differ from the plain path")
    dev_max = _max_err(out.trajectory[:, :PLAIN_FRAMES], ref.trajectory)
    print(f"phase 3: first {PLAIN_FRAMES} frames: trajectory max |kernel - plain| = {dev_max:.3e} "
          f"(tolerance {TRAJ_TOL})")
    _require(dev_max <= TRAJ_TOL, "trajectory deviates from the plain path")
    true = torch.as_tensor(seqs[0].true_pose_frames)
    ate_k = float(metrics.ate(out.trajectory[0].cpu(), true))
    ate_p = float(metrics.ate(ref.trajectory[0].cpu(), true[:PLAIN_FRAMES]))
    print(f"phase 3: lane 0 ATE vs ground truth: kernels {ate_k:.6f} m, plain (first "
          f"{PLAIN_FRAMES} frames) {ate_p:.6f} m; landmarks {int(out.n_landmarks[0, -1])}")
    _require(ate_k < 0.05, f"lane 0 ATE {ate_k} m: the filter lost track")

    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        runner.replay_batch(data, cfg, cam, "corners")
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
    fps = B * F / statistics.median(times)
    print(f"phase 3: main path {fps:.1f} frames/s (median of 3: "
          f"{', '.join(f'{t:.3f}' for t in times)} s per {B}x{F} replay); "
          f"plain path {B * PLAIN_FRAMES / plain_s:.1f} frames/s ({plain_s:.3f} s for "
          f"{B}x{PLAIN_FRAMES})")
    return launches


def _frames_for_ccl(dev):
    """Phase 4's inputs: 32 rendered 640x480 frames (the 20-marker arena at
    varied poses), 8 uniform-noise frames, 2 rendered 1920x1080 frames."""
    from aruco_slam_tpu_torch.ops.camera import CameraIntrinsics
    from aruco_slam_tpu_torch.sim import renderer, synthetic

    rng = np.random.default_rng(4)
    poses = np.stack([rng.uniform(0.8, 4.3, 32), rng.uniform(-3.9, -0.8, 32),
                      rng.uniform(-np.pi, np.pi, 32)], axis=1)
    poses[0] = (2.55, -2.0, 1.2)  # tests/test_detector.py's scene
    arena = synthetic.make_arena(n_markers=20)
    vga = renderer.render_poses(poses, arena, CameraIntrinsics.create(600.0, 600.0, 320.0, 240.0),
                                device=dev)
    noise = torch.as_tensor(rng.integers(0, 256, (8, 480, 640), dtype=np.uint8), device=dev)
    hd = renderer.render_poses(poses[:2], arena,
                               CameraIntrinsics.create(1800.0, 1800.0, 960.0, 540.0),
                               height=1080, width=1920, device=dev)
    return {"rendered 640x480": vga, "noise 640x480": noise, "rendered 1920x1080": hd}


def phase4_ccl(dev):
    """K3, K4, K5, K5s against their plain versions; returns per kernel
    (max err, ms, plain ms), the times for one 16-frame 640x480 chunk."""
    from aruco_slam_tpu_torch.ops.detector import DetectorConfig
    from aruco_slam_tpu_torch.ops.kernels import ccl

    cfg = DetectorConfig()
    r, C, s, r1, r2 = cfg.adaptive_radius, cfg.adaptive_C, cfg.mean_stride, cfg.ccl_rounds, \
        cfg.closed_ccl_rounds
    err = dict.fromkeys(ccl.LAUNCHES, 0.0)

    def check(name, got, want, what):
        for a, b in zip(got, want):
            _require(a.shape == b.shape and torch.equal(a, b),
                     f"{name} differs from its plain version on {what}")
            err[name] = max(err[name], _max_err(a.to(torch.int64), b.to(torch.int64)))

    inputs = _frames_for_ccl(dev)
    for what, frames in inputs.items():
        for i in range(0, frames.shape[0], 16):
            img = frames[i: i + 16].contiguous()
            ref = ccl.threshold_label_union_reference(img, r, C, s, r1, r2)
            check("threshold_label_union", ccl.threshold_label_union(img, r, C, s, r1, r2),
                  ref, what)
            check("threshold_label", ccl.threshold_label(img, r, C, s, r1),
                  ccl.threshold_label_reference(img, r, C, s, r1), what)
            fg, lab, fg_c, _ = ref
            for mask in (fg, fg_c):
                check("label_components", (ccl.label_components(mask, r1),),
                      (ccl.label_components_reference(mask, r1),), what)
            seed = lab.reshape(fg.shape)
            check("label_components_seeded", (ccl.label_components(fg_c, r2, init=seed),),
                  (ccl.label_components_reference(fg_c, r2, init=seed),), what)
            torch.cuda.synchronize()
        print(f"phase 4: K3 K4 K5 K5s bit-identical to plain on {frames.shape[0]} {what} "
              f"frames (foreground {float(fg.float().mean()):.3f})")

    img = inputs["rendered 640x480"][:16].contiguous()
    fg, lab, fg_c, _ = ccl.threshold_label_union_reference(img, r, C, s, r1, r2)
    seed = lab.reshape(fg.shape)
    runs = {
        "threshold_label_union": (lambda: ccl.threshold_label_union(img, r, C, s, r1, r2),
                                  lambda: ccl.threshold_label_union_reference(img, r, C, s, r1, r2)),
        "threshold_label": (lambda: ccl.threshold_label(img, r, C, s, r1),
                            lambda: ccl.threshold_label_reference(img, r, C, s, r1)),
        "label_components": (lambda: ccl.label_components(fg, r1),
                             lambda: ccl.label_components_reference(fg, r1)),
        "label_components_seeded": (lambda: ccl.label_components(fg_c, r2, init=seed),
                                    lambda: ccl.label_components_reference(fg_c, r2, init=seed)),
    }
    px = img.numel()
    # bytes per pixel in + out, and operations per pixel, of each variant
    work = {
        "threshold_label_union": (1 + 1 + 4 + 1 + 4, CCL_THRESHOLD_OPS + CCL_CLOSE_OPS
                                  + (r1 + r2) * CCL_ROUND_OPS),
        "threshold_label": (1 + 1 + 4, CCL_THRESHOLD_OPS + r1 * CCL_ROUND_OPS),
        "label_components": (1 + 4, r1 * CCL_ROUND_OPS),
        "label_components_seeded": (1 + 4 + 4, r2 * CCL_ROUND_OPS),
    }
    out = {}
    for name, (kern, plain) in runs.items():
        ms = _cuda_time(kern, 20)
        plain_ms = _cuda_time(plain, 3)
        bound = _bound(px * work[name][0], px * work[name][1])
        out[name] = (err[name], ms, plain_ms, bound)
        print(f"phase 4: {name} {ms:.4f} ms/launch (16 frames 640x480), plain {plain_ms:.4f} "
              f"ms/call, bound {bound[0]:.5f} ms ({bound[1]})")
    return out


def _image_sequences(dev):
    from aruco_slam_tpu_torch.ops.camera import CameraIntrinsics
    from aruco_slam_tpu_torch.sim import synthetic

    cam = CameraIntrinsics.create(600.0, 600.0, 320.0, 240.0)
    return [
        synthetic.generate_sequence(
            synthetic.SimParams(duration=IMG_SECONDS, seed=s), level="images", camera=cam,
            device=dev,
        )
        for s in (0, 1)
    ]


def _timed(fn):
    """Seconds of one call, CUDA events around it after a synchronize."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 1e3


def _check_detections(got, want, what):
    ids, corners, valid = got
    ids_r, corners_r, valid_r = want
    _require(torch.equal(ids, ids_r), f"{what}: ids differ from the plain detector")
    _require(torch.equal(valid, valid_r), f"{what}: valid differs from the plain detector")
    err = _max_err(corners, corners_r, valid)
    _require(err <= CORNER_TOL, f"{what}: corners differ by {err} px")
    return err


def phase5_image_path(dev):
    """The image-level path at bench.py's shape through K3, K1 and K2."""
    import dataclasses

    from aruco_slam_tpu_torch import runner
    from aruco_slam_tpu_torch.ops import detector
    from aruco_slam_tpu_torch.ops.kernels import ccl
    from aruco_slam_tpu_torch.ops.kernels import ekf_update_batched as kb
    from aruco_slam_tpu_torch.ops.kernels import pnp_frontend as pk
    from aruco_slam_tpu_torch.utils import metrics
    from aruco_slam_tpu_torch.utils.config import EkfConfig, SlamConfig

    cfg = SlamConfig(ekf=EkfConfig(max_landmarks=32, max_observations_per_frame=24))
    det_cfg = detector.DetectorConfig()
    seqs = _image_sequences(dev)
    cam = seqs[0].camera()  # the calibration the sequences carry
    data = runner.build_batch_data(seqs, IMG_B, "images", dev)
    n_frames = seqs[0].num_frames
    total = IMG_B * n_frames
    _require(tuple(data.images.shape) == (IMG_B, n_frames, 480, 640),
             f"image data shape {tuple(data.images.shape)}")

    torch.cuda.synchronize()
    for k in ccl.LAUNCHES:
        ccl.LAUNCHES[k] = 0
    pk.LAUNCHES = 0
    kb.LAUNCHES = 0
    out = runner.replay_batch(data, cfg, cam, "images", det_cfg, IMG_CHUNK)
    torch.cuda.synchronize()
    launches = {**ccl.LAUNCHES, "pnp_frontend": pk.LAUNCHES, "ekf_frame_batched": kb.LAUNCHES}
    print(f"phase 5: launches in one {IMG_B}x{n_frames} image-level replay: {launches}")
    chunks = -(-total // IMG_CHUNK)
    _require(launches == {"threshold_label_union": chunks, "threshold_label": 0,
                          "label_components": 0, "label_components_seeded": 0,
                          "pnp_frontend": n_frames, "ekf_frame_batched": n_frames},
             f"expected K3 x {chunks}, K1 and K2 x {n_frames}; got {launches}")

    det = runner.detect_frames(data.images, det_cfg, IMG_CHUNK)
    det_ref = runner.detect_frames(data.images, det_cfg, IMG_CHUNK, reference=True)
    c_err = _check_detections(det, det_ref, "image path")
    n_det = int(det[2].sum())
    _require(n_det > total, f"only {n_det} detections in {total} frames")
    ref = runner.replay_batch_reference(data, cfg, cam, "images", det_cfg, IMG_CHUNK)
    torch.cuda.synchronize()
    _require(bool(torch.isfinite(out.trajectory).all()), "non-finite trajectory")
    _require(torch.equal(out.n_landmarks, ref.n_landmarks), "n_landmarks differ from the plain path")
    _require(torch.equal(out.final_state.slot_ids, ref.final_state.slot_ids),
             "final slot_ids differ from the plain path")
    dev_max = _max_err(out.trajectory, ref.trajectory)
    true = torch.as_tensor(seqs[0].true_pose_frames)
    ate = float(metrics.ate(out.trajectory[0].cpu(), true))
    print(f"phase 5: {n_det} detections in {total} frames, ids/valid equal to the plain "
          f"detector, max |corner diff| {c_err:.3e} px; trajectory max |kernel - plain| "
          f"{dev_max:.3e} (tolerance {TRAJ_TOL}); lane 0 ATE {ate:.6f} m, landmarks "
          f"{int(out.n_landmarks[0, -1])}")
    _require(dev_max <= TRAJ_TOL, "trajectory deviates from the plain path")
    _require(ate < 0.05, f"lane 0 ATE {ate} m: the filter lost track")

    kern = [_timed(lambda: runner.replay_batch(data, cfg, cam, "images", det_cfg, IMG_CHUNK))
            for _ in range(3)]
    kern16 = [_timed(lambda: runner.replay_batch(data, cfg, cam, "images", det_cfg, 16))]
    plain = [_timed(lambda: runner.replay_batch_reference(data, cfg, cam, "images", det_cfg,
                                                          IMG_CHUNK))]
    t_det = _timed(lambda: runner.detect_frames(data.images, det_cfg, IMG_CHUNK))
    corner = runner._corner_data_from_detections(data, *det)
    t_rep = _timed(lambda: runner.replay_batch(corner, cfg, cam, "corners"))
    print(f"phase 5: image path {total / statistics.median(kern):.1f} frames/s (median of 3: "
          f"{', '.join(f'{t:.3f}' for t in kern)} s per {IMG_B}x{n_frames} replay); plain path "
          f"{total / statistics.median(plain):.1f} frames/s ({', '.join(f'{t:.3f}' for t in plain)} s); "
          f"kernel path at chunk 16 {total / statistics.median(kern16):.1f} frames/s "
          f"({', '.join(f'{t:.3f}' for t in kern16)} s)")
    print(f"phase 5: split of the kernel path: detection {t_det:.3f} s "
          f"({1e3 * t_det / total:.4f} ms/frame), corner-level replay {t_rep:.3f} s")

    chunk = data.images.reshape(-1, 480, 640)[:IMG_CHUNK].contiguous()
    detector.detect_markers_batch(chunk, det_cfg)  # warm
    detector.STAGE_MARKS = []
    torch.cuda.synchronize()
    detector.detect_markers_batch(chunk, det_cfg)
    torch.cuda.synchronize()
    marks, detector.STAGE_MARKS = detector.STAGE_MARKS, None
    split = {}
    for (_, a), (stage, b) in zip(marks, marks[1:]):
        split[stage] = split.get(stage, 0.0) + a.elapsed_time(b)
    print(f"phase 5: one {IMG_CHUNK}-frame chunk's detection by stage (ms): "
          + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
          + f"; total {sum(split.values()):.3f}")

    # the two other detector branches, each through the same entry point
    branches = {
        "closing_union=False": (dataclasses.replace(det_cfg, closing_union=False),
                                {"threshold_label": chunks}),
        "mean_stride=3": (dataclasses.replace(det_cfg, mean_stride=3),
                          {"label_components": chunks, "label_components_seeded": chunks}),
    }
    branch_launches = {}
    for what, (bcfg, expect) in branches.items():
        torch.cuda.synchronize()
        for k in ccl.LAUNCHES:
            ccl.LAUNCHES[k] = 0
        res = runner.replay_batch(data, cfg, cam, "images", bcfg, IMG_CHUNK)
        torch.cuda.synchronize()
        got = {k: v for k, v in ccl.LAUNCHES.items() if v}
        _require(got == expect, f"{what}: expected launches {expect}, got {got}")
        _require(bool(torch.isfinite(res.trajectory).all()), f"{what}: non-finite trajectory")
        branch_launches.update(got)
        first = data.images[0]
        _check_detections(runner.detect_frames(first, bcfg, IMG_CHUNK),
                          runner.detect_frames(first, bcfg, IMG_CHUNK, reference=True), what)
        print(f"phase 5: branch {what}: launches {got}; lane 0 detections equal to the plain "
              f"detector; landmarks {int(res.n_landmarks[0, -1])}")
    return {**launches, **branch_launches}


def _device_busy(prof):
    """(device-busy microseconds as the union of device-event intervals,
    {event name: [count, total us]}) of a torch.profiler run."""
    from torch.autograd import DeviceType

    spans, by_name = [], {}
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        start, end = evt.time_range.start, evt.time_range.end
        spans.append((start, end))
        item = by_name.setdefault(evt.name, [0, 0.0])
        item[0] += 1
        item[1] += end - start
    busy, last = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > last:
            busy += end - max(start, last)
            last = end
    return busy, by_name


def _k6_case(dev, cfg, n_lm, rng):
    """A state with n_lm landmarks (an SPD covariance over the active
    block, every slot seen last frame)."""
    from aruco_slam_tpu_torch.models import ekf

    L = cfg.ekf.max_landmarks
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

    return ekf.init_state(cfg, 1, dev)._replace(
        mu=t(mu, torch.float32), sigma=t(sigma, torch.float32),
        slot_ids=t(slot_ids, torch.int32),
        n_landmarks=torch.tensor([n_lm], dtype=torch.int32, device=dev),
        last_obs=t(rng.normal(size=(L, 3)), torch.float32),
        seen_prev=torch.ones(1, L, dtype=torch.bool, device=dev),
        initialized=torch.ones(1, dtype=torch.bool, device=dev),
    )


def _k6_frame(state, rng, n_known=9, n_new=4):
    """M observations in a random arrival order: known landmarks (the first
    repeats its slot's last record, a stationary-gate hit where the slot
    was seen last frame), new markers and invalid padding."""
    from aruco_slam_tpu_torch.models import ekf

    dev = state.mu.device
    n_lm = int(state.n_landmarks[0])
    slots = state.slot_ids[0].cpu().numpy()
    known = rng.choice(n_lm, min(n_known, n_lm), replace=False)
    ids = np.full(M, -1, np.int32)
    ids[:len(known) + n_new] = np.concatenate(
        [slots[known], 200_000 + rng.choice(100_000, n_new, replace=False)])
    z = (rng.normal(size=(M, 3)) * 0.5).astype(np.float32)
    if len(known):
        z[0] = state.last_obs[0, known[0]].cpu().numpy()
    Bn = (rng.normal(size=(M, 3, 3)) * 0.05).astype(np.float32)
    R = Bn @ np.transpose(Bn, (0, 2, 1)) + 0.01 * np.eye(3, dtype=np.float32)
    perm = rng.permutation(M)
    return ekf.FrameObservations(*(torch.as_tensor(x[perm], device=dev)[None]
                                   for x in (ids, z, R, ids >= 0)))


def phase6_k6(dev):
    """K6 against its plain version at 64, 128, 512 (and 5) landmarks;
    returns (max err, {max_landmarks: (ms, plain ms, device ms, bound)})."""
    from torch.profiler import ProfilerActivity, profile

    from aruco_slam_tpu_torch import runner
    from aruco_slam_tpu_torch.models import ekf
    from aruco_slam_tpu_torch.ops.kernels import ekf_update as k6
    from aruco_slam_tpu_torch.utils.config import CompatConfig, EkfConfig, SlamConfig

    worst, timings, repeats = 0.0, {}, 0
    for L, n_lm in ((64, 40), (128, 100), (512, 300), (5, 3)):
        for reject in (False, True):
            cfg = SlamConfig(ekf=EkfConfig(max_landmarks=L, max_observations_per_frame=M),
                             compat=CompatConfig(reject_divergent=reject, divergence_ze_norm=0.6))
            rng = np.random.default_rng(L)
            state = _k6_case(dev, cfg, n_lm, rng)
            err = {"mu": 0.0, "sigma": 0.0, "last_obs": 0.0}
            for f in range(6):
                frame = _k6_frame(state, rng)
                out = k6.frame_update(state, frame, cfg)
                ref = k6.frame_update_reference(state, frame, cfg)
                torch.cuda.synchronize()
                for name in ("slot_ids", "n_landmarks", "seen_prev", "diverged", "dropped"):
                    _require(torch.equal(getattr(out, name), getattr(ref, name)),
                             f"K6 {name} differs (max_landmarks {L}, frame {f})")
                for name in err:
                    a, r = getattr(out, name), getattr(ref, name)
                    _require(torch.allclose(a, r, atol=5e-5, rtol=5e-3),
                             f"K6 {name} differs (max_landmarks {L}, frame {f}): {_max_err(a, r):.3e}")
                    err[name] = max(err[name], _max_err(a, r))
                slot = ekf.lookup_slots(state.slot_ids, frame.ids)[0]
                last = state.last_obs[0][torch.clamp(slot, min=0).long()]
                seen = state.seen_prev[0][torch.clamp(slot, min=0).long()]
                repeats += int((frame.valid[0] & (slot >= 0) & seen
                                & (frame.z[0] == last).all(-1)).sum())
                state = out
            worst = max(worst, *err.values())
            print(f"phase 6: K6 max_landmarks={L} N={3 + 3 * L} reject={reject}: landmarks "
                  f"{int(state.n_landmarks[0])}, dropped {int(state.dropped[0])}, diverged "
                  f"{int(state.diverged[0])}; max |dmu| {err['mu']:.3e}, |dsigma| "
                  f"{err['sigma']:.3e}, |dlast_obs| {err['last_obs']:.3e}")
        if L == 5:
            _require(int(state.dropped[0]) > 0, "the 5-slot run never dropped an observation")
            continue
        frame = _k6_frame(state, rng)
        ms = _cuda_time(lambda: k6.frame_update(state, frame, cfg), 100)
        plain = _cuda_time(lambda: k6.frame_update_reference(state, frame, cfg), 5)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                k6.frame_update(state, frame, cfg)
            torch.cuda.synchronize()
        spans = [v for k, v in _device_busy(prof)[1].items() if "ekf_frame_update" in k]
        dev_ms = spans[0][1] / spans[0][0] / 1e3 if spans else None
        slots = ekf.lookup_slots(state.slot_ids, frame.ids)
        known = int((frame.valid & (slots >= 0)).sum())
        bound = _ekf_bound(1, 3 + 3 * L, L, M, known, False)
        timings[L] = (ms, plain, dev_ms, bound)
        print(f"phase 6: K6 max_landmarks={L} ({k6.grid_blocks(3 + 3 * L)} blocks): "
              f"{ms:.4f} ms/launch through the wrapper, kernel alone "
              f"{'not measured' if dev_ms is None else f'{dev_ms:.4f} ms'} (profiler); plain "
              f"{plain:.4f} ms/call; bound {bound[0]:.5f} ms ({bound[1]}, {known} known)")
    _require(repeats > 0, "no stationary-gate hit in phase 6")

    cfg = SlamConfig(ekf=EkfConfig(max_landmarks=64, max_observations_per_frame=M))
    state = _k6_case(dev, cfg, 40, np.random.default_rng(1))
    frame = _k6_frame(state, np.random.default_rng(2))
    idle = state._replace(initialized=torch.zeros_like(state.initialized))
    out = k6.frame_update(idle, frame, cfg)
    torch.cuda.synchronize()
    for name in ekf.EkfState._fields:
        _require(torch.equal(getattr(out, name), getattr(idle, name)),
                 f"K6 changed {name} of an uninitialized state")
    k2_ms = _cuda_time(lambda: runner.update_batched(state, frame, cfg), 100)
    print(f"phase 6: K6 uninitialized no-op equal; {repeats} stationary-gate hits; K2 at B=1, N=195 "
          f"(runner.update_batched) {k2_ms:.4f} ms/launch beside K6 {timings[64][0]:.4f}")
    return worst, timings


def phase7_single_stream(dev):
    """BASELINE config 2 through runner.replay_sequence (K6) against the
    plain replay; then the fused update against the same reference."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from aruco_slam_tpu_torch import runner
    from aruco_slam_tpu_torch.ops.kernels import ekf_update as k6
    from aruco_slam_tpu_torch.sim import synthetic
    from aruco_slam_tpu_torch.utils import metrics
    from aruco_slam_tpu_torch.utils.config import EkfConfig, SlamConfig

    cfg = SlamConfig(ekf=EkfConfig(max_landmarks=128, max_observations_per_frame=16))
    seq = synthetic.generate_sequence(
        synthetic.SimParams(duration=210.0, profile="tour", tour_width=20.0, tour_height=16.0,
                            tour_inset=1.6, encoder_noise=0.4, fov_deg=90.0,
                            max_view_angle_deg=85.0, seed=11),
        marker_map=synthetic.make_arena(n_markers=100, width=20.0, height=16.0),
    )
    F = seq.num_frames
    _require(F == 2100 and seq.max_obs == M, f"config 2 has {F} frames of {seq.max_obs}")
    torch.cuda.synchronize()
    k6.LAUNCHES = 0
    out = runner.replay_sequence(seq, cfg, device=dev)
    torch.cuda.synchronize()
    launches = k6.LAUNCHES
    print(f"phase 7: K6 launches in one {F}-frame single-stream replay: {launches}")
    _require(launches == F, f"expected {F} K6 launches, got {launches}")

    data = runner.replay_data_from_sequence(seq, "obs", dev)
    plain = {}
    plain_s = _timed(lambda: plain.update(ref=runner.replay_reference(data, cfg)))
    ref = plain["ref"]
    true = torch.as_tensor(seq.true_pose_frames)

    def agree(res, what):
        _require(bool(torch.isfinite(res.trajectory).all()), f"{what}: non-finite trajectory")
        _require(torch.equal(res.n_landmarks, ref.n_landmarks), f"{what}: n_landmarks differ")
        _require(torch.equal(res.final_state.slot_ids, ref.final_state.slot_ids),
                 f"{what}: slot_ids differ")
        err = _max_err(res.trajectory, ref.trajectory)
        _require(err <= TRAJ_TOL, f"{what}: trajectory deviates from the plain path by {err}")
        return err, float(metrics.ate(res.trajectory.cpu(), true))

    err, ate = agree(out, "K6 path")
    ate_ref = float(metrics.ate(ref.trajectory.cpu(), true))
    # the JAX package measured EKF ATE 0.401 m on this run (benchmarks/results.json)
    print(f"phase 7: landmarks {int(out.n_landmarks[-1])}, slots equal; trajectory max |K6 - "
          f"plain| {err:.3e} (tolerance {TRAJ_TOL}); ATE K6 {ate:.6f} m, plain {ate_ref:.6f} m")
    _require(ate < 1.0, f"ATE {ate} m: the filter lost track")

    times = [_timed(lambda: runner.replay(data, cfg)) for _ in range(3)]
    fps = F / statistics.median(times)
    print(f"phase 7: single-stream {fps:.1f} frames/s (median of 3: "
          f"{', '.join(f'{t:.3f}' for t in times)} s per {F}-frame replay); plain "
          f"{F / plain_s:.1f} frames/s ({plain_s:.3f} s)")

    fused_cfg = dataclasses.replace(cfg, ekf=dataclasses.replace(cfg.ekf, fused_update=True))
    fused = {}
    f_s = _timed(lambda: fused.update(out=runner.replay(data, fused_cfg)))
    f_err, f_ate = agree(fused["out"], "fused path")
    print(f"phase 7: fused_update=True: trajectory max |fused - plain| {f_err:.3e}, ATE "
          f"{f_ate:.6f} m, {F / f_s:.1f} frames/s ({f_s:.3f} s)")

    head = data._replace(**{k: v[:200] for k, v in data._asdict().items() if v is not None})
    runner.replay(head, cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        runner.replay(head, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, by_name = _device_busy(prof)
    n_dev = sum(c for c, _ in by_name.values())
    k6_us = sum(v[1] for k, v in by_name.items() if "ekf_frame_update" in k)
    print(f"phase 7: profile of 200 frames: device busy {busy / 1e3:.3f} ms of {wall * 1e3:.3f} "
          f"ms wall ({100 * busy / 1e6 / wall:.1f}%), {n_dev / 200:.1f} device events per "
          f"frame, K6 {k6_us / 200 / 1e3:.4f} ms per frame")
    return launches


def phase8_system(dev):
    """The streaming SlamSystem, default config, 60 rendered frames, against
    the same calls through the plain versions."""
    from aruco_slam_tpu_torch.ops.detector import detect_markers
    from aruco_slam_tpu_torch.ops.kernels import ccl
    from aruco_slam_tpu_torch.ops.kernels import ekf_update as k6
    from aruco_slam_tpu_torch.system import SlamSystem
    from aruco_slam_tpu_torch.utils.config import SlamConfig

    seq = _image_sequences(dev)[0]
    cam = seq.camera()
    epf, F = seq.enc_per_frame, seq.num_frames
    enc_w, enc_dt = seq.enc_w.reshape(F, epf, 2), seq.enc_dt.reshape(F, epf)

    def drive(system, lat_enc, lat_img):
        dets = []
        for f in range(F):
            for e in range(epf):
                t0 = time.perf_counter()
                system.add_encoder(float(enc_w[f, e, 0]), float(enc_w[f, e, 1]),
                                   float(enc_dt[f, e]))
                torch.cuda.synchronize()
                lat_enc.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            system.add_image(seq.images[f])
            torch.cuda.synchronize()
            lat_img.append(time.perf_counter() - t0)
            dets.append(system.last_detections)
        return dets

    kern = SlamSystem(SlamConfig(), cam, device=dev)
    plain = SlamSystem(SlamConfig(), cam, device=dev)
    plain._update = k6.frame_update_reference
    plain._detect = functools.partial(detect_markers, reference=True)
    drive(SlamSystem(SlamConfig(), cam, device=dev), [], [])  # warm
    torch.cuda.synchronize()
    k6.LAUNCHES = 0
    for k in ccl.LAUNCHES:
        ccl.LAUNCHES[k] = 0
    lat_enc, lat_img = [], []
    dets = drive(kern, lat_enc, lat_img)
    launches = {"ekf_frame_update": k6.LAUNCHES, **{k: v for k, v in ccl.LAUNCHES.items() if v}}
    print(f"phase 8: launches over {F} add_image calls: {launches}")
    _require(launches == {"ekf_frame_update": F, "threshold_label_union": F},
             f"expected K6 and K3 x {F}, got {launches}")
    dets_p = drive(plain, [], [])
    for f, (a, b) in enumerate(zip(dets, dets_p)):
        _check_detections(a, b, f"SlamSystem frame {f}")
    n_det = sum(int(d.valid.sum()) for d in dets)
    err = float(np.abs(kern.pose() - plain.pose()).max())
    lms, ids = kern.landmark_map()
    lms_p, ids_p = plain.landmark_map()
    _require(np.array_equal(ids, ids_p), "SlamSystem map ids differ from the plain run")
    map_err = float(np.abs(lms - lms_p).max()) if len(lms) else 0.0
    _require(err <= TRAJ_TOL and map_err <= TRAJ_TOL,
             f"SlamSystem pose / map differ from the plain run by {err} / {map_err}")
    true = seq.true_pose_frames[-1]
    print(f"phase 8: {n_det} detections in {F} frames equal to the plain run; pose "
          f"|kernel - plain| {err:.3e}, map {map_err:.3e} over {len(ids)} landmarks; final pose "
          f"error {float(np.hypot(*(kern.pose()[:2] - true[:2]))):.4f} m")
    print(f"phase 8: latency (host clock to synchronize), median of {len(lat_img)} add_image "
          f"{1e3 * statistics.median(lat_img):.3f} ms, of {len(lat_enc)} add_encoder "
          f"{1e3 * statistics.median(lat_enc):.3f} ms")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    if not (ROOT / "aruco_slam_tpu_torch" / "ops" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT} holds no aruco_slam_tpu_torch sources; "
              "run it from the repository root", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from aruco_slam_tpu_torch.utils.config import EkfConfig, SlamConfig

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cfg = SlamConfig(ekf=EkfConfig(max_landmarks=32, max_observations_per_frame=M))
    t_start = time.perf_counter()

    def phase(n, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"phase {n}: done in {time.perf_counter() - t0:.1f} s")
        return out

    phase(0, phase0_card)
    k1_err, (k1_ms, k1_plain), k1_bound = phase(1, phase1_k1, cfg, dev)
    k2_err, (k2_ms, k2_plain, k2_bound) = phase(2, phase2_k2, cfg, dev)
    launches = phase(3, phase3_main_path, cfg, dev)
    ccl_stats = phase(4, phase4_ccl, dev)
    img_launches = phase(5, phase5_image_path, dev)
    k6_err, k6_times = phase(6, phase6_k6, dev)
    k6_launches = phase(7, phase7_single_stream, dev)
    phase(8, phase8_system, dev)
    print(f"all phases: {time.perf_counter() - t_start:.1f} s")

    def row(name, source, replaces, n, err, ms, plain_ms, bound):
        # library_ms: no single PyTorch call computes any of these functions
        return {"name": name, "route": "cuda",
                "source": f"aruco_slam_tpu_torch/ops/kernels/csrc/{source}",
                "replaces": f"aruco_slam_tpu/ops/kernels/{replaces}", "launches": n,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
                "bound_by": bound[1], "library_ms": None}

    kernels = [
        row("pnp_frontend", "pnp_frontend.cu", "pnp_frontend.py:219",
            launches["pnp_frontend"], k1_err, k1_ms, k1_plain, k1_bound),
        row("ekf_frame_batched", "ekf_frame_batched.cu", "ekf_update_batched.py:77",
            launches["ekf_frame_batched"], k2_err, k2_ms, k2_plain, k2_bound),
    ]
    for name, line in (("threshold_label_union", 229), ("threshold_label", 217),
                       ("label_components", 200), ("label_components_seeded", 207)):
        err, ms, plain_ms, bound = ccl_stats[name]
        kernels.append(row(name, "ccl.cu", f"ccl.py:{line}", img_launches[name], err, ms,
                           plain_ms, bound))
    k6_ms, k6_plain, _, k6_bound = k6_times[128]  # config 2's shape, N = 387
    kernels.append(row("ekf_frame_update", "ekf_frame_update.cu", "ekf_update.py:73",
                       k6_launches, k6_err, k6_ms, k6_plain, k6_bound))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
