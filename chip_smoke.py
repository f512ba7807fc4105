#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU: builds the hand-written
CUDA kernels from this checkout, holds each against its plain PyTorch version
at the main paths' shapes, then drives the main paths — batched corner-level
replay (256 lanes x 600 frames, K1 + K2's smem variant; BASELINE config 2's
arena at 128 and 512 landmarks, K2's cluster and device variants), batched
image-level replay (32 lanes
x 60 rendered 640x480 frames, K3-K5s in their cluster body + K1 + K2),
detection of rendered 1920x1080 frames (K3-K5s in their block body: a frame
in tiles over many SMs) and of 3840x2160 frames (its spilled plan, as K5 on
a 7680x4320 mask), the probes of the CCL family's studies (the card's
copy floor, the threshold stage alone, K4 at 1080p in both block plans),
single-stream replay of BASELINE config 2 (2,100 frames, 128 landmarks, K6's
frame step in its cluster variant, one launch a frame; 512 landmarks, its
grid variant on the frame's active square), the streaming
SlamSystem (60 rendered frames, K3 + K6), the smoothing back-end (config
2 through the filter -> smoother pipelines, K6 in their EKF pass; the BA
solver alone on configs 4 and 5) and the multi-rank paths on this one card
(config 5's distributed BA, the sharded replay and detection, over NCCL
with one rank and gloo with four), .asq streaming, the demo and the
benchmark harness through the command line — and checks each against its
plain path, its single-process path and the ground truth.

Run from the repository root:  python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero):
  0. the card: refuse without CUDA; print its name and power limit; build
     the five kernel sources (nvcc, sm_90a, all at once) and print ptxas's
     register report.
  1. K1 (PnP front-end) vs its plain version: B=256 x M=16 lanes of real
     corners, padded slots (not valid) and garbage slots (marked valid)
     included, on an undistorted and a distorted camera. keep equal on every
     lane; z, R to atol 2e-5 (R rtol 2e-4) where kept. Timed: the kernel
     alone (torch.profiler over 20 launches, exactly one device event each;
     again with the garbage slots padded), through the wrapper, and plain.
  2. K2 (the whole EKF frame step from the raw frame) vs its plain version
     (frame_step_inputs + the plain step) in each variant over 20
     consecutive frames of real inputs with 10 encoder ticks a frame, one
     frame without ticks and one lane not yet initialized (K2_CASES): smem
     at B=256, N=99 (and 4 slots, where landmarks drop); cluster at 128
     slots with B=32, 1 and 128 (CTAs a lane from the wrapper's rule);
     device at 512 slots on phase 3b's lanes, B=4, frames 80-99. Then the
     device variant on 4 synthetic lanes of 512 slots whose active blocks
     straddle what a cluster holds on chip (L2_LANDMARKS: two lanes run in
     device memory) over 6 frames. Integer state exact; mu, sigma and the
     rows to atol 5e-5 / rtol 5e-3. Each variant timed as K1 is (exactly
     one device event a call) beside its plain version and bound. The card's
     cluster occupancy for G = 1..16, and the G sweep: the cluster program
     alone at N=387 (100 landmarks a lane) for G in SWEEP_CTAS x B in
     SWEEP_LANES, beside the rule's G. Then each kind (K2_WIDE: smem at
     B=256, N=99; cluster at B=32, N=387; device at B=4, N=1,539) over
     WIDE_FRAMES frames of WIDE_M = 300 observation slots (past
     MAX_SHARED_OBS, the prologue's slots and order in device memory; ids
     repeated, new and padding ones among them) against the plain version,
     the kernel alone timed beside the plain version and the bound.
  3. the main path: runner.replay_batch over 8 synthetic sequences (seeds
     0-7, 60 s) tiled to 256 lanes, EkfConfig(max_landmarks=32,
     max_observations_per_frame=16), the sequences' own camera. K1 and K2
     launch exactly once per frame; landmarks and slots equal the plain
     path's on every lane and the trajectory is within TRAJ_TOL of it over
     the plain run's cut depth (the first PLAIN_FRAMES frames); frames/s
     (median of 3); one replay under torch.profiler: device events per
     frame, busy share, K1 and K2 device time; peak device memory.
  3b. the batched user with a large map: BASELINE config 2's arena
     (benchmarks/run_all.py:77-89, 100 markers), seeds 0-7 at corner level
     tiled to 32 lanes, EkfConfig(max_landmarks=128,
     max_observations_per_frame=16), the first 300 frames (K2's cluster
     variant once per frame); then 4 lanes x 100 frames at 512 slots (its
     device variant). Each against the plain replay of the same frames:
     landmarks and slots equal, trajectory within TRAJ_TOL; frames/s.
  4. the CCL family K3, K4, K5, K5s vs their plain versions, bit for bit,
     in both bodies: the cluster body (a frame per cluster of 8 CTAs) on 32
     rendered 640x480 frames at varied poses, 8 uniform-noise frames and 2
     frames drawn across its band edges (a serpentine through all 8 bands
     that the bounded rounds leave unconverged; components on every band
     edge), and K5 / K5s on that mask itself; the block body (a frame in
     tiles, a CTA a tile, ccl.block_plan) on rendered 1280x720 and
     1920x1080 frames at 1 and HD_CHUNK frames, uint8 and float32, on one
     1084x1920 frame (its height no multiple of the tiles'), and K5 / K5s
     on a 1920x1080 mask drawn across the tiles of the 1- and HD_CHUNK-frame
     plans (a serpentine through every tile, components on the tile edges,
     runs across the row splits; unconverged). Each launch's body is the
     one its shape selects. K3 timed in both bodies at 1, 16 and 128
     640x480 frames; each variant and body at its path's chunk (128 640x480
     frames, HD_CHUNK 1920x1080 frames) beside the plain version's, the
     cluster body at 16 640x480 frames and the block body at 1 1920x1080
     frame and HD_CHUNK 1280x720 frames too, each beside its bound.
  4b. the probes P1-P3 of the JAX package's benchmarks/ on their kernels:
     P1b probes.copy_to_int32 (float32 -> int32) on P1's 20 rendered 640x480
     frames, P1a ccl.threshold_only (K4's threshold stage alone) on the
     same frames in the cluster body, P1's rounds sweep on them (K4 at 1, 2,
     4 and 8 rounds, K5 on the threshold's mask at 1, 4 and 8), P2
     probes.scale_copy (x 1.0000001) on P2's 32, P1a on HD_CHUNK rendered
     1920x1080 frames in the block body, and P3: K4 (3 rounds) on a
     1920x1080 frame of random bytes in the resident plan (ccl.block_plan)
     and the spilled plan (ccl.spilled_plan). Each once as the probes'
     path, the launch counts set to 0 just before each call and read just
     after (gate: one launch each); each result bit-identical to its plain
     version, the copies also on a frame of fractional values in [-0.99,
     256), the two plans' fg and labels equal. Timed: the kernel alone
     (torch.profiler, 20 launches, one window), the wrapper and the plain
     version (CUDA events), the copies' one PyTorch call
     (img.to(torch.int32), img * 1.0000001) as their library time; each
     with its bytes, achieved GB/s and share of 3.35 TB/s beside its
     bound; K4's time on P1's frames split into the copy, the threshold,
     the first round and a later one.
  4c. the block body's spilled plan (ccl.spilled_plan: the frame's tiles
     cannot all be resident on the SMs at once; every CTA of the team takes
     as many tiles as the busiest or one fewer) on users' frames: the path
     (counts set to 0 just before, read just after) is runner.detect_frames
     on SPILL_FRAMES rendered 3840x2160 frames in the detector's three
     branches (K3; closing_union=False: K4; mean_stride=3: K5 and K5s),
     each detection equal to the plain detector's, then K5 on one 7680x4320
     random mask at 3 rounds (gate: one launch each). Each kernel bit for
     bit against its plain version on those inputs (K5 on K3's raw mask,
     K5s on the closed one seeded with its labels), timed as phase 4b's
     rows beside its bound; detect_frames' ms a frame at 3840x2160.
  5. the image-level path at bench.py's shape (BASELINE.md config 3b):
     runner.replay_batch(..., "images") over 2 rendered sequences (seeds 0
     and 1, 6 s at 10 Hz) tiled to 32 lanes, EkfConfig(max_landmarks=32,
     max_observations_per_frame=24), DetectorConfig(). K3 (cluster body)
     launches once per 128-frame chunk, K1 and K2 once per frame;
     detections equal the plain detector's (ids, valid exact, corners to
     1e-3 px); landmarks and slots equal the plain path's; trajectory
     within TRAJ_TOL; lane 0 ATE below 0.05 m; frames/s of both paths (the
     plain path and the JAX default chunk of 16 timed once), the
     detection/replay split and a per-stage split of one chunk's detection.
     The two other detector branches run the same replay once each:
     closing_union=False (K4) and a stride the fused threshold does not
     take (K5, K5s). Then the 1920x1080 detection path: runner.detect_frames
     over HD_CHUNK rendered 1920x1080 frames in each of the three branches
     (K3, K4, K5 + K5s in the block body), detections equal the plain
     detector's.
  6. K6 (single-stream frame update) vs its plain version in both variants:
     the cluster variant at max_landmarks 64, 128 and the largest it takes,
     the grid variant one above that and at 512 (and 5, where observations
     drop), M=16 in shuffled arrival order, both reject_divergent settings,
     over frames of new, known, gated and dropped observations, plus an
     uninitialized no-op. Integer state exact; mu, sigma to atol 5e-5 /
     rtol 5e-3. Per size: ms per call through the wrapper (100 calls), the
     kernel alone and the device events per call (torch.profiler: exactly
     one), beside the plain version's and K2's at B=1, N=195; the cluster
     variant timed at 2, 4, 8 and 16 CTAs at N = 195 and 387 (where they fit).
     Then K6's frame step (the compose of the frame's encoder ticks, the
     predict, the update, the replay's rows) vs its plain version
     (K6_STEP_CASES: N = 195, 387 and 1,539 with a small and a full active
     square, 0 and 10 ticks, initialized and not): out of place, in place
     (mu and sigma updated where they are) and reading frame f of time-major
     arrays with the rows; exactly one device event a call. Timed on
     K6_STEP_TIMED's states (12 known markers, 10 ticks): the kernel alone
     in place, the call through the replay's path over 100 distinct frames,
     the plain version, the bound of the frame's active square. Then both
     variants (K6_WIDE: N = 387 and 1,539, 100 landmarks) over WIDE_FRAMES
     frames of WIDE_M = 300 slots through the replay's path, each frame
     against the plain step, the kernel alone timed in place.
  7. the single-stream main path: runner.replay_sequence of BASELINE config
     2 (benchmarks/run_all.py config2_loop_100: the 100-marker 20 x 16 m
     arena, 210 s tour, EkfConfig(max_landmarks=128,
     max_observations_per_frame=16), 2,100 frames at obs level). K6's
     frame step (cluster variant) launches once per frame; against
     runner.replay_reference: landmarks and slots equal, trajectory within
     TRAJ_TOL, ATE of both; frames/s of one timed replay; then
     fused_update=True (plain update_fused) against the same reference; a
     profile of 200 frames (gate: at most 2 device events a frame). Then
     the first GRID_FRAMES frames with max_landmarks=512 (K6's grid variant
     once per frame) against the plain replay of the same frames, frames/s
     and their profile (the same gate).
  8. the streaming SlamSystem with the default SlamConfig(): 60 frames of
     10 add_encoder calls and one add_image of a 640x480 frame rendered on
     the card, against the same calls through the plain versions (pose, map
     and every frame's detections); median ms per add_image / add_encoder.
  9. the smoothing back-end (torch ops; no Pallas kernel in the reference).
     BASELINE config 2 (as phase 7) through pipeline.ekf_then_ba (20 GN x
     200 CG, adaptive, gauge-deflated, keyframe_stride 1: K = 2,100) and
     pipeline.ekf_then_pose_graph (12 GN x 100 CG), each from the entry
     point with its own EKF pass: K6 (cluster variant) launches once per
     frame in each; the EKF pass's and the solve's seconds (CUDA events
     after a synchronize), GN/s, the solve's device-busy share and device
     events per GN (torch.profiler over a 2-GN solve of the same problem),
     the cost before and after, and the mean landmark error against the
     truth before (the EKF map) and after. Gate: the cost falls; the map
     error after is at most MAP_GAIN_TOL x before and below MAP_ERR_MAX.
     Then ba.solve alone on configs 4 (synthetic 1,000 keyframes / 500
     landmarks) and 5 (10,000 / 5,000), 10 GN x 50 CG, damping 1e-4,
     packed (benchmarks/run_all.py:243-300), each solved twice: GN/s, ms
     per GN, the cost reduction, the mean pose and landmark error against
     the truth (gate: below TRUTH_ERR_MAX, landmarks with a factor) and the
     run-to-run difference. Config 4 also on the host CPU in float32 (gate:
     within CARD_CPU_TOL m / rad of the card) and under torch's sync debug
     mode (gate: as many host syncs in a 10-GN solve as in a 2-GN one).
  10. the multi-rank paths and the last modules (torch.distributed ranks
     started by parallel.launch.run_ranks; every rank on this card). Two
     worlds: 1 rank over NCCL, and 4 ranks over gloo sharing the card.
     10a: config 5 (benchmarks/run_all.py:277-300, synthetic 10,000
     keyframes / 5,000 landmarks) partitioned (dist_ba.partition_problem)
     and solved by dist_ba.solve_dist, 10 GN x 50 CG, damping 1e-4, in each
     world. Gate: the cost falls, the history within DIST_HISTORY_RTOL of
     the single-device ba.solve (packed, as phase 9) on the same problem,
     the truth errors below TRUTH_ERR_MAX, and exactly iters x (cg + 2) + 1
     all-reduces and one all-gather per rank; printed: the largest pose
     and landmark gap to the single-device solve, GN/s of each world
     beside the single device's (CUDA events in each rank; the slowest
     rank). 10b: phase 3's replay (256 lanes x 600 frames, corner level)
     through runner.replay_sharded in each world. Gate: every lane's
     n_landmarks and final slots equal the single-process replay's, the
     trajectory within TRAJ_TOL; K1 and K2 launch once per frame in each
     rank; frames/s (the slowest rank). 10c: phase 5's 32 lanes x 60
     rendered 640x480 frames detected by runner.detect_frames sharded over
     the 4 ranks. Gate: ids, corners and valid bit-identical to the
     unsharded call. 10d: phase 5's two rendered sequences saved with
     image_format="asq", loaded and replayed by runner.replay_sequence at
     image level (frames streamed through runner.detect_frames_asq).
     Gate: detections bit-identical to the npz sequence's, trajectories
     equal; ms a frame of detect_frames_asq beside detect_frames. 10e:
     aruco_slam_tpu_torch.demo at its 30 s on the card (gate: the map
     written, ATE below 1 m), then parallel.dryrun.dryrun_multichip(1).
     No rank compiles a kernel: the parent builds them before it starts
     any (gate: the ranks' build reports are empty).
  11. the port's benchmark harness as a user runs it: python -m
     aruco_slam_tpu_torch.cli bench in a subprocess from the repository
     root (bench.py's legs and sizes: the 256 x 600 corner-level replay,
     the 32 x 60 image-level replay at the runner's default detector chunk
     of 16, the numpy reference). Gate: exit code 0 within BENCH_TIMEOUT_S;
     a last line with exactly bench.py's keys, value above 0 and an
     image-level number; an earlier line naming the cuda device; K1 and K2
     (smem) once a frame in every corner-level replay, K3 (cluster body)
     once a 16-frame chunk and K1, K2 once a frame in every image-level
     replay. Printed beside phase 3's frames/s. Then the single-chip entry
     step parallel.dryrun.entry() on the card (K6's frame step, N = 99, 10
     ticks, 4 new markers) against its plain version, as phase 6 holds K6.
Every kernel's bound is the larger of its bytes over 3.35 TB/s and its
operations over 67 TFLOP/s (the H100 SXM data sheet), from this run's inputs.
The second-to-last line is a JSON object of the kernels; the last line is
{"ok": true, "device": {...}}.
"""

import contextlib
import functools
import json
import statistics
import subprocess
import sys
import time
from collections.abc import Callable
from pathlib import Path
from typing import NamedTuple

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
# 1920x1080 frames per detector call on the block body's path (the frames a
# 1080p camera's user detects in one call; two frames at a time in flight,
# each in 64 tiles on its own SMs).
HD_CHUNK = 16
# Phase 3b: BASELINE config 2's arena at corner level, batched: lanes and
# frames at 128 slots (K2's cluster variant), and at 512 slots (its device
# variant; the plain replay costs about 40 ms a frame there).
C2_LANES, C2_FRAMES = 32, 300
DEVICE_LANES, DEVICE_FRAMES = 4, 100
# Frames of config 2 replayed with 512 landmark slots (K6's grid variant on
# the frames' small active squares): its plain replay costs about 60 ms a
# frame on the card.
GRID_FRAMES = 200
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
# K2's compose per encoder tick: the midpoint arc (about 15), sin and cos
# (about 20 each), H A and H Q H^T (63) and the 3x2 noise product (about 30).
COMPOSE_OPS_PER_TICK = 150
# The CCL family per pixel: the threshold about 5 (block sum, window mean,
# compare), the 3x3 closing 18, and each CCL round 17 (8-neighbour min, four
# directional run scans).
CCL_THRESHOLD_OPS, CCL_CLOSE_OPS, CCL_ROUND_OPS = 5, 18, 17


def _bound(n_bytes, n_ops):
    """(ms, "bytes" or "operations"): the least time the card could take."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _ekf_bound(B, N, L, M, rank3_ops, ticks=None):
    """An EKF frame step's bound: sigma and mu read and written once, the
    observations and the bookkeeping read once; ``rank3_ops`` for the known
    observations' rank-3 updates (6 n^2 each, n the lane's active rows and
    columns, 3 + 3 landmarks). With ``ticks`` (K2): the ticks read (12
    bytes each), the replay's rows written (52 bytes a lane), 30 N
    operations a lane for the predict and COMPOSE_OPS_PER_TICK a tick."""
    state = (2 * N * N + 2 * N) * 4 + 2 * L * (4 + 12 + 1)
    obs = M * (4 + 12 + 36 + 1)
    if ticks is None:
        return _bound(B * (state + obs), rank3_ops)
    return _bound(B * (state + obs + 12 * ticks + 52),
                  rank3_ops + B * (30 * N + COMPOSE_OPS_PER_TICK * ticks))


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


# Seconds of idle time at each end of a profiled window, tried in turn. In
# a long process torch.profiler (torch 2.11+cu128 on an H100) came to place
# device events several ms before their launches and dropped those that fell
# before the window opened: K6's check counted 7-11 of 20 launches after the
# earlier phases. A profile that also traced host activity over a replay
# made later profiles drop some too, so no profile here traces the host.
PROFILE_PADS_S = (0.2, 1.0, 3.0)


@contextlib.contextmanager
def _profiled(pad=PROFILE_PADS_S[0]):
    """torch.profiler around the block: device activity only, the window
    opened ``pad`` seconds before the block and closed ``pad`` seconds after
    its device work."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(pad)
        yield prof
        torch.cuda.synchronize()
        time.sleep(pad)


def _kernel_ms(call, part, reps=20, pads=PROFILE_PADS_S):
    """(device ms per launch of the kernels whose names hold ``part``,
    device events per call) over ``reps`` calls under torch.profiler,
    after a warm-up call: the kernel's own time, without the host time
    that separates back-to-back calls. A profile that saw fewer than
    ``reps`` device events dropped some, and runs again in a wider window
    (the next of ``pads``; after the last: the time over the events it
    kept). Where no window of ``pads`` kept an event of the kernel, the
    wider windows of PROFILE_PADS_S are tried too, and where none of them
    did either, the time is CUDA events' over ``reps`` back-to-back calls
    and the events per call are None (unknown)."""
    call()
    tries = (*pads, *(p for p in PROFILE_PADS_S if p > max(pads)))
    for i, pad in enumerate(tries):
        with _profiled(pad) as prof:
            for _ in range(reps):
                call()
        by_name = _device_busy(prof)[1]
        n_all = sum(c for c, _ in by_name.values())
        hits = [v for k, v in by_name.items() if part in k]
        n = sum(c for c, _ in hits)
        if n_all >= reps or (n and i >= len(pads) - 1):
            break
        print(f"(profiler: {n_all} device events of {reps} calls of {part} in a {pad} s "
              f"window; again in a wider one)")
    if not n:
        print(f"(profiler: no device event of {part} in any window; CUDA events over {reps} "
              f"calls instead)")
        return _cuda_time(call, reps), None
    return sum(us for _, us in hits) / n / 1e3, n_all / reps


def _require(cond, what):
    if not cond:
        raise AssertionError(what)


def _max_err(a, b, mask=None):
    d = (a - b).abs()
    if mask is not None:
        d = d[mask]
    return float(d.max()) if d.numel() else 0.0


def _card():
    """The card's name and power limit as nvidia-smi reads them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return smi.stdout.strip().splitlines()[0]


def phase0_card():
    print(_card())
    from concurrent.futures import ThreadPoolExecutor

    from aruco_slam_tpu_torch.ops.kernels import _build

    names = ("pnp_frontend", "ekf_frame_batched", "ccl", "ekf_frame_update", "probes")
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
        # padded slots (not valid) holding garbage: the kernel skips them
        corners[::11, -2] = np.nan
        valid[::11, -2] = False
        c = torch.as_tensor(corners, device=dev)
        v = torch.as_tensor(valid, device=dev)
        z, R, keep = pk.pnp_frontend_batch(c, v, cam, cfg)
        zr, Rr, keepr = pk.pnp_frontend_reference(c, v, cam, cfg)
        torch.cuda.synchronize()
        _require(torch.equal(keep, keepr), f"K1 keep differs on {int((keep != keepr).sum())} lanes")
        _require(not bool(keep[::17, -1].any()), "K1 kept a garbage slot")
        _require(not bool(keep[::11, -2].any()), "K1 kept a padded slot")
        _require(int(keep.sum()) > B, "K1 kept too few real markers to mean anything")
        ez = _max_err(z, zr, keep)
        eR = _max_err(R, Rr, keep)
        R_ok = torch.allclose(R[keep], Rr[keep], atol=2e-5, rtol=2e-4)
        _require(ez <= 2e-5 and R_ok, f"K1 vs plain: z err {ez}, R err {eR}")
        print(f"phase 1: K1 dist={dist is not None} lanes={B * M} kept={int(keep.sum())} "
              f"max |dz|={ez:.3e} max |dR|={eR:.3e}")
        worst = max(worst, ez, eR)
        if timing is None:
            call = lambda: pk.pnp_frontend_batch(c, v, cam, cfg)  # noqa: E731
            ms, events = _kernel_ms(call, "pnp_frontend")
            _require(events == 1, f"K1 made {events} device events per call, not one")
            timing = (ms, _cuda_time(lambda: pk.pnp_frontend_reference(c, v, cam, cfg), 5),
                      _cuda_time(call, 50))
            n_valid = int(v.sum())
            # the same lanes with the garbage slots padded instead: a lane's
            # inf / NaN takes the IEEE slow paths of division and sqrt
            v_clean = v.clone()
            v_clean[::17, -1] = False
            clean_ms, _ = _kernel_ms(lambda: pk.pnp_frontend_batch(c, v_clean, cam, cfg),
                                     "pnp_frontend")
            print(f"phase 1: K1 {clean_ms:.4f} ms/launch on the device with the garbage "
                  f"slots padded ({int(v_clean.sum())} lanes valid)")
    # Every lane reads valid (1 B) and writes z 12 + R 36 + keep 1 B; a
    # valid one also reads its corners (32 B) and runs the solve. A padded
    # slot exits at once.
    lanes = B * M
    bound = _bound(lanes * 50 + n_valid * 32, n_valid * K1_OPS_PER_LANE)
    print(f"phase 1: K1 {timing[0]:.4f} ms/launch on the device ({timing[2]:.4f} ms/call "
          f"through the wrapper), plain {timing[1]:.4f} ms/call, bound {bound[0]:.5f} ms "
          f"({bound[1]}; {n_valid} of {lanes} lanes valid)")
    return worst, timing, bound


def _k2_frame(f, data, cfg, cam, ticks=True):
    """Frame f's K2 arguments as the main path makes them: K1 on the
    frame's corners, the frame's encoder ticks as strided views (none when
    ``ticks`` is false)."""
    from aruco_slam_tpu_torch.models import ekf
    from aruco_slam_tpu_torch.ops.kernels import pnp_frontend as pk

    valid = data.obs_valid[:, f].contiguous()
    z, R, keep = pk.pnp_frontend_batch(data.corners_px[:, f].contiguous(), valid, cam, cfg)
    frame = ekf.FrameObservations(data.obs_ids[:, f].contiguous(), z, R, keep)
    ew, edt = data.enc_w[:, f], data.enc_dt[:, f]
    if not ticks:
        ew, edt = ew[:, :0], edt[:, :0]
    return frame, ekf.Control(ew[..., 0], ew[..., 1], edt)


# K2's cases: (variant, lanes, max_landmarks, sequences, first frame). Each
# runs 20 consecutive frames of real inputs (K1 on rendered corners, 10
# encoder ticks a frame) after a warm replay up to its first frame; the
# fifth frame runs with no ticks (T = 0) and lane 1 (lane 0 of one) is not
# yet initialized at the first. "short": 32 distinct 5 s sequences;
# "config2": phase 3b's lanes, 100 frames into config 2's tour.
K2_CASES = (
    ("smem", B, 32, "short", 20),  # the main path's shape, N = 99
    ("smem", B, 4, "short", 20),  # capacity drops
    ("cluster", 32, 128, "short", 20),  # BASELINE config 2's map, N = 387
    ("cluster", 1, 128, "short", 20),  # one lane: K6's 16 CTAs
    ("cluster", 128, 128, "short", 20),  # more lanes than one wave of any G holds
    ("device", DEVICE_LANES, 512, "config2", 80),  # phase 3b's lanes, N = 1,539
)
# The device variant's frames in device memory: 4 lanes of 512 slots whose
# active blocks straddle what a cluster holds on chip (lanes 0 and 2 run in
# device memory, 1 and 3 on chip), 6 frames of 9 known and 4 new markers.
L2_LANDMARKS = (400, 60, 505, 100)
# The G sweep: K2's cluster program at N = 387 (128 slots, 100 landmarks a
# lane, config 2's late tour), kernel alone, at these batches and CTAs a lane.
SWEEP_LANES, SWEEP_CTAS = (1, 4, 32, 128), (2, 3, 4, 6, 8, 16)
# Frames wider than the kernels keep their prologue's slots and order in
# shared memory for (ekf_update.MAX_SHARED_OBS = 256; past it they are in
# device memory): K2 in each kind and K6 in each variant over WIDE_FRAMES
# frames of WIDE_M observation slots whose ids repeat, new and padding ones
# among them (_wide_frame). K2: (variant, lanes, max_landmarks, landmarks a
# lane); K6: (max_landmarks, landmarks).
WIDE_M, WIDE_FRAMES = 300, 3
# K2-smem's plan at phase 3's lanes and the Monte-Carlo cell's
# (arena20_corners_b4096), and the frames that hold the larger to the plain
# version.
SMEM_PLAN_LANES, SMEM_PLAN_FRAMES = (B, 4096), 3
K2_WIDE = (("smem", B, 32, 20), ("cluster", 32, 128, 100), ("device", DEVICE_LANES, 512, 100))
K6_WIDE = ((128, 100), (512, 100))


def _k2_check(out, ref, what):
    """K2's output against the plain version's: the integer state exact, mu,
    sigma and last_obs to atol 5e-5 / rtol 5e-3; returns the max error."""
    for name in ("slot_ids", "n_landmarks", "seen_prev", "initialized", "diverged", "dropped"):
        _require(torch.equal(getattr(out, name), getattr(ref, name)), f"K2 {what}: {name} differs")
    err = 0.0
    for name in ("mu", "sigma", "last_obs"):
        a, r = getattr(out, name), getattr(ref, name)
        _require(torch.allclose(a, r, atol=5e-5, rtol=5e-3),
                 f"K2 {what}: {name} differs by {_max_err(a, r):.3e}")
        err = max(err, _max_err(a, r))
    return err


def _k2_choice(kb, n_dim, lanes):
    """(variant, CTAs a lane) that the wrapper chose for this card."""
    return kb._choices[(torch.cuda.current_device(), n_dim, M, lanes)][:2]


def _k2_lanes(dev, cfg, n_lms, rng, ticks=10):
    """Lanes of ``_k6_case`` states (n_lms[b] landmarks) with a frame of
    ``_k6_frame`` each and ``ticks`` encoder ticks a lane."""
    from aruco_slam_tpu_torch.models import ekf

    lanes = [_k6_case(dev, cfg, n, rng) for n in n_lms]
    state = ekf.EkfState(*(torch.cat(x) for x in zip(*lanes)))
    frame, controls = _k2_next(state, rng, ticks)
    return state, frame, controls


def _k2_next(state, rng, ticks=10, make=None):
    """A frame of ``make`` (``_k6_frame`` by default) for every lane of a
    batched state, and its ticks."""
    from aruco_slam_tpu_torch.models import ekf

    dev, n = state.mu.device, state.mu.shape[0]
    make = make or _k6_frame
    frames = [make(ekf.EkfState(*(x[b:b + 1] for x in state)), rng) for b in range(n)]
    w = torch.as_tensor(rng.uniform(-1.0, 3.0, (n, ticks, 2)).astype(np.float32), device=dev)
    dt = torch.as_tensor(rng.uniform(0.005, 0.02, (n, ticks)).astype(np.float32), device=dev)
    return (ekf.FrameObservations(*(torch.cat(x) for x in zip(*frames))),
            ekf.Control(w[..., 0], w[..., 1], dt))


def phase2_k2(dev):
    """K2 in each variant against its plain version over 20 consecutive
    frames, the device variant's frames in device memory, and the G sweep;
    returns {variant: (max err, ms, plain ms, bound, wrapper ms)} at the
    variant's first case."""
    from aruco_slam_tpu_torch import runner
    from aruco_slam_tpu_torch.ops.camera import CameraIntrinsics
    from aruco_slam_tpu_torch.ops.kernels import ekf_update_batched as kb
    from aruco_slam_tpu_torch.utils.config import EkfConfig, SlamConfig

    cam = CameraIntrinsics.create(600.0, 600.0, 320.0, 240.0)
    sources = {"short": (_sequences(cam, range(100, 132), 5.0), cam),  # 32 distinct sequences
               "config2": _config2_arena()}
    out_stats, dropped = {}, 0
    for kind, lanes, L, source, start in K2_CASES:
        seqs, cam = sources[source]
        c = SlamConfig(ekf=EkfConfig(max_landmarks=L, max_observations_per_frame=M))
        n_dim = 3 + 3 * L
        _require(kb.variant(n_dim)[0] == kind, f"K2 at {L} landmarks: {kb.variant(n_dim)}")
        data = runner.build_batch_data(seqs, lanes, "corners", dev)
        warm = runner.replay_batch(data._replace(**{
            k: v[:, :start] for k, v in data._asdict().items() if v is not None
        }), c, cam, "corners")
        state = warm.final_state
        state.initialized[min(1, lanes - 1)] = False
        F = start + 20
        rows = [kb.Rows(torch.zeros(lanes, F, 3, device=dev),
                        torch.zeros(lanes, F, 3, 3, device=dev),
                        torch.zeros(lanes, F, dtype=torch.int32, device=dev), 0) for _ in "ab"]
        err, before = 0.0, dict(kb.LAUNCHES)
        for f in range(start, F):
            frame, controls = _k2_frame(f, data, c, cam, ticks=f != start + 5)
            out = kb.frame_step_batched(state, frame, controls, c, rows=rows[0]._replace(f=f))
            ref = kb.frame_step_reference(state, frame, controls, c, rows=rows[1]._replace(f=f))
            torch.cuda.synchronize()
            err = max(err, _k2_check(out, ref, f"({kind}, B={lanes}, N={n_dim}) frame {f}"))
            if kind not in out_stats and f == F - 1:
                call = lambda: kb.frame_step_batched(state, frame, controls, c)  # noqa: E731
                ms, events = _kernel_ms(call, "ekf_frame_batched")
                _require(events == 1, f"K2 ({kind}) made {events} device events per call, "
                         f"not one")
                wrap_ms = _cuda_time(call, 50)
                plain = _cuda_time(lambda: kb.frame_step_reference(state, frame, controls, c), 5)
                _, _, _, _, _, _, valid, slots = kb.frame_step_inputs(state, frame, controls, c)
                known = (valid & (slots >= 0)).sum(dim=1).double()
                active = (3 + 3 * state.n_landmarks).double()
                rank3 = float((6 * known * active * active).sum())
                bound = _ekf_bound(lanes, n_dim, L, M, rank3, controls.dt.shape[1])
                out_stats[kind] = [0.0, ms, plain, bound, wrap_ms]
                print(f"phase 2: K2 ({kind}, G={_k2_choice(kb, n_dim, lanes)[1]}) B={lanes} "
                      f"N={n_dim} M={M} T={controls.dt.shape[1]}: "
                      f"{ms:.4f} ms/launch on the device ({wrap_ms:.4f} ms/call through the "
                      f"wrapper), one device event a call, plain {plain:.4f} ms/call, bound "
                      f"{bound[0]:.5f} ms ({bound[1]}; {int(known.sum())} known observations)")
            state = out
        _require(kb.LAUNCHES[kind] - before[kind] >= 20, f"K2 ({kind}) did not launch its variant")
        for a, r in zip(rows[0][:3], rows[1][:3]):
            _require(torch.allclose(a, r, atol=5e-5, rtol=5e-3), f"K2 ({kind}) rows differ")
        out_stats[kind][0] = max(out_stats[kind][0], err)
        dropped += int(state.dropped.sum()) if L == 4 else 0
        print(f"phase 2: K2 ({kind}, G={_k2_choice(kb, n_dim, lanes)[1]}) B={lanes} N={n_dim} "
              f"frames {start}-{F - 1} (frame {start + 5} without ticks, a lane uninitialized at "
              f"{start}): landmarks {int(state.n_landmarks.min())}-"
              f"{int(state.n_landmarks.max())}, dropped {int(state.dropped.sum())}, "
              f"max |err| {err:.3e}")
    _require(dropped > 0, "the small-capacity run never dropped a landmark")
    out_stats["device"][0] = max(out_stats["device"][0], _k2_device_memory(dev, kb))
    _k2_sweep(dev, kb)
    out_stats["smem"][0] = max(out_stats["smem"][0], _k2_smem_plans(dev, kb, *sources["short"]))
    for kind, (err, ms) in _k2_wide(dev, kb).items():
        out_stats[kind][0] = max(out_stats[kind][0], err)
        out_stats[kind].append(ms)
    return {k: tuple(v) for k, v in out_stats.items()}


def _k2_smem_plans(dev, kb, seqs, cam):
    """K2-smem's plan (threads a lane, resident lanes an SM, waves) at each
    of SMEM_PLAN_LANES on 32 distinct 5 s sequences (N 99, M 16), the
    kernel alone timed at frames 20 and on, and the larger batch held to
    its plain version over SMEM_PLAN_FRAMES frames; returns the max
    error."""
    from aruco_slam_tpu_torch import runner
    from aruco_slam_tpu_torch.utils.config import EkfConfig, SlamConfig

    L, start = 32, 20
    c = SlamConfig(ekf=EkfConfig(max_landmarks=L, max_observations_per_frame=M))
    n_dim, d, lib = 3 + 3 * L, torch.cuda.current_device(), kb._lib()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    err, times = 0.0, {}
    for lanes in SMEM_PLAN_LANES:
        data = runner.build_batch_data(seqs, lanes, "corners", dev)
        state = runner.replay_batch(data._replace(**{
            k: v[:, :start] for k, v in data._asdict().items() if v is not None
        }), c, cam, "corners").final_state
        checked = lanes == max(SMEM_PLAN_LANES)
        for f in range(start, start + (SMEM_PLAN_FRAMES if checked else 1)):
            frame, controls = _k2_frame(f, data, c, cam)
            out = kb.frame_step_batched(state, frame, controls, c)
            if checked:
                ref = kb.frame_step_reference(state, frame, controls, c)
                torch.cuda.synchronize()
                err = max(err, _k2_check(out, ref, f"(smem, B={lanes}) frame {f}"))
            state = out
        kind, _, _, threads = kb._choices[(d, n_dim, M, lanes)]
        _require(kind == "smem", f"K2 at B={lanes}, N={n_dim}: {kind}")
        plans = {t: kb._plan(lib, d, kind, n_dim, L, M, 1, t)[1] for t in kb.SMEM_THREADS}
        waves = {t: -(-lanes // (r * sms)) for t, r in plans.items()}
        call = lambda: kb.frame_step_batched(state, frame, controls, c)  # noqa: E731
        before = dict(kb.SMEM_LAUNCHES)
        times[lanes], events = _kernel_ms(call, "ekf_frame_batched", pads=PROFILE_PADS_S[:1])
        _require(kb.SMEM_LAUNCHES[threads] > before[threads], f"K2-smem at B={lanes} did not "
                 f"launch its {threads}-thread plan")
        print(f"phase 2: K2 (smem) B={lanes} N={n_dim} M={M}: the {threads}-thread plan, "
              f"{plans[threads]} resident lanes an SM, {waves[threads]} wave(s) over {sms} SMs "
              f"(plans by threads: resident {plans}, waves {waves}); {times[lanes]:.4f} ms/launch "
              f"on the device ({events} device events a call)"
              + (f"; {SMEM_PLAN_FRAMES} frames equal to the plain version, max |err| {err:.3e}"
                 if checked else ""))
    print(f"phase 2: K2-smem, B {max(times)} against B {min(times)}: "
          f"{times[max(times)] / times[min(times)]:.2f}x the time for "
          f"{max(times) / min(times):.0f}x the lanes")
    return err


def _k2_wide(dev, kb):
    """K2 in each kind (K2_WIDE) on WIDE_FRAMES consecutive frames of
    WIDE_M observation slots against its plain version, timed at the
    first; returns {kind: (max err, kernel ms)}."""
    from aruco_slam_tpu_torch.models import ekf
    from aruco_slam_tpu_torch.utils.config import EkfConfig, SlamConfig

    out = {}
    for kind, lanes, L, n_lm in K2_WIDE:
        cfg = SlamConfig(ekf=EkfConfig(max_landmarks=L, max_observations_per_frame=WIDE_M))
        n_dim = 3 + 3 * L
        _require(kb.variant(n_dim)[0] == kind, f"K2 at {L} landmarks: {kb.variant(n_dim)}")
        rng = np.random.default_rng(WIDE_M + L)
        state = ekf.EkfState(*(torch.cat(x) for x in zip(*(_k6_case(dev, cfg, n_lm, rng)
                                                            for _ in range(lanes)))))
        frame, controls = _k2_next(state, rng, make=_wide_frame)
        err, before = 0.0, kb.LAUNCHES[kind]
        for f in range(WIDE_FRAMES):
            got = kb.frame_step_batched(state, frame, controls, cfg)
            ref = kb.frame_step_reference(state, frame, controls, cfg)
            torch.cuda.synchronize()
            err = max(err, _k2_check(got, ref, f"({kind}, B={lanes}, M={WIDE_M}) frame {f}"))
            if f == 0:
                ms, _ = _kernel_ms(lambda: kb.frame_step_batched(state, frame, controls, cfg),
                                   "ekf_frame_batched")
                plain = _cuda_time(lambda: kb.frame_step_reference(state, frame, controls, cfg),
                                   2)
                _, _, _, _, _, _, valid, slots = kb.frame_step_inputs(state, frame, controls, cfg)
                known = (valid & (slots >= 0)).sum(dim=1).double()
                active = (3 + 3 * state.n_landmarks).double()
                bound = _ekf_bound(lanes, n_dim, L, WIDE_M, float((6 * known * active**2).sum()),
                                   controls.dt.shape[1])
                n_valid = int(frame.valid.sum())
            state = got
            frame, controls = _k2_next(state, rng, make=_wide_frame)
        _require(kb.LAUNCHES[kind] - before >= WIDE_FRAMES, f"K2 ({kind}) did not launch at "
                 f"M={WIDE_M}")
        out[kind] = (err, ms)
        g = kb._choices[(torch.cuda.current_device(), n_dim, WIDE_M, lanes)][1]
        print(f"phase 2: K2 ({kind}, G={g}) B={lanes} N={n_dim} M={WIDE_M} (slots and order "
              f"in device memory; "
              f"{n_valid} valid at the first frame): {WIDE_FRAMES} frames equal to the plain "
              f"version, max |err| {err:.3e}; {ms:.4f} ms/launch on the device, plain "
              f"{plain:.4f} ms/call, bound {bound[0]:.5f} ms ({bound[1]}); landmarks now "
              f"{int(state.n_landmarks.min())}-{int(state.n_landmarks.max())}, dropped "
              f"{int(state.dropped.sum())}")
    return out


def _k2_device_memory(dev, kb):
    """The device variant with lanes whose frame's active block runs in
    device memory beside lanes on chip, against the plain version over 6
    frames; returns the max error."""
    from aruco_slam_tpu_torch.utils.config import EkfConfig, SlamConfig

    L = 512
    cfg = SlamConfig(ekf=EkfConfig(max_landmarks=L, max_observations_per_frame=M))
    n_dim, lanes = 3 + 3 * L, len(L2_LANDMARKS)
    rng = np.random.default_rng(L)
    state, frame, controls = _k2_lanes(dev, cfg, L2_LANDMARKS, rng)
    err, before = 0.0, kb.LAUNCHES["device"]
    for f in range(6):
        out = kb.frame_step_batched(state, frame, controls, cfg)
        ref = kb.frame_step_reference(state, frame, controls, cfg)
        torch.cuda.synchronize()
        if f == 0:
            rows = kb.on_chip_rows("device", n_dim, M, _k2_choice(kb, n_dim, lanes)[1])
            n_new = (frame.valid & (kb.frame_step_inputs(state, frame, controls, cfg)[7] < 0)).sum(1)
            na = 3 + 3 * torch.clamp(state.n_landmarks + n_new, max=L)
            in_l2 = (na > rows).tolist()
            _require(any(in_l2) and not all(in_l2),
                     f"expected lanes both on chip and in device memory: blocks {na.tolist()}, "
                     f"{rows} rows on chip")
            ms, events = _kernel_ms(lambda: kb.frame_step_batched(state, frame, controls, cfg),
                                    "ekf_frame_batched", pads=PROFILE_PADS_S[:1])
        err = max(err, _k2_check(out, ref, f"(device memory) frame {f}"))
        state = out
        frame, controls = _k2_next(state, rng)
    _require(kb.LAUNCHES["device"] - before >= 6, "the device variant did not launch")
    print(f"phase 2: K2 (device, G={_k2_choice(kb, n_dim, lanes)[1]}) B={lanes} N={n_dim}, "
          f"landmarks {L2_LANDMARKS} (active blocks {na.tolist()}; {rows} rows fit on chip, lanes "
          f"in device memory {in_l2}): 6 frames equal to the plain version, max |err| {err:.3e}; "
          f"{ms:.4f} ms/launch on the device at the first frame; landmarks now "
          f"{state.n_landmarks.tolist()}, dropped {state.dropped.tolist()}")
    return err


def _k2_sweep(dev, kb):
    """Kernel-alone ms of K2's cluster program at N = 387 over SWEEP_CTAS x
    SWEEP_LANES (where the stripe fits a CTA), beside the G of the wrapper's
    rule and the card's cluster occupancy."""
    from aruco_slam_tpu_torch.utils.config import EkfConfig, SlamConfig

    L = 128
    n_dim = 3 + 3 * L
    cfg = SlamConfig(ekf=EkfConfig(max_landmarks=L, max_observations_per_frame=M))
    lib = kb._lib()
    for kind, n in (("cluster", n_dim), ("device", 3 + 3 * 512)):
        occ = [kb._plan(lib, torch.cuda.current_device(), kind, n, (n - 3) // 3, M, g)[1]
               if g >= kb.min_ctas(kind, n) else None for g in range(1, 17)]
        print(f"phase 2: K2 ({kind}, N={n}) clusters of G = 1..16 CTAs the card holds at once: "
              f"{occ} (the wrapper's table for a host without a card: {kb.H100_CLUSTERS})")
    rng = np.random.default_rng(387)
    for lanes in SWEEP_LANES:
        state, frame, controls = _k2_lanes(dev, cfg, (100,) * lanes, rng)
        ref = kb.frame_step_reference(state, frame, controls, cfg)
        kb.frame_step_batched(state, frame, controls, cfg)  # the rule's choice, cached
        rule = _k2_choice(kb, n_dim, lanes)[1]
        times = {}
        for g in sorted(set(SWEEP_CTAS) | {rule}):
            if kb.shared_bytes("cluster", n_dim, L, M, ctas=g) > kb.MAX_SHARED_BYTES:
                continue
            call = functools.partial(kb._launch, state, frame, controls, cfg, None, None,
                                     ("cluster", g))
            _k2_check(call(), ref, f"(cluster, B={lanes}, G={g}, sweep)")
            times[g] = _kernel_ms(call, "ekf_frame_batched", pads=PROFILE_PADS_S[:1])[0]
        best = min(times, key=times.get)
        print(f"phase 2: K2 G sweep, N={n_dim}, B={lanes}, kernel alone (ms) by G: "
              + ", ".join(f"{g}: {t:.4f}" for g, t in times.items())
              + f"; the rule's G={rule} takes {times[rule] / times[best]:.3f}x the fastest "
              f"(G={best})")


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
    _reset_counts(pk, kb)
    out = runner.replay_batch(data, cfg, cam, "corners")
    torch.cuda.synchronize()
    launches = _counts(pk, kb)
    print(f"phase 3: launches in one {B}x{F} replay: {launches}")
    _require(launches == {"pnp_frontend": F, "ekf_frame_batched.smem": F,
                          "ekf_frame_batched.cluster": 0, "ekf_frame_batched.device": 0},
             f"expected {F} launches of K1 and of K2's smem variant, got {launches}")

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
    _profile_replay("phase 3", lambda: runner.replay_batch(data, cfg, cam, "corners"), F)
    return launches, fps


def _reset_counts(pk, kb):
    pk.LAUNCHES = 0
    for k in kb.LAUNCHES:
        kb.LAUNCHES[k] = 0


def _counts(pk, kb):
    return {"pnp_frontend": pk.LAUNCHES,
            **{f"ekf_frame_batched.{k}": v for k, v in kb.LAUNCHES.items()}}


def _profile_replay(what, replay, frames):
    """One replay under torch.profiler: device events per frame, the
    device-busy share of its wall time, K1's and K2's device ms per frame;
    and the replay's peak device memory (a second, unprofiled run)."""
    with _profiled(PROFILE_PADS_S[1]) as prof:
        t0 = time.perf_counter()
        replay()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, by_name = _device_busy(prof)
    n_dev = sum(c for c, _ in by_name.values())
    k1 = sum(v[1] for k, v in by_name.items() if "pnp_frontend" in k) / frames / 1e3
    k2 = sum(v[1] for k, v in by_name.items() if "ekf_frame" in k) / frames / 1e3
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    replay()
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    others = sorted(((v[0], k) for k, v in by_name.items()
                     if "pnp_frontend" not in k and "ekf_frame" not in k), reverse=True)[:4]
    print(f"{what}: profile of one replay: {n_dev / frames:.2f} device events per frame "
          f"(others: {others}), device busy {busy / 1e3:.3f} ms of {wall * 1e3:.3f} ms wall "
          f"({100 * busy / 1e6 / wall:.1f}%), K1 {k1:.4f} ms and K2 {k2:.4f} ms of device time "
          f"per frame; peak device memory {peak:.1f} MiB above the inputs")
    return n_dev / frames


@functools.lru_cache(maxsize=1)
def _config2_arena():
    """Phase 3b's lanes: BASELINE config 2's arena (100 markers, 20 x 16 m,
    a 210 s tour) at corner level, seeds 0-7, and their camera."""
    from aruco_slam_tpu_torch.ops.camera import CameraIntrinsics
    from aruco_slam_tpu_torch.sim import synthetic

    arena = synthetic.make_arena(n_markers=100, width=20.0, height=16.0)
    seqs = [
        synthetic.generate_sequence(
            synthetic.SimParams(duration=210.0, profile="tour", tour_width=20.0,
                                tour_height=16.0, tour_inset=1.6, encoder_noise=0.4,
                                fov_deg=90.0, max_view_angle_deg=85.0, seed=s, max_obs=M),
            marker_map=arena, level="corners",
            camera=CameraIntrinsics.create(600.0, 600.0, 320.0, 240.0),
        )
        for s in range(8)
    ]
    return seqs, seqs[0].camera()


def phase3b_config2_batched(dev):
    """The batched user with a large map: BASELINE config 2's arena at corner
    level through runner.replay_batch, K2's cluster variant (128 slots) and
    its device variant (512 slots), against the plain replay."""
    from aruco_slam_tpu_torch import runner
    from aruco_slam_tpu_torch.ops.kernels import ekf_update_batched as kb
    from aruco_slam_tpu_torch.ops.kernels import pnp_frontend as pk
    from aruco_slam_tpu_torch.utils.config import EkfConfig, SlamConfig

    seqs, cam = _config2_arena()
    full = runner.build_batch_data(seqs, C2_LANES, "corners", dev)
    launches = {}
    for kind, lanes, L, frames in (("cluster", C2_LANES, 128, C2_FRAMES),
                                   ("device", DEVICE_LANES, 512, DEVICE_FRAMES)):
        cfg = SlamConfig(ekf=EkfConfig(max_landmarks=L, max_observations_per_frame=M))
        data = full._replace(**{k: v[:lanes, :frames] for k, v in full._asdict().items()
                                if v is not None})
        torch.cuda.synchronize()
        _reset_counts(pk, kb)
        res = {}
        t = _timed(lambda: res.update(out=runner.replay_batch(data, cfg, cam, "corners")))
        got = _counts(pk, kb)
        want = {"pnp_frontend": frames, "ekf_frame_batched.smem": 0,
                "ekf_frame_batched.cluster": 0, "ekf_frame_batched.device": 0,
                f"ekf_frame_batched.{kind}": frames}
        _require(got == want, f"{kind}: expected launches {want}, got {got}")
        launches[kind] = got[f"ekf_frame_batched.{kind}"]
        plain = {}
        t_plain = _timed(lambda: plain.update(
            ref=runner.replay_batch_reference(data, cfg, cam, "corners")))
        out, ref = res["out"], plain["ref"]
        _require(bool(torch.isfinite(out.trajectory).all()), f"{kind}: non-finite trajectory")
        _require(torch.equal(out.n_landmarks, ref.n_landmarks), f"{kind}: n_landmarks differ")
        _require(torch.equal(out.final_state.slot_ids, ref.final_state.slot_ids),
                 f"{kind}: slot_ids differ")
        err = _max_err(out.trajectory, ref.trajectory)
        _require(err <= TRAJ_TOL, f"{kind}: trajectory deviates from the plain path by {err}")
        times = [t] + [_timed(lambda: runner.replay_batch(data, cfg, cam, "corners"))
                       for _ in range(2)]
        print(f"phase 3b: config 2's arena, {lanes} lanes x {frames} frames, max_landmarks={L} "
              f"(K2 {kind}): launches {got}; landmarks {int(out.n_landmarks[:, -1].min())}-"
              f"{int(out.n_landmarks[:, -1].max())} and slots equal to the plain replay, "
              f"trajectory max |kernel - plain| {err:.3e}; "
              f"{lanes * frames / statistics.median(times):.1f} frames/s (median of 3: "
              f"{', '.join(f'{x:.3f}' for x in times)} s), plain "
              f"{lanes * frames / t_plain:.1f} frames/s ({t_plain:.3f} s)")
    return launches


def _poses(n, seed=4):
    rng = np.random.default_rng(seed)
    poses = np.stack([rng.uniform(0.8, 4.3, n), rng.uniform(-3.9, -0.8, n),
                      rng.uniform(-np.pi, np.pi, n)], axis=1)
    poses[0] = (2.55, -2.0, 1.2)  # tests/test_detector.py's scene
    return poses


def _render_hd(n, dev, h=1080, w=1920):
    """n h x w frames (1920x1080 by default) of the 20-marker arena at
    varied poses, the camera's focal length in proportion to the width."""
    from aruco_slam_tpu_torch.ops.camera import CameraIntrinsics
    from aruco_slam_tpu_torch.sim import renderer, synthetic

    f = 1800.0 * w / 1920
    return renderer.render_poses(_poses(n, 5), synthetic.make_arena(n_markers=20),
                                 CameraIntrinsics.create(f, f, w / 2, h / 2),
                                 height=h, width=w, device=dev)


def _band_crossing_mask(h=480, w=640, bands=8):
    """A serpentine that winds down through every band of the cluster body
    (the bounded rounds do not converge on it), plus components that end
    on, start on and straddle each band edge (tests/test_torch_ccl.py)."""
    fg = np.zeros((h, w), bool)
    for y in range(2, h - 2, 4):
        fg[y, 4:w - 4] = True
        fg[y + 1: y + 4, w - 5 if (y // 4) % 2 == 0 else 4] = True
    fg[:, w // 2 - 20: w // 2 - 18] = False  # cut it into two windings
    band = h // bands
    for b in range(1, bands):
        y = b * band
        fg[y - 3: y, 40 + 60 * b: 60 + 60 * b] = True  # ends on the edge
        fg[y: y + 3, 50 + 60 * b: 70 + 60 * b] = True  # starts on it
        fg[y - 1: y + 1, 10: 20] = True  # straddles it
    return fg


def _tile_crossing_mask(h, w, band_rows, seg):
    """A serpentine that winds down through every band of ``band_rows``
    rows (the block body's tiles; the bounded rounds do not converge on
    it), components that end on, start on and straddle band edges, and
    short runs that end on, start on and cross the row splits every ``seg``
    pixels (tests/torch_ccl_masks.py)."""
    fg = np.zeros((h, w), bool)
    for y in range(2, h - 2, 4):
        fg[y, 4:w - 4] = True
        fg[y + 1: y + 4, w - 5 if (y // 4) % 2 == 0 else 4] = True
    fg[:, w // 2 - 20: w // 2 - 18] = False  # two windings
    span = max(1, w - 100)
    for i, y in enumerate(range(band_rows, h, band_rows * max(1, 8 // band_rows))):
        x = 40 + (60 * i) % span
        fg[max(0, y - 3): y, x: x + 20] = True  # ends on the edge
        fg[y: y + 3, x + 10: x + 30] = True  # starts on it
        fg[y - 1: y + 1, 10: 20] = True  # straddles it
    rows = list(range(4, h - 4, 4))
    for k, x in enumerate(range(seg, w - 8, seg)):
        y = rows[k % len(rows)]
        fg[y, x - 6: x + 6] = True  # across the split
        fg[rows[(k + len(rows) // 2) % len(rows)], x - 5: x] = True  # ends on it
    return fg


def _frames_for_ccl(dev):
    """Phase 4's inputs: 32 rendered 640x480 frames (the 20-marker arena at
    varied poses), 8 uniform-noise frames, 2 frames drawn across the
    cluster body's band edges; HD_CHUNK rendered 1280x720 and 1920x1080
    frames, and one 1084x1920 frame (the block body's tiles do not divide
    its height)."""
    from aruco_slam_tpu_torch.ops.camera import CameraIntrinsics
    from aruco_slam_tpu_torch.sim import renderer, synthetic

    rng = np.random.default_rng(4)
    arena = synthetic.make_arena(n_markers=20)
    vga = renderer.render_poses(_poses(32), arena,
                                CameraIntrinsics.create(600.0, 600.0, 320.0, 240.0), device=dev)
    noise = torch.as_tensor(rng.integers(0, 256, (8, 480, 640), dtype=np.uint8), device=dev)
    # dark strokes on a bright page: a serpentine of 2-pixel rows joined at
    # alternate ends through all 8 bands, and the band-edge mask's shapes
    snake = np.full((480, 640), 200, np.uint8)
    for y in range(2, 478, 4):
        snake[y:y + 2, 4:636] = 20
    for y in range(4, 478, 8):
        snake[y:y + 2, 632:636] = 20
    for y in range(8, 478, 8):
        snake[y:y + 2, 4:8] = 20
    edges = np.where(_band_crossing_mask(), 20, 200).astype(np.uint8)
    bands = torch.as_tensor(np.stack([snake, edges]), device=dev)
    return {"rendered 640x480": vga, "noise 640x480": noise, "band-crossing 640x480": bands,
            "rendered 1280x720": _render_hd(HD_CHUNK, dev, 720, 1280),
            "rendered 1920x1080": _render_hd(HD_CHUNK, dev),
            "rendered 1084x1920": _render_hd(1, dev, 1084, 1920)}


# bytes per pixel in + out, and operations per pixel, of each CCL variant
def _ccl_work(name, r1, r2):
    return {
        "threshold_label_union": (1 + 1 + 4 + 1 + 4, CCL_THRESHOLD_OPS + CCL_CLOSE_OPS
                                  + (r1 + r2) * CCL_ROUND_OPS),
        "threshold_label": (1 + 1 + 4, CCL_THRESHOLD_OPS + r1 * CCL_ROUND_OPS),
        "label_components": (1 + 4, r1 * CCL_ROUND_OPS),
        "label_components_seeded": (1 + 4 + 4, r2 * CCL_ROUND_OPS),
    }[name]


def phase4_ccl(dev):
    """K3, K4, K5, K5s against their plain versions in both bodies; returns
    per "variant.body" (max err, ms, plain ms, bound) at the body's path
    chunk: 128 frames of 640x480 (cluster), HD_CHUNK of 1920x1080 (block)."""
    from aruco_slam_tpu_torch.ops.detector import DetectorConfig
    from aruco_slam_tpu_torch.ops.kernels import ccl

    cfg = DetectorConfig()
    r, C, s, r1, r2 = cfg.adaptive_radius, cfg.adaptive_C, cfg.mean_stride, cfg.ccl_rounds, \
        cfg.closed_ccl_rounds
    err = dict.fromkeys(ccl.LAUNCHES, 0.0)

    def check(name, got, want, what, kind):
        for a, b in zip(got, want):
            _require(a.shape == b.shape and torch.equal(a, b),
                     f"{name} ({kind} body) differs from its plain version on {what}")
            key = f"{name}.{kind}"
            err[key] = max(err[key], _max_err(a.to(torch.int64), b.to(torch.int64)))

    def check_all(img, what, kind):
        before = dict(ccl.LAUNCHES)
        ref = ccl.threshold_label_union_reference(img, r, C, s, r1, r2)
        check("threshold_label_union", ccl.threshold_label_union(img, r, C, s, r1, r2),
              ref, what, kind)
        check("threshold_label", ccl.threshold_label(img, r, C, s, r1),
              ccl.threshold_label_reference(img, r, C, s, r1), what, kind)
        fg, lab, fg_c, _ = ref
        for mask in (fg, fg_c):
            check("label_components", (ccl.label_components(mask, r1),),
                  (ccl.label_components_reference(mask, r1),), what, kind)
        seed = lab.reshape(fg.shape)
        check("label_components_seeded", (ccl.label_components(fg_c, r2, init=seed),),
              (ccl.label_components_reference(fg_c, r2, init=seed),), what, kind)
        torch.cuda.synchronize()
        used = {k: v - before[k] for k, v in ccl.LAUNCHES.items() if v != before[k]}
        _require(used == {f"threshold_label_union.{kind}": 1, f"threshold_label.{kind}": 1,
                          f"label_components.{kind}": 2,
                          f"label_components_seeded.{kind}": 1},
                 f"{what}: launches {used}, expected the {kind} body")
        return float(fg.float().mean())

    inputs = _frames_for_ccl(dev)
    for what, frames in inputs.items():
        h, w = frames.shape[1:]
        kind = ccl.body(h, w, s)
        _require(kind == ccl.body(h, w) == ("block" if w > 1024 else "cluster"),
                 f"{what}: body {kind}")
        if kind == "cluster":  # the cluster body's path: chunks of 16
            for i in range(0, frames.shape[0], 16):
                dens = check_all(frames[i: i + 16].contiguous(), what, kind)
            print(f"phase 4: K3 K4 K5 K5s ({kind} body) bit-identical to plain on "
                  f"{frames.shape[0]} {what} frames (foreground {dens:.3f})")
            continue
        # the block body: one frame (spread over the card) and the chunk
        # (frames in flight side by side), uint8 and float32
        for n in sorted({1, frames.shape[0]}):
            for dtype in (torch.uint8, torch.float32):
                img = frames[:n].to(dtype).contiguous()
                dens = check_all(img, what, kind)
                plan = ccl.block_plan(h, w, n)
                print(f"phase 4: K3 K4 K5 K5s ({kind} body) bit-identical to plain on {n} {what} "
                      f"{str(dtype)[6:]} frames (foreground {dens:.3f}; tiles of "
                      f"{plan.tile_rows}x{plan.tile_width}, {plan.tiles_x * plan.tiles_y} a "
                      f"frame, {plan.teams} frames in flight)")

    # K5 and K5s at 1920x1080 on a mask drawn across the block body's tiles
    # for one frame and for the chunk
    for n in (1, HD_CHUNK):
        plan = ccl.block_plan(1080, 1920, n)
        mask = _tile_crossing_mask(1080, 1920, plan.tile_rows, plan.tile_width // 32)
        fg = torch.as_tensor(mask, device=dev)[None].repeat(n, 1, 1).contiguous()
        ref = ccl.label_components_reference(fg, r1)
        check("label_components", (ccl.label_components(fg, r1),), (ref,),
              f"the {n}-frame tile-crossing mask", "block")
        seed = ref.reshape(fg.shape)
        check("label_components_seeded", (ccl.label_components(fg, r2, init=seed),),
              (ccl.label_components_reference(fg, r2, init=seed),),
              f"the {n}-frame tile-crossing mask", "block")
        parts = int(torch.unique(ref[0][fg[0].reshape(-1)]).numel())
        _require(parts > 16, f"the 1920x1080 tile-crossing mask converged ({parts} labels)")
        print(f"phase 4: K5, K5s (block body) bit-identical to plain on {n} 1920x1080 "
              f"tile-crossing masks (tiles of {plan.tile_rows} rows; {parts} labels left on its "
              f"foreground by {r1} rounds: unconverged)")

    # K5 and K5s on the band-crossing mask itself
    mask = torch.as_tensor(_band_crossing_mask(), device=dev)[None].contiguous()
    lab = ccl.label_components(mask, r1)
    ref = ccl.label_components_reference(mask, r1)
    check("label_components", (lab,), (ref,), "the band-crossing mask", "cluster")
    seed = lab.reshape(mask.shape)
    check("label_components_seeded", (ccl.label_components(mask, r2, init=seed),),
          (ccl.label_components_reference(mask, r2, init=seed),), "the band-crossing mask",
          "cluster")
    parts = int(torch.unique(ref[0][mask.reshape(-1)]).numel())
    _require(parts > 16, f"the band-crossing mask converged ({parts} labels)")
    print(f"phase 4: K5, K5s bit-identical to plain on the band-crossing mask ({parts} labels "
          f"left on its foreground by {r1} rounds: unconverged)")

    # K3 in both bodies at 1, 16 and 128 640x480 frames (the block body
    # launched through the wrapper's own launcher: the shape alone would
    # give the cluster body)
    vga = inputs["rendered 640x480"]
    vga128 = vga.repeat(4, 1, 1).contiguous()
    for n in (1, 16, 128):
        img = vga128[:n].contiguous()
        t = {kind: _cuda_time(lambda k=kind: ccl._launch_threshold(
            img, r, C, s, r1, r2, True, k), 10 if n == 128 else 30)
            for kind in ("cluster", "block")}
        print(f"phase 4: K3 at {n} frames 640x480: cluster body {t['cluster']:.4f} ms, block "
              f"body {t['block']:.4f} ms")

    # each variant at its body's path chunk (the kernels line's row: 128
    # 640x480 frames, HD_CHUNK 1920x1080 frames), then at the other sizes
    out = {}
    hd = inputs["rendered 1920x1080"]
    for kind, img, what in (("cluster", vga128, "128 frames 640x480"),
                            ("cluster", vga128[:16].contiguous(), "16 frames 640x480"),
                            ("block", hd, f"{HD_CHUNK} frames 1920x1080"),
                            ("block", hd[:1].contiguous(), "1 frame 1920x1080"),
                            ("block", inputs["rendered 1280x720"], f"{HD_CHUNK} frames 1280x720")):
        fg, lab, fg_c, _ = ccl.threshold_label_union_reference(img, r, C, s, r1, r2)
        seed = lab.reshape(fg.shape)
        runs = {
            "threshold_label_union": (
                lambda: ccl.threshold_label_union(img, r, C, s, r1, r2),
                lambda: ccl.threshold_label_union_reference(img, r, C, s, r1, r2)),
            "threshold_label": (lambda: ccl.threshold_label(img, r, C, s, r1),
                                lambda: ccl.threshold_label_reference(img, r, C, s, r1)),
            "label_components": (lambda: ccl.label_components(fg, r1),
                                 lambda: ccl.label_components_reference(fg, r1)),
            "label_components_seeded": (
                lambda: ccl.label_components(fg_c, r2, init=seed),
                lambda: ccl.label_components_reference(fg_c, r2, init=seed)),
        }
        px = img.numel()
        for name, (kern, plain) in runs.items():
            key = f"{name}.{kind}"
            ms = _cuda_time(kern, 10)
            n_bytes, n_ops = _ccl_work(name, r1, r2)
            bound = _bound(px * n_bytes, px * n_ops)
            if key in out:  # the body at another chunk: its time beside its bound
                print(f"phase 4: {key} {ms:.4f} ms/launch ({what}), bound {bound[0]:.5f} ms "
                      f"({bound[1]})")
                continue
            plain_ms = _cuda_time(plain, 2)
            out[key] = (err[key], ms, plain_ms, bound)
            print(f"phase 4: {key} {ms:.4f} ms/launch ({what}), plain {plain_ms:.4f} ms/call, "
                  f"bound {bound[0]:.5f} ms ({bound[1]})")
        del fg, lab, fg_c, seed, runs
    return out


# The probes P1-P3 of the JAX package's studies: the threshold of
# benchmarks/_ccl_fixed_probe.py (radius 7, C 7.0, stride 4) and its rounds
# sweep (:87-102: K4 at P1_ROUNDS, K5 on the threshold's mask at
# P1_K5_ROUNDS), the rounds of benchmarks/_p1080b_probe.py, and each row's
# TPU kernel (a file of the JAX package's kernels, or a path from the root).
PROBE_RADIUS, PROBE_C, PROBE_STRIDE, P3_ROUNDS = 7, 7.0, 4, 3
P1_ROUNDS, P1_K5_ROUNDS = (1, 2, 4, 8), (1, 4, 8)
PROBE_REPLACES = {
    "probe_copy": "benchmarks/_ccl_fixed_probe.py:68",
    "probe_scale": "benchmarks/_det_chain_probe.py:222",
    "threshold_only.cluster": "benchmarks/_ccl_fixed_probe.py:49",
    "threshold_only.block": "benchmarks/_ccl_fixed_probe.py:49",
    "threshold_label.block.random": "benchmarks/_p1080b_probe.py:16",
    "threshold_label.block.spilled": "benchmarks/_p1080b_probe.py:16",
    **{f"threshold_label.cluster.rounds{k}": "ccl.py:217" for k in P1_ROUNDS},
    **{f"label_components.cluster.rounds{k}": "ccl.py:200" for k in P1_K5_ROUNDS},
}


def _probe_frames(dev):
    """The probes' inputs on the card: P1's 20 and P2's 32 rendered 640x480
    frames (SimParams(duration=2.0 and 4.0, seed=0), fx = fy = 600) as
    float32, as the probes cast them; HD_CHUNK rendered 1920x1080 frames
    (the threshold in the block body); P3's 1920x1080 frame of random bytes
    (default_rng(0)) as float32; a 640x480 frame of fractional values in
    [-0.99, 256) (the copies' contract)."""
    from aruco_slam_tpu_torch.ops.camera import CameraIntrinsics
    from aruco_slam_tpu_torch.sim import synthetic

    cam = CameraIntrinsics.create(600.0, 600.0, 320.0, 240.0)

    def rendered(duration, n):
        seq = synthetic.generate_sequence(synthetic.SimParams(duration=duration, seed=0),
                                          level="images", camera=cam, device=dev)
        return torch.as_tensor(np.asarray(seq.images[:n]), device=dev).float().contiguous()

    rand = np.random.default_rng(0).integers(0, 256, (1080, 1920)).astype(np.uint8)
    frac = np.random.default_rng(7).uniform(-0.99, 256.0, (1, 480, 640)).astype(np.float32)
    return {"p1": rendered(2.0, 20), "p2": rendered(4.0, 32),
            "hd": _render_hd(HD_CHUNK, dev).float().contiguous(),
            "p3": torch.as_tensor(rand, device=dev)[None].float().contiguous(),
            "frac": torch.as_tensor(frac, device=dev)}


class ProbeStep(NamedTuple):
    """One kernel call at its probe's shape: the call and its plain version,
    the launch counts and the key the call adds one to, the kernel's name
    in the profiler, the frames it reads, and its work: every input byte
    read once and every output byte written once, the operations it does."""

    call: Callable
    plain: Callable
    counts: dict
    key: str
    part: str
    img: torch.Tensor
    n_bytes: int
    n_ops: int


def _probe_step(op, call, plain, img, rounds=0):
    """The ProbeStep of ``op`` ("copy", "scale", "threshold", "k4" or
    "k5") on ``img``: float32 in; int32 out for the copy and the threshold,
    float32 for the scale, a bool mask and int32 labels for K4, int32
    labels of a bool mask for K5; one operation an element for the copies,
    CCL_THRESHOLD_OPS for the threshold and CCL_ROUND_OPS a round."""
    from aruco_slam_tpu_torch.ops.kernels import ccl, probes

    px = img.numel()
    if op in ("copy", "scale"):
        return ProbeStep(call, plain, probes.LAUNCHES, f"probe_{op}", "probe_kernel", img,
                         8 * px, px)
    kind = ccl.body(*img.shape[1:], None if op == "k5" else PROBE_STRIDE)
    key, n_bytes, n_ops = {
        "threshold": ("threshold_only", 8 * px, CCL_THRESHOLD_OPS * px),
        "k4": ("threshold_label", 9 * px, (CCL_THRESHOLD_OPS + rounds * CCL_ROUND_OPS) * px),
        "k5": ("label_components", 5 * px, rounds * CCL_ROUND_OPS * px),
    }[op]
    return ProbeStep(call, plain, ccl.LAUNCHES, f"{key}.{kind}", "ccl_", img, n_bytes, n_ops)


def _rounds_steps(img, with_k5):
    """P1's rounds sweep on ``img``: K4 at P1_ROUNDS and, ``with_k5``, K5
    on the threshold's mask at P1_K5_ROUNDS, by row."""
    from aruco_slam_tpu_torch.ops.kernels import ccl

    r, C, s = PROBE_RADIUS, PROBE_C, PROBE_STRIDE
    kind = ccl.body(*img.shape[1:], s)
    steps = {f"threshold_label.{kind}.rounds{k}": _probe_step(
        "k4", lambda k=k: ccl.threshold_label(img, r, C, s, k),
        lambda k=k: ccl.threshold_label_reference(img, r, C, s, k), img, k) for k in P1_ROUNDS}
    if with_k5:
        fg = ccl.threshold_only_reference(img, r, C, s).bool()
        steps.update({f"label_components.{kind}.rounds{k}": _probe_step(
            "k5", lambda k=k: ccl.label_components(fg, k),
            lambda k=k: ccl.label_components_reference(fg, k), fg, k) for k in P1_K5_ROUNDS})
    return steps


def _probe_steps(frames, spilled):
    """The probes' path, one kernel call each at its probe's shape, by row:
    the copy and the threshold alone on P1's frames, P1's rounds sweep on
    them, the scale on P2's, the threshold alone on HD_CHUNK 1920x1080
    frames, and K4 on P3's frame in the planner's plan and in ``spilled``."""
    from aruco_slam_tpu_torch.ops.kernels import ccl, probes

    r, C, s, n = PROBE_RADIUS, PROBE_C, PROBE_STRIDE, P3_ROUNDS
    p1, p2, hd, p3 = frames["p1"], frames["p2"], frames["hd"], frames["p3"]
    return {
        "probe_copy": _probe_step("copy", lambda: probes.copy_to_int32(p1),
                                  lambda: probes.copy_to_int32_reference(p1), p1),
        "probe_scale": _probe_step("scale", lambda: probes.scale_copy(p2),
                                   lambda: probes.scale_copy_reference(p2), p2),
        "threshold_only.cluster": _probe_step("threshold", lambda: ccl.threshold_only(p1, r, C, s),
                                              lambda: ccl.threshold_only_reference(p1, r, C, s),
                                              p1),
        **_rounds_steps(p1, with_k5=True),
        "threshold_only.block": _probe_step("threshold", lambda: ccl.threshold_only(hd, r, C, s),
                                            lambda: ccl.threshold_only_reference(hd, r, C, s), hd),
        "threshold_label.block.random": _probe_step(
            "k4", lambda: ccl.threshold_label(p3, r, C, s, n),
            lambda: ccl.threshold_label_reference(p3, r, C, s, n), p3, n),
        "threshold_label.block.spilled": _probe_step(
            "k4", lambda: ccl.threshold_label(p3, r, C, s, n, plan=spilled),
            lambda: ccl.threshold_label_reference(p3, r, C, s, n), p3, n),
    }


def _probe_check(name, step):
    """Runs the step's call and its plain version; raises unless every
    output is equal bit for bit. Returns the outputs and their max |diff|."""
    got, want = step.call(), step.plain()
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    for a, b in zip(got, want):
        _require(a.dtype == b.dtype and torch.equal(a, b),
                 f"{name} differs from its plain version")
    return got, max(_max_err(a.to(torch.float64), b.to(torch.float64))
                    for a, b in zip(got, want))


def _probe_ms(step, pads=PROFILE_PADS_S):
    """(device ms a launch, how): ``_kernel_ms`` over 20 launches, by
    torch.profiler or, where it saw no event of the kernel, CUDA events."""
    ms, events = _kernel_ms(step.call, step.part, pads=pads)
    return ms, "profiler" if events is not None else "CUDA events"


def _probe_rate(n_bytes, ms):
    """The bytes, the achieved GB/s and its share of 3.35 TB/s, as text."""
    gbps = n_bytes / ms / 1e6
    return (f"{n_bytes / 1e6:.2f} MB at {gbps:.1f} GB/s "
            f"({gbps * 1e9 / HBM_BYTES_PER_S:.1%} of 3.35 TB/s)")


def _probe_split(ms, kind, copy="probe_copy"):
    """K4's time on P1's frames in ``kind``'s body, split: the copy, the
    threshold over it, the first round, and a later round (1 to 8)."""
    thr = ms[f"threshold_only.{kind}"]
    k4 = [ms[f"threshold_label.{kind}.rounds{k}"] for k in P1_ROUNDS]
    per = (k4[-1] - k4[0]) / (P1_ROUNDS[-1] - P1_ROUNDS[0])
    split = {"copy": ms[copy], "threshold_over_copy": thr - ms[copy],
             "first_round": k4[0] - thr, "per_round_1_to_8": per}
    return split, (f"K4 ({kind} body) = copy {ms[copy]:.4f} + threshold {thr - ms[copy]:.4f} "
                   f"+ first round {k4[0] - thr:.4f} + {per:.4f} ms a later round")


def phase4b_probes(dev):
    """The probes P1-P3 on their kernels: the path (each kernel once at its
    probe's shape, the counts set to 0 just before each call and read just
    after), each result against its plain version bit for bit, the copies
    also on a frame of fractional values, K4's two plans against each other;
    then each kernel timed (device ms by the profiler, the call through the
    wrapper and the plain version by CUDA events, the one PyTorch call that
    computes a copy as its library time) beside its bound and achieved
    GB/s, and K4's time on P1's frames split by stage. Returns per row
    (launches, max err, ms, plain ms, bound, library ms, wrapper ms)."""
    from aruco_slam_tpu_torch.ops.kernels import ccl, probes

    frames = _probe_frames(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    spilled = ccl.spilled_plan(1080, 1920, sms)
    resident = ccl.block_plan(1080, 1920, 1, sms)
    _require(not resident.spilled, f"1920x1080 took a spilled plan: {resident}")
    _require(spilled.ctas <= spilled.tiles_x * spilled.tiles_y,
             f"a CTA of the spilled plan has no tile: {spilled}")
    steps = _probe_steps(frames, spilled)
    launches = {}
    for name, step in steps.items():
        for c in (probes.LAUNCHES, ccl.LAUNCHES):
            for k in c:
                c[k] = 0
        step.call()
        torch.cuda.synchronize()
        launches[name] = step.counts[step.key]
    _require(all(v == 1 for v in launches.values()), f"probe path launches {launches}")
    print(f"phase 4b: launches in the probes' path: {launches}")

    outs, err = {}, {}
    for name, step in steps.items():
        outs[name], err[name] = _probe_check(name, step)
    frac = frames["frac"]
    for kern, plain, name in ((probes.copy_to_int32, probes.copy_to_int32_reference, "probe_copy"),
                              (probes.scale_copy, probes.scale_copy_reference, "probe_scale")):
        _require(torch.equal(kern(frac), plain(frac)),
                 f"{name} differs from its plain version on fractional values")
    for a, b in zip(outs["threshold_label.block.random"], outs["threshold_label.block.spilled"]):
        _require(torch.equal(a, b), "K4's resident and spilled plans differ")
    dens = float(outs["threshold_label.block.random"][0].float().mean())
    print(f"phase 4b: every probe row bit-identical to its plain version (P1's 20 640x480 "
          f"frames: the copy, the threshold alone, K4 at rounds {P1_ROUNDS}, K5 at rounds "
          f"{P1_K5_ROUNDS}; P2's 32: the scale; {HD_CHUNK} frames 1920x1080: the threshold "
          f"alone in the block body), the copies also on fractional values; K4 on P3's random "
          f"1920x1080 frame (foreground {dens:.3f}) in the resident plan ({resident.tiles_y} "
          f"tiles of {resident.tile_rows} rows on {resident.ctas} SMs) and the spilled plan "
          f"({spilled.tiles_y} tiles of {spilled.tile_rows} rows, {spilled.ctas} CTAs)")

    library = {"probe_copy": lambda: frames["p1"].to(torch.int32),
               "probe_scale": lambda: frames["p2"] * 1.0000001}
    # One profiler window a row: the time a launch over the events it kept.
    # Here most windows keep 11-13 of 20 events, and the wider windows'
    # retries took 40 s of the phase.
    pads = PROFILE_PADS_S[:1]
    out, dev_ms = {}, {}
    for name, step in steps.items():
        ms, how = _probe_ms(step, pads)
        dev_ms[name] = ms
        wrap_ms = _cuda_time(step.call, 10)
        plain_ms = _cuda_time(step.plain, 2)
        lib_ms = _kernel_ms(library[name], "", pads=pads)[0] if name in library else None
        bound = _bound(step.n_bytes, step.n_ops)
        out[name] = (launches[name], err[name], ms, plain_ms, bound, lib_ms, wrap_ms)
        lib = f", library {lib_ms:.4f} ms" if lib_ms is not None else ""
        print(f"phase 4b: {name} {ms:.4f} ms/launch on the device ({how}; "
              f"{tuple(step.img.shape)}), {_probe_rate(step.n_bytes, ms)}, bound "
              f"{bound[0]:.5f} ms ({bound[1]}); wrapper {wrap_ms:.4f} ms/call, plain "
              f"{plain_ms:.4f} ms/call{lib}")
    print(f"phase 4b: P1's 20 frames: {_probe_split(dev_ms, 'cluster')[1]}")
    res, spl = dev_ms["threshold_label.block.random"], dev_ms["threshold_label.block.spilled"]
    print(f"phase 4b: P3's two plans: resident {res:.4f} ms, spilled {spl:.4f} ms "
          f"({spl / res:.2f}x)")
    return out


# The frames that take the block body's spilled plan (their tiles cannot
# all be resident on the card's SMs at once) at the detector's own route: a
# 4K camera's (SPILL_FRAMES rendered 3840x2160 frames a detector call; a 12
# MP camera's 4000x3000 likewise) and, K5 alone, one 7680x4320 random mask
# (default_rng(8), foreground 0.6) at DetectorConfig().ccl_rounds.
SPILL_FRAMES = 4
UHD, UHD8 = (2160, 3840), (4320, 7680)
# the CCL entry points' TPU kernels: aruco_slam_tpu/ops/kernels/ccl.py lines
CCL_LINES = {"threshold_label_union": 229, "threshold_label": 217, "label_components": 200,
             "label_components_seeded": 207}
SPILL_ROWS = {  # row of the kernels line: its entry point
    "threshold_label_union.block.2160p": "threshold_label_union",
    "threshold_label.block.2160p": "threshold_label",
    "label_components.block.2160p": "label_components",
    "label_components_seeded.block.2160p": "label_components_seeded",
    "label_components.block.4320p": "label_components",
}


def phase4c_spilled(dev):
    """The block body's spilled plan on users' frames: the plans (every CTA
    of the team with a tile); the path (the counts set to 0 just before and
    read just after): runner.detect_frames on SPILL_FRAMES 3840x2160 frames
    in the detector's three branches (K3; K4; K5 and K5s), then K5 on the
    8K mask, each detection equal to the plain detector's; each row bit for
    bit against its plain version and timed as phase 4b's rows (device ms
    by the profiler, the wrapper and the plain version by CUDA events)
    beside its bound; detect_frames' ms a frame at 3840x2160. Returns per
    row (launches, max err, ms, plain ms, bound, wrapper ms)."""
    import dataclasses

    from aruco_slam_tpu_torch import runner
    from aruco_slam_tpu_torch.ops.detector import DetectorConfig
    from aruco_slam_tpu_torch.ops.kernels import ccl

    cfg = DetectorConfig()
    r, C, s, r1, r2 = cfg.adaptive_radius, cfg.adaptive_C, cfg.mean_stride, cfg.ccl_rounds, \
        cfg.closed_ccl_rounds
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for h, w in (UHD, UHD8):
        plan = ccl.block_plan(h, w, 1, sms)
        tiles = plan.tiles_x * plan.tiles_y
        _require(plan.spilled and plan == ccl.spilled_plan(h, w, sms)
                 and plan.ctas <= min(tiles, sms), f"{w}x{h}: plan {plan}")
        print(f"phase 4c: {w}x{h} spills: {tiles} tiles of {plan.tile_rows}x{plan.tile_width} "
              f"on a team of {plan.ctas} CTAs, {-(-tiles // plan.ctas)} or fewer each; "
              f"workspaces {4 * plan.work_words / 1e6:.1f} MB in device memory")
    img = _render_hd(SPILL_FRAMES, dev, *UHD)
    mask8 = torch.as_tensor(np.random.default_rng(8).random((1, *UHD8)) < 0.6, device=dev)

    branches = {"K3": (cfg, {"threshold_label_union.block": 1}),
                "closing_union=False": (dataclasses.replace(cfg, closing_union=False),
                                        {"threshold_label.block": 1}),
                "mean_stride=3": (dataclasses.replace(cfg, mean_stride=3),
                                  {"label_components.block": 1,
                                   "label_components_seeded.block": 1})}
    for bcfg, _ in branches.values():
        runner.detect_frames(img, bcfg, SPILL_FRAMES)  # warm: the plans
    ccl.label_components(mask8, r1)
    torch.cuda.synchronize()
    for k in ccl.LAUNCHES:
        ccl.LAUNCHES[k] = 0
    dets = {what: runner.detect_frames(img, bcfg, SPILL_FRAMES)
            for what, (bcfg, _) in branches.items()}
    torch.cuda.synchronize()
    uhd_launches = {k: v for k, v in ccl.LAUNCHES.items() if v}
    for k in ccl.LAUNCHES:
        ccl.LAUNCHES[k] = 0
    ccl.label_components(mask8, r1)
    torch.cuda.synchronize()
    uhd8_launches = {k: v for k, v in ccl.LAUNCHES.items() if v}
    want = {k: v for _, e in branches.values() for k, v in e.items()}
    _require(uhd_launches == want and uhd8_launches == {"label_components.block": 1},
             f"spilled path launches {uhd_launches}, {uhd8_launches}")
    print(f"phase 4c: launches in the spilled path: {SPILL_FRAMES} 3840x2160 frames "
          f"{uhd_launches}; the 7680x4320 mask {uhd8_launches}")
    for what, (bcfg, _) in branches.items():
        c_err = _check_detections(dets[what], runner.detect_frames(img, bcfg, SPILL_FRAMES,
                                                                   reference=True), what)
        n_det = int(dets[what][2].sum())
        _require(n_det > 0, f"3840x2160 {what}: no detection")
        print(f"phase 4c: 3840x2160 detection ({what}): {n_det} detections equal to the plain "
              f"detector (max |corner diff| {c_err:.3e} px)")
    t = [_timed(lambda: runner.detect_frames(img, cfg, SPILL_FRAMES)) for _ in range(3)]
    print(f"phase 4c: runner.detect_frames on {SPILL_FRAMES} 3840x2160 frames: "
          f"{1e3 * statistics.median(t) / SPILL_FRAMES:.4f} ms/frame (median of 3: "
          f"{', '.join(f'{x * 1e3:.3f}' for x in t)} ms a call)")

    fg, lab, fg_c, _ = ccl.threshold_label_union_reference(img, r, C, s, r1, r2)
    seed = lab.reshape(fg.shape)
    runs = {
        "threshold_label_union.block.2160p": (
            lambda: ccl.threshold_label_union(img, r, C, s, r1, r2),
            lambda: ccl.threshold_label_union_reference(img, r, C, s, r1, r2), img),
        "threshold_label.block.2160p": (lambda: ccl.threshold_label(img, r, C, s, r1),
                                        lambda: ccl.threshold_label_reference(img, r, C, s, r1),
                                        img),
        "label_components.block.2160p": (lambda: ccl.label_components(fg, r1),
                                         lambda: ccl.label_components_reference(fg, r1), fg),
        "label_components_seeded.block.2160p": (
            lambda: ccl.label_components(fg_c, r2, init=seed),
            lambda: ccl.label_components_reference(fg_c, r2, init=seed), fg_c),
        "label_components.block.4320p": (lambda: ccl.label_components(mask8, r1),
                                         lambda: ccl.label_components_reference(mask8, r1),
                                         mask8),
    }
    out = {}
    for key, (kern, plain, x) in runs.items():
        name = SPILL_ROWS[key]
        step = ProbeStep(kern, plain, ccl.LAUNCHES, f"{name}.block", "ccl_", x, 0, 0)
        _, err = _probe_check(key, step)
        ms, how = _probe_ms(step, PROFILE_PADS_S[:1])
        wrap_ms = _cuda_time(kern, 10)
        plain_ms = _cuda_time(plain, 2)
        n_bytes, n_ops = _ccl_work(name, r1, r2)
        bound = _bound(x.numel() * n_bytes, x.numel() * n_ops)
        n = (uhd8_launches if key.endswith("4320p") else uhd_launches)[f"{name}.block"]
        out[key] = (n, err, ms, plain_ms, bound, wrap_ms)
        print(f"phase 4c: {key} {ms:.4f} ms/launch on the device ({how}; {tuple(x.shape)}), "
              f"bound {bound[0]:.5f} ms ({bound[1]}); wrapper {wrap_ms:.4f} ms/call, plain "
              f"{plain_ms:.4f} ms/call")
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
    from aruco_slam_tpu_torch.utils import logging as slog
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
    _reset_counts(pk, kb)
    out = runner.replay_batch(data, cfg, cam, "images", det_cfg, IMG_CHUNK)
    torch.cuda.synchronize()
    launches = {**ccl.LAUNCHES, **_counts(pk, kb)}
    print(f"phase 5: launches in one {IMG_B}x{n_frames} image-level replay: {launches}")
    chunks = -(-total // IMG_CHUNK)
    _require(launches == {**dict.fromkeys(ccl.LAUNCHES, 0), "threshold_label_union.cluster": chunks,
                          "pnp_frontend": n_frames, "ekf_frame_batched.smem": n_frames,
                          "ekf_frame_batched.cluster": 0, "ekf_frame_batched.device": 0},
             f"expected K3 (cluster body) x {chunks}, K1 and K2 x {n_frames}; got {launches}")

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
    slog.RECORDER = rec = slog.Recorder()
    torch.cuda.synchronize()
    detector.detect_markers_batch(chunk, det_cfg)
    torch.cuda.synchronize()
    slog.RECORDER = None
    split = slog.stage_ms(rec.closed())
    print(f"phase 5: one {IMG_CHUNK}-frame chunk's detection by stage (ms): "
          + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
          + f"; total {sum(split.values()):.3f}")

    # the two other detector branches, each through the same entry point
    branches = {
        "closing_union=False": (dataclasses.replace(det_cfg, closing_union=False),
                                {"threshold_label.cluster": chunks}),
        "mean_stride=3": (dataclasses.replace(det_cfg, mean_stride=3),
                          {"label_components.cluster": chunks,
                           "label_components_seeded.cluster": chunks}),
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

    # the 1920x1080 detection path: the block body, in each branch
    hd = _render_hd(HD_CHUNK, dev)
    hd_branches = {
        "1920x1080": (det_cfg, {"threshold_label_union.block": 1}),
        "1920x1080 closing_union=False": (dataclasses.replace(det_cfg, closing_union=False),
                                          {"threshold_label.block": 1}),
        "1920x1080 mean_stride=3": (dataclasses.replace(det_cfg, mean_stride=3),
                                    {"label_components.block": 1,
                                     "label_components_seeded.block": 1}),
    }
    for what, (bcfg, expect) in hd_branches.items():
        runner.detect_frames(hd, bcfg, HD_CHUNK)  # warm
        torch.cuda.synchronize()
        for k in ccl.LAUNCHES:
            ccl.LAUNCHES[k] = 0
        t_hd = {}
        t = _timed(lambda: t_hd.update(det=runner.detect_frames(hd, bcfg, HD_CHUNK)))
        got = {k: v for k, v in ccl.LAUNCHES.items() if v}
        _require(got == expect, f"{what}: expected launches {expect}, got {got}")
        branch_launches.update(got)
        c_err = _check_detections(t_hd["det"], runner.detect_frames(hd, bcfg, HD_CHUNK,
                                                                    reference=True), what)
        n_hd = int(t_hd["det"][2].sum())
        _require(n_hd > 0, f"{what}: no detection in {HD_CHUNK} frames")
        print(f"phase 5: {what} detection of {HD_CHUNK} frames: launches {got}; {n_hd} "
              f"detections equal to the plain detector (max |corner diff| {c_err:.3e} px); "
              f"{1e3 * t / HD_CHUNK:.4f} ms/frame")
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


def _wide_frame(state, rng, m=WIDE_M, n_known=12, n_new=4):
    """m observation slots of one lane in a random arrival order whose ids
    repeat: n_known of its landmarks and n_new new markers, each many
    times (a known one near its expected measurement from the state's
    mean, a new one near one place; each copy moved by a few cm, so that
    their order matters), about a fifth invalid (some with a padding id);
    one is a known landmark at its slot's last record (a stationary-gate
    hit where the slot was seen last frame). A noise floor of 0.1 in R:
    measurements far from the expected ones, or a floor of 0.01, would
    make a chain of ~200 updates lose float32 digits in any order (mu to
    about 1e-3 against float64)."""
    from aruco_slam_tpu_torch.models import ekf

    dev = state.mu.device
    n_lm = int(state.n_landmarks[0])
    slots = state.slot_ids[0].cpu().numpy()
    mu = state.mu[0].double().cpu().numpy()
    known = rng.choice(n_lm, min(n_known, n_lm), replace=False)
    pool = np.concatenate([slots[known], 200_000 + rng.choice(100_000, n_new, replace=False)])
    lm = mu[3:].reshape(-1, 3)[known]
    dx, dy, c, s = lm[:, 0] - mu[0], lm[:, 1] - mu[1], np.cos(mu[2]), np.sin(mu[2])
    at = np.concatenate([np.stack([c * dx + s * dy, -s * dx + c * dy,
                                   (lm[:, 2] - mu[2] + np.pi) % (2 * np.pi) - np.pi], -1),
                         rng.uniform(0.3, 2.0, (n_new, 3))])
    pick = rng.integers(0, len(pool), m)
    ids = pool[pick].astype(np.int32)
    valid = rng.random(m) > 0.2
    ids[~valid & (rng.random(m) > 0.5)] = -1
    z = (at[pick] + rng.normal(size=(m, 3)) * 0.03).astype(np.float32)
    ids[0], valid[0] = slots[known[0]], True
    z[0] = state.last_obs[0, known[0]].cpu().numpy()
    Bn = (rng.normal(size=(m, 3, 3)) * 0.05).astype(np.float32)
    R = Bn @ np.transpose(Bn, (0, 2, 1)) + 0.1 * np.eye(3, dtype=np.float32)
    perm = rng.permutation(m)
    return ekf.FrameObservations(*(torch.as_tensor(x[perm], device=dev)[None]
                                   for x in (ids, z, R, valid)))


def _k6_timing(call):
    """(ms per call over 100 calls, the kernel alone in ms and the device
    events per call, both from torch.profiler over 20 calls) of a K6 call."""
    return (_cuda_time(call, 100), *_kernel_ms(call, "ekf_frame_update"))


# K6's frame step in phase 6: (max_landmarks, landmarks) with the case's 4
# new markers, so the active square is small (40 of 64, 100 of 128 and of
# 512 slots) or full (126 of 128 and 508 of 512: na = N), as the card tests
# (tests/test_torch_cuda.py: _K6_SQUARES); and the states it is timed on:
# config 2's late map at 128 and at 512 slots (100 landmarks) and a full
# 512-landmark map, every observation known.
K6_STEP_CASES = ((64, 40), (128, 100), (128, 126), (512, 100), (512, 508))
K6_STEP_TIMED = (("N195", 64, 40), ("N387", 128, 100), ("N1539_small", 512, 100),
                 ("N1539_full", 512, 512))
K6_STEP_FRAMES = 101  # distinct frames of the timed replay-path calls


def _k6_ticks(dev, rng, frames, ticks=10):
    """``frames`` frames of encoder ticks [frames, T], as strided views of one
    [frames, T, 2] tensor (the replay's layout)."""
    from aruco_slam_tpu_torch.models import ekf

    w = torch.as_tensor(rng.uniform(-1.0, 3.0, (frames, ticks, 2)).astype(np.float32),
                        device=dev)
    dt = torch.as_tensor(rng.uniform(0.005, 0.02, (frames, ticks)).astype(np.float32),
                         device=dev)
    return ekf.Control(w[..., 0], w[..., 1], dt)


def _k6_step_bound(state, frame, ticks, L):
    """The frame step's bound in place, from this run's inputs: the active
    square of sigma (na x na, na = 3 + 3 min(L, landmarks + new markers))
    and its mu read and written once, the bookkeeping, the observations and
    the ticks read once, the rows written; 6 na^2 operations per known
    observation, 30 na for the predict, COMPOSE_OPS_PER_TICK a tick."""
    from aruco_slam_tpu_torch.models import ekf

    slots = ekf.lookup_slots(state.slot_ids, frame.ids)
    known = int((frame.valid & (slots >= 0)).sum())
    new = int((frame.valid & (slots < 0)).sum())
    na = 3 + 3 * min(L, int(state.n_landmarks[0]) + new)
    M, T = frame.ids.shape[1], ticks.dt.shape[1]
    n_bytes = (2 * na * na + 2 * na) * 4 + 2 * L * (4 + 12 + 1) + M * 53 + 12 * T + 52
    return _bound(n_bytes, 6 * na * na * known + 30 * na + COMPOSE_OPS_PER_TICK * T), na


def _k6_frame_step_checks(dev):
    """K6's frame step against its plain version (K6_STEP_CASES at 0 and 10
    ticks, initialized and not: out of place, in place, and frame f of
    time-major arrays with the rows; the three frames through the replay's
    ``replay_step``, in place from its second frame on), one device event a
    call; returns the max error by variant."""
    from aruco_slam_tpu_torch.models import ekf
    from aruco_slam_tpu_torch.ops.kernels import ekf_update as k6
    from aruco_slam_tpu_torch.utils.config import EkfConfig, SlamConfig

    worst = {"cluster": 0.0, "grid": 0.0}
    for L, n_lm in K6_STEP_CASES:
        cfg = SlamConfig(ekf=EkfConfig(max_landmarks=L, max_observations_per_frame=M))
        kind = k6.variant(3 + 3 * L)[0]
        for ticks in (0, 10):
            for init in (True, False):
                rng = np.random.default_rng(L + n_lm + ticks)
                state = _k6_case(dev, cfg, n_lm, rng)
                state = state._replace(initialized=torch.full_like(state.initialized, init))
                frame = _k6_frame(state, rng, n_known=9, n_new=4)
                frames = ekf.FrameObservations(*(torch.cat([x] * 3) for x in frame))
                controls = _k6_ticks(dev, rng, 3, ticks)
                one = (frame, ekf.Control(*(x[1:2] for x in controls)))

                def rows():
                    return k6.Rows(torch.zeros(3, 3, device=dev),
                                   torch.zeros(3, 3, 3, device=dev),
                                   torch.zeros(3, dtype=torch.int32, device=dev), 1)

                ref_rows, got_rows = rows(), rows()
                ref = k6.frame_step_reference(state, frames, controls, cfg, rows=ref_rows)
                mine = ekf.EkfState(*(t.clone() for t in state))
                spare = ekf.init_state(cfg, 1, dev)._replace(mu=mine.mu, sigma=mine.sigma)
                outs = (k6.frame_step(state, *one, cfg),
                        k6.frame_step(mine, *one, cfg, out=spare),
                        k6.frame_step(state, frames, controls, cfg, rows=got_rows))
                torch.cuda.synchronize()
                what = f"K6 frame step (N {3 + 3 * L}, {n_lm} landmarks, {ticks} ticks, " \
                       f"initialized {init})"
                for out in outs:
                    for name in ("slot_ids", "n_landmarks", "seen_prev", "initialized",
                                 "diverged", "dropped"):
                        _require(torch.equal(getattr(out, name), getattr(ref, name)),
                                 f"{what}: {name} differs")
                    for name in ("mu", "sigma", "last_obs"):
                        a, r = getattr(out, name), getattr(ref, name)
                        _require(torch.allclose(a, r, atol=5e-5, rtol=5e-3),
                                 f"{what}: {name} differs by {_max_err(a, r):.3e}")
                        worst[kind] = max(worst[kind], _max_err(a, r))
                _require(torch.equal(got_rows.n_landmarks, ref_rows.n_landmarks)
                         and torch.allclose(got_rows.trajectory, ref_rows.trajectory, atol=5e-5,
                                            rtol=5e-3)
                         and torch.allclose(got_rows.pose_cov, ref_rows.pose_cov, atol=5e-5,
                                            rtol=5e-3), f"{what}: rows differ")
                # the replay's path: three frames, the last two in place, each
                # held against the plain step from the kernel's previous state
                plain_rows, rep_rows = rows(), rows()
                rep = k6.replay_step(state, frames, controls, cfg, rep_rows)
                prev = state
                for f in range(3):
                    plain_rows.f = f
                    plain = k6.frame_step_reference(prev, frames, controls, cfg,
                                                    rows=plain_rows)
                    got = rep(f)
                    torch.cuda.synchronize()
                    for name in ("slot_ids", "n_landmarks", "seen_prev", "initialized",
                                 "diverged", "dropped"):
                        _require(torch.equal(getattr(got, name), getattr(plain, name)),
                                 f"{what}, replay path frame {f}: {name} differs")
                    for name in ("mu", "sigma", "last_obs"):
                        a, r = getattr(got, name), getattr(plain, name)
                        _require(torch.allclose(a, r, atol=5e-5, rtol=5e-3),
                                 f"{what}, replay path frame {f}: {name} differs by "
                                 f"{_max_err(a, r):.3e}")
                        worst[kind] = max(worst[kind], _max_err(a, r))
                    prev = ekf.EkfState(*(t.clone() for t in got))  # the next frame overwrites
                for a, r in ((rep_rows.trajectory, plain_rows.trajectory),
                             (rep_rows.pose_cov, plain_rows.pose_cov)):
                    _require(torch.allclose(a, r, atol=5e-5, rtol=5e-3),
                             f"{what}, replay path: rows differ by {_max_err(a, r):.3e}")
                _require(torch.equal(rep_rows.n_landmarks, plain_rows.n_landmarks),
                         f"{what}, replay path: rows differ")
        # one device event a call, on the last case's inputs (20 calls: the
        # profiler drops the first events of a short window)
        _, events = _kernel_ms(lambda: k6.frame_step(state, *one, cfg), "ekf_frame_update")
        _require(events == 1, f"{what}: {events} device events per call, not one")
        print(f"phase 6: K6 frame step ({kind} variant) N={3 + 3 * L}, {n_lm} landmarks + 4 new, "
              f"0 and 10 ticks, initialized and not: equal to the plain version out of place, "
              f"in place, at frame f of time-major arrays (rows too) and over 3 frames of the "
              f"replay path; one device event a call")
    return worst


def _k6_frame_step_timing(dev):
    """K6's frame step timed on K6_STEP_TIMED's states, 10 ticks a frame,
    every observation known: the kernel alone in place (the main path's
    form; torch.profiler over 20 calls from the same inputs), the call
    through the replay path (``replay_step``; CUDA events over
    K6_STEP_FRAMES - 1 distinct time-major frames after the first)
    and the plain version; returns {tag: (kind, wrapper ms, plain ms,
    kernel ms, bound, na, frame update kernel ms)}."""
    from aruco_slam_tpu_torch.models import ekf
    from aruco_slam_tpu_torch.ops.kernels import ekf_update as k6
    from aruco_slam_tpu_torch.utils.config import EkfConfig, SlamConfig

    out = {}
    for tag, L, n_lm in K6_STEP_TIMED:
        cfg = SlamConfig(ekf=EkfConfig(max_landmarks=L, max_observations_per_frame=M))
        kind = k6.variant(3 + 3 * L)[0]
        rng = np.random.default_rng(n_lm)
        state = _k6_case(dev, cfg, n_lm, rng)
        per = [_k6_frame(state, rng, n_known=12, n_new=0) for _ in range(K6_STEP_FRAMES)]
        frames = ekf.FrameObservations(*(torch.cat(x) for x in zip(*per)))
        controls = _k6_ticks(dev, rng, K6_STEP_FRAMES)
        one = (per[0], ekf.Control(*(x[:1] for x in controls)))
        spare = ekf.init_state(cfg, 1, dev)._replace(mu=state.mu.clone(), sigma=state.sigma.clone())
        mine = state._replace(mu=spare.mu, sigma=spare.sigma)
        dev_ms, events = _kernel_ms(lambda: k6.frame_step(mine, *one, cfg, out=spare),
                                    "ekf_frame_update")
        _require(events == 1, f"K6 frame step {tag}: {events} device events per call, not one")
        upd_ms = _kernel_ms(lambda: k6.frame_update(state, per[0], cfg), "ekf_frame_update")[0]
        rows = k6.Rows(torch.zeros(K6_STEP_FRAMES, 3, device=dev),
                       torch.zeros(K6_STEP_FRAMES, 3, 3, device=dev),
                       torch.zeros(K6_STEP_FRAMES, dtype=torch.int32, device=dev))
        rep = k6.replay_step(state, frames, controls, cfg, rows)
        box = [0]

        def step():
            rep(box[0])
            box[0] += 1

        wrap_ms = _cuda_time(step, K6_STEP_FRAMES - 1)
        plain = _cuda_time(lambda: k6.frame_step_reference(state, *one, cfg), 5)
        bound, na = _k6_step_bound(state, per[0], one[1], L)
        out[tag] = (kind, wrap_ms, plain, dev_ms, bound, na, upd_ms)
        print(f"phase 6: K6 frame step {tag} ({kind} variant, N={3 + 3 * L}, na={na}, 12 known, "
              f"10 ticks): kernel alone {dev_ms:.4f} ms in place (the update alone out of place "
              f"{upd_ms:.4f}), {wrap_ms:.4f} ms/call through the replay path, plain "
              f"{plain:.4f} ms/call; bound {bound[0]:.5f} ms ({bound[1]})")
    return out


def phase6_k6(dev):
    """K6 against its plain version in both variants (the update alone,
    then the frame step); returns (max err by variant, {max_landmarks:
    (variant, wrapper ms, plain ms, kernel-alone ms, bound)} of the update,
    the frame step's timings)."""
    from aruco_slam_tpu_torch import runner
    from aruco_slam_tpu_torch.models import ekf
    from aruco_slam_tpu_torch.ops.kernels import ekf_update as k6
    from aruco_slam_tpu_torch.utils.config import CompatConfig, EkfConfig, SlamConfig

    top = k6.MAX_CLUSTER_LANDMARKS
    worst, timings, repeats = {"cluster": 0.0, "grid": 0.0}, {}, 0
    for L, n_lm in ((64, 40), (128, 100), (top, top - 60), (top + 1, top - 60), (512, 300),
                    (5, 3)):
        kind = k6.variant(3 + 3 * L)[0]
        _require(kind == ("cluster" if L <= top else "grid"), f"K6 at {L} landmarks: {kind}")
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
            worst[kind] = max(worst[kind], *err.values())
            print(f"phase 6: K6 ({kind} variant) max_landmarks={L} N={3 + 3 * L} "
                  f"reject={reject}: landmarks {int(state.n_landmarks[0])}, dropped "
                  f"{int(state.dropped[0])}, diverged {int(state.diverged[0])}; max |dmu| "
                  f"{err['mu']:.3e}, |dsigma| {err['sigma']:.3e}, |dlast_obs| "
                  f"{err['last_obs']:.3e}")
        if L == 5:
            _require(int(state.dropped[0]) > 0, "the 5-slot run never dropped an observation")
            continue
        frame = _k6_frame(state, rng)
        choice = k6.variant(3 + 3 * L)
        ms, dev_ms, events = _k6_timing(lambda: k6.frame_update(state, frame, cfg))
        _require(events == 1, f"K6 made {events} device events per call, not one")
        plain = _cuda_time(lambda: k6.frame_update_reference(state, frame, cfg), 5)
        slots = ekf.lookup_slots(state.slot_ids, frame.ids)
        known = int((frame.valid & (slots >= 0)).sum())
        bound = _ekf_bound(1, 3 + 3 * L, L, M, 6 * (3 + 3 * L) ** 2 * known)
        timings[L] = (kind, ms, plain, dev_ms, bound)
        print(f"phase 6: K6 max_landmarks={L} N={3 + 3 * L} {choice}: {ms:.4f} ms/call "
              f"through the wrapper, kernel alone "
              f"{dev_ms:.4f} ms (profiler), "
              f"{events:.2f} device events per call; plain {plain:.4f} ms/call; bound "
              f"{bound[0]:.5f} ms ({bound[1]}, {known} known)")
        if L in (64, 128):  # the cluster size, timed on the same frame
            for ctas in (2, 4, 8, 16):
                if k6.cluster_shared_bytes(3 + 3 * L, ctas) > k6.MAX_SHARED_BYTES:
                    continue
                t, d, _ = _k6_timing(lambda c=ctas: k6._launch(state, frame, cfg, ("cluster", c)))
                print(f"phase 6: K6 N={3 + 3 * L} at {ctas} CTAs a cluster: {t:.4f} ms/call, "
                      f"kernel alone {d:.4f} ms")
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
          f"(runner.update_batched) {k2_ms:.4f} ms/launch beside K6 {timings[64][1]:.4f}")
    for kind, err in _k6_frame_step_checks(dev).items():
        worst[kind] = max(worst[kind], err)
    wide = _k6_wide(dev)
    for kind, (err, _) in wide.items():
        worst[kind] = max(worst[kind], err)
    return worst, timings, _k6_frame_step_timing(dev), {k: ms for k, (_, ms) in wide.items()}


def _k6_wide(dev):
    """K6's frame step in each variant (K6_WIDE) on WIDE_FRAMES frames of
    WIDE_M observation slots through the replay's ``replay_step`` (in place
    from its second frame on), each frame held against the plain step from
    the kernel's previous state; the kernel alone timed in place on the
    first frame. Returns {variant: (max err, kernel ms)}."""
    from aruco_slam_tpu_torch.models import ekf
    from aruco_slam_tpu_torch.ops.kernels import ekf_update as k6
    from aruco_slam_tpu_torch.utils.config import EkfConfig, SlamConfig

    out = {}
    for L, n_lm in K6_WIDE:
        cfg = SlamConfig(ekf=EkfConfig(max_landmarks=L, max_observations_per_frame=WIDE_M))
        kind = k6.variant(3 + 3 * L)[0]
        rng = np.random.default_rng(WIDE_M + L)
        state = _k6_case(dev, cfg, n_lm, rng)
        controls = _k6_ticks(dev, rng, WIDE_FRAMES)
        per, ahead = [], state  # each frame made for the state it will meet (the plain chain)
        for f in range(WIDE_FRAMES):
            per.append(_wide_frame(ahead, rng))
            ahead = k6.frame_step_reference(ahead, per[-1],
                                            ekf.Control(*(x[f:f + 1] for x in controls)), cfg)
        frames = ekf.FrameObservations(*(torch.cat(x) for x in zip(*per)))

        def rows():
            return k6.Rows(torch.zeros(WIDE_FRAMES, 3, device=dev),
                           torch.zeros(WIDE_FRAMES, 3, 3, device=dev),
                           torch.zeros(WIDE_FRAMES, dtype=torch.int32, device=dev))

        got_rows, plain_rows = rows(), rows()
        before = k6.LAUNCHES[kind]
        rep = k6.replay_step(state, frames, controls, cfg, got_rows)
        prev, err, what = state, 0.0, f"K6 ({kind}, N {3 + 3 * L}, M {WIDE_M})"
        for f in range(WIDE_FRAMES):
            plain_rows.f = f
            plain = k6.frame_step_reference(prev, frames, controls, cfg, rows=plain_rows)
            got = rep(f)
            torch.cuda.synchronize()
            for name in ("slot_ids", "n_landmarks", "seen_prev", "initialized", "diverged",
                         "dropped"):
                _require(torch.equal(getattr(got, name), getattr(plain, name)),
                         f"{what} frame {f}: {name} differs")
            for name in ("mu", "sigma", "last_obs"):
                a, r = getattr(got, name), getattr(plain, name)
                _require(torch.allclose(a, r, atol=5e-5, rtol=5e-3),
                         f"{what} frame {f}: {name} differs by {_max_err(a, r):.3e}")
                err = max(err, _max_err(a, r))
            prev = ekf.EkfState(*(t.clone() for t in got))  # the next frame overwrites
        _require(k6.LAUNCHES[kind] - before == WIDE_FRAMES, f"{what}: launches")
        _require(torch.equal(got_rows.n_landmarks, plain_rows.n_landmarks)
                 and torch.allclose(got_rows.trajectory, plain_rows.trajectory, atol=5e-5,
                                    rtol=5e-3), f"{what}: rows differ")
        one = (per[0], ekf.Control(*(x[:1] for x in controls)))
        spare = ekf.init_state(cfg, 1, dev)._replace(mu=state.mu.clone(), sigma=state.sigma.clone())
        mine = state._replace(mu=spare.mu, sigma=spare.sigma)
        ms, _ = _kernel_ms(lambda: k6.frame_step(mine, *one, cfg, out=spare), "ekf_frame_update")
        plain_ms = _cuda_time(lambda: k6.frame_step_reference(state, *one, cfg), 2)
        bound, na = _k6_step_bound(state, per[0], one[1], L)
        # frames with no valid observation: the prologue (its O(M^2) rank
        # count), the predict and the bookkeeping alone, at WIDE_M and at M
        idle = {m: f._replace(valid=torch.zeros_like(f.valid))
                for m, f in ((WIDE_M, per[0]), (M, _k6_frame(state, rng)))}
        idle_ms = {m: _kernel_ms(lambda f=f: k6.frame_step(mine, f, one[1], cfg, out=spare),
                                 "ekf_frame_update", pads=PROFILE_PADS_S[:1])[0]
                   for m, f in idle.items()}
        out[kind] = (err, ms)
        print(f"phase 6: K6 frame step ({kind} variant) N={3 + 3 * L}, {n_lm} landmarks, "
              f"M={WIDE_M} (slots and order in device memory; {int(per[0].valid.sum())} valid "
              f"at the first frame, na={na}): {WIDE_FRAMES} frames through the replay path "
              f"equal to the plain step, max |err| {err:.3e}; kernel alone in place "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms/call, bound {bound[0]:.5f} ms "
              f"({bound[1]}); landmarks now {int(got.n_landmarks[0])}, dropped "
              f"{int(got.dropped[0])}; a frame with no valid observation (prologue, "
              f"predict, bookkeeping): {idle_ms[WIDE_M]:.4f} ms at M={WIDE_M}, "
              f"{idle_ms[M]:.4f} ms at M={M}")
    return out


def _config2():
    """BASELINE config 2 as benchmarks/run_all.py:77-89 builds it: the
    100-marker 20 x 16 m arena, a 210 s tour (2,100 frames at obs level),
    EkfConfig(max_landmarks=128, max_observations_per_frame=16)."""
    from aruco_slam_tpu_torch.sim import synthetic
    from aruco_slam_tpu_torch.utils.config import EkfConfig, SlamConfig

    cfg = SlamConfig(ekf=EkfConfig(max_landmarks=128, max_observations_per_frame=16))
    seq = synthetic.generate_sequence(
        synthetic.SimParams(duration=210.0, profile="tour", tour_width=20.0, tour_height=16.0,
                            tour_inset=1.6, encoder_noise=0.4, fov_deg=90.0,
                            max_view_angle_deg=85.0, seed=11),
        marker_map=synthetic.make_arena(n_markers=100, width=20.0, height=16.0),
    )
    return cfg, seq


# Windows of phase 7's profiles: seconds of idle time at each end, tried in
# turn (the widest of PROFILE_PADS_S, then wider still).
SINGLE_STREAM_PADS_S = (PROFILE_PADS_S[-1], 6.0)


def _profile_single_stream(what, replay, frames):
    """One single-stream replay of ``frames`` frames under torch.profiler:
    the device's busy share, device events and K6's ms a frame. Every frame
    launches K6 exactly once, so a window that holds fewer K6 events than
    frames lost some and runs again in a wider one; the widest must hold
    them all, and at most 2 device events a frame in all."""
    for pad in SINGLE_STREAM_PADS_S:
        with _profiled(pad) as prof:
            t0 = time.perf_counter()
            replay()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        busy, by_name = _device_busy(prof)
        n_dev = sum(c for c, _ in by_name.values())
        hits = [v for k, v in by_name.items() if "ekf_frame_update" in k]
        k6_n, k6_us = sum(c for c, _ in hits), sum(us for _, us in hits)
        if k6_n >= frames:
            break
        print(f"(profiler: {k6_n} K6 events of {frames} frames in a {pad} s window; again in "
              f"a wider one)")
    print(f"phase 7: profile of {what}: device busy {busy / 1e3:.3f} ms of {wall * 1e3:.3f} ms "
          f"wall ({100 * busy / 1e6 / wall:.1f}%), {n_dev / frames:.2f} device events per frame, "
          f"{k6_n} K6 events, K6 {k6_us / frames / 1e3:.4f} ms per frame")
    _require(k6_n == frames, f"{what}: {k6_n} K6 events in the profile of {frames} frames")
    _require(n_dev <= 2 * frames, f"{what}: {n_dev / frames:.2f} device events a frame: the "
             "frame step is not one launch a frame")


def phase7_single_stream(dev):
    """BASELINE config 2 through runner.replay_sequence (K6) against the
    plain replay; then the fused update against the same reference."""
    import dataclasses

    from aruco_slam_tpu_torch import runner
    from aruco_slam_tpu_torch.ops.kernels import ekf_update as k6
    from aruco_slam_tpu_torch.utils import metrics

    cfg, seq = _config2()
    F = seq.num_frames
    _require(F == 2100 and seq.max_obs == M, f"config 2 has {F} frames of {seq.max_obs}")
    torch.cuda.synchronize()
    for k in k6.LAUNCHES:
        k6.LAUNCHES[k] = 0
    out = runner.replay_sequence(seq, cfg, device=dev)
    torch.cuda.synchronize()
    launches = dict(k6.LAUNCHES)
    print(f"phase 7: K6 launches in one {F}-frame single-stream replay: {launches}")
    _require(launches == {"cluster": F, "grid": 0},
             f"expected {F} launches of K6's cluster variant, got {launches}")

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

    k6_s = _timed(lambda: runner.replay(data, cfg))
    print(f"phase 7: single-stream {F / k6_s:.1f} frames/s (one timed {F}-frame replay: "
          f"{k6_s:.3f} s); plain {F / plain_s:.1f} frames/s ({plain_s:.3f} s)")

    fused_cfg = dataclasses.replace(cfg, ekf=dataclasses.replace(cfg.ekf, fused_update=True))
    fused = {}
    f_s = _timed(lambda: fused.update(out=runner.replay(data, fused_cfg)))
    f_err, f_ate = agree(fused["out"], "fused path")
    print(f"phase 7: fused_update=True: trajectory max |fused - plain| {f_err:.3e}, ATE "
          f"{f_ate:.6f} m, {F / f_s:.1f} frames/s ({f_s:.3f} s)")

    head = data._replace(**{k: v[:200] for k, v in data._asdict().items() if v is not None})
    runner.replay(head, cfg)
    _profile_single_stream("200 frames", lambda: runner.replay(head, cfg), 200)

    # a map of 512 slots (N = 1,539): K6's grid variant on every frame
    big = dataclasses.replace(cfg, ekf=dataclasses.replace(cfg.ekf, max_landmarks=512))
    head = data._replace(**{k: v[:GRID_FRAMES] for k, v in data._asdict().items()
                            if v is not None})
    torch.cuda.synchronize()
    for k in k6.LAUNCHES:
        k6.LAUNCHES[k] = 0
    res = {}
    g_s = _timed(lambda: res.update(out=runner.replay(head, big)))
    grid_launches = dict(k6.LAUNCHES)
    _require(grid_launches == {"cluster": 0, "grid": GRID_FRAMES},
             f"expected {GRID_FRAMES} launches of K6's grid variant, got {grid_launches}")
    ref_big = runner.replay_reference(head, big)
    torch.cuda.synchronize()
    got = res["out"]
    _require(bool(torch.isfinite(got.trajectory).all()), "512 slots: non-finite trajectory")
    _require(torch.equal(got.n_landmarks, ref_big.n_landmarks), "512 slots: n_landmarks differ")
    _require(torch.equal(got.final_state.slot_ids, ref_big.final_state.slot_ids),
             "512 slots: slot_ids differ")
    g_err = _max_err(got.trajectory, ref_big.trajectory)
    _require(g_err <= TRAJ_TOL, f"512 slots: trajectory deviates from the plain path by {g_err}")
    g_s = _timed(lambda: runner.replay(head, big))  # the first call above made the grid's plan
    print(f"phase 7: max_landmarks=512, first {GRID_FRAMES} frames: launches {grid_launches}; "
          f"landmarks {int(got.n_landmarks[-1])} and slots equal to the plain replay, trajectory "
          f"max |K6 - plain| {g_err:.3e}; {GRID_FRAMES / g_s:.1f} frames/s ({g_s:.3f} s)")
    _profile_single_stream(f"the {GRID_FRAMES} frames at 512 slots",
                           lambda: runner.replay(head, big), GRID_FRAMES)
    return {"cluster": launches["cluster"], "grid": grid_launches["grid"]}


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
    for counts in (k6.LAUNCHES, ccl.LAUNCHES):
        for k in counts:
            counts[k] = 0
    lat_enc, lat_img = [], []
    dets = drive(kern, lat_enc, lat_img)
    launches = {**{f"ekf_frame_update.{k}": v for k, v in k6.LAUNCHES.items() if v},
                **{k: v for k, v in ccl.LAUNCHES.items() if v}}
    print(f"phase 8: launches over {F} add_image calls: {launches}")
    _require(launches == {"ekf_frame_update.cluster": F, "threshold_label_union.cluster": F},
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


# Phase 9's gates. Config 2 (tests/test_loop_closure.py:51-100): the map
# error after the solve is at most MAP_GAIN_TOL x the EKF-initialised error
# and below MAP_ERR_MAX. Configs 4 and 5 (tests/test_ba.py
# test_ba_converges_to_ground_truth): mean pose and landmark error below
# TRUTH_ERR_MAX, the landmarks taken over those with a factor (a landmark
# no keyframe observes keeps its initial value: 283 of config 4's 500 do).
# Card against the host CPU on config 4: CARD_CPU_TOL in m and rad.
MAP_GAIN_TOL = 1.05
MAP_ERR_MAX = 0.6
TRUTH_ERR_MAX = 0.03
CARD_CPU_TOL = 1e-3
# the JAX package's config-2 BA map error on a TPU v5e (BASELINE.md:44): an
# accuracy figure of the algorithm, printed beside the port's
JAX_CONFIG2_BA_MAP_ERR = 0.131


def _map_err(lms, ids, seq):
    """Mean planar distance of landmarks [L, 3] (ids [L]) to the truth."""
    true = {int(i): seq.true_landmarks[k] for k, i in enumerate(seq.true_landmark_ids)}
    return float(np.mean([np.linalg.norm(lms[s, :2] - true[int(a)][:2])
                          for s, a in enumerate(ids)]))


@contextlib.contextmanager
def _spied(module, name, log):
    """``module.name`` wrapped while the block runs: each call appends
    (seconds by CUDA events after a synchronize, args, kwargs, result)."""
    real = getattr(module, name)

    def wrapped(*a, **k):
        out = {}
        sec = _timed(lambda: out.update(r=real(*a, **k)))
        log.append((sec, a, k, out["r"]))
        return out["r"]

    setattr(module, name, wrapped)
    try:
        yield
    finally:
        setattr(module, name, real)


def _solve_profile(problem, kw, gn=2):
    """(device-busy share, device events per GN iteration) of a ``gn``-GN
    solve of ``problem`` with the solver options ``kw``: the same shapes and
    per-iteration work as the full solve, in a window the profiler keeps."""
    from aruco_slam_tpu_torch.models import ba

    kw = {**kw, "iters": gn}
    ba.solve(problem, **kw)
    with _profiled(PROFILE_PADS_S[-1]) as prof:
        t0 = time.perf_counter()
        ba.solve(problem, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, by_name = _device_busy(prof)
    return busy / 1e6 / wall, sum(c for c, _ in by_name.values()) / gn


def _syncs(fn):
    """Host syncs that ``fn`` makes (torch's sync debug mode, warnings)."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def _truth_errors(poses, lms, problem, true_poses, true_lms):
    """(mean pose error m, mean |angle| error rad, mean landmark error m
    over the landmarks with a factor and over all, the landmarks with a
    factor)."""
    p, l = poses.cpu().numpy(), lms.cpu().numpy()
    seen = np.bincount(np.asarray(problem.obs_lm), minlength=len(true_lms)) > 0
    dth = np.arctan2(np.sin(p[:, 2] - true_poses[:, 2]), np.cos(p[:, 2] - true_poses[:, 2]))
    lerr = np.linalg.norm(l[:, :2] - true_lms[:, :2], axis=1)
    return (float(np.linalg.norm(p[:, :2] - true_poses[:, :2], axis=1).mean()),
            float(np.abs(dth).mean()), float(lerr[seen].mean()), float(lerr.mean()), int(seen.sum()))


def _pose_gap(a, b):
    """(max |xy| difference m, max |angle| difference rad) of two [K, 3]."""
    a, b = a.cpu().double(), b.cpu().double()
    dth = torch.atan2(torch.sin(a[:, 2] - b[:, 2]), torch.cos(a[:, 2] - b[:, 2]))
    return float((a[:, :2] - b[:, :2]).abs().max()), float(dth.abs().max())


def phase9_backend(dev):
    """The smoothing back-end: config 2 through pipeline.ekf_then_ba and
    ekf_then_pose_graph (the EKF pass through K6), then the solver alone on
    configs 4 and 5."""
    from aruco_slam_tpu_torch import convert, pipeline, runner
    from aruco_slam_tpu_torch.models import ba, ekf, graph_builder
    from aruco_slam_tpu_torch.ops.kernels import ekf_update as k6

    cfg, seq = _config2()
    F = seq.num_frames
    for name, run in (("ekf_then_ba", pipeline.ekf_then_ba),
                      ("ekf_then_pose_graph", pipeline.ekf_then_pose_graph)):
        for k in k6.LAUNCHES:
            k6.LAUNCHES[k] = 0
        replays, solves = [], []
        with _spied(runner, "replay", replays), _spied(ba, "solve", solves):
            out = run(seq, cfg, device=dev)
        launches = dict(k6.LAUNCHES)
        _require(launches == {"cluster": F, "grid": 0},
                 f"{name}: expected {F} launches of K6's cluster variant, got {launches}")
        _require(len(replays) == 1 and len(solves) == 1, f"{name}: {len(replays)} EKF passes, "
                 f"{len(solves)} solves")
        ekf_s, solve_s = replays[0][0], solves[0][0]
        problem, kw = solves[0][1][0], solves[0][2]
        stats = out["stats"]
        c0, c1 = float(stats.initial_cost), float(stats.final_cost)
        _require(bool(torch.isfinite(out["poses"]).all()), f"{name}: non-finite poses")
        _require(c1 < c0, f"{name}: final cost {c1} not below the initial {c0}")
        lms = out["landmarks"]
        after = _map_err(lms.cpu().numpy() if isinstance(lms, torch.Tensor) else lms,
                         out["landmark_ids"], seq)
        e_lms, e_ids, e_act = (t[0].cpu().numpy() for t in
                               ekf.get_map(out["ekf_result"].final_state, cfg))
        if name == "ekf_then_ba":  # the BA problem starts from the EKF map
            before = _map_err(out["problem"].landmarks, out["landmark_ids"], seq)
        else:
            before = _map_err(e_lms[e_act], e_ids[e_act], seq)
        _require(after <= MAP_GAIN_TOL * before and after < MAP_ERR_MAX,
                 f"{name}: map error {after} m after the solve, {before} m before")
        busy, per_gn = _solve_profile(problem, kw)
        extra = f", {out['n_closures']} closures" if "n_closures" in out else ""
        print(f"phase 9: {name} on config 2 (K = {problem.poses.shape[0]} keyframes, "
              f"{problem.landmarks.shape[0]} landmark rows, {problem.odo_i.shape[0]} odometry "
              f"factors{extra}; {kw['iters']} GN x {kw['cg_iters']} CG): EKF pass {ekf_s:.3f} s "
              f"({launches['cluster']} K6 launches), solve {solve_s:.3f} s, "
              f"{kw['iters'] / solve_s:.2f} GN/s")
        print(f"phase 9: {name}: cost {c0:.6g} -> {c1:.6g}; map error {before:.4f} m (EKF) -> "
              f"{after:.4f} m (the JAX package's BA on a TPU v5e: {JAX_CONFIG2_BA_MAP_ERR} m); "
              f"solve device busy {100 * busy:.1f}% with {per_gn:.0f} device events per GN "
              f"(profile of 2 GN)")

    for what, (n_kf, n_lm) in (("config 4", (1000, 500)), ("config 5", (10000, 5000))):
        prob_np, true_poses, true_lms = graph_builder.synthetic_ba_problem(
            n_kf, n_lm, obs_per_kf=8, seed=0)
        packed, static = ba.prepare(prob_np)
        kw = dict(iters=10, cg_iters=50, damping=1e-4, **static)
        problem = convert.ba_problem_from_numpy(packed, dev)
        runs = []
        for _ in range(2):
            res = {}
            sec = _timed(lambda: res.update(out=ba.solve(problem, **kw)))
            runs.append((sec, res["out"]))
        sec, (poses, lms, stats) = runs[1]
        gap = max(_max_err(runs[0][1][0], poses), _max_err(runs[0][1][1], lms))
        c0, c1 = float(stats.initial_cost), float(stats.final_cost)
        pe, ae, le, le_all, n_seen = _truth_errors(poses, lms, prob_np, true_poses, true_lms)
        _require(c1 < c0 and pe < TRUTH_ERR_MAX and le < TRUTH_ERR_MAX,
                 f"{what}: cost {c0} -> {c1}, pose error {pe} m, landmark error {le} m")
        print(f"phase 9: {what} ({n_kf} keyframes / {n_lm} landmarks, 8 observations a keyframe; "
              f"10 GN x 50 CG): {10 / sec:.2f} GN/s, {1e3 * sec / 10:.3f} ms per GN (the second "
              f"of 2 solves; the first {10 / runs[0][0]:.2f} GN/s); cost reduction {c0 / c1:.2f}x "
              f"({c0:.6g} -> {c1:.6g}); mean error to the truth: poses {pe:.5f} m / {ae:.5f} rad, "
              f"landmarks {le:.5f} m over the {n_seen} with a factor ({le_all:.5f} m over all "
              f"{n_lm}); run-to-run max |difference| {gap:.3e}")
        if what == "config 4":
            # the first solve under the debug mode counted one sync that the
            # later ones did not: the 2-GN and 10-GN solves are counted after it
            first, n2, n10 = (_syncs(lambda n=n: ba.solve(problem, **{**kw, "iters": n}))
                              for n in (2, 2, 10))
            _require(n2 == n10, f"host syncs: {n2} in a 2-GN solve, {n10} in a 10-GN one")
            cpu = ba.solve(convert.ba_problem_from_numpy(packed, "cpu"), **kw)
            dp, dth = _pose_gap(poses, cpu[0])
            dl, dlth = _pose_gap(lms, cpu[1])
            print(f"phase 9: config 4 card against the host CPU (float32): poses max |dxy| "
                  f"{dp:.3e} m, |dtheta| {dth:.3e} rad; landmarks {dl:.3e} m, {dlth:.3e} rad "
                  f"(tolerance {CARD_CPU_TOL}); host syncs in a solve: {n2} at 2 GN, {n10} at "
                  f"10 GN ({first} in the first solve under the debug mode)")
            _require(max(dp, dth, dl, dlth) <= CARD_CPU_TOL,
                     f"config 4: card and CPU solves differ by {(dp, dth, dl, dlth)}")


# Phase 10: the worlds (ranks, backend) on this card, and the gate on the
# distributed solve's cost history against the single-device solve's: the
# JAX package's bound for its sharded solve (tests/test_parallel.py:46-48).
WORLDS = ((1, "nccl"), (4, "gloo"))
# config 5's keyframes and landmarks (benchmarks/run_all.py:277-300)
CONFIG5 = (10000, 5000)
DIST_HISTORY_RTOL = 2e-2
# the demo's gate: phase 7's ATE gate for a single-stream replay
DEMO_ATE_MAX = 1.0


def _phase10_rank(rank, world, dev, sharded, seqs, cam, cfg, img_seqs):
    """One rank of phase 10: 10a's solve, 10b's replay and, with
    ``img_seqs``, 10c's detection; each after a warm-up call, timed by CUDA
    events after an all-reduce that lines the ranks up."""
    import torch.distributed as dist

    from aruco_slam_tpu_torch import runner
    from aruco_slam_tpu_torch.ops import detector
    from aruco_slam_tpu_torch.ops.kernels import _build
    from aruco_slam_tpu_torch.ops.kernels import ekf_update_batched as kb
    from aruco_slam_tpu_torch.ops.kernels import pnp_frontend as pk
    from aruco_slam_tpu_torch.parallel import dist_ba, mesh

    def lined_up(fn):
        mesh.all_reduce(torch.zeros(1, device=dev))
        for k in mesh.COUNTS:
            mesh.COUNTS[k] = 0
        res = {}
        sec = _timed(lambda: res.update(out=fn()))
        return res["out"], sec, dict(mesh.COUNTS)

    out = {}
    local = dist_ba.shard(sharded, rank, dev)
    kw = dict(iters=10, cg_iters=50, damping=1e-4)
    dist_ba.solve_dist(local, **{**kw, "iters": 1})
    (poses, lms, hist), out["ba_s"], out["ba_counts"] = lined_up(
        lambda: dist_ba.solve_dist(local, **kw))
    out["ba"] = (poses, lms, hist) if rank == 0 else None

    data = runner.build_batch_data(seqs, B, "corners", "cpu")
    runner.replay_sharded(data, cfg, cam, "corners", device=dev)
    _reset_counts(pk, kb)
    rep, out["replay_s"], _ = lined_up(
        lambda: runner.replay_sharded(data, cfg, cam, "corners", device=dev))
    out["replay_launches"] = _counts(pk, kb)
    if rank == 0:
        out["replay"] = (rep.trajectory, rep.n_landmarks, rep.final_state.slot_ids)

    if img_seqs is not None:
        from aruco_slam_tpu_torch.ops.kernels import ccl

        images = runner.build_batch_data(img_seqs, IMG_B, "images", dev).images
        det_cfg = detector.DetectorConfig()
        runner.detect_frames(images, det_cfg, IMG_CHUNK, group=dist.group.WORLD)
        for k in ccl.LAUNCHES:
            ccl.LAUNCHES[k] = 0
        det, out["detect_s"], _ = lined_up(
            lambda: runner.detect_frames(images, det_cfg, IMG_CHUNK, group=dist.group.WORLD))
        out["detect_launches"] = {k: v for k, v in ccl.LAUNCHES.items() if v}
        out["detect"] = det if rank == 0 else None
    out["built"] = sorted(_build.build_reports)  # kernels this rank compiled
    return out


def phase10_ranks(cfg, dev):
    """The multi-rank paths (distributed BA, sharded replay and detection)
    in two worlds on this card, .asq streaming, the demo and the dry run."""
    card = _card()
    print(f"phase 10: card {card}")
    _phase10_worlds(cfg, dev, WORLDS, card)
    _phase10_streams(dev, card)


def _phase10_worlds(cfg, dev, worlds, card):
    """10a-10c in each of ``worlds`` ((ranks, backend), ...)."""
    from aruco_slam_tpu_torch import convert, runner
    from aruco_slam_tpu_torch.models import ba, graph_builder
    from aruco_slam_tpu_torch.ops import detector
    from aruco_slam_tpu_torch.ops.camera import CameraIntrinsics
    from aruco_slam_tpu_torch.parallel import dist_ba, launch

    n_kf, n_lm = CONFIG5
    prob_np, true_poses, true_lms = graph_builder.synthetic_ba_problem(n_kf, n_lm, obs_per_kf=8,
                                                                       seed=0)
    kw = dict(iters=10, cg_iters=50, damping=1e-4)
    packed, static = ba.prepare(prob_np)
    single_problem = convert.ba_problem_from_numpy(packed, dev)
    ba.solve(single_problem, **kw, **static)
    single = {}
    single_s = _timed(lambda: single.update(out=ba.solve(single_problem, **kw, **static)))
    s_poses, s_lms, s_stats = single["out"]
    s_hist = s_stats.cost_history.cpu().numpy()

    seqs = _sequences(CameraIntrinsics.create(600.0, 600.0, 320.0, 240.0), range(8), 60.0)
    cam = seqs[0].camera()
    data = runner.build_batch_data(seqs, B, "corners", dev)
    ref = runner.replay_batch(data, cfg, cam, "corners")
    img_seqs = _image_sequences(dev)
    images = runner.build_batch_data(img_seqs, IMG_B, "images", dev).images
    det_cfg = detector.DetectorConfig()
    det_ref = runner.detect_frames(images, det_cfg, IMG_CHUNK)

    expect = kw["iters"] * (kw["cg_iters"] + 2) + 1
    for world, backend in worlds:
        sharded, lm_perm = dist_ba.partition_problem(prob_np, world)
        t0 = time.perf_counter()
        ranks = launch.run_ranks(_phase10_rank, world, backend, dev.type,
                                 args=(sharded, seqs, cam, cfg, img_seqs if world > 1 else None))
        wall = time.perf_counter() - t0
        cards = min(world, torch.cuda.device_count())
        what = (f"phase 10: world {world} over {backend} on {cards} card"
                f"{'s' if cards > 1 else ''} ({card})")
        built = [r["built"] for r in ranks if r["built"]]
        _require(not built, f"{what}: ranks compiled kernels: {built}")

        poses, lms, hist = ranks[0]["ba"]
        hist = hist.numpy()
        counts = [r["ba_counts"] for r in ranks]
        _require(all(c == {"all_reduce": expect, "all_gather": 1} for c in counts),
                 f"{what}: collectives per rank {counts}, expected {expect} all-reduces "
                 "and 1 all-gather")
        _require(hist[-1] < hist[0], f"{what}: cost {hist[0]} -> {hist[-1]}")
        h_gap = float(np.max(np.abs(hist / s_hist - 1)))
        _require(h_gap <= DIST_HISTORY_RTOL, f"{what}: cost history differs from the single "
                 f"device's by {h_gap} (rtol {DIST_HISTORY_RTOL})")
        lms_g = lms[torch.as_tensor(lm_perm)]
        pe, ae, le, _, _ = _truth_errors(poses, lms_g, prob_np, true_poses, true_lms)
        _require(pe < TRUTH_ERR_MAX and le < TRUTH_ERR_MAX,
                 f"{what}: pose error {pe} m, landmark error {le} m")
        p_gap, l_gap = _pose_gap(poses, s_poses), _pose_gap(lms_g, s_lms)
        ba_s = max(r["ba_s"] for r in ranks)
        print(f"{what}, 10a config 5 ({n_kf} / {n_lm}, 10 GN x 50 CG): "
              f"{kw['iters'] / ba_s:.2f} GN/s (slowest rank {ba_s:.3f} s; single device "
              f"{kw['iters'] / single_s:.2f} GN/s, {single_s:.3f} s); cost {hist[0]:.6g} -> "
              f"{hist[-1]:.6g} (single device {s_hist[0]:.6g} -> {s_hist[-1]:.6g}, largest "
              f"relative gap {h_gap:.3e}); gap to the single device: poses {p_gap[0]:.3e} m / "
              f"{p_gap[1]:.3e} rad, landmarks {l_gap[0]:.3e} m / {l_gap[1]:.3e} rad; truth "
              f"errors poses {pe:.5f} m / {ae:.5f} rad, landmarks {le:.5f} m; collectives per "
              f"rank {counts[0]} (iters x (cg + 2) + 1 = {expect})")

        traj, n_lms, slots = ranks[0]["replay"]
        _require(torch.equal(n_lms, ref.n_landmarks.cpu()), f"{what}: n_landmarks differ")
        _require(torch.equal(slots, ref.final_state.slot_ids.cpu()), f"{what}: slots differ")
        t_gap = _max_err(traj, ref.trajectory.cpu())
        _require(t_gap <= TRAJ_TOL, f"{what}: trajectory differs by {t_gap}")
        launches = [r["replay_launches"] for r in ranks]
        want = {"pnp_frontend": F, "ekf_frame_batched.smem": F,
                "ekf_frame_batched.cluster": 0, "ekf_frame_batched.device": 0}
        _require(all(c == want for c in launches), f"{what}: launches per rank {launches}")
        rep_s = max(r["replay_s"] for r in ranks)
        print(f"{what}, 10b sharded replay ({B} lanes x {F} frames, {B // world} a rank): "
              f"{B * F / rep_s:.1f} frames/s (slowest rank {rep_s:.3f} s); K1 and K2 launches "
              f"per rank per frame {launches[0]['pnp_frontend'] / F:.0f} and "
              f"{launches[0]['ekf_frame_batched.smem'] / F:.0f}; n_landmarks and slots equal to "
              f"the single process's, trajectory max |difference| {t_gap:.3e}")

        if world > 1:
            det = ranks[0]["detect"]
            _require(all(torch.equal(a, b.cpu()) for a, b in zip(det, det_ref)),
                     f"{what}: sharded detections differ from the unsharded call's")
            det_s = max(r["detect_s"] for r in ranks)
            print(f"{what}, 10c sharded detection of {images.shape[0] * images.shape[1]} "
                  f"frames: bit-identical to the unsharded call ({int(det[2].sum())} "
                  f"detections); {1e3 * det_s / (images.shape[0] * images.shape[1]):.4f} ms a "
                  f"frame (slowest rank); CCL launches per rank "
                  f"{[r['detect_launches'] for r in ranks]}")
        print(f"{what}: {wall:.1f} s with the ranks' start")


def _phase10_streams(dev, card):
    """10d (.asq) and 10e (the demo, the dry run) in this process."""
    import tempfile

    from aruco_slam_tpu_torch import demo, runner
    from aruco_slam_tpu_torch.io.sequence import Sequence
    from aruco_slam_tpu_torch.ops import detector
    from aruco_slam_tpu_torch.ops.kernels import ccl
    from aruco_slam_tpu_torch.ops.kernels import ekf_update as k6
    from aruco_slam_tpu_torch.parallel import dryrun
    from aruco_slam_tpu_torch.utils.config import EkfConfig, SlamConfig

    def reset():
        for counts in (ccl.LAUNCHES, k6.LAUNCHES):
            for k in counts:
                counts[k] = 0

    def launched():
        return {k: v for k, v in {**ccl.LAUNCHES, **{f"ekf_frame_update.{k}": v for k, v in
                                                     k6.LAUNCHES.items()}}.items() if v}

    img_seqs = _image_sequences(dev)
    det_cfg = detector.DetectorConfig()
    cfg_img = SlamConfig(ekf=EkfConfig(max_landmarks=32, max_observations_per_frame=24))
    with tempfile.TemporaryDirectory() as tmp:
        for k, seq in enumerate(img_seqs):
            seq.save(f"{tmp}/npz{k}.npz")
            seq.save(f"{tmp}/asq{k}.npz", image_format="asq")
            s_npz, s_asq = Sequence.load(f"{tmp}/npz{k}.npz"), Sequence.load(f"{tmp}/asq{k}.npz")
            _require(s_asq.images is None and "images_asq_path" in s_asq.meta,
                     "the .asq sequence holds its frames")
            path = s_asq.meta["images_asq_path"]
            frames = torch.from_numpy(s_npz.images).to(dev)
            got, want = {}, {}
            t_asq = _timed(lambda: got.update(d=runner.detect_frames_asq(path, det_cfg,
                                                                         device=dev)))
            t_npz = _timed(lambda: want.update(d=runner.detect_frames(frames, det_cfg)))
            _require(all(torch.equal(a, b) for a, b in zip(got["d"], want["d"])),
                     f"sequence {k}: .asq detections differ from the npz sequence's")
            torch.cuda.synchronize()
            reset()
            r_asq = runner.replay_sequence(s_asq, cfg_img, level="images", device=dev)
            torch.cuda.synchronize()
            asq_launches = launched()
            r_npz = runner.replay_sequence(s_npz, cfg_img, level="images", device=dev)
            gap = _max_err(r_asq.trajectory, r_npz.trajectory)
            _require(torch.equal(r_asq.trajectory, r_npz.trajectory),
                     f"sequence {k}: .asq and npz trajectories differ by {gap}")
            n = s_npz.num_frames
            print(f"phase 10d ({card}): sequence {k} ({n} frames): .asq detections and "
                  f"trajectory equal to the npz sequence's ({int(got['d'][2].sum())} "
                  f"detections); detect_frames_asq {1e3 * t_asq / n:.4f} ms a frame, "
                  f"detect_frames {1e3 * t_npz / n:.4f} (both at chunk 16, the first call); "
                  f"launches in the .asq replay {asq_launches}")

        res = {}
        reset()
        demo_s = _timed(lambda: res.update(out=demo.main(f"{tmp}/demo", device=dev)))
        demo_launches = launched()
        m = res["out"]["metrics"]
        with open(res["out"]["map"]) as f:
            n_map = sum(1 for line in f if line.strip() and not line.startswith("#"))
        _require(n_map > 0 and m["ate"] < DEMO_ATE_MAX,
                 f"demo: {n_map} map lines, ATE {m['ate']} m")
        print(f"phase 10e ({card}): demo (30 s, ekf_then_ba) in {demo_s:.3f} s: ATE "
              f"{m['ate']:.5f} m, {m['n_landmarks']} landmarks, map {n_map} lines, BA cost "
              f"{res['out']['ba_cost'][0]:.6g} -> {res['out']['ba_cost'][1]:.6g}; launches "
              f"{demo_launches}")
    t0 = time.perf_counter()
    runs = dryrun.dryrun_multichip(1)
    _require(runs[0].device.type == "cuda" and runs[0].detections > 0,
             f"dryrun_multichip(1): {runs}")
    print(f"phase 10e: dryrun_multichip(1) on {runs[0].device}: {runs[0]}; "
          f"{time.perf_counter() - t0:.1f} s with the rank's start")


# Phase 11: the seconds the harness may take (about 18 s on an H100 with
# the process's start), and bench.py's keys.
BENCH_TIMEOUT_S = 300
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "image_level_frames_per_sec_per_chip"}
BENCH_REPLAYS = 4  # a warm replay and 3 timed ones in each leg
BENCH_IMG_CHUNK = 16  # runner.replay_batch's default detector chunk
IMG_FRAMES = 60  # frames of an image-level sequence: IMG_SECONDS at 10 Hz


def _bench_launches(lines, leg):
    """The launches the harness printed for the leg whose line starts with
    ``leg``."""
    line = next((ln for ln in lines if ln.startswith(leg)), None)
    _require(line is not None, f"cli bench printed no line {leg!r}")
    return json.loads(line.split(f"launches over {BENCH_REPLAYS} replays ", 1)[1])


def phase11_bench_entry(main_fps):
    """``python -m aruco_slam_tpu_torch.cli bench`` from the repository
    root, then ``parallel.dryrun.entry()`` on the card against its plain
    version."""
    from aruco_slam_tpu_torch.ops.kernels import ekf_update as k6
    from aruco_slam_tpu_torch.parallel import dryrun

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "aruco_slam_tpu_torch.cli", "bench"], cwd=ROOT,
                          capture_output=True, text=True, timeout=BENCH_TIMEOUT_S)
    bench_s = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    for line in lines[:-1] + proc.stderr.strip().splitlines()[-10:]:
        print(f"phase 11: | {line}")
    _require(proc.returncode == 0 and lines, f"cli bench exited {proc.returncode}: "
                                             f"{proc.stderr[-4000:]}")
    last = json.loads(lines[-1])
    _require(set(last) == BENCH_KEYS, f"cli bench's last line has keys {sorted(last)}")
    _require(last["value"] > 0, f"cli bench's value {last['value']}")
    img = last["image_level_frames_per_sec_per_chip"]
    _require(img is not None and img > 0, f"cli bench's image-level number {img}")
    _require(any(ln.startswith("bench: device cuda") for ln in lines[:-1]),
             "no line of cli bench names the cuda device")
    corner = _bench_launches(lines, "bench: corner level")
    want = {"pnp_frontend": BENCH_REPLAYS * F, "ekf_frame_batched.smem": BENCH_REPLAYS * F}
    _require(corner == want, f"corner-level leg: launches {corner}, expected {want}")
    image = _bench_launches(lines, "bench: image level")
    want = {"pnp_frontend": BENCH_REPLAYS * IMG_FRAMES,
            "ekf_frame_batched.smem": BENCH_REPLAYS * IMG_FRAMES,
            "threshold_label_union.cluster": BENCH_REPLAYS * -(-IMG_B * IMG_FRAMES
                                                               // BENCH_IMG_CHUNK)}
    _require(image == want, f"image-level leg: launches {image}, expected {want}")
    print(f"phase 11: cli bench in {bench_s:.1f} s with the process's start: {lines[-1]}; "
          f"phase 3's main path in this process {main_fps:.1f} frames/s")

    fn, args = dryrun.entry()
    _require(fn is k6.frame_step and args[0].mu.device.type == "cuda",
             f"entry(): {fn} on {args[0].mu.device}")
    plain = k6.frame_step_reference(*args)
    torch.cuda.synchronize()
    for k in k6.LAUNCHES:
        k6.LAUNCHES[k] = 0
    out = fn(*args)
    torch.cuda.synchronize()
    launches = dict(k6.LAUNCHES)
    _require(launches == {"cluster": 1, "grid": 0}, f"entry(): K6 launches {launches}")
    for name in ("slot_ids", "n_landmarks", "seen_prev", "initialized", "diverged", "dropped"):
        _require(torch.equal(getattr(out, name), getattr(plain, name)),
                 f"entry(): {name} differs from the plain version")
    err = 0.0
    for name in ("mu", "sigma", "last_obs"):
        a, r = getattr(out, name), getattr(plain, name)
        _require(torch.allclose(a, r, atol=5e-5, rtol=5e-3),
                 f"entry(): {name} differs by {_max_err(a, r):.3e}")
        err = max(err, _max_err(a, r))
    _require(int(out.n_landmarks[0]) == 4,
             f"entry(): {int(out.n_landmarks[0])} landmarks, not the frame's 4")
    print(f"phase 11: entry() on {args[0].mu.device}: K6 launches {launches}, max |kernel - plain| "
          f"{err:.3e} (atol 5e-5, rtol 5e-3), 4 landmarks")


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
    k1_err, (k1_ms, k1_plain, k1_wrap), k1_bound = phase(1, phase1_k1, cfg, dev)
    k2_stats = phase(2, phase2_k2, dev)
    launches, main_fps = phase(3, phase3_main_path, cfg, dev)
    c2_launches = phase("3b", phase3b_config2_batched, dev)
    ccl_stats = phase(4, phase4_ccl, dev)
    probe_stats = phase("4b", phase4b_probes, dev)
    spill_stats = phase("4c", phase4c_spilled, dev)
    img_launches = phase(5, phase5_image_path, dev)
    k6_err, _, k6_step, k6_wide = phase(6, phase6_k6, dev)
    k6_launches = phase(7, phase7_single_stream, dev)
    phase(8, phase8_system, dev)
    phase(9, phase9_backend, dev)
    phase(10, phase10_ranks, cfg, dev)
    phase(11, phase11_bench_entry, main_fps)
    print(f"all phases: {time.perf_counter() - t_start:.1f} s")

    def row(name, source, replaces, n, err, ms, plain_ms, bound, library_ms=None, **extra):
        # replaces: a file of the JAX package's kernels, or a path from the
        # repository's root. library_ms: the one PyTorch call that computes
        # the same function (the probes' copies); none computes the others.
        if "/" not in replaces:
            replaces = f"aruco_slam_tpu/ops/kernels/{replaces}"
        return {"name": name, "route": "cuda",
                "source": f"aruco_slam_tpu_torch/ops/kernels/csrc/{source}",
                "replaces": replaces, "launches": n,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
                "bound_by": bound[1], "library_ms": library_ms, **extra}

    # K1 and K2: ms is the device time per launch (the profiler), wrapper_ms
    # the host-bound time per call through the wrapper
    kernels = [
        row("pnp_frontend", "pnp_frontend.cu", "pnp_frontend.py:219",
            launches["pnp_frontend"], k1_err, k1_ms, k1_plain, k1_bound, wrapper_ms=k1_wrap),
    ]
    # K2's variants on their paths: smem in phase 3, cluster and device in 3b
    k2_launches = {"smem": launches["ekf_frame_batched.smem"], **c2_launches}
    # m300_ms: the kernel alone on frames of WIDE_M observation slots
    for kind in ("smem", "cluster", "device"):
        err, ms, plain_ms, bound, wrap_ms, wide_ms = k2_stats[kind]
        kernels.append(row(f"ekf_frame_batched.{kind}", "ekf_frame_batched.cu",
                           "ekf_update_batched.py:77", k2_launches[kind], err, ms, plain_ms,
                           bound, wrapper_ms=wrap_ms, m300_ms=wide_ms))
    for name, line in CCL_LINES.items():
        for kind in ("cluster", "block"):
            key = f"{name}.{kind}"
            err, ms, plain_ms, bound = ccl_stats[key]
            kernels.append(row(key, "ccl.cu", f"ccl.py:{line}", img_launches[key], err, ms,
                               plain_ms, bound))
    # the probes P1-P3 on their path (phase 4b): ms is the device time per
    # launch (the profiler), wrapper_ms the call through the wrapper
    for name, (n, err, ms, plain_ms, bound, lib_ms, wrap_ms) in probe_stats.items():
        source = "probes.cu" if name.startswith("probe_") else "ccl.cu"
        kernels.append(row(name, source, PROBE_REPLACES[name], n, err, ms, plain_ms, bound,
                           library_ms=lib_ms, wrapper_ms=wrap_ms))
    # the spilled plan on users' frames (phase 4c): ms is the device time per
    # launch (the profiler), wrapper_ms the call through the wrapper
    for key, (n, err, ms, plain_ms, bound, wrap_ms) in spill_stats.items():
        kernels.append(row(key, "ccl.cu", f"ccl.py:{CCL_LINES[SPILL_ROWS[key]]}", n, err, ms,
                           plain_ms, bound, wrapper_ms=wrap_ms))
    # K6's frame step at its paths' shapes: config 2's map at 128 slots (N =
    # 387, cluster) and at 512 (N = 1,539, grid; its full square beside it).
    # ms is the kernel alone in place (the profiler), wrapper_ms the call
    # through the replay path, update_ms the update alone (SlamSystem's
    # call) out of place, m300_ms the kernel alone in place on a frame of
    # WIDE_M slots; the bound counts the frame's active square (na).
    for kind, tag in (("cluster", "N387"), ("grid", "N1539_small")):
        _, wrap_ms, plain_ms, dev_ms, bound, na, upd_ms = k6_step[tag]
        extra = {}
        if kind == "grid":
            full = k6_step["N1539_full"]
            extra = {"full_square_ms": full[3], "full_square_bound_ms": full[4][0],
                     "full_square_wrapper_ms": full[1]}
        kernels.append(row(f"ekf_frame_update.{kind}", "ekf_frame_update.cu", "ekf_update.py:73",
                           k6_launches[kind], k6_err[kind], dev_ms, plain_ms, bound,
                           wrapper_ms=wrap_ms, update_ms=upd_ms, active_rows=na,
                           m300_ms=k6_wide[kind], **extra))
    idle = [k["name"] for k in kernels if not k["launches"]]
    _require(not idle, f"kernels the paths never launched: {idle}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
