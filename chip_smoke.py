#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU: builds the hand-written
CUDA kernels from this checkout, holds each against its plain PyTorch version
at the main path's shapes, then drives the main path — batched corner-level
replay, 256 lanes x 600 frames — through both kernels and checks it against
the plain path and the ground truth.

Run from the repository root:  python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero):
  0. the card: refuse without CUDA; print its name and power limit; build
     both kernels (nvcc, sm_90a) and print ptxas's register report.
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
     path's on every lane; the trajectory within TRAJ_TOL of it; frames/s.
The second-to-last line is a JSON object of the kernels; the last line is
{"ok": true, "device": {...}}.
"""

import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
DIST = (-0.28, 0.07, 1.2e-3, -8e-4, 0.018)  # tests/test_pallas_kernels.py:354
B, M, F = 256, 16, 600
# Trajectory agreement of the kernel path with the plain path over 600
# frames: both are float32 with sums taken in another order, and the EKF
# carries the differences forward; 1 mm / 1 mrad is far below the
# filter's own error against the ground truth.
TRAJ_TOL = 1e-3


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
    from aruco_slam_tpu_torch.ops.kernels import _build

    for name in ("pnp_frontend", "ekf_frame_batched"):
        _build.load(name)
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
    print(f"phase 1: K1 {timing[0]:.4f} ms/launch, plain {timing[1]:.4f} ms/call")
    return worst, timing


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
                timing = (ms, plain)
            state = out._replace(initialized=torch.ones_like(out.initialized))
        print(f"phase 2: K2 B={B} N={n_dim} M={M} frames 20-39: landmarks "
              f"{int(state.n_landmarks.min())}-{int(state.n_landmarks.max())}, "
              f"dropped {int(state.dropped.sum())}, max |err| {err:.3e}")
        worst = max(worst, err)
    _require(int(state.dropped.sum()) > 0, "the small-capacity run never dropped a landmark")
    print(f"phase 2: K2 {timing[0]:.4f} ms/launch, plain {timing[1]:.4f} ms/call")
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

    ref = runner.replay_batch_reference(data, cfg, cam, "corners")
    torch.cuda.synchronize()
    _require(bool(torch.isfinite(out.trajectory).all()), "non-finite trajectory")
    _require(torch.equal(out.n_landmarks, ref.n_landmarks), "n_landmarks differ from the plain path")
    _require(torch.equal(out.final_state.slot_ids, ref.final_state.slot_ids),
             "final slot_ids differ from the plain path")
    dev_max = _max_err(out.trajectory, ref.trajectory)
    print(f"phase 3: trajectory max |kernel - plain| = {dev_max:.3e} (tolerance {TRAJ_TOL})")
    _require(dev_max <= TRAJ_TOL, "trajectory deviates from the plain path")
    true = torch.as_tensor(seqs[0].true_pose_frames)
    ate_k = float(metrics.ate(out.trajectory[0].cpu(), true))
    ate_p = float(metrics.ate(ref.trajectory[0].cpu(), true))
    print(f"phase 3: lane 0 ATE vs ground truth: kernels {ate_k:.6f} m, plain {ate_p:.6f} m; "
          f"landmarks {int(out.n_landmarks[0, -1])}")
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
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    runner.replay_batch_reference(data, cfg, cam, "corners")
    end.record()
    torch.cuda.synchronize()
    plain_s = start.elapsed_time(end) / 1e3
    fps = B * F / statistics.median(times)
    print(f"phase 3: main path {fps:.1f} frames/s (median of 3: "
          f"{', '.join(f'{t:.3f}' for t in times)} s per {B}x{F} replay); "
          f"plain path {B * F / plain_s:.1f} frames/s ({plain_s:.3f} s)")
    return launches


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
    phase0_card()
    k1_err, (k1_ms, k1_plain) = phase1_k1(cfg, dev)
    k2_err, (k2_ms, k2_plain) = phase2_k2(cfg, dev)
    launches = phase3_main_path(cfg, dev)
    kernels = [
        {"name": "pnp_frontend", "route": "cuda",
         "source": "aruco_slam_tpu_torch/ops/kernels/csrc/pnp_frontend.cu",
         "replaces": "aruco_slam_tpu/ops/kernels/pnp_frontend.py:219",
         "launches": launches["pnp_frontend"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain},
        {"name": "ekf_frame_batched", "route": "cuda",
         "source": "aruco_slam_tpu_torch/ops/kernels/csrc/ekf_frame_batched.cu",
         "replaces": "aruco_slam_tpu/ops/kernels/ekf_update_batched.py:77",
         "launches": launches["ekf_frame_batched"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
