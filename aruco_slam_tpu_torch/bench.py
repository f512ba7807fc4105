"""Benchmark harness (L7) — counterpart of the root ``bench.py``, with the
same workload and the same last line, run on a torch device (None: the
card).

Headline: frames/s of the corner-level batched replay (``runner.replay_batch``:
K1 and K2 once a frame on the card) at B = 256 lanes over 8 distinct 60 s
sequences (F = 600), ``SlamConfig(ekf=EkfConfig(32, 16))``, the sequences'
own camera; B·F over the mean of 3 timed replays after a warm one.
``image_level_frames_per_sec_per_chip``: the image-level replay (rendered
640x480 frames -> detector -> PnP -> EKF; K3, K1, K2) of 2 sequences tiled
to 32 lanes at the runner's default detector chunk, the median of 3.

``vs_baseline`` divides the headline by the median of
:data:`REFERENCE_RUNS` runs of :func:`bench_reference_numpy` (the
single-thread float64 numpy EKF, with cv2's per-marker PnP where cv2 is
installed) over the same observation stream, measured in the same run on
this host. ``bench.py``'s pinned baseline was measured on another host and
is not used.

The last line of standard output is one JSON object with ``bench.py``'s
keys: ``metric``, ``value``, ``unit``, ``vs_baseline`` and
``image_level_frames_per_sec_per_chip``. The lines before it give the
device and its power limit, every timed replay's seconds, the kernel
launches of each leg, the reference's runs and whether cv2 was present.
Nothing is caught: a failed leg, build or launch raises.

Usage: python -m aruco_slam_tpu_torch.cli bench [--device DEVICE]
"""

from __future__ import annotations

import json
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from aruco_slam_tpu_torch import runner
from aruco_slam_tpu_torch.ops.camera import CameraIntrinsics
from aruco_slam_tpu_torch.ops.kernels import ccl, ekf_update_batched, pnp_frontend
from aruco_slam_tpu_torch.sim import synthetic
from aruco_slam_tpu_torch.utils.config import EkfConfig, SlamConfig
from aruco_slam_tpu_torch.utils.device import resolve
from aruco_slam_tpu_torch.utils.reference_ekf import ReferenceEKF

# Runs of the numpy reference that vs_baseline takes the median of: a
# host-clock rate on a shared host moves between runs.
REFERENCE_RUNS = 5
# max/min of the timed runs above which a leg warns on stderr
SPREAD_WARN = 1.5


def _sync(device: torch.device) -> None:
    """Wait for the device's work: a replay returns before the card ends."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(replay, device: torch.device, reps: int):
    """One warm call of ``replay``, then ``reps`` timed on the host clock,
    each ended by a synchronize: (the last output, each call's seconds)."""
    out = replay()
    _sync(device)
    seconds = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = replay()
        _sync(device)
        seconds.append(time.perf_counter() - t0)
    return out, seconds


def _warn_spread(what: str, seconds) -> None:
    if max(seconds) > SPREAD_WARN * min(seconds):
        print(f"WARNING: {what} spread {min(seconds):.4f}-{max(seconds):.4f}", file=sys.stderr)


def _launches() -> dict:
    """The kernel wrappers' launch counts (they count on the card only)."""
    return {"pnp_frontend": pnp_frontend.LAUNCHES,
            **{f"ekf_frame_batched.{k}": v for k, v in ekf_update_batched.LAUNCHES.items()},
            **ccl.LAUNCHES}


def _launched(before: dict) -> dict:
    return {k: v - before[k] for k, v in _launches().items() if v != before[k]}


def build_data(batch, duration, cam, level="corners", distinct=8, device=None):
    """``min(batch, distinct)`` synthetic sequences (seeds 0, 1, ...) at
    ``level`` through ``cam`` (frames rendered on ``device``), tiled to
    ``batch`` lanes on ``device`` (None: the card); returns (data, seqs)."""
    seqs = [
        synthetic.generate_sequence(
            synthetic.SimParams(duration=duration, seed=s), level=level, camera=cam,
            device=device,
        )
        for s in range(min(batch, distinct))
    ]
    return runner.build_batch_data(seqs, batch, level, device), seqs


def bench_device(data, cfg, cam, level, reps=5):
    """Counterpart of ``bench.py``'s ``bench_tpu``: one warm replay, then
    ``reps`` timed ones on the host clock, each ended by a synchronize.
    Returns (B·F over the mean seconds of a replay, the last output, each
    timed replay's seconds)."""
    out, seconds = _timed(lambda: runner.replay_batch(data, cfg, cam, level),
                          data.obs_ids.device, reps)
    batch, frames = data.obs_ids.shape[:2]
    return batch * frames / statistics.fmean(seconds), out, seconds


def _cv2():
    """cv2, or None where it is not installed."""
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def bench_reference_numpy(seq, n_frames=150, marker_length=0.27):
    """Single-thread reference-equivalent pipeline for the same workload,
    frames/s on the host: per frame, per-marker PnP (cv2.solvePnP
    IPPE_SQUARE, the native path the reference uses through
    estimatePoseSingleMarkers) where cv2 is installed, then the dense
    float64 EKF (the reference's Eigen formulation, ``ReferenceEKF``)."""
    cv2 = _cv2()
    if cv2 is not None:
        obj = np.array(
            [
                [-marker_length / 2, marker_length / 2, 0],
                [marker_length / 2, marker_length / 2, 0],
                [marker_length / 2, -marker_length / 2, 0],
                [-marker_length / 2, -marker_length / 2, 0],
            ]
        )
        seq_cam = seq.camera()  # the calibration the sequence carries
        K = np.asarray(seq_cam.matrix, np.float64)
        dist = np.asarray(seq_cam.dist, np.float64)
    else:
        print(
            "WARNING: cv2 missing — baseline omits per-marker PnP, "
            "vs_baseline not comparable to cv2-equipped runs",
            file=sys.stderr,
        )

    ekf = ReferenceEKF()
    epf = seq.enc_per_frame
    enc_w = seq.enc_w.reshape(-1, epf, 2)
    enc_dt = seq.enc_dt.reshape(-1, epf)
    n_frames = min(n_frames, seq.num_frames)
    t0 = time.perf_counter()
    for f in range(n_frames):
        for e in range(epf):
            ekf.add_encoder(enc_w[f, e, 0], enc_w[f, e, 1], enc_dt[f, e])
        obs = []
        for j in range(seq.max_obs):
            if not seq.obs_valid[f, j]:
                continue
            if cv2 is not None and seq.corners_px is not None:
                corners = seq.corners_px[f, j].astype(np.float64)
                cv2.solvePnP(
                    obj, corners.reshape(-1, 1, 2), K, dist,
                    flags=cv2.SOLVEPNP_IPPE_SQUARE,
                )
            obs.append((int(seq.obs_ids[f, j]), seq.obs_z[f, j], seq.obs_R[f, j]))
        ekf.add_frame(obs)
    return n_frames / (time.perf_counter() - t0)


def bench_image_level(cam, batch=32, duration=6.0, device=None):
    """Secondary metric: the full image pipeline (640x480 frames rendered
    on ``device`` -> detector -> PnP -> EKF) at ``batch`` lanes over 2
    sequences, ``detect_frames``' default chunk — BASELINE.md config 3b.
    One warm replay, then 3 timed ones; returns (B·F over the median
    seconds, each timed replay's seconds)."""
    device = resolve(device)
    cfg = SlamConfig(ekf=EkfConfig(max_landmarks=32, max_observations_per_frame=24))
    data, seqs = build_data(batch, duration, cam, "images", distinct=2, device=device)
    cam = seqs[0].camera()  # the calibration the sequence carries
    _, seconds = _timed(lambda: runner.replay_batch(data, cfg, cam, "images"), device, 3)
    _warn_spread("image-level rep (s)", seconds)
    return batch * seqs[0].num_frames / statistics.median(seconds), seconds


def _device_line(device: torch.device) -> str:
    """The device, and on the card its name and what nvidia-smi reads of
    its power limit where nvidia-smi is installed."""
    if device.type != "cuda":
        return f"bench: device {device}"
    line = f"bench: device {device} ({torch.cuda.get_device_name(device)})"
    if shutil.which("nvidia-smi"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        )
        line += f"; nvidia-smi: {smi.stdout.strip()}"
    return line


def _seconds(seconds) -> str:
    return ", ".join(f"{s:.4f}" for s in seconds)


def main(device=None, batch=256, duration=60.0, reps=3, image_batch=32, image_duration=6.0,
         reference_frames=60):
    """Run every leg at ``bench.py``'s sizes (the keywords cut them) on
    ``device`` (None: the card) and print the lines described above."""
    device = resolve(device)
    print(_device_line(device))
    cfg = SlamConfig(ekf=EkfConfig(max_landmarks=32, max_observations_per_frame=16))
    cam = CameraIntrinsics.create(600.0, 600.0, 320.0, 240.0)
    data, seqs = build_data(batch, duration, cam, device=device)
    cam = seqs[0].camera()  # replay with the camera the sequences carry
    before = _launches()
    fps, _, seconds = bench_device(data, cfg, cam, "corners", reps=reps)
    frames = data.obs_ids.shape[1]
    print(f"bench: corner level B={batch} F={frames}: {fps:.1f} frames/s (mean of {reps}: "
          f"{_seconds(seconds)} s); launches over {reps + 1} replays {json.dumps(_launched(before))}")

    before = _launches()
    img_fps, img_seconds = bench_image_level(cam, image_batch, image_duration, device)
    print(f"bench: image level B={image_batch}: {img_fps:.1f} frames/s (median of 3: "
          f"{_seconds(img_seconds)} s); launches over 4 replays {json.dumps(_launched(before))}")

    runs = [bench_reference_numpy(seqs[0], n_frames=reference_frames)
            for _ in range(REFERENCE_RUNS)]
    ref_fps = statistics.median(runs)
    _warn_spread("numpy reference (frames/s)", runs)
    cv2 = _cv2()
    print(f"bench: numpy reference over {min(reference_frames, seqs[0].num_frames)} frames, "
          f"cv2 {cv2.__version__ if cv2 is not None else 'missing'}: median {ref_fps:.1f} frames/s "
          f"of {REFERENCE_RUNS} runs ({', '.join(f'{r:.1f}' for r in runs)}; "
          f"max/min {max(runs) / min(runs):.3f})")
    print(
        json.dumps(
            {
                "metric": "ekf_pipeline_frames_per_sec_per_chip",
                "value": round(fps, 1),
                "unit": "frames/s",
                "vs_baseline": round(fps / ref_fps, 2),
                "image_level_frames_per_sec_per_chip": round(img_fps, 1),
            }
        )
    )


if __name__ == "__main__":
    main()
