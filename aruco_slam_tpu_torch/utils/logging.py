"""Structured run records + profiling (L4 observability) — counterpart of
``aruco_slam_tpu.utils.logging``.

- :func:`write_replay_log`: per-frame JSONL records (pose, covariance
  trace, landmark count) written once per replay from the result, the JAX
  package's records for the same result;
- :func:`trace`: a context manager around ``torch.profiler`` writing a
  TensorBoard / Perfetto trace (the JAX package's wraps ``jax.profiler``).
"""

from __future__ import annotations

import contextlib
import json

import numpy as np
import torch

from aruco_slam_tpu_torch.utils.device import host


def write_replay_log(path: str, result, every: int = 1) -> int:
    """Write per-frame records of a single-stream ``ReplayResult`` to JSONL,
    then one summary record. Returns the number of per-frame records."""
    traj = host(result.trajectory)
    covs = host(result.pose_cov)
    n_lm = host(result.n_landmarks)
    n = 0
    with open(path, "w") as f:
        for i in range(0, len(traj), every):
            rec = {
                "frame": i,
                "x": float(traj[i, 0]),
                "y": float(traj[i, 1]),
                "theta": float(traj[i, 2]),
                "cov_trace": float(np.trace(covs[i])),
                "n_landmarks": int(n_lm[i]),
            }
            f.write(json.dumps(rec) + "\n")
            n += 1
        summary = {
            "final": True,
            "frames": len(traj),
            "diverged": int(host(result.final_state.diverged).reshape(-1)[0]),
            "dropped": int(host(result.final_state.dropped).reshape(-1)[0]),
        }
        f.write(json.dumps(summary) + "\n")
    return n


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a trace of the host, and of the card where there is one, into
    ``logdir`` (``*.pt.trace.json``, viewable in TensorBoard or Perfetto)."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)):
        yield
