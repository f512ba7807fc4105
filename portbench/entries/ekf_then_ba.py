"""ekf_then_ba: the port's offline back end, one ``pipeline.ekf_then_ba``
call a unit of work, as a user with one recorded run calls it: the
filter's pass (``runner.replay``: K6 a frame), the factor graph built on
the host (``models/graph_builder.py``), packed and solved on the card
(``models/ba.py``), ended by a synchronize.

Set-up makes one ``io.sequence.Sequence`` on the host from the cell's lane
0 (the base sequence's observations, lane 0's encoder ticks: the arrays
the ``stream`` traffic replays) and the ``SlamConfig`` of the
deployment's ``filter`` and ``estimator``. The traffic file gives the
call's ``keyframe_stride``, ``ba_iters``, ``cg_iters``, ``damping``,
``adaptive`` and ``deflate_gauge``.

The reference is the float64 filter (``reference/ekf.py``) and, on its
answer, the float64 back end (``reference/ba.py``, on the CPU). The
compared numbers: ``traj_gap`` (the filter's trajectory, as the stream
cell's), ``pose_gap`` and ``lm_gap`` (the largest gap of a keyframe pose
and of a landmark with a factor after the solve, m or rad, angles
wrapped), ``cost_gap`` (the program's final cost's gap over the
reference's), ``answer_cost_gap`` (the same for the cost of the program's
poses and landmarks on the reference's graph, in float64: an answer that
its factors do not bear out, where the flat valley of the posterior lets
``pose_gap`` and ``lm_gap`` swing by millimetres between seeds),
``lm_id_mismatch`` (landmark ids, exact) and ``history_mismatch`` (how far
the cost history's length is from ``ba_iters`` + 1, exact).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench import cell as cellmod
from portbench import check, roofline
from portbench.control import TF32Products
from portbench.reference import ba

KWARGS = ("keyframe_stride", "ba_iters", "cg_iters", "damping", "adaptive", "deflate_gauge")


def slam_config(config: dict, level: str):
    """The port's ``SlamConfig`` of the deployment's ``estimator`` and
    ``filter``."""
    from aruco_slam_tpu_torch.utils.config import (ArucoConfig, CompatConfig, EkfConfig,
                                                   NoiseConfig, OdomConfig, SlamConfig)

    est, f = config["estimator"], config["filter"]
    return SlamConfig(
        covariance=NoiseConfig(Q_k=est["Q_k"], R_x=est["R_x"], R_y=est["R_y"],
                               R_theta=est["R_theta"]),
        odom=OdomConfig(kl=est["wheel_radius_m"], kr=est["wheel_radius_m"],
                        b=est["half_wheelbase_m"]),
        aruco=ArucoConfig(marker_length=est["marker_length_m"],
                          pnp_refine_iters=est["pnp_refine_iters"]),
        compat=CompatConfig(stationary_gate_eps=est["stationary_gate_m"]),
        ekf=EkfConfig(max_landmarks=f["max_landmarks"],
                      max_observations_per_frame=f["max_observations_per_frame"][level],
                      symmetrize_sigma=est["symmetrize_sigma"]),
        useful_distance_threshold=est["useful_distance_m"])


def _lane0(cell) -> tuple:
    """Lane 0's host arrays: enc_w [F, T, 2], enc_dt [F, T], ids, z, R,
    valid [F, M, ...]."""
    return (cell.enc_w[0].cpu().numpy(), cell.enc_dt[0].cpu().numpy(),
            *(cell.base[k][0] for k in ("ids", "z", "R", "valid")))


class Program:
    """``pipeline.ekf_then_ba`` on the cell's sequence, called as
    ``program()``."""

    launches = cellmod.Program.launches

    def __init__(self, cell):
        from aruco_slam_tpu_torch import pipeline
        from aruco_slam_tpu_torch.io.sequence import Sequence
        from aruco_slam_tpu_torch.ops.camera import CameraIntrinsics

        self.pipeline, self.cell = pipeline, cell
        c = cell.config["camera"]
        self.camera = CameraIntrinsics.create(c["fx"], c["fy"], c["cx"], c["cy"])
        self.slam = slam_config(cell.config, cell.level)
        enc_w, enc_dt, ids, z, R, valid = _lane0(cell)
        self.seq = Sequence(enc_w=enc_w.reshape(-1, 2), enc_dt=enc_dt.reshape(-1),
                            enc_per_frame=cell.epf, obs_ids=ids, obs_z=z, obs_R=R,
                            obs_valid=valid)
        self.kwargs = {k: cell.traffic[k] for k in KWARGS}

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __call__(self):
        return self.pipeline.ekf_then_ba(self.seq, self.slam, self.camera, level=self.cell.level,
                                         device=self.cell.device, **self.kwargs)


def result(out) -> dict:
    """The compared parts of one call's output, on the host."""
    return {"trajectory": out["ekf_result"].trajectory.cpu(), "poses": out["poses"].cpu(),
            "landmarks": out["landmarks"].cpu(),
            "landmark_ids": torch.as_tensor(np.asarray(out["landmark_ids"])),
            "cost_history": out["stats"].cost_history.cpu()}


def reference(cell, dtype=torch.float64) -> dict:
    """The plain filter on lane 0 (on the cell's device), then the plain
    back end on its answer (on the CPU), in ``dtype``; with the graph."""
    f = check.reference(cell, np.arange(1), dtype)
    t = cell.traffic
    g = ba.build(*_lane0(cell), cell.config["estimator"], t["keyframe_stride"],
                 f["trajectory"][0].cpu().numpy(), f["slot_ids"][0].cpu().numpy(),
                 f["mu"][0].cpu().numpy(), dtype)
    poses, landmarks, history = ba.solve(g, t["ba_iters"], t["cg_iters"], t["damping"],
                                         t["adaptive"], t["deflate_gauge"])
    return {"trajectory": f["trajectory"][0].cpu(), "poses": poses, "landmarks": landmarks,
            "landmark_ids": torch.as_tensor(g.ids), "cost_history": history, "graph": g}


def control(cell) -> dict:
    """The control: the reference in float32 with every matrix product's
    inputs in TF32 (``control.py``), in the program's place."""
    with TF32Products():
        return reference(cell, torch.float32)


def numbers(cell, got: dict, ref: dict) -> dict:
    """The compared numbers of ``got`` (``result``) against ``ref``. Every
    landmark of the graph has a factor: it numbers only observed markers."""
    angle = torch.tensor([False, False, True])
    ids, want_ids = got["landmark_ids"], ref["landmark_ids"]
    lm_id = float((ids != want_ids).sum()) if ids.shape == want_ids.shape else float(
        abs(ids.numel() - want_ids.numel()))
    g, want = ref["graph"], float(ref["cost_history"][-1])

    def gap(a, b):
        return check._max(check._gap(a, b, angle)) if a.shape == b.shape else math.nan

    answer = math.nan
    if lm_id == 0 and got["poses"].shape == ref["poses"].shape:
        answer = float(ba.cost(g, got["poses"].to(g.poses.dtype),
                               got["landmarks"].to(g.poses.dtype)))
    return {
        "traj_gap": gap(got["trajectory"], ref["trajectory"]),
        "pose_gap": gap(got["poses"], ref["poses"]),
        "lm_gap": gap(got["landmarks"], ref["landmarks"]) if lm_id == 0 else math.nan,
        "cost_gap": abs(float(got["cost_history"][-1]) - want) / want,
        "answer_cost_gap": abs(answer - want) / want,
        "lm_id_mismatch": lm_id,
        "history_mismatch": float(abs(got["cost_history"].numel()
                                      - (cell.traffic["ba_iters"] + 1))),
    }


def bounds(cell, ref: dict) -> dict:
    """The solve's least seconds a call (``roofline.ba_solve``)."""
    g, t = ref["graph"], cell.traffic
    return {"ba_solve": roofline.ba_solve(g.poses.shape[0], g.landmarks.shape[0],
                                          g.obs_kf.shape[0], g.odo_i.shape[0], t["ba_iters"],
                                          t["cg_iters"], t["adaptive"], t["deflate_gauge"])}
