"""The comparison that decides ``correct``: what the window's last call
returned, against the plain reference (``reference/``) run afterwards on
the same inputs, lane by lane.

The reference is float64 (the detector float32, as the deployment states;
its masks and labels are exact). Every number compared has a limit in the
cell's traffic file, set from the readings that ``PERF.md`` gives; a
number above its limit, or not a number, makes the run not correct.
"""

from __future__ import annotations

import math

import torch

from portbench.reference import detector, ekf, pnp

DET_CHUNK = 128  # frames per call of the plain detector


def reference(cell, lanes, dtype=torch.float64) -> dict:
    """The reference's answers for ``lanes`` (host indices) of ``cell``:
    its detections of the distinct sequences' frames (image level), and the
    EKF's trajectory, landmark counts and final state, in ``dtype``."""
    est, dev = cell.config["estimator"], cell.device
    out = {}
    if cell.level == "images":
        dets = [detector.detect_markers_batch(cell.base_images[d, i:i + DET_CHUNK])
                for d in range(cell.distinct) for i in range(0, cell.frames, DET_CHUNK)]
        D, F = cell.distinct, cell.frames
        ids = torch.cat([x.ids for x in dets]).reshape(D, F, -1)
        corners = torch.cat([x.corners for x in dets]).reshape(D, F, -1, 4, 2)
        valid = torch.cat([x.valid for x in dets]).reshape(D, F, -1)
        out["detections"] = (ids, corners, valid)
    elif cell.level == "corners":
        ids, valid = (torch.as_tensor(cell.base[k], device=dev) for k in ("ids", "valid"))
        corners = torch.as_tensor(cell.base["corners"], device=dev)
    if cell.level == "obs":
        ids, valid = (torch.as_tensor(cell.base[k], device=dev) for k in ("ids", "valid"))
        z = torch.as_tensor(cell.base["z"], device=dev).to(dtype)
        R = torch.as_tensor(cell.base["R"], device=dev).to(dtype)
        keep = valid
    else:
        z, R, keep, _ = pnp.frontend(corners.to(dtype), valid, cell.config["camera"], est)
    lane_idx = torch.as_tensor(lanes, device=dev)
    out.update(ekf.replay(cell.enc_w.index_select(0, lane_idx),
                          cell.enc_dt.index_select(0, lane_idx), ids, z, R, keep,
                          cell.lane_base.index_select(0, lane_idx), est,
                          cell.config["filter"]["max_landmarks"]))
    return out


def _gap(a: torch.Tensor, b: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """|a - b| elementwise, angles (where ``angle``) wrapped."""
    d = a.to(torch.float64) - b.to(torch.float64)
    d = torch.where(angle, ekf.wrap(d), d)
    return d.abs()


def _max(x: torch.Tensor) -> float:
    """The largest element; NaN if any is NaN; 0 for none."""
    if x.numel() == 0:
        return 0.0
    if torch.isnan(x).any():
        return math.nan
    return float(x.max())


def numbers(cell, got: dict, detections, ref: dict) -> dict:
    """Each compared number of the program's result for the checked lanes
    (``cell.result_of``, those lanes selected) and its detections of every
    lane, against ``ref``."""
    dev = got["trajectory"].device
    out = {}
    if "detections" in ref:
        r_ids, r_corners, r_valid = (x.index_select(0, cell.lane_base) for x in ref["detections"])
        p_ids, p_corners, p_valid = detections
        same = (p_valid == r_valid) & (~r_valid | (p_ids == r_ids))
        out["det_mismatch"] = float((~same).sum())
        both = p_valid & r_valid
        out["corner_gap_px"] = _max((p_corners - r_corners).abs()[both])
    pose_angle = torch.tensor([False, False, True], device=dev)
    out["traj_gap"] = _max(_gap(got["trajectory"], ref["trajectory"], pose_angle))
    out["lm_mismatch"] = float((got["n_landmarks"] != ref["n_landmarks"]).sum())
    out["slot_mismatch"] = float((got["slot_ids"] != ref["slot_ids"]).any(-1).sum())
    N = ref["mu"].shape[1]
    angle = (torch.arange(N, device=dev) % 3) == 2
    active = torch.zeros_like(ref["mu"], dtype=torch.bool)
    active[:, 3:] = (ref["slot_ids"] >= 0).repeat_interleave(3, dim=1)
    out["map_gap"] = _max(_gap(got["mu"], ref["mu"], angle)[active])
    scale = ref["sigma"].abs().amax(dim=(1, 2))
    no_angle = torch.zeros((), dtype=torch.bool, device=dev)
    out["cov_gap"] = _max(_gap(got["sigma"], ref["sigma"], no_angle).amax(dim=(1, 2)) / scale)
    return out


def judge(values: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit (NaN fails)."""
    table = {k: {"value": v, "limit": limits[k]} for k, v in values.items()}
    ok = all(v <= limits[k] for k, v in values.items())  # NaN <= x is False
    return ok, table
