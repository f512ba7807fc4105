"""One cell's data and the port's entry that its window drives.

The harness makes every input from the seed (``reference.sim``; the frames
by ``reference.render``) and hands the port only those tensors, through
its public entries: ``runner.replay_batch`` for the batched cells and
``runner.replay`` for the single stream. From the port it reads the
result, the kernel wrappers' launch counters and the detector's stage
marks.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import render, sim

ENTRIES = ("replay_batch", "replay")  # the entries Program runs; others: ``entries/``


class Cell:
    """Inputs of one cell on ``device``: ``base`` (the distinct sequences,
    host arrays), per-lane tensors ``enc_w [B, F, T, 2]``, ``enc_dt``,
    ``ids``, ``valid``, and by level ``corners``, ``z`` / ``R`` or
    ``images``. ``lane_base[b]`` is the distinct sequence lane b replays."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.device = config, traffic, torch.device(device)
        self.seed = seed
        s = config["sensors"]
        self.level, self.lanes = traffic["level"], traffic["lanes"]
        self.distinct = traffic["distinct"]
        self.epf = int(round(s["encoder_hz"] / s["camera_hz"]))
        self.base = sim.base_sequences(config, self.level, self.distinct, seed,
                                       traffic.get("join_s"))
        self.frames = self.base["ids"].shape[1]
        dev = self.device
        self.lane_base = torch.arange(self.lanes, device=dev) % self.distinct
        gen = torch.Generator(device=dev).manual_seed(seed)
        self.enc_w, self.enc_dt = sim.lane_encoders(
            torch.as_tensor(self.base["wheels"], device=dev), self.lanes,
            s["encoder_noise_radps"], self.epf, 1.0 / s["encoder_hz"], gen)
        self.ids = self.lanes_of("ids")
        self.valid = self.lanes_of("valid")
        self.corners = self.z = self.R = self.images = None
        if self.level == "corners":
            self.corners = self.lanes_of("corners")
        elif self.level == "obs":
            self.z, self.R = self.lanes_of("z"), self.lanes_of("R")
        else:
            self.base_images = torch.stack([
                render.render(sim.Arena.from_config(config), p, config["camera"],
                              s["camera_height_m"], dev)
                for p in self.base["poses"]])
            self.images = self.base_images.index_select(0, self.lane_base)

    def lanes_of(self, key: str) -> torch.Tensor:
        return torch.as_tensor(self.base[key], device=self.device).index_select(0, self.lane_base)

    @property
    def frames_per_call(self) -> int:
        return self.lanes * self.frames


class Program:
    """The port's entry for a cell, called as ``program()``: the window's
    unit of work. At image level ``detections`` holds what
    ``runner.detect_frames`` returned in the latest call (the window's
    detections): the runner's ``detect_frames`` is wrapped while the
    program is open, and given back by :meth:`close` (or on leaving a
    ``with`` block), which drops the program's hold on its tensors."""

    def __init__(self, cell: Cell):
        from aruco_slam_tpu_torch import runner
        from aruco_slam_tpu_torch.ops.camera import CameraIntrinsics
        from aruco_slam_tpu_torch.utils.config import EkfConfig, SlamConfig

        self.runner, self.cell = runner, cell
        c, f = cell.config["camera"], cell.config["filter"]
        self.camera = CameraIntrinsics.create(c["fx"], c["fy"], c["cx"], c["cy"])
        self.slam = SlamConfig(ekf=EkfConfig(
            max_landmarks=f["max_landmarks"],
            max_observations_per_frame=f["max_observations_per_frame"][cell.level]))
        self.entry = cell.traffic["entry"]
        if self.entry not in ENTRIES:
            raise ValueError(f"unknown entry {self.entry!r}")
        self.data = runner.ReplayData(cell.enc_w, cell.enc_dt, cell.ids, cell.z, cell.R,
                                      cell.valid, cell.corners, cell.images)
        if self.entry == "replay":
            self.data = runner.ReplayData(*(None if x is None else x[0] for x in self.data))
        self.detections = None
        self._detect = None
        if cell.level == "images":
            self._detect = detect = runner.detect_frames

            def capture(*args, **kwargs):
                self.detections = detect(*args, **kwargs)
                return self.detections

            runner.detect_frames = capture

    def close(self) -> None:
        """Gives the runner its own ``detect_frames`` back."""
        if self._detect is not None:
            self.runner.detect_frames, self._detect = self._detect, None

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __call__(self):
        if self.entry == "replay":
            return self.runner.replay(self.data, self.slam, self.camera, self.cell.level)
        return self.runner.replay_batch(self.data, self.slam, self.camera, self.cell.level,
                                        det_chunk=self.cell.traffic.get("det_chunk", 16))

    def launches(self) -> dict:
        """The kernel wrappers' launch counters (they count on the card)."""
        from aruco_slam_tpu_torch.ops.kernels import ccl, ekf_update, ekf_update_batched, \
            pnp_frontend

        return {"pnp_frontend": pnp_frontend.LAUNCHES,
                **{f"ekf_frame_batched.{k}": v for k, v in ekf_update_batched.LAUNCHES.items()},
                **{f"ekf_frame_update.{k}": v for k, v in ekf_update.LAUNCHES.items()},
                **ccl.LAUNCHES}


def result_of(out, entry: str) -> dict:
    """The compared parts of a replay's result, with a lane axis."""
    r = {"trajectory": out.trajectory, "n_landmarks": out.n_landmarks,
         "mu": out.final_state.mu, "sigma": out.final_state.sigma,
         "slot_ids": out.final_state.slot_ids}
    if entry == "replay":
        r["trajectory"], r["n_landmarks"] = r["trajectory"][None], r["n_landmarks"][None]
    return r


def sample_lanes(lanes: int, count, seed: int) -> np.ndarray:
    """The lanes a check compares: all of them, or ``count`` drawn from
    the seed, sorted."""
    if count == "all" or count >= lanes:
        return np.arange(lanes)
    rng = np.random.default_rng([seed, 7])
    return np.sort(rng.choice(lanes, size=count, replace=False))
