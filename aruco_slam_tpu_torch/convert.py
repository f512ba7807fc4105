"""Carry state across from the JAX package and back — this system's form
of loading weights.

Everything crosses as numpy arrays or plain Python values, so this module
imports neither package's JAX side: a caller turns JAX arrays into numpy
first (``np.asarray``). The tests use it to feed both sides one state.
"""

from __future__ import annotations

import numpy as np
import torch

from aruco_slam_tpu_torch.models.ba import BAProblem
from aruco_slam_tpu_torch.models.ekf import EkfState
from aruco_slam_tpu_torch.ops.camera import CameraIntrinsics
from aruco_slam_tpu_torch.ops.detector import DetectorConfig
from aruco_slam_tpu_torch.utils.config import SlamConfig, build
from aruco_slam_tpu_torch.utils.device import resolve

_DTYPES = dict(
    mu=torch.float32, sigma=torch.float32, slot_ids=torch.int32,
    n_landmarks=torch.int32, last_obs=torch.float32, seen_prev=torch.bool,
    initialized=torch.bool, diverged=torch.int32, dropped=torch.int32,
)


def config_from_dict(d: dict) -> SlamConfig:
    """A SlamConfig from ``dataclasses.asdict`` of either package's config."""
    return build(SlamConfig, d)


def _tuples(v):
    return tuple(_tuples(x) for x in v) if isinstance(v, (list, tuple)) else v


def detector_config_from_dict(d: dict) -> DetectorConfig:
    """A DetectorConfig from ``dataclasses.asdict`` of either package's
    config; lists (as from JSON) become the tuples the config holds."""
    return DetectorConfig(**{k: _tuples(v) for k, v in d.items()})


def camera_from_numpy(fx, fy, cx, cy, dist) -> CameraIntrinsics:
    """The port's camera from host values (e.g. ``np.asarray`` of a JAX
    ``CameraIntrinsics``' fields)."""
    return CameraIntrinsics.create(
        float(np.asarray(fx)), float(np.asarray(fy)), float(np.asarray(cx)),
        float(np.asarray(cy)), [float(v) for v in np.asarray(dist).reshape(-1)],
    )


def ekf_state_from_numpy(state, device=None) -> EkfState:
    """The port's batched EkfState from a JAX ``EkfState`` whose leaves are
    numpy, plain (``mu [N]``) or batched (``mu [B, N]``), on ``device``
    (None: the card)."""
    device = resolve(device)
    batched = np.asarray(state.mu).ndim == 2
    fields = {}
    for name in EkfState._fields:
        arr = np.asarray(getattr(state, name))
        if not batched:
            arr = arr[None]
        fields[name] = torch.tensor(arr, dtype=_DTYPES[name], device=device)
    return EkfState(**fields)


def ekf_state_to_numpy(state: EkfState) -> dict:
    """Batched numpy arrays of every field, by the JAX EkfState's names."""
    return {name: getattr(state, name).detach().cpu().numpy() for name in EkfState._fields}


def batched_state_from_trailing(st: dict, initialized=True, device=None) -> EkfState:
    """The port's batch-major EkfState from the JAX batched kernel's
    trailing-batch dict (``mu [N, B]``, ``sigma [N, N, B]``,
    ``slot_ids [L, B]``, ``n_lm [1, B]``, ``last_obs [L, 3, B]``,
    ``seen [L, B]``, ``div [1, B]``, ``drop [1, B]``), on ``device``
    (None: the card)."""
    device = resolve(device)
    mu = np.asarray(st["mu"]).T
    B = mu.shape[0]

    def t(x, dt):
        return torch.tensor(np.asarray(x), dtype=dt, device=device)

    return EkfState(
        mu=t(mu, torch.float32),
        sigma=t(np.transpose(np.asarray(st["sigma"]), (2, 0, 1)), torch.float32),
        slot_ids=t(np.asarray(st["slot_ids"]).T, torch.int32),
        n_landmarks=t(np.asarray(st["n_lm"])[0], torch.int32),
        last_obs=t(np.transpose(np.asarray(st["last_obs"]), (2, 0, 1)), torch.float32),
        seen_prev=t(np.asarray(st["seen"]).T != 0, torch.bool),
        initialized=t(np.broadcast_to(np.asarray(initialized, bool), (B,)), torch.bool),
        diverged=t(np.asarray(st["div"])[0], torch.int32),
        dropped=t(np.asarray(st["drop"])[0], torch.int32),
    )


def batched_state_to_trailing(state: EkfState) -> dict:
    """The inverse: numpy arrays in the JAX batched kernel's layout."""
    a = ekf_state_to_numpy(state)
    return dict(
        mu=np.ascontiguousarray(a["mu"].T),
        sigma=np.ascontiguousarray(np.transpose(a["sigma"], (1, 2, 0))),
        slot_ids=np.ascontiguousarray(a["slot_ids"].T),
        n_lm=a["n_landmarks"][None, :],
        last_obs=np.ascontiguousarray(np.transpose(a["last_obs"], (1, 2, 0))),
        seen=np.ascontiguousarray(a["seen_prev"].T.astype(np.int32)),
        div=a["diverged"][None, :],
        drop=a["dropped"][None, :],
    )


_BA_INDEX_FIELDS = ("obs_kf", "obs_lm", "odo_i", "odo_j")


def ba_problem_from_numpy(problem, device=None) -> BAProblem:
    """A tensor :class:`BAProblem` on ``device`` (None: the card) from a
    numpy one, as either package's graph builder or ``prepare`` makes it:
    indices int64, masks bool, and the floats in their own dtype (float32,
    or float64 for the oracle tests)."""
    device = resolve(device)
    fields = {}
    for name in BAProblem._fields:
        arr = np.asarray(getattr(problem, name))
        if name in _BA_INDEX_FIELDS:
            arr = arr.astype(np.int64)
        fields[name] = torch.tensor(arr, device=device)
    return BAProblem(**fields)


def ba_problem_to_numpy(problem: BAProblem) -> BAProblem:
    """The inverse: a numpy BAProblem with the builders' int32 indices."""
    fields = {}
    for name in BAProblem._fields:
        arr = getattr(problem, name).detach().cpu().numpy()
        fields[name] = arr.astype(np.int32) if name in _BA_INDEX_FIELDS else arr
    return BAProblem(**fields)
