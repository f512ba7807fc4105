"""Checkpoint / resume (L4) and the learned-map exporter — counterpart of
``aruco_slam_tpu.io.checkpoint``.

A checkpoint of a NamedTuple of tensors (an ``EkfState``, a ``BAProblem``)
is the JAX package's npz layout: ``<path>.npz`` holding one array
``leaf_<i>`` per field, in order (JAX's flattening order). So a checkpoint
written by the port loads in the JAX package (its npz reader) and one
written by the JAX package's npz writer loads here. The JAX package's
orbax format is not read: it needs JAX.

The exporter writes EKF / BA landmark estimates in the reference's
``map.txt`` schema (map/map.txt:1 header), so ATE tooling can diff the
estimated map against the ground truth.
"""

from __future__ import annotations

import numpy as np
import torch

from aruco_slam_tpu_torch.io import map_io
from aruco_slam_tpu_torch.utils.device import host, resolve


def save_pytree(path: str, tree) -> None:
    """Save a NamedTuple (or tuple) of tensors or arrays to ``path + ".npz"``."""
    np.savez_compressed(path + ".npz",
                        **{f"leaf_{i}": host(leaf) for i, leaf in enumerate(tree)})


def load_pytree(path: str, like, device=None):
    """Load what :func:`save_pytree` (or the JAX package's npz writer) saved
    from a tree of ``like``'s type and length: each leaf a tensor on
    ``device`` (None: the card) with the file's shape and dtype."""
    device = resolve(device)
    with np.load(path + ".npz") as f:
        leaves = [torch.as_tensor(f[f"leaf_{i}"], device=device) for i in range(len(like))]
    return type(like)(*leaves) if hasattr(like, "_fields") else type(like)(leaves)


def export_learned_map(
    path: str,
    landmarks,
    ids,
    active,
    marker_length: float = 0.27,
    z: float = 0.3,
) -> map_io.MarkerMap:
    """Write the estimated landmark map in the reference map.txt schema.

    ``landmarks [L, 3]`` planar (x, y, face-normal yaw), ``ids [L]``,
    ``active [L]`` (tensors or arrays): one lane of ``models.ekf.get_map``
    or a BA solve. Round-trips through ``map_io.load_map``."""
    from aruco_slam_tpu_torch.sim.synthetic import planar_to_map

    landmarks = host(landmarks)
    ids = host(ids)
    active = host(active).astype(bool)
    m = planar_to_map(landmarks[active], ids=ids[active], marker_length=marker_length, z=z)
    map_io.save_map(path, m)
    return m
