"""ArUco marker dictionary: a frozen copy of the port's ``ops.dictionary``
(OpenCV's ``DICT_ARUCO_ORIGINAL`` and the lookup stage of
``cv::aruco::detectMarkers``), for the benchmark's renderer and its plain
detector.

``DICT_ARUCO_ORIGINAL`` is generated, not tabulated: each of the 5 rows of
the 5x5 bit grid encodes 2 id bits (MSB first) with the classic ArUco code
words 00 -> 10000, 01 -> 10111, 10 -> 01001, 11 -> 01110, giving 1024
markers. The tables stay in numpy; :func:`match_bits` is one
``[K, 25] x [25, 4096]`` product against every rotation of every code.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

Tensor = torch.Tensor

ARUCO_ORIGINAL_WORDS = np.array(
    [
        [1, 0, 0, 0, 0],  # 00
        [1, 0, 1, 1, 1],  # 01
        [0, 1, 0, 0, 1],  # 10
        [0, 1, 1, 1, 0],  # 11
    ],
    np.uint8,
)


@functools.lru_cache(maxsize=None)
def aruco_original_bits() -> np.ndarray:
    """All 1024 DICT_ARUCO_ORIGINAL markers as [1024, 5, 5] {0,1} arrays
    (1 = white cell on the printed marker, OpenCV's convention)."""
    ids = np.arange(1024)
    rows = [ARUCO_ORIGINAL_WORDS[(ids >> (2 * (4 - i))) & 0b11] for i in range(5)]
    return np.stack(rows, axis=1)


@functools.lru_cache(maxsize=None)
def aruco_original_rotations() -> np.ndarray:
    """[4, 1024, 25]: the four 90-degree rotations of every codeword,
    flattened row-major; rotation r equals ``np.rot90(bits, r)``."""
    bits = aruco_original_bits()
    return np.stack([np.rot90(bits, r, axes=(1, 2)).reshape(1024, 25) for r in range(4)])


@functools.lru_cache(maxsize=None)
def _codes(device: torch.device) -> Tensor:
    return torch.as_tensor(
        aruco_original_rotations().reshape(4 * 1024, 25), dtype=torch.float32, device=device
    )


def match_bits(bits: Tensor, max_correction: int = 1):
    """Match extracted bit grids ``[..., 5, 5]`` (1 = white) against the
    dictionary. Returns (ids, rotations, distances, valid), each ``[...]``.

    Hamming distance to all 4096 (rotation, id) codewords by one product:
    d = 25 - (b . c + (1 - b) . (1 - c)). Every term is 0 or 1, so the
    float32 sums are exact on any device. Ties go to the first codeword
    (``argmin`` returns the first minimum, as ``jnp.argmin`` does)."""
    codes = _codes(bits.device)
    b = bits.reshape(*bits.shape[:-2], 25).to(torch.float32)
    same = b @ codes.T + (1.0 - b) @ (1.0 - codes.T)
    dist = 25.0 - same
    best = torch.argmin(dist, dim=-1)
    d = torch.gather(dist, -1, best[..., None])[..., 0]
    rot = torch.div(best, 1024, rounding_mode="floor").to(torch.int32)
    mid = (best % 1024).to(torch.int32)
    return mid, rot, d, d <= max_correction


def marker_pattern(marker_id: int, cells: int = 7) -> np.ndarray:
    """Printed pattern with its 1-cell black border: [7, 7] {0,1}, 1 = white."""
    if cells != 7:
        raise ValueError(f"ARUCO_ORIGINAL patterns are 7x7 cells, got {cells}")
    out = np.zeros((7, 7), np.uint8)
    out[1:6, 1:6] = aruco_original_bits()[marker_id]
    return out
