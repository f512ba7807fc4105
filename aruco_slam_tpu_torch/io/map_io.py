"""Ground-truth marker-map file I/O (L3) — the copy of
``aruco_slam_tpu.io.map_io`` this package imports without JAX.

Parser/writer for the reference's ``map.txt`` schema
(``id length x y z roll_x pitch_y yaw_z``, see reference map/map.txt:1 and
``MapLoader::loadMap`` src/map_loader.cpp:7-84), preserving its lenient /
strict line semantics **including its quirks**, which we reproduce
deterministically:

- blank lines and ``#`` comments are skipped (src/map_loader.cpp:26-36);
- a line whose first non-space char is not a digit (including a leading
  ``-``!) is "garbage": the whole map is discarded and parsing stops
  (src/map_loader.cpp:44-50);
- fewer than 4 fields: the line is skipped (src/map_loader.cpp:52-58);
- the optional-field cascade (src/map_loader.cpp:60-79) has sticky
  stream-failure semantics plus two wrong-variable assignments, so the
  *effective* per-field results are:

  ======  ===  =====  ======  ====
  fields   z   roll   pitch   yaw
  ======  ===  =====  ======  ====
  4        0     0      0      0
  5        z     0      0      0
  6        z     0      0      0   (parsed roll overwritten by the yaw-read
                                    failure branch writing ``roll = 0``;
                                    yaw is uninitialized -> we define it 0)
  7        z     0    pitch    0   (same overwrite; yaw defined 0)
  8        z   roll   pitch   yaw
  ======  ===  =====  ======  ====

The in-memory map is a plain numpy container used by host code and the
sequence generator.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class MarkerMap:
    """Ground-truth marker map: id, side length, 3-D pose (xyz + fixed-axis RPY)."""

    ids: np.ndarray = field(default_factory=lambda: np.zeros((0,), np.int32))
    lengths: np.ndarray = field(default_factory=lambda: np.zeros((0,), np.float64))
    positions: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.float64))
    rpys: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.float64))

    def __len__(self) -> int:
        return len(self.ids)

    def planar(self) -> np.ndarray:
        """Planar landmark states [(x, y, yaw)] — the (mx, my, mtheta) the EKF
        estimates (the reference compares these visually in rviz)."""
        return np.stack(
            [self.positions[:, 0], self.positions[:, 1], self.rpys[:, 2]], axis=-1
        )


def _is_float(tok: str) -> bool:
    try:
        float(tok)
        return True
    except ValueError:
        return False


def load_map(path: str) -> MarkerMap:
    """Parse a ``map.txt`` file with the reference's exact line semantics."""
    with open(path) as f:
        lines = f.readlines()
    return parse_map_lines(lines)


def parse_map_lines(lines) -> MarkerMap:
    ids, lengths, positions, rpys = [], [], [], []
    for line in lines:
        stripped = line.strip()
        if not stripped:
            continue  # blank (src/map_loader.cpp:26-30)
        first = stripped[0]
        if first == "#":
            continue  # comment (src/map_loader.cpp:32-36)
        if not first.isdigit():
            # Garbage line: discard everything parsed so far and stop
            # (src/map_loader.cpp:44-50 clears the map and returns).
            return MarkerMap()
        toks = stripped.split()
        # Required: id length x y — istream semantics: a malformed token makes
        # the whole required read fail and the line is skipped.
        if len(toks) < 4 or not all(_is_float(t) for t in toks[:4]):
            continue
        try:
            mid = int(float(toks[0]))
        except ValueError:
            continue
        length, x, y = (float(t) for t in toks[1:4])
        opt = toks[4:8]
        n_opt = 0
        vals = []
        for t in opt:  # sticky failure: stop at first bad token
            if not _is_float(t):
                break
            vals.append(float(t))
            n_opt += 1
        z = vals[0] if n_opt >= 1 else 0.0
        if n_opt >= 4:
            roll, pitch, yaw = vals[1], vals[2], vals[3]
        elif n_opt == 3:
            # roll parsed but overwritten by the failing yaw-read branch
            # (src/map_loader.cpp:75-79 writes roll = 0); yaw uninitialized
            # in the reference — defined as 0 here.
            roll, pitch, yaw = 0.0, vals[2], 0.0
        else:  # n_opt in (0, 1, 2): everything after z collapses to 0
            roll, pitch, yaw = 0.0, 0.0, 0.0
        ids.append(mid)
        lengths.append(length)
        positions.append((x, y, z))
        rpys.append((roll, pitch, yaw))
    if not ids:
        return MarkerMap()
    return MarkerMap(
        ids=np.asarray(ids, np.int32),
        lengths=np.asarray(lengths, np.float64),
        positions=np.asarray(positions, np.float64),
        rpys=np.asarray(rpys, np.float64),
    )


def save_map(path: str, marker_map: MarkerMap) -> None:
    """Write a map in the reference schema (round-trips through load_map)."""
    with open(path, "w") as f:
        f.write("# id    length\tx\ty\tz\troll_x\tpitch_y\tyaw_z\n")
        for i in range(len(marker_map)):
            x, y, z = marker_map.positions[i]
            r, p, yw = marker_map.rpys[i]
            f.write(
                f"{int(marker_map.ids[i])}\t{marker_map.lengths[i]:.6g}\t"
                f"{x:.6g}\t{y:.6g}\t{z:.6g}\t{r:.6g}\t{p:.6g}\t{yw:.6g}\n"
            )
