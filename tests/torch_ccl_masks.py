"""Masks drawn across the CCL block body's tile layout, shared by the CCL
tests on the CPU (tests/test_torch_ccl.py) and on the card
(tests/test_torch_cuda.py)."""

import numpy as np


def tile_crossing_mask(h: int, w: int, band_rows: int, seg: int) -> np.ndarray:
    """An h x w bool mask: a serpentine of 1-pixel rows joined at alternate
    ends that winds down through every band of ``band_rows`` rows (the
    bounded rounds leave it unconverged), cut into two windings; components
    that end on, start on and straddle band edges (at most one edge in
    eight rows carries them); and short runs on the rows between the
    serpentine's that end on, start on and cross the row splits every
    ``seg`` pixels (a lane's share of a tile row, and the tile edges)."""
    fg = np.zeros((h, w), bool)
    for y in range(2, h - 2, 4):
        fg[y, 4:w - 4] = True
        fg[y + 1: y + 4, w - 5 if (y // 4) % 2 == 0 else 4] = True
    fg[:, w // 2 - 20: w // 2 - 18] = False  # two windings
    span = max(1, w - 100)
    for i, y in enumerate(range(band_rows, h, band_rows * max(1, 8 // band_rows))):
        x = 40 + (60 * i) % span
        fg[max(0, y - 3): y, x: x + 20] = True  # ends on the edge
        fg[y: y + 3, x + 10: x + 30] = True  # starts on it
        fg[y - 1: y + 1, 10: 20] = True  # straddles it
    rows = list(range(4, h - 4, 4))
    for k, x in enumerate(range(seg, w - 8, seg)):
        if not rows:
            break
        y = rows[k % len(rows)]
        fg[y, x - 6: x] = True  # ends on the split ...
        fg[y, x: x + 6] = True  # ... and goes on across it
        y2 = rows[(k + len(rows) // 2) % len(rows)]
        fg[y2, x - 5: x] = True  # ends on the split
    return fg
