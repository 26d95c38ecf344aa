"""Inputs that exercise the deposit's edge cases, for tests and chip_smoke.py."""

import numpy as np

__all__ = ['edge_points']


def edge_points(n, nmesh, yb, box, rng):
    """(n, 3) float32 points in [0, box) with about half placed where the
    cell index is fragile: on TSC cell edges and their next float32 up,
    on y-block edges, at 0 and at box, just below box, and just below 0
    (which the single periodic wrap maps onto box)."""
    h = np.float32(box) / np.float32(nmesh)
    pos = (rng.random((n, 3)) * box).astype(np.float32)
    m = rng.random((n, 3))
    cell_edge = ((rng.integers(0, nmesh + 1, (n, 3)) + 0.5) * h).astype(np.float32)
    block_edge = ((rng.integers(0, nmesh // yb + 1, (n, 3)) * yb - 0.5) * h).astype(np.float32)
    picks = [
        (0.2, cell_edge),
        (0.3, block_edge),
        (0.33, np.float32(box)),
        (0.36, np.nextafter(np.float32(box), np.float32(0))),
        (0.39, np.float32(-1e-6)),
        (0.42, np.float32(0)),
        (0.5, np.nextafter(cell_edge, np.float32(np.inf))),
    ]
    lo = 0.0
    for hi, val in picks:
        pos = np.where((m >= lo) & (m < hi), val, pos)
        lo = hi
    return pos
