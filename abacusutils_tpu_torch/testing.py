"""Inputs that exercise the deposit's edge cases, for tests and chip_smoke.py."""

import numpy as np

__all__ = ['edge_points', 'edge_points_centred']


def edge_points(n, nmesh, yb, box, rng):
    """(n, 3) float32 points in [0, box) with about half placed where the
    cell index is fragile: on TSC cell edges and their next float32 up,
    on block edges (every `yb` cells: K1's brick edges), at 0 and at box,
    just below box, and just below 0 (which the single periodic wrap maps
    onto box)."""
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


def edge_points_centred(n, nmesh, yb, box, rng):
    """(n, 3) float32 points of a box-centred catalog, about [-box/2, box/2),
    for the unwrapped CIC paint: about half lie where the cell index
    floor(p * nmesh / box + 0.5) is fragile, on cell edges at negative and
    positive coordinates and their next float32 up or down, on block
    edges (every `yb` cells), at -box/2 and just below box/2, and up to a cell outside the box
    (galaxies displaced past the edge). Every point lies within one box
    length of [0, box), the domain of TSC's single periodic wrap."""
    h = np.float32(box) / np.float32(nmesh)
    half = np.float32(box) / 2
    pos = (rng.random((n, 3)) * box - box / 2).astype(np.float32)
    m = rng.random((n, 3))
    k = rng.integers(-(nmesh // 2) - 1, nmesh // 2 + 1, (n, 3))
    cell_edge = ((k - 0.5) * h).astype(np.float32)
    jb = rng.integers(-((nmesh // yb) // 2), (nmesh // yb) // 2 + 1, (n, 3))
    block_edge = ((jb * yb - 0.5) * h).astype(np.float32)
    outside = (rng.random((n, 3)) * h + half).astype(np.float32) * np.where(m < 0.45, -1, 1)
    picks = [
        (0.15, cell_edge),
        (0.2, np.nextafter(cell_edge, np.float32(np.inf))),
        (0.25, np.nextafter(cell_edge, np.float32(-np.inf))),
        (0.3, block_edge),
        (0.33, -half),
        (0.36, np.nextafter(half, np.float32(0))),
        (0.42, np.float32(-1e-6)),
        (0.5, outside),
    ]
    lo = 0.0
    for hi, val in picks:
        pos = np.where((m >= lo) & (m < hi), val, pos)
        lo = hi
    return pos.astype(np.float32)
