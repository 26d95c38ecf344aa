"""Inputs that exercise the deposit's edge cases, for tests and chip_smoke.py,
a CPU twin of K7's walk for the tests, the NFW radial sample that
``AbacusHOD.run_hod(want_nfw=True)`` draws from, and the reciso smoothing
at the k bins' centres that makes the field-level LCV flow the k-level
one's."""

import numpy as np
import torch

__all__ = ['edge_points', 'edge_points_centred', 'menv_ranges', 'menv_walk', 'nfw_draw',
           'smoothing_at_bin_centres']


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


def menv_ranges(st):
    """The 27 neighbour ranges K7 finds for each of its work items (the 9
    rows around the item's, each over its cells k0 - 1 .. k1 + 1 in up to
    three pieces cut at the periodic seam), from the Menv stage `st`
    (models/hod/menv_device.py:MenvStage): (begin, length, wrap) as int64
    tensors of shapes (nitems, 27), (nitems, 27) and (nitems, 27, 3), in
    csrc/prepare_sim.cu's slot order (row (di, dj) lexicographic, then
    piece: inside, below 0, past nc - 1)."""
    cells = st.cells.long()
    work = st.work.long()
    q = st.query.long()
    i0, i1 = q[work[:, 0]], q[work[:, 1] - 1]
    ci, cj, k0, k1 = cells[0, i0], cells[1, i0], cells[2, i0], cells[2, i1]
    nc0, nc1, nc2 = st.ncs
    per = st.periodic
    dev = cells.device

    def neighbour(c, d, n):
        m = c + d
        w = torch.zeros_like(m)
        if not per:
            return torch.where((m >= 0) & (m < n), m, -1), w
        w = (m >= n).long() - (m < 0).long()
        m = m - w * n
        ok = (n >= 3) or (d == 0 if n == 1 else d >= 0)
        return (m if ok else torch.full_like(m, -1)), w

    begin, length, wrap = [], [], []
    for t in range(27):
        r, piece = divmod(t, 3)
        ni, wi = neighbour(ci, r // 3 - 1, nc0)
        nj, wj = neighbour(cj, r % 3 - 1, nc1)
        wk = torch.zeros_like(k0)
        if per and nc2 < 3:
            ka, kb = torch.zeros_like(k0), torch.full_like(k0, nc2 - 1 if piece == 0 else -1)
        elif piece == 0:
            ka, kb = (k0 - 1).clamp_min(0), (k1 + 1).clamp_max(nc2 - 1)
        elif per:
            edge = (k0 == 0) if piece == 1 else (k1 == nc2 - 1)
            ka = torch.full_like(k0, nc2 - 1 if piece == 1 else 0)
            kb = torch.where(edge, ka, -1)
            wk = torch.where(edge, -1 if piece == 1 else 1, 0)
        else:
            ka, kb = torch.zeros_like(k0), torch.full_like(k0, -1)
        base = (ni * nc1 + nj) * nc2
        lo, hi = base + ka, base + kb + 1
        if st.ukeys is not None:
            lo, hi = (torch.searchsorted(st.ukeys, v) for v in (lo, hi))
        ok = (ni >= 0) & (nj >= 0) & (ka <= kb)
        starts = st.starts.long()
        lo, hi = torch.where(ok, lo, 0), torch.where(ok, hi, 0)
        begin.append(torch.where(ok, starts[lo], 0))
        length.append(torch.where(ok, starts[hi] - starts[lo], 0))
        wrap.append(torch.stack([wi, wj, wk], 1))
    return (torch.stack(begin, 1), torch.stack(length, 1),
            torch.stack(wrap, 1).to(dev))


def menv_walk(st, lbox, rout2, pairs=False):
    """K7's walk on the CPU: for every item, the ranges of
    :func:`menv_ranges` laid end to end, each candidate outside its centre's
    27 cells (a z cell more than one away) skipped, the rest summed in that
    order with the kernel's float64 steps (the minimum image by division on
    a periodic grid of fewer than 5 cells an axis, else by the range's
    wrap). Returns Menv in cell order, bit for bit the kernel's; with
    pairs=True, the (centre, candidate) int64 index pairs the sums take,
    in walk order, instead."""
    from .models.hod.menv_device import K7_CENTRES, _SHIFT_MIN_CELLS

    x, y, z, m, rin2 = st.cols
    n = x.numel()
    out = torch.zeros(n, dtype=torch.float64)
    begin, length, wrap = menv_ranges(st)
    cum = torch.cumsum(length, 1)
    total = cum[:, -1]
    cum = cum - length  # each range's first place in the item's walk
    work = st.work.long()
    nitems = work.shape[0]
    slot = torch.arange(K7_CENTRES)
    qi = work[:, :1] + slot[None, :]
    active = qi < work[:, 1:]
    ci = torch.where(active, st.query.long()[qi.clamp_max(st.query.numel() - 1)], 0)
    kz = st.cells[2].long()
    rnd = st.periodic and min(st.ncs) < _SHIFT_MIN_CELLS
    acc = torch.zeros(ci.shape, dtype=torch.float64)
    found = []
    items = torch.arange(nitems)
    for pos in range(int(total.max()) if nitems else 0):
        live = pos < total
        r = (torch.searchsorted(cum, torch.full((nitems, 1), pos), right=True) - 1)[:, 0]
        j = begin[items, r] + pos - cum[items, r]
        j = torch.where(live, j, 0)
        dk = kz[j][:, None] - kz[ci]
        if st.periodic:
            nc2 = st.ncs[2]
            dk = torch.where(dk > 1, dk - nc2, torch.where(dk < -1, dk + nc2, dk))
        take = active & live[:, None] & (dk.abs() <= 1)
        d = []
        for a, col in enumerate((x, y, z)):
            da = col[ci] - col[j][:, None]
            if rnd:
                da = da - lbox * torch.round(da / lbox)
            elif st.periodic:
                da = da - (wrap[items, r, a].double() * lbox)[:, None]
            d.append(da)
        d2 = (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]
        ann = (d2 <= rout2).long() - (d2 <= rin2[ci]).long()
        mj = m[j][:, None].expand_as(acc)
        acc = torch.where(take & (ann > 0), acc + mj, torch.where(take & (ann < 0), acc - mj, acc))
        if pairs:
            found.append(torch.stack([ci[take], j[:, None].expand_as(ci)[take]], 1))
    if pairs:
        return torch.cat(found) if found else torch.zeros((0, 2), dtype=torch.int64)
    out[ci[active]] = acc[active]
    return out


def nfw_draw(n, c_max, seed):
    """`n` draws of x from P(x) ~ x / (1 + x)^2 on (0, c_max] (the NFW_draw
    of run_hod(want_nfw=True)), by the inverse of its cumulative m(x) =
    ln(1 + x) - x / (1 + x) on a table of 2e5 intervals; numpy, seeded."""
    x = np.linspace(0.0, c_max, 200_001)
    m = np.log1p(x) - x / (1 + x)
    u = np.random.default_rng(seed).random(n) * m[-1]
    return np.interp(u, m, x)


def smoothing_at_bin_centres(k_bin_edges):
    """A stand-in for ``ops.power.get_smoothing`` that gives every rfft mode
    exp(-kc^2 R^2 / 2), kc the centre of the k bin that ``bin_kmu`` puts the
    mode in (squared edges in units of the fundamental as float32,
    searchsorted left, clipped into the first and last bin), instead of the
    mode's own |k|. The k-level LCV flow smooths at the bin centres, so the
    field-level flow under this stand-in is the k-level flow's arithmetic:
    patched into ``models.zcv.tools_cv``, it shows that the two reciso flows
    differ only by where the smoothing is taken."""
    from .ops.power import _mode_geometry

    edges = np.asarray(k_bin_edges, np.float64)
    centres = 0.5 * (edges[1:] + edges[:-1])

    def get_smoothing(n1d, L, R, dtype=np.float32, device=None):
        n1d = int(n1d)
        kmag2, _, _ = _mode_geometry(n1d, device)
        dk = 2.0 * np.pi / L
        edges2 = torch.from_numpy(((edges / dk) ** 2).astype(np.float32)).to(kmag2.device)
        b = (torch.searchsorted(edges2, kmag2, side='left') - 1).clamp_(0, len(centres) - 1)
        kc = torch.from_numpy(centres).to(kmag2.device)[b]
        return torch.exp(-(kc * kc) * (R * R) / 2.0).to(torch.float32).reshape(
            n1d, n1d, n1d // 2 + 1)

    return get_smoothing
