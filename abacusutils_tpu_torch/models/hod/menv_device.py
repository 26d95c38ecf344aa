r"""Local mass environment on the card: grid-binned annulus mass sums (K7).

Counterpart of abacusutils_tpu/models/hod/menv_device.py with the contract
of :func:`~.menv.do_Menv_from_tree`: Menv(halo) = the mass of all halos
within r_outer minus that within r_inner (both balls closed, the self mass
cancels), for halos above mcut; the periodic minimum image in a box, none in
a light cone.

The host preparation is the JAX package's, line for line: the box wrap
``(pos + Lbox/2) % Lbox``, cell ids on cells of edge >= r_outer (the light
cone's grid spans the catalog), the dense compression of the ids when the
grid has 2^31 - 1 cells or more (here also where it has more than 8 cells a
halo), and :func:`_axis_neighbors`. Then, on the
device: one stable sort by cell, the cell starts from ``bincount`` and a
running sum, work items of at most :data:`K7_CENTRES` centres of one cell
(ops/grid.py:work_items), K7 (``csrc/prepare_sim.cu:menv_annulus``) and an
unsort back to input order.

Arithmetic is float64 throughout (Hopper has it natively: the JAX package's
double-float32 ``_tf`` twins for the TPU have no counterpart here). The
squared distances and the ball tests are the tree's, so the classification
equals cKDTree's; only the summation order differs, so Menv agrees with the
host engine to float64 round-off (rtol 1e-12) and its zeros are the same.
"""

import numpy as np
import torch

from ... import _build
from ...convert import resolve_device
from ...ops.grid import work_items

__all__ = ['do_menv_device', 'menv_annulus', 'menv_annulus_plain', 'K7_CENTRES']

# centres of one cell a K7 work item (and block) takes
K7_CENTRES = 64
# cell ids are compressed densely (the occupied cells only, found by binary
# search in K7) from this many cells on: the JAX package's bound of the
# int32 sort keys; a grid of more than 8 cells a halo (plus 2^24) is
# compressed too, so the cell starts stay small beside the catalog
_DENSE_MIN_CELLS = 2**31 - 1
# centres of a chunk of the plain all-pairs sum: chunk x N pairs at once
_PLAIN_PAIRS = 1 << 24


def _axis_neighbors(n, periodic):
    """Neighbour index table (n, 3) per axis with -1 for absent slots:
    wrapped and deduplicated for periodic axes (n < 3 aliases offsets),
    clamped for open axes (menv_device.py:_axis_neighbors)."""
    ci = np.arange(n)[:, None]
    cand = ci + np.array([-1, 0, 1])[None, :]
    if periodic:
        cand = cand % n
        out = np.full((n, 3), -1, np.int64)
        for i in range(n):
            u = np.unique(cand[i])
            out[i, : len(u)] = u
        return out
    return np.where((cand >= 0) & (cand < n), cand, -1)


def _cell_keys(pos, r_outer, halo_lc, Lbox):
    """The JAX package's host preparation (menv_device.py:483-517): the
    coordinates the sums use (wrapped into the box, or as float64 in a
    light cone), the cells along each axis, each halo's cell id, whether the
    axes are periodic, and the sorted raw ids of the occupied cells where the
    ids were compressed densely (else None)."""
    pos = np.asarray(pos)
    if halo_lc:
        pos = np.asarray(pos, np.float64)
        periodic = False
        mn = pos.min(axis=0)
        span = np.maximum(pos.max(axis=0) - mn, 1e-9)
        ncs = np.maximum((span // r_outer).astype(np.int64), 1)
        h = span / ncs  # >= r_outer
        cell = [
            np.clip(((pos[:, a] - mn[a]) / h[a]).astype(np.int64), 0, ncs[a] - 1)
            for a in range(3)
        ]
    else:
        pos = (pos + Lbox / 2.0) % Lbox
        periodic = True
        nc1 = max(int(Lbox // r_outer), 1)
        ncs = np.array([nc1, nc1, nc1], np.int64)
        h = np.array([Lbox / nc1] * 3, np.float64)
        cell = [np.clip((pos[:, a] / h[a]).astype(np.int64), 0, nc1 - 1) for a in range(3)]
    C = int(ncs.prod())
    key = (cell[0] * ncs[1] + cell[1]) * ncs[2] + cell[2]
    # int32 cell starts: compress cell ids densely when the raw id space
    # overflows (full-sky light-cone grids, nearly all empty)
    if C >= _DENSE_MIN_CELLS or C > 8 * len(key) + (1 << 24):
        cell_of_dense, key = np.unique(key, return_inverse=True)
    else:
        cell_of_dense = None
    return pos, ncs, key, periodic, cell_of_dense


def _check_menv(cols, starts, work, dev):
    n = cols[0].shape[0]
    for name, t in zip(('x', 'y', 'z', 'm', 'rin2'), cols):
        if t.dtype != torch.float64 or t.shape != (n,) or not t.is_contiguous() or (
                t.device != dev):
            raise ValueError(f'{name} must be a contiguous ({n},) float64 tensor on {dev}')
    for name, t in (('starts', starts), ('work', work)):
        if t.dtype != torch.int32 or not t.is_contiguous() or t.device != dev:
            raise ValueError(f'{name} must be a contiguous int32 tensor on {dev}')
    if work.dim() != 2 or work.shape[1] != 3:
        raise ValueError('work must be an (nitems, 3) int32 tensor')
    if n >= 2**31:
        raise ValueError(f'{n} halos exceed K7\'s int32 indices')


def menv_annulus_plain(x, y, z, m, rin2, periodic, lbox, rout2, mcut, centres=None):
    """K7's function by a chunked all-pairs sum with its arithmetic: for each
    centre above mcut, sum_j m_j ([d2 <= rout2] - [d2 <= rin2_i]) over every
    halo j, d the minimum image dx - L round(dx / L) (half to even) when
    `periodic`; 0 for the other centres. The cells only prune pairs that
    cannot count, so this is K7's function. Float64 in and out. `centres`
    (int64 indices, all above mcut) limits the sums to those centres; the
    other entries are 0."""
    n = x.numel()
    out = torch.zeros(n, dtype=torch.float64, device=x.device)
    if centres is None:
        centres = torch.nonzero(m > mcut).flatten()
    chunk = max(1, _PLAIN_PAIRS // max(n, 1))

    def diff(a, ac):
        d = ac[:, None] - a[None, :]
        return d - lbox * torch.round(d / lbox) if periodic else d

    for c0 in range(0, centres.numel(), chunk):
        idx = centres[c0:c0 + chunk]
        dx, dy, dz = diff(x, x[idx]), diff(y, y[idx]), diff(z, z[idx])
        d2 = (dx * dx + dy * dy) + dz * dz
        ann = (d2 <= rout2).to(torch.int8) - (d2 <= rin2[idx][:, None]).to(torch.int8)
        out[idx] = (ann.to(torch.float64) * m[None, :]).sum(dim=1)
    return out


def menv_annulus(cols, starts, ukeys, nbrs, ncs, periodic, lbox, rout2, mcut, work):
    """Annulus mass sums of the halos sorted by cell.

    cols: (x, y, z, m, rin2), contiguous float64 (N,) tensors in cell order;
    starts: the int32 cell offsets (cells + 1); ukeys: the int64 raw id of
    each occupied cell where `starts` indexes them densely, else None; nbrs:
    the three int32 (nc, 3) neighbour tables of :func:`_axis_neighbors`; ncs:
    the cells along each axis; work: the int32 (cell, begin, end) items of
    :func:`~abacusutils_tpu_torch.ops.grid.work_items`. Returns Menv in cell
    order (float64, 0 at or below mcut).

    On CUDA tensors this launches K7 (csrc/prepare_sim.cu) on the current
    stream; on CPU tensors it runs :func:`menv_annulus_plain`."""
    dev = cols[0].device
    if dev.type == 'cpu':
        return menv_annulus_plain(*cols, periodic, lbox, rout2, mcut)
    _check_menv(cols, starts, work, dev)
    for t in nbrs:
        if t.dtype != torch.int32 or t.dim() != 2 or t.shape[1] != 3 or t.device != dev:
            raise ValueError(f'each neighbour table must be an (nc, 3) int32 tensor on {dev}')
    if ukeys is not None and (ukeys.dtype != torch.int64 or ukeys.device != dev):
        raise ValueError(f'ukeys must be an int64 tensor on {dev}')
    out = torch.empty(cols[0].numel(), dtype=torch.float64, device=dev)
    lib = _build.lib()
    with torch.cuda.device(dev):
        code = lib.menv_annulus(
            *(c.data_ptr() for c in cols), starts.data_ptr(),
            None if ukeys is None else ukeys.data_ptr(), 0 if ukeys is None else ukeys.numel(),
            *(t.data_ptr() for t in nbrs), *(int(v) for v in ncs), int(periodic),
            float(lbox), float(rout2), float(mcut), work.data_ptr(), work.shape[0],
            out.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(code, 'menv_annulus')
    menv_annulus.launches += 1
    return out


menv_annulus.launches = 0


def stage_menv(pos, mass, r_inner, r_outer, halo_lc, Lbox, device):
    """The host preparation and the device sort of :func:`do_menv_device`:
    returns (the float64 columns x, y, z, m, rin2 in cell order, the cell
    starts, ukeys, the neighbour tables, ncs, periodic, the work items, the
    int64 sort order)."""
    mass = np.asarray(mass, np.float64)
    n = len(mass)
    r_inner = np.broadcast_to(np.asarray(r_inner, np.float64), (n,))
    pos, ncs, key, periodic, cell_of_dense = _cell_keys(pos, r_outer, halo_lc, Lbox)
    ncell = len(cell_of_dense) if cell_of_dense is not None else int(ncs.prod())

    def up(a, dt):
        return torch.from_numpy(np.ascontiguousarray(a, dt)).to(device)

    skey, order = torch.sort(up(key, np.int64), stable=True)
    cols = [up(pos[:, a], np.float64)[order] for a in range(3)]
    # r_inner^2 on the host in float64, as the JAX package squares it
    cols += [up(mass, np.float64)[order], up(r_inner * r_inner, np.float64)[order]]
    counts = torch.bincount(skey, minlength=ncell)
    starts = torch.zeros(ncell + 1, dtype=torch.int64, device=device)
    torch.cumsum(counts, 0, out=starts[1:])
    starts = starts.to(torch.int32)
    work = work_items(starts, n, K7_CENTRES)
    nbrs = [up(_axis_neighbors(int(c), periodic), np.int32) for c in ncs]
    ukeys = None if cell_of_dense is None else up(cell_of_dense, np.int64)
    return cols, starts, ukeys, nbrs, ncs, periodic, work, order


def do_menv_device(pos, mass, r_inner, r_outer, halo_lc, Lbox, mcut=1e11, device=None):
    """Menv of every halo on `device` (None: the card; 'cpu' runs the plain
    all-pairs version), the contract of
    abacusutils_tpu/models/hod/menv_device.py:do_menv_device.

    pos (N, 3), mass (N,), r_inner scalar or (N,), r_outer scalar. Returns
    an (N,) float64 numpy array (0 for halos at or below mcut)."""
    device = resolve_device(device)
    mass = np.asarray(mass, np.float64)
    if len(mass) == 0:
        return np.zeros(0, np.float64)
    r_outer = float(np.asarray(r_outer))
    cols, starts, ukeys, nbrs, ncs, periodic, work, order = stage_menv(
        pos, mass, r_inner, r_outer, halo_lc, Lbox, device)
    out = menv_annulus(cols, starts, ukeys, nbrs, ncs, periodic,
                       Lbox if periodic else 0.0, r_outer * r_outer, float(mcut), work)
    menv = torch.empty_like(out)
    menv[order] = out
    return menv.cpu().numpy()
