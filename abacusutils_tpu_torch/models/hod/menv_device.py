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
halo), and the neighbour cells of its ``_axis_neighbors`` (wrapped on a
periodic axis, where fewer than 3 cells alias and count once; none past an
open face). Then, on the device: one stable sort by cell, the cell starts
from ``bincount`` and a running sum, the centres above mcut, the work items
of :func:`_row_runs` (runs of occupied cells along z in one row, at most
:data:`K7_CENTRES` centres each), K7 (``csrc/prepare_sim.cu:menv_annulus``)
and an unsort back to input order.

Menv sums over the 27 cells around a halo's own, as the JAX package's
device engine does: for r_inner <= r_outer (cells of edge >= r_outer) that
is every halo of the annulus, the host tree's sum; a larger r_inner may
reach past those cells, and both device engines leave the halos there out.

Arithmetic is float64 throughout (Hopper has it natively: the JAX package's
double-float32 ``_tf`` twins for the TPU have no counterpart here). The
squared distances and the ball tests are the tree's, so the classification
equals cKDTree's; only the summation order differs, so Menv agrees with the
host engine to float64 round-off (rtol 1e-12) and its zeros are the same.
"""

from typing import NamedTuple

import numpy as np
import torch

from ... import _build
from ...convert import resolve_device
from ...ops.grid import work_items

__all__ = ['do_menv_device', 'menv_annulus', 'menv_annulus_plain', 'stage_menv', 'MenvStage',
           'K7_CENTRES']

# centres a K7 work item takes, a thread each: a block of one warp (on an
# H100, items of 64 and 128 centres, most lanes idle, took 1.2-1.3x longer;
# scripts/torch/k1m_k7_compare.py)
K7_CENTRES = 32
# a run of cells continues past up to RUN_GAP - 1 cells without a centre:
# the neighbour ranges of its two sides then touch or overlap, so one item
# walks no candidate that two would not
RUN_GAP = 3
# box grids of this many cells an axis or more take the minimum image from
# each neighbour range's wrap instead of a division (csrc/prepare_sim.cu)
_SHIFT_MIN_CELLS = 5
# cell ids are compressed densely (the occupied cells only, found by binary
# search in K7) from this many cells on: the JAX package's bound of the
# int32 sort keys; a grid of more than 8 cells a halo (plus 2^24) is
# compressed too, so the cell starts stay small beside the catalog
_DENSE_MIN_CELLS = 2**31 - 1
# centres of a chunk of the plain all-pairs sum: chunk x N pairs at once
_PLAIN_PAIRS = 1 << 24


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


class MenvStage(NamedTuple):
    """The device stage of :func:`do_menv_device`: `cols` the float64 x, y,
    z, m, r_inner^2 in cell order; `cells` the (3, N) int32 cell of each
    halo along each axis; `starts` the int32 cell offsets (cells + 1);
    `ukeys` the int64 raw id of each occupied cell where `starts` indexes
    them densely, else None; `ncs` the cells along each axis; `periodic`;
    `mcut`; `query` the int32 index of every centre above mcut; `work` the
    (nitems, 2) int32 (begin, end) items into `query` of :func:`_row_runs`;
    `order` the int64 sort order (sorted[i] = input[order[i]])."""

    cols: list
    cells: torch.Tensor
    starts: torch.Tensor
    ukeys: object
    ncs: tuple
    periodic: bool
    mcut: float
    query: torch.Tensor
    work: torch.Tensor
    order: torch.Tensor


def _check_menv(st, dev):
    cols = st.cols
    n = cols[0].shape[0]
    for name, t in zip(('x', 'y', 'z', 'm', 'rin2'), cols):
        if t.dtype != torch.float64 or t.shape != (n,) or not t.is_contiguous() or (
                t.device != dev):
            raise ValueError(f'{name} must be a contiguous ({n},) float64 tensor on {dev}')
    for name, t in (('cells', st.cells), ('starts', st.starts), ('query', st.query),
                    ('work', st.work)):
        if t.dtype != torch.int32 or not t.is_contiguous() or t.device != dev:
            raise ValueError(f'{name} must be a contiguous int32 tensor on {dev}')
    if st.cells.shape != (3, n):
        raise ValueError(f'cells must be (3, {n})')
    if st.work.dim() != 2 or st.work.shape[1] != 2:
        raise ValueError('work must be an (nitems, 2) int32 tensor')
    if st.ukeys is not None and (st.ukeys.dtype != torch.int64 or st.ukeys.device != dev):
        raise ValueError(f'ukeys must be an int64 tensor on {dev}')
    if n >= 2**31:
        raise ValueError(f'{n} halos exceed K7\'s int32 indices')


def neighbour_cells(ci, cj, ncs, periodic):
    """Whether cells ci and cj ((..., 3) int64 tensors, broadcast) are
    neighbours on every axis, the JAX package's 27 cells: at most one cell
    apart, across the seam of a periodic axis too, where fewer than 3 cells
    make every pair neighbours."""
    ok = None
    for a in range(3):
        d = cj[..., a] - ci[..., a]
        if periodic:
            d = torch.remainder(d + 1, int(ncs[a])) - 1
        near = d.abs() <= 1
        ok = near if ok is None else ok & near
    return ok


def menv_annulus_plain(x, y, z, m, rin2, cells, ncs, periodic, lbox, rout2, mcut, centres=None):
    """K7's function by a chunked all-pairs sum with its arithmetic: for each
    centre above mcut, sum_j m_j ([d2 <= rout2] - [d2 <= rin2_i]) over the
    halos j of the 27 cells around the centre's (:func:`neighbour_cells` of
    `cells`, the (3, N) cell of each halo along each axis, and `ncs`), d the
    minimum image dx - L round(dx / L) (half to even) when `periodic`; 0 for
    the other centres. Float64 in and out. `centres` (int64 indices, all
    above mcut) limits the sums to those centres; the other entries are 0."""
    n = x.numel()
    out = torch.zeros(n, dtype=torch.float64, device=x.device)
    if centres is None:
        centres = torch.nonzero(m > mcut).flatten()
    chunk = max(1, _PLAIN_PAIRS // max(n, 1))
    cell = cells.long().T

    def diff(a, ac):
        d = ac[:, None] - a[None, :]
        return d - lbox * torch.round(d / lbox) if periodic else d

    for c0 in range(0, centres.numel(), chunk):
        idx = centres[c0:c0 + chunk]
        dx, dy, dz = diff(x, x[idx]), diff(y, y[idx]), diff(z, z[idx])
        d2 = (dx * dx + dy * dy) + dz * dz
        ann = (d2 <= rout2).to(torch.int8) - (d2 <= rin2[idx][:, None]).to(torch.int8)
        i, j = torch.nonzero(ann, as_tuple=True)
        far = ~neighbour_cells(cell[idx[i]], cell[j], ncs, periodic)
        ann[i[far], j[far]] = 0
        out[idx] = (ann.to(torch.float64) * m[None, :]).sum(dim=1)
    return out


def menv_annulus(st, lbox, rout2):
    """Annulus mass sums of the halos of the :class:`MenvStage` `st`, in
    cell order (float64, 0 at or below st.mcut); `lbox` the box (0 in a
    light cone), `rout2` r_outer^2.

    On CUDA tensors this launches K7 (csrc/prepare_sim.cu) once, on the
    current stream: a block of K7_CENTRES threads an item of st.work. On CPU
    tensors it runs :func:`menv_annulus_plain`."""
    dev = st.cols[0].device
    if dev.type == 'cpu':
        return menv_annulus_plain(*st.cols, st.cells, st.ncs, st.periodic, lbox, rout2, st.mcut)
    _check_menv(st, dev)
    n = st.cols[0].numel()
    out = torch.zeros(n, dtype=torch.float64, device=dev)
    if st.work.shape[0] == 0:
        return out
    rnd = bool(st.periodic and min(st.ncs) < _SHIFT_MIN_CELLS)
    lib = _build.lib()
    with torch.cuda.device(dev):
        code = lib.menv_annulus(
            *(c.data_ptr() for c in st.cols), st.cells.data_ptr(), n, st.starts.data_ptr(),
            None if st.ukeys is None else st.ukeys.data_ptr(),
            0 if st.ukeys is None else st.ukeys.numel(), *(int(v) for v in st.ncs),
            int(st.periodic), float(lbox), float(rout2), st.query.data_ptr(),
            st.work.data_ptr(), st.work.shape[0], K7_CENTRES, int(rnd), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(code, 'menv_annulus')
    menv_annulus.launches += 1
    return out


menv_annulus.launches = 0


def _row_runs(kcells, ncs, periodic):
    """K7's work items over the centres with cells `kcells` ((3, nq) int64,
    in sorted order): runs of consecutive centres in one (i, j) row whose z
    cells lie at most RUN_GAP apart, cut into items of at most K7_CENTRES
    centres. On a periodic axis of 3 cells or more a run stays within one
    group of nc - 2 cells, so that its neighbour range, a cell more on each
    side, holds no cell twice; along fewer cells the range is the whole
    row. Returns the (nitems, 2) int32 (begin, end) items into the
    centres."""
    nq = kcells.shape[1]
    dev = kcells.device
    nc2 = int(ncs[2])
    span = nc2 - 2 if periodic and nc2 >= 3 else nc2
    ci, cj, ck = kcells
    group = (ci * int(ncs[1]) + cj) * -(-nc2 // span) + torch.div(ck, span, rounding_mode='floor')
    brk = torch.ones(nq, dtype=torch.bool, device=dev)
    brk[1:] = (group[1:] != group[:-1]) | (ck[1:] - ck[:-1] > RUN_GAP)
    starts = torch.cat([torch.nonzero(brk).flatten(), torch.tensor([nq], device=dev)])
    work = work_items(starts, nq, K7_CENTRES)
    return work[work[:, 2] > work[:, 1]][:, 1:].contiguous()


def stage_menv(pos, mass, r_inner, r_outer, halo_lc, Lbox, device, mcut=1e11):
    """The host preparation and the device sort of :func:`do_menv_device`:
    returns the :class:`MenvStage` of the catalog on `device`."""
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
    ukeys = None if cell_of_dense is None else up(cell_of_dense, np.int64)
    raw = skey if ukeys is None else ukeys[skey]
    nc1, nc2 = int(ncs[1]), int(ncs[2])
    cells = torch.stack([raw // (nc1 * nc2), (raw // nc2) % nc1, raw % nc2])
    query = torch.nonzero(cols[3] > mcut).flatten()
    work = _row_runs(cells[:, query], ncs, periodic)
    return MenvStage(cols, cells.to(torch.int32), starts.to(torch.int32), ukeys,
                     tuple(int(c) for c in ncs), periodic, float(mcut), query.to(torch.int32),
                     work.to(torch.int32), order)


def do_menv_device(pos, mass, r_inner, r_outer, halo_lc, Lbox, mcut=1e11, device=None):
    """Menv of every halo on `device` (None: the card; 'cpu' runs the plain
    version), the contract of
    abacusutils_tpu/models/hod/menv_device.py:do_menv_device.

    pos (N, 3), mass (N,), r_inner scalar or (N,), r_outer scalar. Returns
    an (N,) float64 numpy array (0 for halos at or below mcut)."""
    device = resolve_device(device)
    mass = np.asarray(mass, np.float64)
    if len(mass) == 0:
        return np.zeros(0, np.float64)
    r_outer = float(np.asarray(r_outer))
    st = stage_menv(pos, mass, r_inner, r_outer, halo_lc, Lbox, device, float(mcut))
    out = menv_annulus(st, Lbox if st.periodic else 0.0, r_outer * r_outer)
    menv = torch.empty_like(out)
    menv[st.order] = out
    return menv.cpu().numpy()
