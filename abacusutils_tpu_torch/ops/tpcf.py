r"""Pair counting and two-point correlation functions (PyTorch + two CUDA kernels).

Counterpart of abacusutils_tpu/ops/tpcf.py: DD counts on a periodic box with
analytic RR, Corrfunc conventions. Pairs are ordered (an autocorrelation
counts each unordered pair twice), ``i == j`` is excluded but coincident
distinct points count, separations take the minimum image, rp or s bins are
right-open on squared edges, pi = \|dz\| falls in unit bins below
``int(pimax)`` (``dz`` in ``[int(pimax), pimax)`` is dropped), mu = \|dz\|/s
(0 where s = 0) falls in ``nmu`` bins with the top bin clamped.

Two engines, as in the JAX package:

- the **cell engine** (``n1 >= _CELL_MIN_N`` or ``method='cell'``, and
  ``lbox // rmax >= 3``): :func:`stage_cells` wraps the points into
  ``[0, lbox)``, sorts them by the cell of an ``nc^3`` grid with one stable
  sort and cuts runs of up to ``span`` consecutive cells of a (ci, cj) row
  into a work list of at most :data:`CHUNK` points an item, all on the
  points' device. The grid is :func:`cell_grid`'s: cells of rmax / 2 a side
  where they still hold :data:`_FINE_MIN_OCC` points of the sparser side a
  cell, else of rmax. :func:`count_pairs_cells` launches K4
  (``csrc/pair_count.cu:pair_count_cells``) over the items; each walks the
  rows of cells of :func:`walk_rows`: those whose nearest corner lies within
  the largest edge, and within pimax along z (for an autocorrelation the
  centre row and the lexicographically positive ones, doubled). All
  arithmetic is float32. There are no occupancy classes, padded layouts or
  per-class programs: the kernel reads the sorted columns and the cell
  starts. The counts do not depend on the grid.
- the **all-pairs engine** (small catalogs, ``method='tile'``, boxes under
  three cells): :func:`count_pairs_all` launches K5 (``pair_count_all``) on
  every pair with the per-pair minimum image, in float32 or, with
  ``dtype=torch.float64``, in double (the JAX tiled engine computes in double
  when x64 is enabled). Positions are not wrapped first, as there. Where
  both sets lie within one period the kernel takes the round of ``d / lbox``
  from two compares with :func:`round_threshold`, which is the same number.

**Which engine, and what follows from it.** Each engine equals the JAX
package's engine of the same name bin for bin. The two engines equal each
other on positions inside ``[0, lbox)``. On positions outside it (a galaxy
that RSD moved past a face) the cell engine wraps each coordinate in float32
first and the all-pairs engine differences the coordinates as they are, so a
pair's float32 ``r2`` can differ in its last bits and a pair at a bin edge
can change its bin. The JAX package sends catalogs under 100,000 points to
its tiled engine; this package sends those from :data:`_CELL_MIN_N` = 25,000
points on to the cell engine, which is faster on the card, unless a
coordinate of either side lies outside ``[0, lbox)``: those go to the
all-pairs engine, so the default counts equal JAX's default counts at every
size. ``method='tile'`` gives JAX's tiled counts at any size,
``method='cell'`` its cell counts.

On CPU tensors each wrapper runs its plain PyTorch version
(:func:`count_pairs_cells_plain`, :func:`count_pairs_all_plain`); on CUDA
tensors it launches its kernel or raises.

**Thresholds.** The squared bin edges are formed in float64 on the host. The
float32 engines compare a float32 ``r2`` against them; ``r2 >= e`` for a
float64 ``e`` is ``r2 >= (the smallest float32 >= e)``, so
:func:`edges_f32` rounds each squared edge **up** to float32 and the kernels
compare float32 values: the counts are those of the exact comparison, which
is also what the JAX package computes with x64 enabled. With x64 disabled
JAX rounds the squared edges to the nearest float32 instead; the two differ
only for a pair whose ``r2`` is exactly the float32 just below an edge.

The stage of a tensor input is cached (at most 8 stages) by the tensors'
identity and version counter, so ``wp``, ``xi(rp, pi)`` and the multipoles
of one catalog, and the autos and crosses of a multi-tracer mock, share it;
an in-place edit of a cached column restages.
"""

import math
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from ..convert import resolve_device
from ..utils import profiling
from .grid import _f32, work_items

__all__ = [
    'CHUNK',
    'CellStage',
    'calc_xirppi_fast',
    'calc_wp_fast',
    'calc_multipole_fast',
    'tpcf_multipole',
    'pair_counts_rppi',
    'pair_counts_smu',
    'stage_cells',
    'cell_grid',
    'walk_rows',
    'round_threshold',
    'edges_f32',
    'bin_lut',
    'candidate_pairs',
    'candidate_pairs_coarse',
    'count_pairs_cells',
    'count_pairs_cells_plain',
    'count_pairs_all',
    'count_pairs_all_plain',
]

MODES = ('rppi', 'smu')
# the most points of the first side a K4 work item holds
CHUNK = 64
# consecutive cells of one (ci, cj) row a K4 work item spans: as many as hold
# ITEM_POINTS points at the catalog's mean density, at most SPAN_MAX; SPAN
# where the density is not given
SPAN = 2
SPAN_MAX = 4
ITEM_POINTS = 16
# threads of a K4 / K5 block, the rows of a K4 walk and of a K5 block, and the
# blocks' static shared memory (csrc/pair_count.cu)
K4_THREADS = 128
K4_MAX_ROWS = 25
K5_THREADS = 128
K5_ROWS = 512
K4_STATIC_SMEM = 10_240
K5_STATIC_SMEM = 3_072
# shared memory one H100 block may use (227 KB)
MAX_SMEM_BYTES = 232_448
# the all-pairs engine aims at this many blocks, so a small first set still
# fills the card
K5_MIN_BLOCKS = 1024
_CELL_MIN_N = 25_000  # below this the all-pairs engine wins on latency
# below this many points JAX's default is its tiled engine
# (abacusutils_tpu/ops/tpcf.py:_CELL_MIN_N); from _CELL_MIN_N up to it the
# default dispatch sends catalogs with a coordinate outside [0, lbox) to the
# all-pairs engine too, whose counts equal JAX's tiled ones there
_JAX_CELL_MIN_N = 100_000
# the cell starts hold nc^3 + 1 offsets a stage (16 MB at 160^3); the finest
# grid measured on the card is the main path's 133^3
_NC_MAX = 160
_FINE_MIN_OCC = 2.0  # points of the sparser side a cell of a finer grid must hold
_STAGE_CACHE_LEN = 8  # tracers x grids of a multi-tracer loop
_stage_cache = []
_span_cache = []


# ---------------------------------------------------------------------------
# input forms
# ---------------------------------------------------------------------------


def _is_soa(pos):
    """True for the SoA form: an (x, y, z) tuple/list of 1-D columns.

    A plain nested list of exactly three (x, y, z) POINTS also has length 3:
    only a tuple, or a list whose elements are 1-D arrays or tensors already,
    is read as columns; a list of lists keeps the (N, 3) point reading."""
    if not isinstance(pos, (tuple, list)) or len(pos) != 3:
        return False
    if all(isinstance(c, (np.ndarray, torch.Tensor)) and c.ndim == 1 for c in pos):
        return True
    return isinstance(pos, tuple) and not any(np.ndim(c) != 1 for c in pos)


def _npoints(pos):
    return len(pos[0]) if _is_soa(pos) else len(pos)


def _host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _to_aos(pos):
    """An (N, 3) host array from either input form."""
    if _is_soa(pos):
        return np.stack([_host(c) for c in pos], axis=1)
    return _host(pos)


def _tensor_columns(pos):
    """The three columns of a tensor input (an (N, 3) tensor or three 1-D
    tensors), or None for a host input."""
    if isinstance(pos, torch.Tensor):
        return [pos[:, i] for i in range(3)]
    if _is_soa(pos) and all(isinstance(c, torch.Tensor) for c in pos):
        return list(pos)
    return None


def _wrapped_columns(pos, lbox, device):
    """x, y, z wrapped into [0, lbox) as contiguous float32 tensors
    (tpcf.py:_prep_cols and the host branch of _SideStage): tensors stay on
    their device and are wrapped in their own type, host data is wrapped in
    float64 and goes to `device` (the card when None)."""
    cols = _tensor_columns(pos)
    if cols is not None:
        return [torch.remainder(c, _f32(lbox) if c.dtype == torch.float32 else lbox)
                .to(torch.float32).contiguous() for c in cols]
    p = np.mod(_to_aos(pos).astype(np.float64), lbox).astype(np.float32)
    device = resolve_device(device)
    return [torch.from_numpy(np.ascontiguousarray(p[:, i])).to(device) for i in range(3)]


def _raw_columns(pos, dtype, device):
    """x, y, z as contiguous `dtype` tensors, not wrapped (the all-pairs
    engine takes the minimum image of every pair)."""
    cols = _tensor_columns(pos)
    if cols is not None:
        return [c.to(dtype).contiguous() for c in cols]
    p = _to_aos(pos).astype(np.float64)
    device = resolve_device(device)
    return [torch.from_numpy(np.ascontiguousarray(p[:, i])).to(dtype).to(device)
            for i in range(3)]


def edges_f32(edges2):
    """Squared edges (float64) as float32 thresholds, each rounded **up** to
    the smallest float32 not below it, so that a float32 ``r2 >= t`` is the
    exact ``r2 >= e``. Returns a float32 numpy array."""
    e = np.asarray(edges2, np.float64)
    t = e.astype(np.float32)
    low = t.astype(np.float64) < e
    t[low] = np.nextafter(t[low], np.float32(np.inf))
    return t


LUT_MAX_CELLS = 2048


def bin_lut(edges2, f64=False):
    """The kernels' table from the leading bits of r2 to its bin along the
    first axis, for ascending squared edges of the kernels' type (float32
    thresholds, or float64): ``(edge, base, shift, key0)`` or None.

    The key of a non-negative value is its leading 32 bits (the float32, or
    the high word of the float64) shifted right by `shift`, less `key0`, and
    at least 0; cell `key` spans the values that share it, cell 0 every value
    below the cell of the first inner edge. ``base[key]`` counts the inner
    edges at or below the cell's lowest value and ``edge[key]`` is the one
    inner edge inside the cell (+inf where there is none), so ``b1 =
    base[key] + (r2 >= edge[key])``. `shift` starts at the exponent alone and
    keeps one more mantissa bit until no cell holds two edges; None where
    that takes more than :data:`LUT_MAX_CELLS` cells (the kernels then
    compare against every edge)."""
    T, mant = (np.float64, 20) if f64 else (np.float32, 23)
    e = np.ascontiguousarray(edges2, T)
    if e.ndim != 1 or len(e) < 2 or e[0] < 0 or not (np.diff(e) > 0).all() or not np.isfinite(
            e).all():
        return None
    bits = (e.view(np.int64) if f64 else e.view(np.int32).astype(np.int64))
    low = 32 if f64 else 0  # bits below the leading 32
    inner = e[1:-1]
    if len(inner) == 0:
        return np.full(1, np.inf, T), np.zeros(1, np.int32), mant, int(bits[-1] >> (mant + low))
    for shift in range(mant, -1, -1):
        key = bits >> (shift + low)
        key0 = int(key[1]) - 1
        ncell = int(key[-1]) - key0 + 1
        if ncell > LUT_MAX_CELLS:
            return None
        cell = (key[1:-1] - key0).astype(np.int64)
        at_floor = bits[1:-1] == (key[1:-1] << (shift + low))
        inside = cell[~at_floor]
        if len(np.unique(inside)) < len(inside):
            continue
        edge = np.full(ncell, np.inf, T)
        edge[inside] = inner[~at_floor]
        # inner edges at or below each cell's lowest value: those of earlier
        # cells, and the ones that are a cell's lowest value
        below = np.bincount(cell + np.where(at_floor, 0, 1), minlength=ncell + 1)[:ncell]
        base = np.cumsum(below).astype(np.int32)
        return edge, base, shift, key0
    return None


_lut_cache = {}


def _lut_tensors(edges_host, f64, device):
    """(edge tensor, base tensor, ncell, shift, key0) of :func:`bin_lut` on
    `device`, uploaded once a set of edges; ncell 0 where there is no table."""
    key = (edges_host.tobytes(), f64, str(device))
    if key not in _lut_cache:
        if len(_lut_cache) >= 64:
            _lut_cache.clear()
        lut = bin_lut(edges_host, f64)
        if lut is None:
            _lut_cache[key] = (None, None, 0, 0, 0)
        else:
            edge, base, shift, key0 = lut
            _lut_cache[key] = (torch.from_numpy(edge).to(device), torch.from_numpy(base).to(device),
                               len(edge), shift, key0)
    return _lut_cache[key]


# ---------------------------------------------------------------------------
# the cell stage and its work list
# ---------------------------------------------------------------------------


class CellStage(NamedTuple):
    """One catalog sorted by the cells of an nc^3 grid on a periodic box:
    `xs`, `ys`, `zs` the wrapped float32 columns in cell order, `starts` the
    int32 (nc^3 + 1,) offsets of the cells, `work` the int32 (nitems, 3)
    (group, begin, end) items of at most :data:`CHUNK` points each, a group
    being `span` consecutive cells of one (ci, cj) row (the last group of a
    row may be shorter; ceil(nc / span) groups a row), `max_occ` the largest
    cell's points."""

    xs: torch.Tensor
    ys: torch.Tensor
    zs: torch.Tensor
    starts: torch.Tensor
    work: torch.Tensor
    n: int
    nc: int
    lbox: float
    max_occ: int
    span: int = 1

    @property
    def groups_per_row(self):
        return -(-self.nc // self.span)


def _cell_scale(lbox, nc):
    """nc / lbox as the float32 quotient the stage and K4 multiply by."""
    return float(np.float32(nc) / np.float32(lbox))


def cell_index(a, lbox, nc):
    """The int32 cell of a coordinate: clip(int(a * (nc / lbox)), 0, nc - 1),
    the scale an f32 division and the product an f32 product
    (tpcf.py:_stage_cells)."""
    return (a * _cell_scale(lbox, nc)).to(torch.int32).clamp_(0, nc - 1)


def cell_key(x, y, z, lbox, nc):
    """The int32 cell key (ci(x) * nc + ci(y)) * nc + ci(z) of
    :func:`cell_index`."""
    return (cell_index(x, lbox, nc) * nc + cell_index(y, lbox, nc)) * nc + cell_index(z, lbox, nc)


def default_span(nc, reach=1, n=None):
    """The cells of a row a work item may span on an nc^3 grid walked with
    `reach` cells along z: as many as hold :data:`ITEM_POINTS` of the
    catalog's `n` points at its mean density (:data:`SPAN` where n is None),
    at most :data:`SPAN_MAX`, and few enough that the item's cells and the
    reach on both sides fit the box once. A sparse catalog gets longer items,
    so that a block still has points to share a tile among."""
    want = SPAN if n is None else min(SPAN_MAX, -(-ITEM_POINTS * nc**3 // max(n, 1)))
    return max(1, min(want, nc - 2 * reach))


def stage_cells(x, y, z, lbox, nc, span=None):
    """Sort wrapped float32 columns by cell and build the work list, on the
    columns' device (tpcf.py:_prep_cols, _stage_cells and _SideStage without
    the occupancy classes and padded layouts): one stable sort by cell key,
    the cell starts from a count of the keys, and the items of runs of `span`
    cells (default :func:`default_span`). One host sync reads the number of
    items and the largest cell."""
    n = x.shape[0]
    C = nc**3
    span = default_span(nc) if span is None else int(span)
    skey, order = torch.sort(cell_key(x, y, z, lbox, nc), stable=True)
    occ = torch.bincount(skey, minlength=C)
    starts = torch.zeros(C + 1, dtype=torch.int32, device=x.device)
    starts[1:] = torch.cumsum(occ, 0)
    # the groups' first cells: every span-th cell of each row, then the end
    gpr = -(-nc // span)
    first = (torch.arange(nc * nc, device=x.device)[:, None] * nc
             + torch.arange(gpr, device=x.device)[None, :] * span).reshape(-1)
    first = torch.cat([first, first.new_tensor([C])])
    work = work_items(starts[first], n, CHUNK)
    nitems, max_occ = torch.stack([(work[:, 2] > work[:, 1]).sum(), occ.max()]).tolist()
    stage_cells.builds += 1
    return CellStage(
        *(c.index_select(0, order) for c in (x, y, z)), starts, work[:nitems].contiguous(),
        n, nc, float(lbox), int(max_occ), span,
    )


stage_cells.builds = 0


def _stage_key(pos):
    """The cache key of a tensor input: each tensor's identity and version
    counter (an in-place edit bumps the version); None for host data, which
    is never cached."""
    if isinstance(pos, torch.Tensor):
        return ((id(pos), pos._version),)
    if _is_soa(pos) and all(isinstance(c, torch.Tensor) for c in pos):
        return tuple((id(c), c._version) for c in pos)
    return None


def _get_stage(pos, lbox, nc, device=None, span=None):
    span = default_span(nc) if span is None else span
    key = _stage_key(pos)
    with profiling.span('abacus.cell_stage'):
        if key is not None:
            for ent in _stage_cache:
                if ent[0] == key and ent[1] == (lbox, nc, span):
                    return ent[2]
        st = stage_cells(*_wrapped_columns(pos, lbox, device), lbox, nc, span)
        if key is not None:
            # hold a reference to pos so the ids in the key cannot be recycled
            _stage_cache.insert(0, (key, (lbox, nc, span), st, pos))
            del _stage_cache[_STAGE_CACHE_LEN:]
        return st


def cell_grid(lbox, rmax, n_sparse):
    """(nc, refine) of the cell engine's grid: cells of rmax / 2 a side
    (refine 2, a walk of up to 5 x 5 rows of cells) where that grid stays
    within :data:`_NC_MAX` cells a side and holds at least
    :data:`_FINE_MIN_OCC` of the `n_sparse` points a cell; else (refine 1)
    the grid of lbox // rmax cells, capped at :data:`_NC_MAX`. The counts are
    the same on every grid; the finer one walks fewer candidate pairs and
    more cells."""
    nc = int(lbox * 2 // rmax)
    if nc <= _NC_MAX and n_sparse >= _FINE_MIN_OCC * nc**3:
        return nc, 2
    return min(int(lbox // rmax), _NC_MAX), 1


class Walk(NamedTuple):
    """The cells a K4 item visits: `rows` the int32 (nrows, 4) (di, dj, Kd,
    multiplicity) rows of cells, each walked over the item's cells widened by
    Kd cells along z; `reach` the largest offset on any axis; `use_wrap`
    whether the grid is wide enough for the item-constant minimum image."""

    rows: np.ndarray
    reach: int
    reach_z: int
    use_wrap: bool


def _reach(limit, cell):
    """Cells from a point's own that may hold a point nearer than `limit`
    along one axis."""
    return max(1, math.ceil(limit / cell - 1e-9))


@lru_cache(maxsize=64)
def walk_rows(nc, lbox, edge2_max, nb2, mode, autocorr):
    """The :class:`Walk` of an nc^3 grid for bins that end at the squared edge
    `edge2_max` (rp for ``'rppi'``, with |dz| < nb2; s for ``'smu'``). A row
    (di, dj) of cells is kept when the gap between the nearest corners,
    (|d| - 1) cells an axis less a thousandth of a cell for the rounding of
    the cell index, lies within the largest edge; Kd is the reach along z,
    for ``'smu'`` the cells the remaining distance allows. An
    autocorrelation keeps the centre row, once, and the lexicographically
    positive rows, twice."""
    cell = lbox / nc
    limit = math.sqrt(edge2_max)
    rxy = _reach(limit, cell)
    rz = _reach(float(nb2) if mode == 'rppi' else limit, cell)

    def gap(d):
        return max((abs(d) - 1.001) * cell, 0.0)

    rows = []
    for di in range(-rxy, rxy + 1):
        for dj in range(-rxy, rxy + 1):
            g2 = gap(di) ** 2 + gap(dj) ** 2
            if g2 >= edge2_max:
                continue
            if autocorr and (di, dj) < (0, 0):
                continue
            kd = rz
            if mode == 'smu':
                kd = max(k for k in range(rz + 1) if g2 + gap(k) ** 2 < edge2_max)
            rows.append((di, dj, kd, 2 if autocorr and (di, dj) != (0, 0) else 1))
    reach = max(rxy, rz)
    return Walk(np.asarray(rows, np.int32).reshape(-1, 4), reach, rz, nc >= 2 * reach + 3)


_rows_cache = {}


def _rows_tensor(walk, device):
    """The walk's rows on `device`, uploaded once a walk and device."""
    key = (walk.rows.tobytes(), str(device))
    if key not in _rows_cache:
        if len(_rows_cache) >= 64:
            _rows_cache.clear()
        _rows_cache[key] = torch.from_numpy(walk.rows).to(device).contiguous()
    return _rows_cache[key]


def _check_walk(stage1, walk):
    nc = stage1.nc
    if len(walk.rows) > K4_MAX_ROWS:
        raise ValueError(f'a walk of {len(walk.rows)} rows of cells exceeds the kernel\'s '
                         f'{K4_MAX_ROWS}: the grid of {nc} cells is too fine for these bins')
    if nc < 2 * walk.reach + 1 or stage1.span + 2 * walk.reach_z > nc:
        raise ValueError(f'a grid of {nc} cells a side (items of {stage1.span}) is too small for '
                         f'a walk of {walk.reach} cells: a cell would be visited twice')


def _item_rows(stage):
    """ci, cj of each work item's row and k0, k1, its first and last cell
    along z (int64 tensors), as K4 reads them."""
    nc = stage.nc
    group, begin, end = stage.work.long().unbind(1)
    row = group // stage.groups_per_row
    k0 = cell_index(stage.zs[begin], stage.lbox, nc).long()
    k1 = cell_index(stage.zs[end - 1], stage.lbox, nc).long()
    return row // nc, row % nc, k0, k1, begin, end


def _neighbour(c, d, nc):
    """Cell index c + d on one axis wrapped into [0, nc) and its wrap code w
    in {-1, 0, 1}: the minimum image subtracts w * lbox."""
    n = c + d
    w = (n >= nc).to(n.dtype) - (n < 0).to(n.dtype)
    return n - w * nc, w


def _pieces(stage1, b, walk):
    """Yield, for each row of the walk and each of its up to three pieces
    (inside the box along z, below 0, past nc - 1), (sb, nb, wi, wj, wk,
    mult): per item the begin and length of the piece in b's sorted columns,
    its wrap codes and the row's multiplicity. Pieces no item has are
    skipped."""
    nc = stage1.nc
    ci, cj, k0, k1, _, _ = _item_rows(stage1)
    starts = b.starts.long()
    zero = torch.zeros_like(k0)
    for di, dj, kd, mult in walk.rows.tolist():
        (ni, wi), (nj, wj) = _neighbour(ci, di, nc), _neighbour(cj, dj, nc)
        base = (ni * nc + nj) * nc
        klo, khi = k0 - kd, k1 + kd
        for ka, kb, wk in (
            (klo.clamp(min=0), khi.clamp(max=nc - 1), 0),
            (klo + nc, zero + (nc - 1), -1),
            (zero, khi - nc, 1),
        ):
            have = ka <= kb
            if not bool(have.any()):
                continue
            ka, kb = torch.where(have, ka, zero), torch.where(have, kb, zero - 1)
            sb = starts[base + ka]
            yield sb, starts[base + kb + 1] - sb, wi, wj, zero + wk, mult


def _pair_walk(stage1, stage2, edges2, nb2, mode):
    edges2 = np.asarray(_host(edges2), np.float64)
    return walk_rows(stage1.nc, stage1.lbox, float(edges2[-1]), int(nb2), _mode(mode),
                     stage2 is None)


def candidate_pairs(stage1, stage2, edges2, nb2, mode):
    """The pairs K4 evaluates for these bins: each point of the first side
    against every point of the pieces its item streams (a Python int)."""
    walk = _pair_walk(stage1, stage2, edges2, nb2, mode)
    b = stage1 if stage2 is None else stage2
    _, _, _, _, begin, end = _item_rows(stage1)
    na = end - begin
    return sum(int((na * nb).sum()) for _, nb, *_ in _pieces(stage1, b, walk))


def candidate_pairs_coarse(stage1, stage2, nc):
    """The pairs a walk of the 27 neighbour cells (the centre and the 13
    lexicographically positive ones for an autocorrelation, stage2 None) of an
    nc^3 grid evaluates on the stages' points, whatever grid they were staged
    on: the work the pair-count bound is stated for (a Python int)."""
    def occupancy(st):
        key = cell_key(st.xs, st.ys, st.zs, st.lbox, nc)
        return torch.bincount(key, minlength=nc**3).reshape(nc, nc, nc)

    autocorr = stage2 is None
    occ_a = occupancy(stage1)
    occ_b = occ_a if autocorr else occupancy(stage2)
    offsets = [(o // 9 - 1, (o // 3) % 3 - 1, o % 3 - 1) for o in range(13 if autocorr else 0, 27)]
    near = sum(torch.roll(occ_b, (-di, -dj, -dk), (0, 1, 2)) for di, dj, dk in offsets)
    return int((occ_a * near).sum())


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _min_image_plain(d, lbox):
    return d - lbox * torch.round(d / lbox)


def _bins_plain(dx, dy, adz, edges2, nb2, mode, aux):
    """The flat bin of each pair, nb1 * nb2 for a pair outside every bin.
    Every product and sum is its own rounded operation; the root of a float32
    r2 is taken in float64 and rounded once, which is the correctly rounded
    float32 root."""
    nb1 = edges2.numel() - 1
    r2 = dx * dx + dy * dy
    if mode == 'smu':
        r2 = r2 + adz * adz
    b1 = torch.searchsorted(edges2, r2, right=True) - 1
    ok = (b1 >= 0) & (b1 < nb1)
    if mode == 'rppi':
        ok &= adz < nb2
        b2 = adz.to(torch.int64)
    else:
        s = r2.double().sqrt().to(r2.dtype)
        mu = torch.where(s > 0, adz / s, torch.zeros_like(s))
        b2 = (mu * aux).to(torch.int64).clamp_(max=nb2 - 1)
    return torch.where(ok, b1 * nb2 + b2, nb1 * nb2)


def _lbox_as(dtype, lbox):
    return _f32(lbox) if dtype == torch.float32 else float(lbox)


def count_pairs_all_plain(cols1, cols2, edges2, nb2, mode, lbox, aux=0.0, max_pairs=1 << 22,
                          row0=None):
    """K5's plain version: all pairs of cols1 = (x, y, z) against cols2
    (None: an autocorrelation, i == j excluded), a tile of cols1 rows at a
    time, with the per-pair minimum image in the columns' type, binned by
    `edges2` (the squared edges, taken in that type) and `nb2`; int64 (nb1 * nb2,) counts.
    row0: cols1 are the rows row0 .. of cols2, a shard of an autocorrelation,
    and the pair of row row0 + i with itself is excluded."""
    autocorr = cols2 is None
    skip = autocorr or row0 is not None
    row0 = 0 if row0 is None else int(row0)
    x2, y2, z2 = cols1 if autocorr else cols2
    n1, n2 = cols1[0].shape[0], x2.shape[0]
    dev, dtype = x2.device, x2.dtype
    lb = _lbox_as(dtype, lbox)
    edges2 = _edges_tensor(edges2, dtype, dev)
    nbins = (edges2.numel() - 1) * nb2
    total = torch.zeros(nbins + 1, dtype=torch.int64, device=dev)
    tile = max(1, max_pairs // max(n2, 1))
    j = torch.arange(n2, device=dev)
    for i0 in range(0, n1, tile):
        x1, y1, z1 = (c[i0:i0 + tile, None] for c in cols1)
        dx = _min_image_plain(x1 - x2[None, :], lb)
        dy = _min_image_plain(y1 - y2[None, :], lb)
        adz = _min_image_plain(z1 - z2[None, :], lb).abs()
        flat = _bins_plain(dx, dy, adz, edges2, nb2, mode, aux)
        if skip:
            i = torch.arange(row0 + i0, row0 + i0 + x1.shape[0], device=dev)
            flat = torch.where(i[:, None] != j[None, :], flat, nbins)
        total += torch.bincount(flat.reshape(-1), minlength=nbins + 1)
    return total[:-1]


def count_pairs_cells_plain(stage1, stage2, edges2, nb2, mode, aux=0.0, max_pairs=1 << 22):
    """K4's plain version, from the stage and the walk the kernel reads: for
    each row of :func:`walk_rows` and each piece of it, the pairs of every
    item's points with the piece's points are laid out flat (about
    `max_pairs` at a time), differenced, given the piece's minimum image
    (``walk.use_wrap``: minus w * lbox; else the per-pair round), binned and
    counted with ``torch.bincount``; the doubled rows of an autocorrelation
    (stage2 None) count twice and the pair of a point with itself is left
    out. int64 (nb1 * nb2,) counts."""
    autocorr = stage2 is None
    b = stage1 if autocorr else stage2
    walk = _pair_walk(stage1, stage2, edges2, nb2, mode)
    _check_walk(stage1, walk)
    lbox = _f32(stage1.lbox)
    dev = stage1.xs.device
    edges2 = _edges_tensor(edges2, torch.float32, dev)
    nbins = (edges2.numel() - 1) * nb2
    total = torch.zeros(nbins + 1, dtype=torch.int64, device=dev)
    begin, end = stage1.work[:, 1].long(), stage1.work[:, 2].long()
    na = end - begin
    for sb, nb, wi, wj, wk, mult in _pieces(stage1, b, walk):
        pairs = na * nb
        cum = np.concatenate([[0], torch.cumsum(pairs, 0).cpu().numpy()])
        lo = 0
        while lo < len(pairs) and cum[lo] < cum[-1]:
            hi = max(int(np.searchsorted(cum, cum[lo] + max_pairs, side='right')) - 1, lo + 1)
            P = pairs[lo:hi]
            tot = int(cum[hi] - cum[lo])
            if tot:
                item = torch.repeat_interleave(torch.arange(lo, hi, device=dev), P, output_size=tot)
                local = torch.arange(tot, device=dev) - (torch.cumsum(P, 0) - P)[item - lo]
                ia = begin[item] + local // nb[item]
                jb = sb[item] + local % nb[item]
                ux = stage1.xs[ia] - b.xs[jb]
                uy = stage1.ys[ia] - b.ys[jb]
                uz = stage1.zs[ia] - b.zs[jb]
                if walk.use_wrap:
                    dx = ux - wi[item].to(torch.float32) * lbox
                    dy = uy - wj[item].to(torch.float32) * lbox
                    adz = (uz - wk[item].to(torch.float32) * lbox).abs()
                else:
                    dx, dy = _min_image_plain(ux, lbox), _min_image_plain(uy, lbox)
                    adz = _min_image_plain(uz, lbox).abs()
                flat = _bins_plain(dx, dy, adz, edges2, nb2, mode, aux)
                if autocorr:
                    flat = torch.where(ia != jb, flat, nbins)
                total += mult * torch.bincount(flat, minlength=nbins + 1)
            lo = hi
    return total[:-1]


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check_columns(cols, dtype, device, name):
    n = cols[0].shape[0]
    for c in cols:
        if c.dtype != dtype or c.shape != (n,) or not c.is_contiguous() or c.device != device:
            raise ValueError(f'{name} must be contiguous ({n},) {dtype} tensors on {device}')
    if n >= 1 << 31:
        raise ValueError(f'{name}: {n} points exceed the kernels\' 32-bit indices')


def _edges_tensor(edges2, dtype, device):
    if isinstance(edges2, torch.Tensor):
        e = edges2.to(device=device, dtype=dtype).contiguous()
    else:
        e = torch.from_numpy(np.ascontiguousarray(edges2)).to(device=device, dtype=dtype)
    if e.dim() != 1 or e.numel() < 2:
        raise ValueError('edges2 must hold at least two squared edges')
    return e


def _mode(mode):
    if mode not in MODES:
        raise ValueError(f'unknown pair-count mode {mode!r}, not one of {MODES}')
    return mode


def _hist_copies(nb1, nb2, size, static, ncell=0):
    """Shared int32 histograms a block keeps (one a warp where they fit, else
    one) and the dynamic shared memory they and the edges (or the bin table
    of `ncell` cells) take."""
    head = (size + 4) * ncell if ncell else size * (nb1 + 1)
    head = -(-head // 16) * 16
    for ncopy in (K4_THREADS // 32, 1):
        smem = head + 4 * nb1 * nb2 * ncopy
        if smem + static <= MAX_SMEM_BYTES:
            return ncopy, smem
    raise ValueError(f'{nb1} x {nb2} bins need {smem + static} B of shared memory, over '
                     f'{MAX_SMEM_BYTES} B')


def _block_overflows(stage1, b, walk):
    """True where a block's int32 histogram could overflow: an item's CHUNK
    points against the fullest cells of every piece, doubled."""
    cells = sum(stage1.span + 2 * int(kd) for kd in walk.rows[:, 2])
    return 2 * CHUNK * cells * b.max_occ >= 1 << 31


def count_pairs_cells(stage1, stage2, edges2, nb2, mode, aux=0.0):
    """Ordered pair counts of two cell stages (stage2 None: the
    autocorrelation of stage1, without the pairs i == j) in nb1 x nb2
    bins: `edges2` the nb1 + 1 float32 squared edges (see :func:`edges_f32`;
    host data, or a tensor that is read back once), `nb2` the unit pi bins
    (``mode='rppi'``) or the mu bins (``'smu'``, `aux` = nmu as a float).
    Returns the int64 (nb1 * nb2,) counts on the stages' device, without
    waiting for it.

    On CUDA tensors this launches K4 (csrc/pair_count.cu) on the current
    stream; on CPU tensors it runs :func:`count_pairs_cells_plain`."""
    mode = _mode(mode)
    b = stage1 if stage2 is None else stage2
    dev = stage1.xs.device
    if (b.nc, b.lbox) != (stage1.nc, stage1.lbox) or b.xs.device != dev:
        raise ValueError('the two stages must share their grid, box and device')
    edges_host = np.asarray(_host(edges2), np.float32)
    edges2 = _edges_tensor(edges2, torch.float32, dev)
    nb1, nb2 = edges2.numel() - 1, int(nb2)
    if dev.type == 'cpu':
        return count_pairs_cells_plain(stage1, stage2, edges2, nb2, mode, aux)
    walk = _pair_walk(stage1, stage2, edges_host, nb2, mode)
    _check_walk(stage1, walk)
    for st, name in ((stage1, 'stage1'), (b, 'stage2')):
        _check_columns((st.xs, st.ys, st.zs), torch.float32, dev, name)
        if st.starts.dtype != torch.int32 or st.starts.shape != (st.nc**3 + 1,) or (
                not st.starts.is_contiguous()):
            raise ValueError(f'{name}.starts must be a contiguous int32 (nc^3 + 1,) tensor')
    work = stage1.work
    if work.dtype != torch.int32 or work.dim() != 2 or work.shape[1] != 3 or (
            not work.is_contiguous()):
        raise ValueError('stage1.work must be a contiguous (nitems, 3) int32 tensor')
    if b.n >= 1 << 30:
        raise ValueError(f'stage2: {b.n} points exceed the tile entries\' 30-bit indices')
    lut_edge, lut_base, ncell, shift, key0 = _lut_tensors(edges_host, False, dev)
    ncopy, _ = _hist_copies(nb1, nb2, 4, K4_STATIC_SMEM, ncell)
    if _block_overflows(stage1, b, walk):
        raise ValueError(f'a cell of {b.max_occ} points could overflow a block\'s int32 counts')
    out = torch.zeros(nb1 * nb2, dtype=torch.int64, device=dev)
    if work.shape[0] == 0 or b.n == 0:
        return out
    rows = _rows_tensor(walk, dev)
    skip_self = int(stage2 is None and float(edges_host[0]) <= 0.0)
    lib = _build.lib()
    with torch.cuda.device(dev):
        code = lib.pair_count_cells(
            stage1.xs.data_ptr(), stage1.ys.data_ptr(), stage1.zs.data_ptr(),
            b.xs.data_ptr(), b.ys.data_ptr(), b.zs.data_ptr(), b.starts.data_ptr(),
            work.data_ptr(), work.shape[0], rows.data_ptr(), rows.shape[0], stage1.nc,
            stage1.groups_per_row, _cell_scale(stage1.lbox, stage1.nc), _f32(stage1.lbox),
            edges2.data_ptr(), nb1, nb2, _f32(aux), MODES.index(mode), int(walk.use_wrap),
            skip_self, ncopy, lut_edge.data_ptr() if ncell else None,
            lut_base.data_ptr() if ncell else None, ncell, shift, key0, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(code, 'pair_count_cells')
    count_pairs_cells.launches += 1
    count_pairs_cells.launches_by_form[mode] += 1
    return out


count_pairs_cells.launches = 0
count_pairs_cells.launches_by_form = dict.fromkeys(MODES, 0)


@lru_cache(maxsize=64)
def round_threshold(lbox, f64=False):
    """The largest value t of the type (float32, or float64) whose rounded
    quotient t / lbox rounds (half to even) to 0. Division is monotone, so
    for |d| < 1.5 lbox ``round(d / lbox) == (d > t) - (d < -t)``: K5 takes
    the minimum image of columns within one period from two compares.
    Found by stepping from lbox / 2 with the same rounded division."""
    T = np.float64 if f64 else np.float32
    lb = T(lbox)
    t = T(0.5) * lb
    while np.round(t / lb) == 0:
        t = np.nextafter(t, T(np.inf))
    while np.round(t / lb) != 0:
        t = np.nextafter(t, T(-np.inf))
    return float(t)


def _col_range(cols1, cols2):
    """The least and the greatest coordinate of the two sets (cols2 None:
    cols1 alone), per axis, as float64 numpy (3,) arrays, from one min/max
    reduction on the device, cached (at most 8) by the columns' identity and
    version."""
    both = list(cols1) + ([] if cols2 is None else list(cols2))
    key = tuple((id(c), c._version) for c in both)
    for ent in _span_cache:
        if ent[0] == key:
            return ent[1]
    lo = torch.stack([c.min() for c in both])
    hi = torch.stack([c.max() for c in both])
    lo, hi = torch.stack([lo, hi]).double().cpu().reshape(2, -1, 3).unbind(0)
    rng = (lo.min(0).values.numpy(), hi.max(0).values.numpy())
    # hold the columns so the ids in the key cannot be recycled
    _span_cache.insert(0, (key, rng, both))
    del _span_cache[_STAGE_CACHE_LEN:]
    return rng


def _one_period(cols1, cols2, lbox):
    """True where every difference of a coordinate of the two sets (cols2
    None: of cols1 with itself) lies within 1.49 lbox."""
    lo, hi = _col_range(cols1, cols2)
    return bool(((hi - lo) < 1.49 * lbox).all())


def _outside_box(cols1, cols2, lbox):
    """True where a coordinate of either set lies outside [0, lbox), in
    its own type or in float32 (the cell engine wraps float32 values)."""
    lo, hi = _col_range(cols1, cols2)
    return bool((lo < 0).any() or (hi >= lbox).any()
                or (hi.astype(np.float32) >= np.float32(lbox)).any())


def count_pairs_all(cols1, cols2, edges2, nb2, mode, lbox, aux=0.0, row0=None):
    """Ordered pair counts over all pairs of cols1 = (x, y, z) and cols2
    (None: the autocorrelation, i == j excluded) with the per-pair minimum
    image, computed in the columns' type (float32 or float64); `edges2` holds
    the nb1 + 1 squared edges. row0: cols1 are the rows row0 .. of cols2 (a
    row shard of an autocorrelation), and the pair of a row with itself is
    excluded by its index in cols2. Returns the int64 (nb1 * nb2,) counts on
    the columns' device.

    On CUDA tensors this launches K5 (csrc/pair_count.cu) on the current
    stream, after one reduction that tells whether the columns lie within
    one period (see :func:`round_threshold`); on CPU tensors it runs
    :func:`count_pairs_all_plain`."""
    mode = _mode(mode)
    dev, dtype = cols1[0].device, cols1[0].dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f'columns must be float32 or float64, not {dtype}')
    edges2 = _edges_tensor(edges2, dtype, dev)
    nb1, nb2 = edges2.numel() - 1, int(nb2)
    if row0 is not None and (
            cols2 is None or not 0 <= row0 <= cols2[0].shape[0] - cols1[0].shape[0]):
        raise ValueError(f'row0={row0}: cols1 must be rows of cols2')
    if dev.type == 'cpu':
        return count_pairs_all_plain(cols1, cols2, edges2, nb2, mode, lbox, aux, row0=row0)
    _check_columns(cols1, dtype, dev, 'cols1')
    b = cols1 if cols2 is None else cols2
    _check_columns(b, dtype, dev, 'cols2')
    n1, n2 = cols1[0].shape[0], b[0].shape[0]
    f64 = dtype == torch.float64
    edges_host = edges2.cpu().numpy()
    lut_edge, lut_base, ncell, shift, key0 = _lut_tensors(edges_host, f64, dev)
    ncopy, _ = _hist_copies(nb1, nb2, 8 if f64 else 4, (2 if f64 else 1) * K5_STATIC_SMEM // 2,
                            ncell)
    out = torch.zeros(nb1 * nb2, dtype=torch.int64, device=dev)
    if n1 == 0 or n2 == 0:
        return out
    # rows of the second set a block takes: enough blocks to fill the card,
    # under 2^31 pairs a block (its int32 histograms) and 65,535 ranges
    iblocks = -(-n1 // K5_ROWS)
    splits = max(1, min(-(-K5_MIN_BLOCKS // iblocks), -(-n2 // K5_THREADS)))
    jchunk = max(-(-n2 // splits), -(-n2 // 65_535))
    jchunk = -(-jchunk // K5_THREADS) * K5_THREADS
    jchunk = min(jchunk, ((1 << 31) - 1) // K5_ROWS // K5_THREADS * K5_THREADS)
    one_period = _one_period(cols1, cols2, lbox)
    skip_self = int((cols2 is None or row0 is not None) and float(edges_host[0]) <= 0.0)
    lib = _build.lib()
    with torch.cuda.device(dev):
        code = lib.pair_count_all(
            *(c.data_ptr() for c in cols1), n1, *(c.data_ptr() for c in b), n2, jchunk,
            _lbox_as(dtype, lbox), round_threshold(_lbox_as(dtype, lbox), f64),
            edges2.data_ptr(), nb1, nb2, float(aux), MODES.index(mode), skip_self, row0 or 0,
            int(f64),
            int(one_period), ncopy, lut_edge.data_ptr() if ncell else None,
            lut_base.data_ptr() if ncell else None, ncell, shift, key0, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(code, 'pair_count_all')
    count_pairs_all.launches += 1
    count_pairs_all.launches_by_form[mode] += 1
    if row0 is not None:
        count_pairs_all.launches_by_form[f'{mode} row offset'] += 1
    count_pairs_all.launches_one_period += int(one_period)
    return out


count_pairs_all.launches = 0
# launches of each mode, and within them those of a row shard of an
# autocorrelation ('<mode> row offset')
count_pairs_all.launches_by_form = dict.fromkeys(MODES + tuple(f'{m} row offset' for m in MODES),
                                                 0)
count_pairs_all.launches_one_period = 0


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def _cell_pair_counts(pos1, pos2, lbox, rmax, edges2, aux, mode, nb1, nb2, method, device):
    """The cell engine's counts, or None where it does not apply (fewer than
    three cells of rmax a side, too few points to matter, ``method='tile'``,
    or a cell so full that a block's int32 histogram could overflow). The
    grid is :func:`cell_grid`'s for the sparser of the two sides."""
    n1 = _npoints(pos1)
    autocorr = pos2 is None
    if int(lbox // rmax) < 3 or method == 'tile' or (method != 'cell' and n1 < _CELL_MIN_N):
        return None
    nc, refine = cell_grid(lbox, rmax, n1 if autocorr else min(n1, _npoints(pos2)))
    side_a = _get_stage(pos1, lbox, nc, device, default_span(nc, refine, n1))
    side_b = side_a if autocorr else _get_stage(
        pos2, lbox, nc, device, default_span(nc, refine, _npoints(pos2)))
    thr = edges_f32(edges2)
    walk = _pair_walk(side_a, None if autocorr else side_b, thr, nb2, mode)
    if _block_overflows(side_a, side_b, walk):
        return None
    counts = count_pairs_cells(side_a, None if autocorr else side_b, thr, nb2, mode, aux)
    return _host_counts(counts, nb1, nb2)


def _host_counts(counts, nb1, nb2):
    """The flat counts on the host, as an (nb1, nb2) array."""
    return profiling.count_copy(counts, counts.cpu()).numpy().reshape(nb1, nb2)


def _check_tiled_feasible(n1, n2, lbox, rmax, method=None):
    """The all-pairs engine is the only one left once the cell engine
    declines. It does N1 * N2 work: fail fast with the cause instead of
    running for hours on multi-million-point catalogs."""
    if n1 * n2 <= 2e12:
        return
    if method == 'tile':
        why = "method='tile' disabled the cell grid engine"
        advice = "drop method='tile' (or pass method='cell')"
    elif int(lbox // rmax) < 3:
        why = (
            f'rmax={rmax:g} leaves fewer than 3 grid cells in a '
            f'{lbox:g} box'
        )
        advice = 'reduce the maximum separation below lbox/3'
    else:
        why = (
            'the cell grid engine declined this workload (cell occupancy '
            'past the exact-histogram capacity bound)'
        )
        advice = 'subsample or split the densest regions'
    raise ValueError(
        f'{why}, and the O(N^2) fallback is infeasible at '
        f'{n1:.2g} x {n2:.2g} points. To proceed: {advice}, '
        'subsample, or split the catalog.'
    )


def _pair_counts(pos1, pos2, edges, nb2, mode, lbox, rmax, aux, method, device, dtype):
    if not (isinstance(pos1, torch.Tensor) or _is_soa(pos1)):
        pos1 = np.asarray(pos1, np.float64)
    edges2 = np.asarray(edges).astype(np.float64) ** 2
    nb1 = len(edges2) - 1
    autocorr = pos2 is None
    cols1 = cols2 = None
    engine = method
    if method is None and _CELL_MIN_N <= _npoints(pos1) < _JAX_CELL_MIN_N:
        # JAX's default counts these with its tiled engine, which does not
        # wrap: follow it where wrapping would move a point
        cols1 = _raw_columns(pos1, dtype, device)
        cols2 = None if autocorr else _raw_columns(pos2, dtype, cols1[0].device)
        if _outside_box(cols1, cols2, lbox):
            engine = 'tile'
    cell = _cell_pair_counts(pos1, pos2, lbox, rmax, edges2, aux, mode, nb1, nb2, engine, device)
    if cell is not None:
        return cell
    _check_tiled_feasible(_npoints(pos1), _npoints(pos1 if autocorr else pos2), lbox, rmax,
                          method=method)
    if cols1 is None:
        cols1 = _raw_columns(pos1, dtype, device)
        cols2 = None if autocorr else _raw_columns(pos2, dtype, cols1[0].device)
    thr = edges_f32(edges2) if dtype == torch.float32 else edges2
    counts = count_pairs_all(cols1, cols2, thr, nb2, mode, lbox, aux)
    return _host_counts(counts, nb1, nb2)


def pair_counts_rppi(pos1, rpbins, pimax, lbox, pos2=None, method=None, device=None,
                     dtype=torch.float32):
    """Ordered pair counts in (rp, unit-pi) bins on a periodic box
    (tpcf.py:pair_counts_rppi). Returns an (nrp, int(pimax)) int64 array;
    each unordered pair counts twice for the autocorrelation (Corrfunc's
    DDrppi convention).

    pos1, pos2: (N, 3) arrays or tensors, or (x, y, z) column tuples. Host
    data goes to `device` (the card when None, an error without one);
    tensors are counted where they lie. method: None picks the engine,
    'cell' forces the cell engine, 'tile' the all-pairs engine, which
    computes in `dtype` (float32, or float64 as JAX's does under x64)."""
    rpbins = np.asarray(rpbins)
    return _pair_counts(pos1, pos2, rpbins, int(pimax), 'rppi', lbox,
                        max(float(rpbins[-1]), float(pimax)), float(pimax), method, device, dtype)


def pair_counts_smu(pos1, sbins, nbins_mu, lbox, pos2=None, method=None, device=None,
                    dtype=torch.float32):
    """Ordered pair counts in (s, mu) bins on a periodic box
    (tpcf.py:pair_counts_smu); arguments as :func:`pair_counts_rppi`.
    Returns an (ns, nbins_mu) int64 array."""
    sbins = np.asarray(sbins)
    return _pair_counts(pos1, pos2, sbins, int(nbins_mu), 'smu', lbox, float(sbins[-1]),
                        float(nbins_mu), method, device, dtype)


# ---------------------------------------------------------------------------
# Reference-API wrappers (host numpy around the counts)
# ---------------------------------------------------------------------------


def tpcf_multipole(s_mu_tcpf_result, mu_bins, order=0):
    """Legendre multipole of xi(s, mu) (tpcf.py:tpcf_multipole)."""
    from numpy.polynomial import legendre as npleg

    s_mu_tcpf_result = np.atleast_1d(s_mu_tcpf_result)
    mu_bins = np.atleast_1d(mu_bins)
    order = int(order)
    mu_bin_centers = (mu_bins[:-1] + mu_bins[1:]) / 2.0
    c = np.zeros(order + 1)
    c[order] = 1.0
    Ln = lambda x: npleg.legval(x, c)  # noqa: E731
    return (
        (2.0 * order + 1.0)
        / 2.0
        * np.sum(
            s_mu_tcpf_result
            * np.diff(mu_bins)
            * (Ln(mu_bin_centers) + Ln(-mu_bin_centers)),
            axis=1,
        )
    )


def _resolve_pos(x1, y1, z1, x2, y2, z2, pos1, pos2):
    """The reference API takes x1/y1/z1 columns; pos1/pos2 are the staged
    form: pass the same tensors across calls (wp, xi and multipoles of one
    catalog) and the cell engine reuses its stage."""
    if pos1 is None:
        pos1 = np.stack([_host(x1), _host(y1), _host(z1)], axis=1)
    if pos2 is None and x2 is not None:
        pos2 = np.stack([_host(x2), _host(y2), _host(z2)], axis=1)
    ND1 = float(_npoints(pos1))
    ND2 = ND1 if pos2 is None else float(_npoints(pos2))
    return pos1, pos2, ND1, ND2


def calc_xirppi_fast(
    x1=None, y1=None, z1=None, rpbins=None, pimax=None, pi_bin_size=None,
    lbox=None, Nthread=None, num_cells=None, x2=None, y2=None, z2=None,
    pos1=None, pos2=None, device=None,
):
    """xi(rp, pi) with analytic RR (tpcf.py:calc_xirppi_fast)."""
    if not isinstance(pimax, int):
        raise ValueError('pimax needs to be an integer')
    if not isinstance(pi_bin_size, int):
        raise ValueError('pi_bin_size needs to be an integer')
    if pimax % pi_bin_size != 0:
        raise ValueError('pi_bin_size needs to be an integer divisor of pimax')

    pos1, pos2, ND1, ND2 = _resolve_pos(x1, y1, z1, x2, y2, z2, pos1, pos2)

    DD = pair_counts_rppi(pos1, rpbins, pimax, lbox, pos2=pos2, device=device)
    DD = DD.reshape(len(rpbins) - 1, pimax // pi_bin_size, pi_bin_size).sum(axis=2)

    rpbins = np.asarray(rpbins)
    RR = (
        np.pi * (rpbins[1:] ** 2 - rpbins[:-1] ** 2) * pi_bin_size / lbox**3 * ND1 * ND2 * 2
    )
    return DD / RR[:, None] - 1


def calc_wp_fast(
    x1=None, y1=None, z1=None, rpbins=None, pimax=None, lbox=None,
    Nthread=None, num_cells=None, x2=None, y2=None, z2=None,
    pos1=None, pos2=None, device=None,
):
    """wp(rp) = 2 sum_pi xi(rp, pi) (tpcf.py:calc_wp_fast)."""
    if not isinstance(pimax, int):
        raise ValueError('pimax needs to be an integer')
    pos1, pos2, ND1, ND2 = _resolve_pos(x1, y1, z1, x2, y2, z2, pos1, pos2)

    DD = pair_counts_rppi(pos1, rpbins, pimax, lbox, pos2=pos2, device=device)
    rpbins = np.asarray(rpbins)
    RR = np.pi * (rpbins[1:] ** 2 - rpbins[:-1] ** 2) / lbox**3 * ND1 * ND2 * 2
    xirppi = DD / RR[:, None] - 1
    return 2 * np.sum(xirppi, axis=1)


def calc_multipole_fast(
    x1=None, y1=None, z1=None, sbins=None, lbox=None, Nthread=None,
    nbins_mu=50, num_cells=None, x2=None, y2=None, z2=None, orders=(0, 2),
    pos1=None, pos2=None, device=None,
):
    """xi_ell(s) from (s, mu) counts (tpcf.py:calc_multipole_fast)."""
    pos1, pos2, ND1, ND2 = _resolve_pos(x1, y1, z1, x2, y2, z2, pos1, pos2)

    DD = pair_counts_smu(pos1, sbins, nbins_mu, lbox, pos2=pos2, device=device)
    sbins = np.asarray(sbins)
    mu_bins = np.linspace(0, 1, nbins_mu + 1)
    RR = (
        2 * np.pi / 3
        * (sbins[1:, None] ** 3 - sbins[:-1, None] ** 3)
        * np.diff(mu_bins)[None, :]
        / lbox**3
        * ND1 * ND2 * 2
    )
    xi_s_mu = DD / RR - 1
    return np.concatenate([tpcf_multipole(xi_s_mu, mu_bins, order=o) for o in orders])
