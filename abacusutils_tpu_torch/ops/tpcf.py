r"""Pair counting and two-point correlation functions (PyTorch + two CUDA kernels).

Counterpart of abacusutils_tpu/ops/tpcf.py: DD counts on a periodic box with
analytic RR, Corrfunc conventions. Pairs are ordered (an autocorrelation
counts each unordered pair twice), ``i == j`` is excluded but coincident
distinct points count, separations take the minimum image, rp or s bins are
right-open on squared edges, pi = \|dz\| falls in unit bins below
``int(pimax)`` (``dz`` in ``[int(pimax), pimax)`` is dropped), mu = \|dz\|/s
(0 where s = 0) falls in ``nmu`` bins with the top bin clamped.

Two engines, as in the JAX package:

- the **cell engine** (``n1 >= 100_000`` or ``method='cell'``, and
  ``lbox // rmax >= 3``): :func:`stage_cells` wraps the points into
  ``[0, lbox)``, sorts them by the cell of an ``nc^3`` grid with one stable
  sort and cuts the cells into a work list of at most :data:`CHUNK` points an
  item, all on the points' device; :func:`count_pairs_cells` launches K4
  (``csrc/pair_count.cu:pair_count_cells``) over the items, which walks each
  item's 27 neighbour cells (14 for an autocorrelation, the mirrored ones
  doubled). All arithmetic is float32. There are no occupancy classes, padded
  layouts or per-class programs: the kernel reads the sorted columns and the
  cell starts.
- the **all-pairs engine** (small catalogs, ``method='tile'``, boxes under
  three cells): :func:`count_pairs_all` launches K5 (``pair_count_all``) on
  every pair with the per-pair minimum image, in float32 or, with
  ``dtype=torch.float64``, in double (the JAX tiled engine computes in double
  when x64 is enabled). Positions are not wrapped first, as there.

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

from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from ..convert import resolve_device
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
    'edges_f32',
    'candidate_pairs',
    'count_pairs_cells',
    'count_pairs_cells_plain',
    'count_pairs_all',
    'count_pairs_all_plain',
]

MODES = ('rppi', 'smu')
# the most points of the first side a K4 work item holds
CHUNK = 64
# threads of a K4 / K5 block (csrc/pair_count.cu)
K4_THREADS = 128
K5_THREADS = 128
# dynamic shared memory one H100 block may use (227 KB)
MAX_SMEM_BYTES = 232_448
# the all-pairs engine aims at this many blocks, so a small first set still
# fills the card
K5_MIN_BLOCKS = 1024
_CELL_MIN_N = 100_000  # below this the all-pairs engine wins on latency
_NC_MAX = 128  # the cell starts hold nc^3 + 1 offsets a stage
_STAGE_CACHE_LEN = 8  # tracers x grids of a multi-tracer loop
_stage_cache = []


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


# ---------------------------------------------------------------------------
# the cell stage and its work list
# ---------------------------------------------------------------------------


class CellStage(NamedTuple):
    """One catalog sorted by the cells of an nc^3 grid on a periodic box:
    `xs`, `ys`, `zs` the wrapped float32 columns in cell order, `starts` the
    int32 (nc^3 + 1,) offsets of the cells, `work` the int32 (nitems, 3)
    (cell, begin, end) items of at most :data:`CHUNK` points each, `max_occ`
    the largest cell's points."""

    xs: torch.Tensor
    ys: torch.Tensor
    zs: torch.Tensor
    starts: torch.Tensor
    work: torch.Tensor
    n: int
    nc: int
    lbox: float
    max_occ: int


def cell_key(x, y, z, lbox, nc):
    """The int32 cell key (ci(x) * nc + ci(y)) * nc + ci(z) with ci =
    clip(int(a * (nc / lbox)), 0, nc - 1), the scale an f32 division and the
    product an f32 product (tpcf.py:_stage_cells)."""
    inv = float(np.float32(nc) / np.float32(lbox))

    def ci(a):
        return (a * inv).to(torch.int32).clamp_(0, nc - 1)

    return (ci(x) * nc + ci(y)) * nc + ci(z)


def stage_cells(x, y, z, lbox, nc):
    """Sort wrapped float32 columns by cell and build the work list, on the
    columns' device (tpcf.py:_prep_cols, _stage_cells and _SideStage without
    the occupancy classes and padded layouts). One host sync reads the number
    of items and the largest cell."""
    n = x.shape[0]
    C = nc**3
    skey, order = torch.sort(cell_key(x, y, z, lbox, nc), stable=True)
    starts = torch.searchsorted(
        skey, torch.arange(C + 1, dtype=torch.int32, device=x.device)
    ).to(torch.int32)
    work = work_items(starts, n, CHUNK)
    occ = starts[1:] - starts[:-1]
    nitems, max_occ = torch.stack(
        [(work[:, 2] > work[:, 1]).sum(), occ.max().long()]
    ).tolist()
    stage_cells.builds += 1
    return CellStage(
        *(c.index_select(0, order) for c in (x, y, z)), starts, work[:nitems].contiguous(),
        n, nc, float(lbox), int(max_occ),
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


def _get_stage(pos, lbox, nc, device=None):
    key = _stage_key(pos)
    if key is not None:
        for ent in _stage_cache:
            if ent[0] == key and ent[1] == (lbox, nc):
                return ent[2]
    st = stage_cells(*_wrapped_columns(pos, lbox, device), lbox, nc)
    if key is not None:
        # hold a reference to pos so the ids in the key cannot be recycled
        _stage_cache.insert(0, (key, (lbox, nc), st, pos))
        del _stage_cache[_STAGE_CACHE_LEN:]
    return st


def _neighbour(c, d, nc):
    """Cell index c + d on one axis wrapped into [0, nc) and its wrap code w
    in {-1, 0, 1}: the minimum image subtracts w * lbox."""
    n = c + d
    w = (n >= nc).to(n.dtype) - (n < 0).to(n.dtype)
    return n - w * nc, w


def _offsets(autocorr):
    """The neighbour offsets in lexicographic order; an autocorrelation
    takes the centre and the 13 positive ones."""
    return [(o // 9 - 1, (o // 3) % 3 - 1, o % 3 - 1) for o in range(13 if autocorr else 0, 27)]


def candidate_pairs(stage1, stage2=None):
    """The pairs K4 evaluates: each point of the first side against every
    point of the neighbour cells its item walks (a Python int)."""
    autocorr = stage2 is None
    nc = stage1.nc
    occ_a = (stage1.starts[1:] - stage1.starts[:-1]).long().reshape(nc, nc, nc)
    b = stage1 if autocorr else stage2
    occ_b = (b.starts[1:] - b.starts[:-1]).long().reshape(nc, nc, nc)
    near = sum(torch.roll(occ_b, (-di, -dj, -dk), (0, 1, 2)) for di, dj, dk in _offsets(autocorr))
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


def count_pairs_all_plain(cols1, cols2, edges2, nb2, mode, lbox, aux=0.0, max_pairs=1 << 22):
    """K5's plain version: all pairs of cols1 = (x, y, z) against cols2
    (None: an autocorrelation, i == j excluded), a tile of cols1 rows at a
    time, with the per-pair minimum image in the columns' type, binned by
    `edges2` (the squared edges, taken in that type) and `nb2`; int64 (nb1 * nb2,) counts."""
    autocorr = cols2 is None
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
        if autocorr:
            i = torch.arange(i0, i0 + x1.shape[0], device=dev)
            flat = torch.where(i[:, None] != j[None, :], flat, nbins)
        total += torch.bincount(flat.reshape(-1), minlength=nbins + 1)
    return total[:-1]


def count_pairs_cells_plain(stage1, stage2, edges2, nb2, mode, aux=0.0, max_pairs=1 << 22):
    """K4's plain version, from the stage the kernel reads: for each neighbour
    offset, the pairs of every item's points with the neighbour cell's points
    are laid out flat (about `max_pairs` at a time), differenced, given the
    item's minimum image (nc >= 5: minus w * lbox; else the per-pair round),
    binned and counted with ``torch.bincount``; the mirrored offsets of an
    autocorrelation (stage2 None) count twice. int64 (nb1 * nb2,) counts."""
    autocorr = stage2 is None
    b = stage1 if autocorr else stage2
    nc, lbox = stage1.nc, _f32(stage1.lbox)
    dev = stage1.xs.device
    edges2 = _edges_tensor(edges2, torch.float32, dev)
    nbins = (edges2.numel() - 1) * nb2
    total = torch.zeros(nbins + 1, dtype=torch.int64, device=dev)
    cell, begin, end = stage1.work.long().unbind(1)
    na = end - begin
    ci, cj, ck = cell // (nc * nc), (cell // nc) % nc, cell % nc
    starts = b.starts.long()
    for di, dj, dk in _offsets(autocorr):
        (ni, wi), (nj, wj), (nk, wk) = _neighbour(ci, di, nc), _neighbour(cj, dj, nc), _neighbour(
            ck, dk, nc)
        ncell = (ni * nc + nj) * nc + nk
        sb = starts[ncell]
        nb = starts[ncell + 1] - sb
        pairs = na * nb
        cum = np.concatenate([[0], torch.cumsum(pairs, 0).cpu().numpy()])
        centre = (di, dj, dk) == (0, 0, 0)
        lo = 0
        while lo < len(pairs):
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
                if nc >= 5:
                    dx = ux - wi[item].to(torch.float32) * lbox
                    dy = uy - wj[item].to(torch.float32) * lbox
                    adz = (uz - wk[item].to(torch.float32) * lbox).abs()
                else:
                    dx, dy = _min_image_plain(ux, lbox), _min_image_plain(uy, lbox)
                    adz = _min_image_plain(uz, lbox).abs()
                flat = _bins_plain(dx, dy, adz, edges2, nb2, mode, aux)
                if autocorr and centre:
                    flat = torch.where(ia != jb, flat, nbins)
                counts = torch.bincount(flat, minlength=nbins + 1)
                total += counts if (centre or not autocorr) else 2 * counts
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


def count_pairs_cells(stage1, stage2, edges2, nb2, mode, aux=0.0):
    """Ordered pair counts of two cell stages (stage2 None: the
    autocorrelation of stage1, i == j skipped in the kernel) in nb1 x nb2
    bins: `edges2` the nb1 + 1 float32 squared edges (see :func:`edges_f32`),
    `nb2` the unit pi bins (``mode='rppi'``) or the mu bins (``'smu'``, `aux`
    = nmu as a float). Returns the int64 (nb1 * nb2,) counts on the stages'
    device, without waiting for it.

    On CUDA tensors this launches K4 (csrc/pair_count.cu) on the current
    stream; on CPU tensors it runs :func:`count_pairs_cells_plain`."""
    mode = _mode(mode)
    b = stage1 if stage2 is None else stage2
    dev = stage1.xs.device
    if (b.nc, b.lbox) != (stage1.nc, stage1.lbox) or b.xs.device != dev:
        raise ValueError('the two stages must share their grid, box and device')
    edges2 = _edges_tensor(edges2, torch.float32, dev)
    nb1, nb2 = edges2.numel() - 1, int(nb2)
    if dev.type == 'cpu':
        return count_pairs_cells_plain(stage1, stage2, edges2, nb2, mode, aux)
    for st, name in ((stage1, 'stage1'), (b, 'stage2')):
        _check_columns((st.xs, st.ys, st.zs), torch.float32, dev, name)
        if st.starts.dtype != torch.int32 or st.starts.shape != (st.nc**3 + 1,):
            raise ValueError(f'{name}.starts must be an int32 (nc^3 + 1,) tensor')
    work = stage1.work
    if work.dtype != torch.int32 or work.dim() != 2 or work.shape[1] != 3 or (
            not work.is_contiguous()):
        raise ValueError('stage1.work must be a contiguous (nitems, 3) int32 tensor')
    smem = 16 * K4_THREADS + 4 * (nb1 + 1) + 4 * nb1 * nb2
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f'{nb1} x {nb2} bins need {smem} B of shared memory, over '
                         f'{MAX_SMEM_BYTES} B')
    # a block's int32 histogram sees at most CHUNK points x 27 cells, doubled
    if 2 * 27 * CHUNK * b.max_occ >= 1 << 31:
        raise ValueError(f'a cell of {b.max_occ} points could overflow a block\'s int32 counts')
    out = torch.zeros(nb1 * nb2, dtype=torch.int64, device=dev)
    if work.shape[0] == 0 or b.n == 0:
        return out
    lib = _build.lib()
    with torch.cuda.device(dev):
        code = lib.pair_count_cells(
            stage1.xs.data_ptr(), stage1.ys.data_ptr(), stage1.zs.data_ptr(),
            b.xs.data_ptr(), b.ys.data_ptr(), b.zs.data_ptr(), b.starts.data_ptr(),
            work.data_ptr(), work.shape[0], stage1.nc, _f32(stage1.lbox), edges2.data_ptr(),
            nb1, nb2, _f32(aux), MODES.index(mode), int(stage2 is None), int(stage1.nc >= 5),
            out.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(code, 'pair_count_cells')
    count_pairs_cells.launches += 1
    count_pairs_cells.launches_by_form[mode] += 1
    return out


count_pairs_cells.launches = 0
count_pairs_cells.launches_by_form = dict.fromkeys(MODES, 0)


def count_pairs_all(cols1, cols2, edges2, nb2, mode, lbox, aux=0.0):
    """Ordered pair counts over all pairs of cols1 = (x, y, z) and cols2
    (None: the autocorrelation, i == j excluded) with the per-pair minimum
    image, computed in the columns' type (float32 or float64); `edges2` holds
    the nb1 + 1 squared edges. Returns the int64 (nb1 * nb2,) counts on the
    columns' device, without waiting for it.

    On CUDA tensors this launches K5 (csrc/pair_count.cu) on the current
    stream; on CPU tensors it runs :func:`count_pairs_all_plain`."""
    mode = _mode(mode)
    dev, dtype = cols1[0].device, cols1[0].dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f'columns must be float32 or float64, not {dtype}')
    edges2 = _edges_tensor(edges2, dtype, dev)
    nb1, nb2 = edges2.numel() - 1, int(nb2)
    if dev.type == 'cpu':
        return count_pairs_all_plain(cols1, cols2, edges2, nb2, mode, lbox, aux)
    _check_columns(cols1, dtype, dev, 'cols1')
    b = cols1 if cols2 is None else cols2
    _check_columns(b, dtype, dev, 'cols2')
    n1, n2 = cols1[0].shape[0], b[0].shape[0]
    size = 4 if dtype == torch.float32 else 8
    smem = size * (3 * K5_THREADS + nb1 + 1) + 4 * nb1 * nb2
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f'{nb1} x {nb2} bins need {smem} B of shared memory, over '
                         f'{MAX_SMEM_BYTES} B')
    out = torch.zeros(nb1 * nb2, dtype=torch.int64, device=dev)
    if n1 == 0 or n2 == 0:
        return out
    # rows of the second set a block takes: enough blocks to fill the card,
    # under 2^31 pairs a block (its int32 histogram) and 65,535 ranges
    iblocks = -(-n1 // K5_THREADS)
    splits = max(1, min(-(-K5_MIN_BLOCKS // iblocks), -(-n2 // K5_THREADS)))
    jchunk = max(-(-n2 // splits), -(-n2 // 65_535))
    jchunk = -(-jchunk // K5_THREADS) * K5_THREADS
    jchunk = min(jchunk, ((1 << 31) - 1) // K5_THREADS // K5_THREADS * K5_THREADS)
    lib = _build.lib()
    with torch.cuda.device(dev):
        code = lib.pair_count_all(
            *(c.data_ptr() for c in cols1), n1, *(c.data_ptr() for c in b), n2, jchunk,
            _lbox_as(dtype, lbox), edges2.data_ptr(), nb1, nb2, float(aux), MODES.index(mode),
            int(cols2 is None), int(dtype == torch.float64), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(code, 'pair_count_all')
    count_pairs_all.launches += 1
    count_pairs_all.launches_by_form[mode] += 1
    return out


count_pairs_all.launches = 0
count_pairs_all.launches_by_form = dict.fromkeys(MODES, 0)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def _cell_pair_counts(pos1, pos2, lbox, rmax, edges2, aux, mode, nb1, nb2, method, device):
    """The cell engine's counts, or None where it does not apply (fewer than
    three cells a side, too few points to matter, ``method='tile'``, or a cell
    so full that a block's int32 histogram could overflow). The grid is nc =
    lbox // rmax cells a side, at most 128: the kernel needs no cap, but every
    stage holds nc^3 + 1 cell starts and a finer grid gains nothing."""
    n1 = _npoints(pos1)
    autocorr = pos2 is None
    nc = int(lbox // rmax)
    if nc < 3 or method == 'tile' or (method != 'cell' and n1 < _CELL_MIN_N):
        return None
    nc = min(nc, _NC_MAX)
    side_a = _get_stage(pos1, lbox, nc, device)
    side_b = side_a if autocorr else _get_stage(pos2, lbox, nc, device)
    if 2 * 27 * CHUNK * side_b.max_occ >= 1 << 31:
        return None
    counts = count_pairs_cells(side_a, None if autocorr else side_b, edges_f32(edges2), nb2, mode,
                               aux)
    return counts.cpu().numpy().reshape(nb1, nb2)


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
    cell = _cell_pair_counts(pos1, pos2, lbox, rmax, edges2, aux, mode, nb1, nb2, method, device)
    if cell is not None:
        return cell
    autocorr = pos2 is None
    _check_tiled_feasible(_npoints(pos1), _npoints(pos1 if autocorr else pos2), lbox, rmax,
                          method=method)
    cols1 = _raw_columns(pos1, dtype, device)
    cols2 = None if autocorr else _raw_columns(pos2, dtype, cols1[0].device)
    thr = edges_f32(edges2) if dtype == torch.float32 else edges2
    counts = count_pairs_all(cols1, cols2, thr, nb2, mode, lbox, aux)
    return counts.cpu().numpy().reshape(nb1, nb2)


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
