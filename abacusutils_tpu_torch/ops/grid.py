"""TSC/CIC mass assignment on cell-sorted points (PyTorch + a CUDA kernel).

Counterpart of abacusutils_tpu/ops/grid.py for the HOD and P(k) routes:

- :func:`cell_key_2d` and :func:`stage_grouped2d` group points by
  (x-cell, y-block) with one stable sort, as ``_stage_sort_by_cell`` does.
  There is no padded (ncell, K) layout: the CUDA deposit reads the sorted
  columns and the per-cell ``starts`` directly.
- :func:`paint_3d_plain` is the 27-point scatter of ``_paint_3d_jit``.
- :func:`tsc_deposit_cells` launches the shared-memory tile deposit K1
  (``csrc/tsc_deposit.cu``) on CUDA tensors and runs
  :func:`paint_3d_plain` on CPU tensors.
- :func:`paint_3d` is the public paint (``ops/grid.py:paint_3d``): stage
  and K1 on CUDA tensors, the plain scatter on CPU tensors.

Both kinds use the 3-point stencil of the JAX package: TSC wraps each
coordinate once into [0, box) and then adds the offset; CIC (weights
max(d, 0), 1 - |d|, max(-d, 0)) paints p + offset unwrapped, as
``get_field`` paints it (``paint_3d(..., kind='cic', wrap=False)``), and
takes its cell index modulo nmesh. Every f32 constant is formed as the JAX
package forms it (an f32 division, then used as an exact Python float), so
cell keys agree bit for bit.
"""

import numpy as np
import torch

from .. import _build

__all__ = [
    'KINDS',
    'axis_cloud',
    'cell_key_2d',
    'stage_grouped2d',
    'paint_3d_plain',
    'paint_3d',
    'tsc_deposit_cells',
    'check_deposit_err',
    'default_yblock',
    'MAX_SMEM_BYTES',
]

# dynamic shared memory one H100 block may use (227 KB)
MAX_SMEM_BYTES = 232_448
# the mass-assignment kinds; K1's template parameter is the index
KINDS = ('tsc', 'cic')


def _f32(v):
    """The float32 value of `v` as an exact Python float."""
    return float(np.float32(v))


def _inv_h(nmesh, box):
    return float(np.float32(nmesh) / np.float32(box))


def _tile_bytes(nmesh, yb):
    """Shared memory of one K1 block: the f32 (3, yb + 2, nmesh) tile."""
    return 4 * 3 * (yb + 2) * nmesh


def default_yblock(nmesh):
    """Largest power of two <= 32 that divides nmesh and whose K1 tile fits
    the shared memory of one block (ops/grid.py:default_yblock, which stops
    at the first divisor: its yb=32 tile at nmesh=1024 is 417,792 B). The
    spectra do not depend on yb, only the order of summation does."""
    yb = 32
    while yb >= 1:
        if nmesh % yb == 0 and _tile_bytes(nmesh, yb) <= MAX_SMEM_BYTES:
            return yb
        yb //= 2
    raise ValueError(f'no y-block tile of nmesh={nmesh} fits {MAX_SMEM_BYTES} B of shared memory')


def _wrap_once(p, box):
    """Single periodic wrap (ops/grid.py:_wrap_once)."""
    p = torch.where(p >= box, p - box, p)
    return torch.where(p < 0, p + box, p)


def _kind(kind):
    kind = kind.lower()
    if kind not in KINDS:
        raise ValueError(f'unknown mass assignment {kind!r}, not one of {KINDS}')
    return kind


def axis_cloud(p1d, box, offset, nmesh, wrap=True, kind='tsc'):
    """Per-axis centre index (int64, not yet taken modulo nmesh) and the
    three stencil weights for offsets (-1, 0, +1); the f32 arithmetic of
    ops/grid.py:_axis_cloud."""
    p1d = p1d.to(torch.float32)
    if wrap:
        p1d = _wrap_once(p1d, _f32(box))
    p = (p1d + _f32(offset)) * _inv_h(nmesh, box)
    i0 = torch.floor(p + 0.5)
    d = i0 - p
    if _kind(kind) == 'tsc':
        ws = (0.5 * (0.5 + d) ** 2, 0.75 - d * d, 0.5 * (0.5 - d) ** 2)
    else:
        ws = (d.clamp_min(0.0), 1.0 - d.abs(), (-d).clamp_min(0.0))
    return i0.to(torch.int64), ws


def cell_key_2d(px, py, nmesh, yb, box, offset=0.0, shift=0.0, kind='tsc'):
    """(x-cell, y-block) grouping key (int32) of each point; `shift` is added
    to both coordinates first (ops/grid.py:cell_key_2d). The cell is K1's
    for `kind`: TSC wraps once before the offset, CIC does not wrap."""
    boxf = _f32(box)
    scale = _inv_h(nmesh, box)
    wrap = _kind(kind) == 'tsc'

    def cells(p):
        p = p + _f32(shift)
        if wrap:
            p = _wrap_once(p, boxf)
        q = (p + _f32(offset)) * scale
        return torch.remainder(torch.floor(q + 0.5).to(torch.int32), nmesh)

    return cells(px) * (nmesh // yb) + torch.div(cells(py), yb, rounding_mode='floor')


def stage_grouped2d(
    cols, nmesh, box, yb, offset=0.0, xi=0, yi=1, shift=0.0, return_order=False, kind='tsc'
):
    """Sort the columns by (x-cell, y-block) key (stable, so equal keys keep
    their input order) and return (sorted columns, starts): cell c's points
    are [starts[c], starts[c+1]) of every sorted column. `starts` is int32 of
    length ncell + 1. With return_order=True the int64 sort permutation
    `order` (sorted[i] = col[order[i]]) comes third. `kind` picks K1's cell
    convention (see :func:`cell_key_2d`). Counterpart of
    ops/grid.py:_stage_sort_by_cell."""
    if nmesh % yb:
        raise ValueError(f'yb={yb} must divide nmesh={nmesh}')
    key = cell_key_2d(cols[xi], cols[yi], nmesh, yb, box, offset, shift, kind)
    skey, order = torch.sort(key, stable=True)
    ncell = nmesh * (nmesh // yb)
    cells = torch.arange(ncell + 1, dtype=skey.dtype, device=skey.device)
    starts = torch.searchsorted(skey, cells).to(torch.int32)
    staged = [c.index_select(0, order) for c in cols]
    return (staged, starts, order) if return_order else (staged, starts)


def paint_3d_plain(grid, px, py, pz, weights, nmesh, box, offset=0.0, kind='tsc'):
    """Accumulate the 27-point cloud of every weighted point into the
    (nmesh, nmesh, nmesh) f32 `grid` in place (the contract of
    ops/grid.py:_paint_3d_jit): TSC wraps each coordinate once, CIC paints
    it unwrapped (wrap=False). Returns `grid`."""
    wrap = _kind(kind) == 'tsc'
    ix, wx = axis_cloud(px, box, offset, nmesh, wrap, kind)
    iy, wy = axis_cloud(py, box, offset, nmesh, wrap, kind)
    iz, wz = axis_cloud(pz, box, offset, nmesh, wrap, kind)
    fx = [torch.remainder(ix + o, nmesh) for o in (-1, 0, 1)]
    fy = [torch.remainder(iy + o, nmesh) for o in (-1, 0, 1)]
    fz = [torch.remainder(iz + o, nmesh) for o in (-1, 0, 1)]
    flat = grid.view(-1)
    w = weights.to(torch.float32)
    for a in range(3):
        for b in range(3):
            wab = wx[a] * wy[b]
            fab = (fx[a] * nmesh + fy[b]) * nmesh
            for c in range(3):
                flat.index_add_(0, fab + fz[c], wab * wz[c] * w)
    return grid


def check_deposit_err(err):
    """Raise if the deposit kernel counted points outside their cell's tile
    (reads the error word, which waits for the device)."""
    n = int(err.item())
    if n:
        raise RuntimeError(
            f'tsc_deposit_cells: {n} points fell outside their staged cell '
            '(staging key and kernel index disagree)'
        )


def tsc_deposit_cells(
    grid, x, y, z, w, starts, nmesh, yb, box, offset=0.0, err=None, kind='tsc'
):
    """Add the TSC (or CIC) deposit of cell-sorted points into `grid` in place.

    x, y, z, w: (N,) f32, sorted by :func:`stage_grouped2d` (same nmesh, yb,
    box, offset, kind); starts: its (ncell + 1,) int32 cell starts; grid:
    (nmesh, nmesh, nmesh) f32, contiguous.

    On CUDA tensors this launches K1 (csrc/tsc_deposit.cu) on the current
    stream. Points whose y falls outside their cell are counted in `err`
    (an int32 (1,) CUDA tensor); with err=None the wrapper allocates one and
    checks it at once, which waits for the device, so a caller that must not
    sync passes its own and calls :func:`check_deposit_err` later.
    On CPU tensors it runs :func:`paint_3d_plain`. Returns `grid`.
    """
    kind = _kind(kind)
    if grid.device.type == 'cpu':
        return paint_3d_plain(grid, x, y, z, w, nmesh, box, offset, kind)
    if nmesh % yb:
        raise ValueError(f'yb={yb} must divide nmesh={nmesh}')
    ncell = nmesh * (nmesh // yb)
    if _tile_bytes(nmesh, yb) > MAX_SMEM_BYTES:
        fits = [
            b for b in range(1, yb) if nmesh % b == 0 and _tile_bytes(nmesh, b) <= MAX_SMEM_BYTES
        ]
        raise ValueError(
            f'tsc_deposit_cells: the (3, yb+2, nmesh) tile is {_tile_bytes(nmesh, yb)} B, '
            f'over the {MAX_SMEM_BYTES} B of shared memory a block may use; '
            + (f'use yb={fits[-1]}' if fits else f'no yb fits nmesh={nmesh}')
        )
    n = x.shape[0]
    for name, t in (('x', x), ('y', y), ('z', z), ('w', w)):
        if t.dtype != torch.float32 or t.shape != (n,) or not t.is_contiguous():
            raise ValueError(f'{name} must be a contiguous ({n},) float32 tensor')
        if t.device != grid.device:
            raise ValueError(f'{name} is on {t.device}, grid on {grid.device}')
    if grid.dtype != torch.float32 or grid.shape != (nmesh,) * 3 or not grid.is_contiguous():
        raise ValueError(f'grid must be a contiguous ({nmesh},)*3 float32 tensor')
    if starts.dtype != torch.int32 or starts.shape != (ncell + 1,) or starts.device != grid.device:
        raise ValueError(f'starts must be a ({ncell + 1},) int32 tensor on {grid.device}')
    starts = starts.contiguous()
    own_err = err is None
    if own_err:
        err = torch.zeros(1, dtype=torch.int32, device=grid.device)
    elif err.dtype != torch.int32 or err.numel() != 1 or err.device != grid.device:
        raise ValueError(f'err must be a one-element int32 tensor on {grid.device}')
    lib = _build.lib()
    with torch.cuda.device(grid.device):
        code = lib.tsc_deposit_cells(
            grid.data_ptr(), x.data_ptr(), y.data_ptr(), z.data_ptr(), w.data_ptr(),
            starts.data_ptr(), ncell, nmesh, yb, _f32(box), _f32(offset), KINDS.index(kind),
            err.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(code, 'tsc_deposit_cells')
    tsc_deposit_cells.launches += 1
    tsc_deposit_cells.launches_by_form[kind] += 1
    if own_err:
        check_deposit_err(err)
    return grid


tsc_deposit_cells.launches = 0
# launches of each kind, within `launches`
tsc_deposit_cells.launches_by_form = dict.fromkeys(KINDS, 0)


def paint_3d(px, py, pz, nmesh, box, weights=None, offset=0.0, kind='tsc', err=None):
    """Paint points onto a new (nmesh,)*3 float32 grid (ops/grid.py:paint_3d
    with TSC's wrap=True and CIC's wrap=False, as ops/power.py:get_field
    calls it). px, py, pz: (N,) tensors; weights: (N,) or None (unit).

    On CUDA tensors the points are staged by (x-cell, y-block of
    :func:`default_yblock`) with one stable sort and deposited by K1, for
    every N; `err` is K1's error word (see
    :func:`tsc_deposit_cells`). On CPU tensors this is the plain scatter."""
    kind = _kind(kind)
    cols = [c.to(torch.float32).contiguous() for c in (px, py, pz)]
    w = (
        torch.ones_like(cols[0]) if weights is None
        else weights.to(cols[0].device, torch.float32).contiguous()
    )
    grid = torch.zeros((nmesh,) * 3, dtype=torch.float32, device=cols[0].device)
    if grid.device.type == 'cpu':
        return paint_3d_plain(grid, *cols, w, nmesh, box, offset, kind)
    yb = default_yblock(nmesh)
    (x, y, z, ws), starts = stage_grouped2d(cols + [w], nmesh, box, yb, offset, kind=kind)
    return tsc_deposit_cells(grid, x, y, z, ws, starts, nmesh, yb, box, offset, err, kind)
