"""TSC/CIC mass assignment on brick-sorted points (PyTorch + a CUDA kernel).

Counterpart of abacusutils_tpu/ops/grid.py for the HOD and P(k) routes:

- :func:`stage_bricks` sorts points by the 3-D brick of their cell with one
  stable sort and cuts the bricks into a work list of at most `max_points`
  points an item (:class:`BrickPlan`), built on the points' device. It takes
  the place of ``_stage_sort_by_cell``; its :func:`brick_key` with the brick
  (1, yb, nmesh) is that function's (x-cell, y-block) key. There is no padded
  (ncell, K) layout: the CUDA deposit reads the sorted columns and the work
  list directly.
- :func:`paint_3d_plain` is the 27-point scatter of ``_paint_3d_jit``;
  :func:`overflow_count_plain` counts the points whose stencil leaves their
  brick's tile, the kernel's overflow word.
- :func:`tsc_deposit_cells` launches the brick-tile deposit K1
  (``csrc/tsc_deposit.cu``) on CUDA tensors and runs the plain versions on
  CPU tensors.
- :func:`paint_3d` is the public paint (``ops/grid.py:paint_3d``): stage and
  K1 on CUDA tensors, the plain scatter on CPU tensors.
- :func:`tsc_deposit_cells_multi` is K1's multi-weight form, the
  counterpart of ``paint_grouped_yb_multiw``: up to MAX_WEIGHTS weight
  columns on one point set, each into its own grid, in one launch of a
  gather without atomics (``csrc/tsc_gather.cu``) over the points sorted by
  the cell of their stencil centre (:func:`stage_gather`, a
  :class:`CellPlan`); :func:`gather_deposit_plain` is that walk in PyTorch;
  :func:`paint_3d_multi` stages and paints them.
- :func:`tsc_parallel`, :func:`cic_serial` and :func:`rightwrap` are the
  reference-compatible wrappers of ``ops/grid.py`` that prepare_sim's shear
  field paints through: an int, tuple or ndarray ``densgrid``, cubic grids
  through K1, ``cic_serial``'s non-cubic grids (the 2-D ``gz == 1`` mode
  among them) on the host.

Both kinds use the 3-point stencil of the JAX package: TSC wraps each
coordinate once into [0, box) and then adds the offset; CIC (weights
max(d, 0), 1 - |d|, max(-d, 0)) paints p + offset unwrapped, as
``get_field`` paints it (``paint_3d(..., kind='cic', wrap=False)``), and
takes its cell index modulo nmesh. ``wrap`` (None: the kind's default)
overrides either, as the JAX package's ``wrap`` argument does. Every f32 constant is formed as the JAX
package forms it (an f32 division, then used as an exact Python float), so
cell keys agree bit for bit.
"""

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from ..convert import resolve_device

__all__ = [
    'KINDS',
    'BRICK',
    'BrickPlan',
    'axis_cloud',
    'brick_key',
    'brick_shape',
    'tile_bytes',
    'stage_bricks',
    'work_items',
    'paint_3d_plain',
    'overflow_count_plain',
    'paint_3d',
    'tsc_deposit_cells',
    'tsc_deposit_cells_multi',
    'paint_3d_multi',
    'CellPlan',
    'GATHER_BRICK',
    'MAX_WEIGHTS',
    'gather_blocks_per_sm',
    'gather_deposit_plain',
    'gather_key',
    'stage_gather',
    'tsc_parallel',
    'partition_parallel',
    'cic_serial',
    'rightwrap',
    'blocks_per_sm',
    'MAX_SMEM_BYTES',
    'RSD_MARGIN',
]

# dynamic shared memory one H100 block may use (227 KB)
MAX_SMEM_BYTES = 232_448
# the mass-assignment kinds; K1's template parameter is the index
KINDS = ('tsc', 'cic')
# the default brick interior (x, y, z), cells
BRICK = (16, 16, 16)
# weight columns K1's multi-weight form takes in one launch
MAX_WEIGHTS = 5
# the brick of output cells a block of the multi-weight gather takes, whose
# cells are one contiguous run of the stage's keys (csrc/tsc_gather.cu's
# GX, GY, GZ: a warp a brick row of 32 cells along z)
GATHER_BRICK = (8, 8, 32)
# cells of margin of a catalog's bricks on each axis RSD moves points along
# after staging (a displacement of 3 Mpc/h is ~0.4 cells at nmesh 256 in a
# 2000 Mpc/h box)
RSD_MARGIN = 2
# a work item holds at most max(MIN_ITEM_POINTS, ITEM_SPLIT x the mean points
# of a brick) points; heavier bricks are cut into several items
MIN_ITEM_POINTS = 2048
ITEM_SPLIT = 2


def _f32(v):
    """The float32 value of `v` as an exact Python float."""
    return float(np.float32(v))


def _inv_h(nmesh, box):
    return float(np.float32(nmesh) / np.float32(box))


def _wrap_once(p, box):
    """Single periodic wrap (ops/grid.py:_wrap_once)."""
    p = torch.where(p >= box, p - box, p)
    return torch.where(p < 0, p + box, p)


def _kind(kind):
    kind = kind.lower()
    if kind not in KINDS:
        raise ValueError(f'unknown mass assignment {kind!r}, not one of {KINDS}')
    return kind


def _wrap(kind, wrap):
    """Whether coordinates are wrapped once: `wrap`, or where it is None the
    JAX package's default for the kind (TSC wraps, CIC does not)."""
    return _kind(kind) == 'tsc' if wrap is None else bool(wrap)


def _axis_centre(p1d, box, offset, nmesh, wrap):
    """The stencil centre (f32, not yet taken modulo nmesh) of each
    coordinate and its offset d = centre - g from it, g = (p + offset) *
    nmesh / box after the optional single wrap: K1's f32 steps."""
    p1d = p1d.to(torch.float32)
    if wrap:
        p1d = _wrap_once(p1d, _f32(box))
    if offset:  # adding 0 changes no centre and no offset
        p1d = p1d + _f32(offset)
    p = p1d * _inv_h(nmesh, box)
    i0 = torch.floor(p + 0.5)
    return i0, i0 - p


def _tsc_weight(slot, d):
    """The TSC weight of stencil slot 0, 1 or 2 (offset -1, 0, +1 from the
    centre) of a point at offset d, in K1's f32 association."""
    if slot == 1:
        return 0.75 - d * d
    s = 0.5 + d if slot == 0 else 0.5 - d
    return 0.5 * (s * s)


def axis_cloud(p1d, box, offset, nmesh, wrap=True, kind='tsc'):
    """Per-axis centre index (int64, not yet taken modulo nmesh) and the
    three stencil weights for offsets (-1, 0, +1); the f32 arithmetic of
    ops/grid.py:_axis_cloud."""
    i0, d = _axis_centre(p1d, box, offset, nmesh, wrap)
    if _kind(kind) == 'tsc':
        ws = tuple(_tsc_weight(a, d) for a in range(3))
    else:
        ws = (d.clamp_min(0.0), 1.0 - d.abs(), (-d).clamp_min(0.0))
    return i0.to(torch.int64), ws


def tile_bytes(brick, margin=(0, 0, 0)):
    """Shared memory of one K1 block: the f32 tile of a brick interior, one
    ghost layer and the margin on each side of every axis."""
    return 4 * math.prod(b + 2 + 2 * m for b, m in zip(brick, margin))


def brick_shape(nmesh, yb=None, margin=(0, 0, 0)):
    """The brick interior (bx, by, bz) K1 uses on an nmesh^3 grid: BRICK,
    with `yb` for its y extent when given, each cut to nmesh. Raises if the
    tile does not fit the shared memory of one block."""
    brick = tuple(min(b, nmesh) for b in (BRICK[0], yb or BRICK[1], BRICK[2]))
    if min(brick) < 1:
        raise ValueError(f'brick {brick} must be at least one cell a side')
    if tile_bytes(brick, margin) > MAX_SMEM_BYTES:
        fits = [b for b in range(brick[1] - 1, 0, -1)
                if tile_bytes((brick[0], b, brick[2]), margin) <= MAX_SMEM_BYTES]
        raise ValueError(
            f'the K1 tile of brick {brick} with margin {tuple(margin)} is '
            f'{tile_bytes(brick, margin)} B, over the {MAX_SMEM_BYTES} B of shared memory a '
            'block may use; ' + (f'use yb={fits[0]}' if fits else 'use a smaller margin')
        )
    return brick


def _cells(p, nmesh, box, offset, shift, wrap):
    """Cell index (int32, modulo nmesh) of each coordinate plus `shift`, in
    K1's f32 arithmetic (ops/grid.py:cell_key_2d's `cells`; adding a zero
    shift or offset changes no cell, so it is skipped)."""
    if shift:
        p = p + _f32(shift)
    if wrap:
        p = _wrap_once(p, _f32(box))
    if offset:
        p = p + _f32(offset)
    q = p * _inv_h(nmesh, box)
    return torch.remainder(torch.floor(q + 0.5).to(torch.int32), nmesh)


def brick_key(px, py, pz, nmesh, brick, box, offset=0.0, shift=0.0, kind='tsc', wrap=None):
    """Brick index (int32) of each point's cell, x-major: ((cx // bx) * nby +
    cy // by) * nbz + cz // bz, with nb = ceil(nmesh / b) bricks an axis (the
    last one ragged). `shift` is added to each coordinate first. The cell is
    K1's for `kind` and `wrap` (by default TSC wraps once before the offset,
    CIC does not wrap). With brick (1, yb, nmesh) this is
    ops/grid.py:cell_key_2d."""
    wrap = _wrap(kind, wrap)
    bx, by, bz = brick
    nby, nbz = -(-nmesh // by), -(-nmesh // bz)
    key = torch.div(_cells(px, nmesh, box, offset, shift, wrap), bx, rounding_mode='floor')
    key = key * nby + torch.div(_cells(py, nmesh, box, offset, shift, wrap), by,
                                rounding_mode='floor')
    return key * nbz + torch.div(_cells(pz, nmesh, box, offset, shift, wrap), bz,
                                 rounding_mode='floor')


class BrickPlan(NamedTuple):
    """K1's work over brick-sorted points: `work` is the (nitems, 3) int32
    (brick, begin, end) list on the points' device (items past the last
    hold begin = end = 0 and do nothing), the bricks tile an nmesh^3 grid
    with interiors `brick` and per-axis `margin` cells for points that move
    after staging."""

    work: torch.Tensor
    nmesh: int
    brick: tuple
    margin: tuple

    @property
    def nbricks(self):
        return _nbricks(self.nmesh, self.brick)


def _nbricks(nmesh, brick):
    return math.prod(-(-nmesh // b) for b in brick)


def _work_list(skey, nbricks, max_points):
    """The (brick, begin, end) items of sorted brick keys, each brick cut
    into ceil(count / max_points) items, built on the keys' device without
    a host sync: its length is the bound min(nbricks, N) + ceil(N /
    max_points), and the items past the last are empty."""
    starts = torch.searchsorted(
        skey, torch.arange(nbricks + 1, dtype=skey.dtype, device=skey.device)
    )
    return work_items(starts, skey.numel(), max_points)


def work_items(starts, n, max_points):
    """The int32 (group, begin, end) items over `n` sorted rows whose groups
    begin at `starts` (ngroups + 1 offsets): each group is cut into
    ceil(count / max_points) items, an empty group gets none. The list has
    the fixed length min(ngroups, n) + ceil(n / max_points), so no host
    sync is needed; the items past the last hold begin = end = 0."""
    ngroups = starts.numel() - 1
    nchunk = torch.div(starts[1:] - starts[:-1] + max_points - 1, max_points,
                       rounding_mode='floor')
    last = torch.cumsum(nchunk, 0)
    cap = min(ngroups, n) + -(-n // max_points)
    item = torch.arange(cap, dtype=last.dtype, device=starts.device)
    group = torch.searchsorted(last, item, right=True)
    real = group < ngroups
    group = group.clamp_(max=ngroups - 1)
    begin = starts[group] + (item - (last[group] - nchunk[group])) * max_points
    end = torch.minimum(begin + max_points, starts[group + 1])
    zero = torch.zeros_like(begin)
    work = torch.stack(
        [torch.where(real, group, zero), torch.where(real, begin, zero),
         torch.where(real, end, zero)], 1
    )
    return work.to(torch.int32)


def stage_bricks(
    cols, nmesh, box, brick=None, margin=(0, 0, 0), offset=0.0, shift=0.0, kind='tsc',
    xi=0, yi=1, zi=2, max_points=None, return_order=False, wrap=None,
):
    """Sort the columns by the brick of their cell (:func:`brick_key` of
    cols[xi], cols[yi], cols[zi]; stable, so points of one brick keep their
    input order) and return (sorted columns, :class:`BrickPlan`); with
    return_order=True the int64 permutation `order` (sorted[i] =
    col[order[i]]) comes third.

    brick: the interior (default :func:`brick_shape`); margin: cells of
    room per axis for points that move after staging (a box catalog staged
    before RSD carries a z margin); a point that moves further is still
    deposited right, straight into the grid. max_points: the most points a
    work item takes (default max(MIN_ITEM_POINTS, ITEM_SPLIT x N / the
    number of bricks)). `kind`, `wrap`, `offset` and `shift` pick the cell as
    K1 computes it."""
    margin = tuple(int(m) for m in margin)
    brick = brick_shape(nmesh, margin=margin) if brick is None else tuple(int(b) for b in brick)
    n = cols[0].shape[0]
    nbricks = _nbricks(nmesh, brick)
    if max_points is None:
        max_points = max(MIN_ITEM_POINTS, ITEM_SPLIT * -(-n // nbricks))
    key = brick_key(cols[xi], cols[yi], cols[zi], nmesh, brick, box, offset, shift, kind, wrap)
    skey, order = torch.sort(key, stable=True)
    plan = BrickPlan(_work_list(skey, nbricks, int(max_points)), nmesh, brick, margin)
    staged = [c.index_select(0, order) for c in cols]
    return (staged, plan, order) if return_order else (staged, plan)


def paint_3d_plain(grid, px, py, pz, weights, nmesh, box, offset=0.0, kind='tsc', wrap=None):
    """Accumulate the 27-point cloud of every weighted point into the
    (nmesh, nmesh, nmesh) f32 `grid` in place (the contract of
    ops/grid.py:_paint_3d_jit): by default TSC wraps each coordinate once,
    CIC paints it unwrapped (wrap=False). Returns `grid`."""
    wrap = _wrap(kind, wrap)
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


def overflow_count_plain(x, y, z, w, plan, box, offset=0.0, kind='tsc', wrap=None):
    """The overflow word of K1 for points staged by `plan`: the number of
    points of non-zero weight whose 27-point stencil leaves their brick's
    tile (the brick, one ghost layer and the margin on each side). Returns a
    0-d int64 tensor."""
    kind, wrap = _kind(kind), _wrap(kind, wrap)
    nmesh = plan.nmesh
    work = plan.work.long()
    # each point's brick, from the items that cover it
    brick = torch.repeat_interleave(work[:, 0], work[:, 2] - work[:, 1], output_size=x.shape[0])
    nb = [-(-nmesh // b) for b in plan.brick]
    bidx = (torch.div(brick, nb[1] * nb[2], rounding_mode='floor'),
            torch.div(brick, nb[2], rounding_mode='floor') % nb[1], brick % nb[2])
    inside = w != 0
    for p, b, m, j in zip((x, y, z), plan.brick, plan.margin, bidx):
        i0, _ = axis_cloud(p, box, offset, nmesh, wrap, kind)
        first = torch.remainder(i0 - 1 - (j * b - 1 - m), nmesh)
        inside = inside & (first + 2 < b + 2 + 2 * m)
    return ((w != 0) & ~inside).sum()


def _check_deposit(grid, cols, plan, nmesh, overflow):
    n = cols[0].shape[0]
    for name, t in zip(('x', 'y', 'z', 'w'), cols):
        if t.dtype != torch.float32 or t.shape != (n,) or not t.is_contiguous():
            raise ValueError(f'{name} must be a contiguous ({n},) float32 tensor')
        if t.device != grid.device:
            raise ValueError(f'{name} is on {t.device}, grid on {grid.device}')
    if grid.dtype != torch.float32 or grid.shape != (nmesh,) * 3 or not grid.is_contiguous():
        raise ValueError(f'grid must be a contiguous ({nmesh},)*3 float32 tensor')
    work = plan.work
    if work.dtype != torch.int32 or work.dim() != 2 or work.shape[1] != 3 or (
        work.device != grid.device
    ):
        raise ValueError(f'plan.work must be an (nitems, 3) int32 tensor on {grid.device}')
    if overflow is not None and (
        overflow.dtype != torch.int32 or overflow.numel() != 1 or overflow.device != grid.device
    ):
        raise ValueError(f'overflow must be a one-element int32 tensor on {grid.device}')


def _launch(grid, x, y, z, w, plan, box, offset, overflow, kind, wrap):
    """One K1 launch of the weight column `w` into `grid`."""
    if overflow is None:
        overflow = torch.zeros(1, dtype=torch.int32, device=grid.device)
    work = plan.work.contiguous()
    lib = _build.lib()
    with torch.cuda.device(grid.device):
        code = lib.tsc_deposit_bricks(
            grid.data_ptr(), x.data_ptr(), y.data_ptr(), z.data_ptr(), w.data_ptr(),
            work.data_ptr(), work.shape[0], plan.nmesh, *plan.brick, *plan.margin, _f32(box),
            _f32(offset), KINDS.index(kind), int(wrap), overflow.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(code, 'tsc_deposit_bricks')


def tsc_deposit_cells(grid, x, y, z, w, plan, box, offset=0.0, overflow=None, kind='tsc',
                      wrap=None):
    """Add the TSC (or CIC) deposit of brick-sorted points into `grid` in
    place.

    x, y, z, w: (N,) f32 in the order of :func:`stage_bricks`; plan: its
    :class:`BrickPlan` (the points may have moved since: K1 deposits a point
    whose stencil leaves its tile straight into the grid); grid:
    (plan.nmesh,)*3 f32, contiguous. `overflow`, an int32 (1,) tensor, gains
    the number of such points (:func:`overflow_count_plain`). `wrap`: see
    :func:`paint_3d_plain`; the points must have been staged with it.

    On CUDA tensors this launches K1 (csrc/tsc_deposit.cu) on the current
    stream, without waiting for the device. On CPU tensors it runs
    :func:`paint_3d_plain` (and :func:`overflow_count_plain` when
    `overflow` is given). Returns `grid`."""
    kind, wrap = _kind(kind), _wrap(kind, wrap)
    nmesh = plan.nmesh
    if grid.device.type == 'cpu':
        if overflow is not None:
            overflow += overflow_count_plain(x, y, z, w, plan, box, offset, kind, wrap).to(
                torch.int32)
        return paint_3d_plain(grid, x, y, z, w, nmesh, box, offset, kind, wrap)
    tile = tile_bytes(plan.brick, plan.margin)
    if tile > MAX_SMEM_BYTES:
        raise ValueError(f'tsc_deposit_cells: a {tile} B tile is over {MAX_SMEM_BYTES} B')
    _check_deposit(grid, (x, y, z, w), plan, nmesh, overflow)
    if plan.work.shape[0] == 0:  # no points: nothing to launch
        return grid
    _launch(grid, x, y, z, w, plan, box, offset, overflow, kind, wrap)
    tsc_deposit_cells.launches += 1
    tsc_deposit_cells.launches_by_form[kind] += 1
    return grid


tsc_deposit_cells.launches = 0
# launches of each kind, within `launches`
tsc_deposit_cells.launches_by_form = dict.fromkeys(KINDS, 0)


def blocks_per_sm(plan, kind='tsc'):
    """Resident K1 blocks an SM holds for `plan`'s tile on the current card
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    out = ctypes.c_int()
    code = _build.lib().tsc_deposit_blocks_per_sm(
        KINDS.index(_kind(kind)), plan.nmesh, tile_bytes(plan.brick, plan.margin),
        ctypes.byref(out),
    )
    _build.check(code, 'tsc_deposit_blocks_per_sm')
    return out.value


def paint_3d(px, py, pz, nmesh, box, weights=None, offset=0.0, kind='tsc', overflow=None,
             wrap=None):
    """Paint points onto a new (nmesh,)*3 float32 grid (ops/grid.py:paint_3d;
    `wrap` None takes TSC's wrap=True and CIC's wrap=False, as
    ops/power.py:get_field calls it). px, py, pz: (N,) tensors; weights: (N,)
    or None (unit).

    On CUDA tensors the points are staged by :func:`stage_bricks` (default
    brick, no margin) and deposited by K1, for every N; `overflow` is K1's
    overflow word (see :func:`tsc_deposit_cells`). On CPU tensors this is
    the plain scatter."""
    kind = _kind(kind)
    cols = [c.to(torch.float32).contiguous() for c in (px, py, pz)]
    w = (
        torch.ones_like(cols[0]) if weights is None
        else weights.to(cols[0].device, torch.float32).contiguous()
    )
    grid = torch.zeros((nmesh,) * 3, dtype=torch.float32, device=cols[0].device)
    if grid.device.type == 'cpu':
        return paint_3d_plain(grid, *cols, w, nmesh, box, offset, kind, wrap)
    (x, y, z, ws), plan = stage_bricks(cols + [w], nmesh, box, offset=offset, kind=kind, wrap=wrap)
    return tsc_deposit_cells(grid, x, y, z, ws, plan, box, offset, overflow, kind, wrap)


class CellPlan(NamedTuple):
    """The multi-weight gather's stage of N points (:func:`stage_gather`):
    `points`, an (N, 4) or (N, 8) f32 row a point in the sorted order: its
    offset d = centre - g from its TSC stencil centre along x, y and z (K1's
    f32 steps), then its `nweights` weight columns, zero-padded to one or
    two 16-byte vectors; `starts`, the int32 first point of every key of
    :func:`gather_key` and the end (nbricks x the cells of
    :data:`GATHER_BRICK` + 1 entries); the grid's `nmesh`."""

    points: torch.Tensor
    starts: torch.Tensor
    nmesh: int
    nweights: int


def _gather_bricks(nmesh):
    return [-(-nmesh // b) for b in GATHER_BRICK]


def _gather_keys(nmesh):
    return math.prod(_gather_bricks(nmesh)) * math.prod(GATHER_BRICK)


def gather_key(cx, cy, cz, nmesh):
    """The brick-major key of cells (cx, cy, cz) of an nmesh^3 grid (int64
    tensors in [0, nmesh)): the index of the cell's :data:`GATHER_BRICK`
    brick (x-major, ceil(nmesh / b) bricks an axis, the last one ragged)
    times the brick's cells, plus the cell's index inside it, z fastest.
    A brick's cells are one run of keys, and so are its rows along z."""
    gx, gy, gz = GATHER_BRICK
    _, nby, nbz = _gather_bricks(nmesh)
    brick = ((cx // gx) * nby + cy // gy) * nbz + cz // gz
    return brick * (gx * gy * gz) + ((cx % gx) * gy + cy % gy) * gz + cz % gz


def stage_gather(cols, nmesh, box, offset=0.0, return_order=False):
    """Sort the points cols[0], cols[1], cols[2] (x, y, z) by the TSC
    stencil centre cell (each coordinate wrapped once, K1's cell bit for
    bit) in the order of :func:`gather_key` (stable, so the points of one
    cell keep their input order), with the weight columns cols[3:] (at most
    MAX_WEIGHTS) packed beside their offsets. Returns the
    :class:`CellPlan`; with return_order=True (plan, the int64 permutation
    `order`: sorted[i] = col[order[i]])."""
    nw = len(cols) - 3
    if not 0 <= nw <= MAX_WEIGHTS:
        raise ValueError(f'the gather packs 0 to {MAX_WEIGHTS} weight columns, not {nw}')
    nkeys = _gather_keys(nmesh)
    if nkeys >= 2**31 - 1:
        raise ValueError(f'an nmesh of {nmesh} has {nkeys} cell keys, over the int32 starts')
    cells, row = [], []
    for p in cols[:3]:
        i0, d = _axis_centre(p, box, offset, nmesh, True)
        cells.append(torch.remainder(i0.to(torch.int32), nmesh))
        row.append(d)
    key = gather_key(*cells, nmesh)  # int32: nkeys < 2^31
    del cells
    order = torch.sort(key, stable=True)[1]
    starts = torch.zeros(nkeys + 1, dtype=torch.int32, device=key.device)
    starts[1:] = torch.cumsum(torch.bincount(key, minlength=nkeys), 0)
    del key
    # gather each column into a row of a (width, N) block, then transpose it
    # once (a strided stack, or a row gather of packed points, takes several
    # times longer)
    row += [w.to(torch.float32) for w in cols[3:]]
    block = torch.empty((4 if 3 + nw <= 4 else 8, len(order)), dtype=torch.float32,
                        device=order.device)
    for j, c in enumerate(row):
        torch.index_select(c, 0, order, out=block[j])
    block[len(row):].zero_()
    del row
    plan = CellPlan(block.t().contiguous(), starts, nmesh, nw)
    return (plan, order) if return_order else plan


def _unit_first(grids, plan):
    """Whether `grids` holds a unit-weight grid before the plan's weight
    columns' (F = nweights + 1) or only theirs (F = nweights); raises
    otherwise."""
    nmesh, nw = plan.nmesh, plan.nweights
    f = grids.shape[0] if grids.dim() == 4 else -1
    if grids.shape[1:] != (nmesh,) * 3 or f not in (nw, nw + 1) or not 1 <= f <= MAX_WEIGHTS:
        raise ValueError(f'grids must be ({nw} or {nw + 1}, {nmesh}, {nmesh}, {nmesh}) for a plan '
                         f'of {nw} weight columns (1 to {MAX_WEIGHTS} grids), not '
                         f'{tuple(grids.shape)}')
    return f == nw + 1


def gather_deposit_plain(grids, plan):
    """The multi-weight gather in PyTorch: every cell of every grid of
    `grids` (see :func:`tsc_deposit_cells_multi`) is written with the sum,
    over the 27 source cells of its stencil in the kernel's order (x offset
    -1, 0, +1, then y, then z, wrapped) and over each source cell's points
    in the staged order, of ((wx wy) w_f) wz. The same f32 steps and order
    as ``csrc/tsc_gather.cu``, so its bits are the kernel's. Returns
    `grids`."""
    unit = _unit_first(grids, plan)
    n = plan.nmesh
    dev = grids.device
    starts = plan.starts.long()
    pts = plan.points
    c = torch.arange(n, device=dev)
    cx, cy, cz = (a.reshape(-1) for a in torch.meshgrid(c, c, c, indexing='ij'))
    acc = torch.zeros((grids.shape[0], n**3), dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for i in range(3):
        for j in range(3):
            for k in range(3):
                key = gather_key((cx + i - 1) % n, (cy + j - 1) % n, (cz + k - 1) % n, n)
                s, e = starts[key], starts[key + 1]
                for t in range(int((e - s).max())):
                    valid = s + t < e
                    p = pts[torch.where(valid, s + t, 0)]
                    wxy = _tsc_weight(2 - i, p[:, 0]) * _tsc_weight(2 - j, p[:, 1])
                    wz = _tsc_weight(2 - k, p[:, 2])
                    for f in range(grids.shape[0]):
                        wab = wxy if unit and f == 0 else wxy * p[:, 3 + f - unit]
                        acc[f] += torch.where(valid, wab * wz, zero)
    grids.copy_(acc.view(grids.shape))
    return grids


def tsc_deposit_cells_multi(grids, plan):
    """Write the TSC deposit of cell-staged points into the grids of
    `grids`, once for each weight column of the stage: K1's multi-weight
    form, the counterpart of ops/grid.py:paint_grouped_yb_multiw. Every
    cell of every grid is written; what the grids held is replaced.

    grids: (F, nmesh, nmesh, nmesh) f32, contiguous: F = plan.nweights, the
    stage's weight columns in order, or F = plan.nweights + 1, a
    unit-weight grid first, F <= MAX_WEIGHTS; plan: the :class:`CellPlan`
    of :func:`stage_gather` (TSC, each coordinate wrapped once, the stage's
    offset).

    On CUDA tensors this launches the gather (csrc/tsc_gather.cu) once, on
    the current stream: each grid cell pulls the points of its 27 source
    cells in a fixed order and is stored once, so two launches give the same
    bits. On CPU tensors it runs :func:`gather_deposit_plain`. Returns
    `grids`."""
    unit = _unit_first(grids, plan)
    if grids.device.type == 'cpu':
        return gather_deposit_plain(grids, plan)
    pts, starts = plan.points, plan.starts
    width = 4 if 3 + plan.nweights <= 4 else 8
    if (pts.dtype != torch.float32 or pts.dim() != 2 or pts.shape[1] != width
            or not pts.is_contiguous() or pts.device != grids.device):
        raise ValueError(f'plan.points must be a contiguous (N, {width}) float32 tensor on '
                         f'{grids.device}')
    nkeys = _gather_keys(plan.nmesh)
    if (starts.dtype != torch.int32 or starts.shape != (nkeys + 1,) or not starts.is_contiguous()
            or starts.device != grids.device):
        raise ValueError(f'plan.starts must be a contiguous ({nkeys + 1},) int32 tensor on '
                         f'{grids.device}')
    if grids.dtype != torch.float32 or not grids.is_contiguous():
        raise ValueError('grids must be a contiguous float32 tensor')
    lib = _build.lib()
    with torch.cuda.device(grids.device):
        code = lib.tsc_gather_cells(
            grids.data_ptr(), pts.data_ptr(), plan.nweights, int(unit), starts.data_ptr(),
            plan.nmesh, *GATHER_BRICK, torch.cuda.current_stream().cuda_stream,
        )
    _build.check(code, 'tsc_gather_cells')
    tsc_deposit_cells_multi.launches += 1
    return grids


tsc_deposit_cells_multi.launches = 0


def gather_blocks_per_sm(nweights, unit):
    """Resident blocks of the multi-weight gather an SM holds on the current
    card for `nweights` weight columns and a unit grid when `unit`
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    out = ctypes.c_int()
    _build.check(_build.lib().tsc_gather_blocks_per_sm(nweights, int(unit), ctypes.byref(out)),
                 'tsc_gather_blocks_per_sm')
    return out.value


def paint_3d_multi(px, py, pz, nmesh, box, weights, offset=0.0):
    """TSC-paint one point set once for each weight column onto a new
    (F, nmesh, nmesh, nmesh) float32 stack (F = len(weights) <= MAX_WEIGHTS;
    a None column is a unit weight): the multi-weight :func:`paint_3d`, the
    counterpart of ops/grid.py:paint_grouped_yb_multiw.

    On CUDA tensors the points and the columns are staged once by
    :func:`stage_gather` and deposited by one :func:`tsc_deposit_cells_multi`
    launch, which writes every cell (the unit grid first; a stack in another
    order is a copy of it). On CPU tensors this is the plain scatter once a
    column."""
    if not 1 <= len(weights) <= MAX_WEIGHTS:
        raise ValueError(f'K1 takes 1 to {MAX_WEIGHTS} weight columns, not {len(weights)}')
    cols = [c.to(torch.float32).contiguous() for c in (px, py, pz)]
    ws = [w if w is None else w.to(cols[0].device, torch.float32).contiguous() for w in weights]
    if cols[0].device.type == 'cpu':
        grids = torch.zeros((len(ws),) + (nmesh,) * 3, dtype=torch.float32)
        ones = torch.ones_like(cols[0])
        for f, w in enumerate(ws):
            paint_3d_plain(grids[f], *cols, ones if w is None else w, nmesh, box, offset)
        return grids
    given = [f for f, w in enumerate(ws) if w is not None]
    unit = len(given) < len(ws)
    plan = stage_gather(cols + [ws[f] for f in given], nmesh, box, offset)
    del cols
    grids = torch.empty((len(given) + unit,) + (nmesh,) * 3, dtype=torch.float32,
                        device=plan.starts.device)
    tsc_deposit_cells_multi(grids, plan)
    # the kernel's grid of each column: the unit one first, then the given
    order = [0 if w is None else unit + given.index(f) for f, w in enumerate(ws)]
    return grids if order == list(range(len(grids))) else grids[order]


# ---------------------------------------------------------------------------
# reference-compatible wrappers (ops/grid.py:740-842)
# ---------------------------------------------------------------------------


def _paint_pos(pos, nmesh, box, weights, offset, kind, wrap, device):
    """paint_3d of an (N, 3) numpy array or tensor; numpy goes to `device`
    (None: the card), a tensor is painted where it lies."""
    if isinstance(pos, torch.Tensor):
        dev = pos.device
    else:
        dev = resolve_device(device)
        pos = torch.from_numpy(np.ascontiguousarray(pos, np.float32)).to(dev)
    if weights is not None:
        weights = torch.as_tensor(weights).to(dev, torch.float32)
    return paint_3d(pos[:, 0], pos[:, 1], pos[:, 2], nmesh, box, weights, offset, kind,
                    wrap=wrap)


def tsc_parallel(pos, densgrid, box, weights=None, nthread=-1, wrap=True, npartition=None,
                 sort=False, coord=0, verbose=False, offset=0.0, device=None):
    """TSC mass assignment with the reference's calling convention
    (ops/grid.py:tsc_parallel). `nthread`, `npartition`, `sort`, `coord` and
    `verbose` are accepted for compatibility; K1 needs no striping.

    pos: (N, 3) numpy array (painted on `device`, None: the card) or tensor
    (painted where it lies). densgrid: an int or a tuple (the cubic shape to
    allocate; returns the grid as a float32 numpy array), or a cubic ndarray
    to accumulate into (returns None)."""
    if isinstance(densgrid, (int, np.integer)):
        densgrid = (int(densgrid),) * 3
    if isinstance(densgrid, tuple):
        nmesh = densgrid[0]
        assert all(n == nmesh for n in densgrid), 'only cubic grids on device'
        return _paint_pos(pos, nmesh, box, weights, offset, 'tsc', wrap, device).cpu().numpy()
    nmesh = densgrid.shape[0]
    assert densgrid.ndim == 3 and all(n == nmesh for n in densgrid.shape)
    out = _paint_pos(pos, nmesh, box, weights, offset, 'tsc', wrap, device).cpu().numpy()
    densgrid += out
    return None


def partition_parallel(pos, npartition, boxsize, weights=None, coord=0, nthread=-1, sort=False):
    """Partition (N, 3) positions into `npartition` stripes along `coord`
    (ops/grid.py:partition_parallel, which abacusnbody/analysis/tsc.py
    exports). Host numpy, as there, element for element: a stable sort by
    stripe and, with `sort`, each stripe ordered by `coord` with numpy's
    default argsort. K1 needs no stripes; this serves callers that do.
    Returns (sorted positions, stripe starts of length npartition + 1, the
    weights in the same order or None)."""
    pos = np.asarray(pos)
    assert pos.shape[1] == 3
    dtype = pos.dtype.type
    inv_pwidth = dtype(npartition / boxsize)
    keys = np.minimum((pos[:, coord] * inv_pwidth).astype(np.int32), npartition - 1)
    order = np.argsort(keys, kind='stable')
    psort = pos[order]
    counts = np.bincount(keys, minlength=npartition)
    starts = np.empty(npartition + 1, dtype=np.int64)
    starts[0] = 0
    np.cumsum(counts, out=starts[1:])
    wsort = weights[order] if weights is not None else None
    if sort:
        for i in range(npartition):
            seg = slice(starts[i], starts[i + 1])
            iord = psort[seg][:, coord].argsort()
            psort[seg] = psort[seg][iord]
            if wsort is not None:
                wsort[seg] = wsort[seg][iord]
    return psort, starts, wsort


def rightwrap(x, L):
    """x - L where x >= L (reference cic.py:7-10; scalars or arrays)."""
    res = np.where(np.asarray(x) >= L, np.asarray(x) - L, x)
    return res.item() if res.ndim == 0 else res


def cic_serial(positions, density, boxsize, weights=None, device=None):
    """CIC mass assignment (ops/grid.py:cic_serial: accumulates into the
    ndarray `density` in place; indices wrap). Cubic grids go through K1
    (unwrapped CIC, on `device` for numpy positions, None: the card);
    non-cubic grids, the 2-D gz == 1 projected mode among them, take the
    host path of the JAX package, the same nearest-centre stencil."""
    gx, gy, gz = density.shape
    if gx == gy == gz:
        out = _paint_pos(positions, gx, boxsize, weights, 0.0, 'cic', False, device)
        density += out.cpu().numpy()
        return
    pos = np.asarray(positions)
    w_pt = np.asarray(weights, np.float64) if weights is not None else 1.0
    axes = []
    for d, g in zip(range(3), (gx, gy, gz)):
        if d == 2 and gz == 1:
            # 2-D projected mode: the z cloud is the single plane, weight 1
            axes.append(([np.zeros(len(pos), np.int64)], [1.0]))
            continue
        p = pos[:, d] / boxsize * g
        i = np.floor(p + 0.5)  # nearest cell centre
        d_c = i - p  # in (-0.5, 0.5]
        ii = i.astype(np.int64)
        axes.append((
            [(ii - 1) % g, ii % g, (ii + 1) % g],
            [np.where(d_c > 0, d_c, 0.0), 1.0 - np.abs(d_c), np.where(d_c > 0, 0.0, -d_c)],
        ))
    (xi, xw), (yi, yw), (zi, zw) = axes
    for a in range(len(xi)):
        for b in range(len(yi)):
            wab = xw[a] * yw[b] * w_pt
            for c in range(len(zi)):
                np.add.at(density, (xi[a], yi[b], zi[c]), wab * zw[c])
