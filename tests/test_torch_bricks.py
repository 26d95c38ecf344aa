"""The brick staging of K1 (ops/grid.py:stage_bricks) against a numpy
reference, the plain deposit over a brick stage against JAX's paint_3d
(points displaced past their brick's margin included), the overflow word's
plain count, the brick defaults, and the device defaults of the port's
entry points (the card unless the caller names another; raising where
there is none).

Tolerances: keys, sort orders, work lists and overflow counts exact; grids
at rtol 1e-5 + atol 1e-6 max|grid| (the tolerance of
tests/test_torch_power_surface.py:test_paint_3d_matches_jax: the scatter
sums in another order than XLA's)."""

import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from abacusutils_tpu.ops import grid as jgrid
from abacusutils_tpu_torch.convert import staged_state_from_numpy
from abacusutils_tpu_torch.models import pipeline as tpipe
from abacusutils_tpu_torch.models.hod import population as tpop
from abacusutils_tpu_torch.ops import power as tpow
from abacusutils_tpu_torch.ops.grid import (
    BRICK,
    MAX_SMEM_BYTES,
    brick_key,
    brick_shape,
    overflow_count_plain,
    stage_bricks,
    tile_bytes,
    tsc_deposit_cells,
)
from torch_helpers import TRACERS, staged_state, t


def _np_cells(p, nmesh, box, offset, shift, kind):
    """The cell of each coordinate in unfused numpy f32 arithmetic, modulo
    nmesh (the cell rule of ops/grid.py:_axis_cloud)."""
    box32 = np.float32(box)
    p = p.astype(np.float32) + np.float32(shift)
    if kind == 'tsc':
        p = np.where(p >= box32, p - box32, p)
        p = np.where(p < 0, p + box32, p)
    q = (p + np.float32(offset)) * (np.float32(nmesh) / box32)
    return np.floor(q + np.float32(0.5)).astype(np.int64)


def _np_stage(pos, nmesh, box, brick, max_points, offset, shift, kind):
    """(key, stable order, [(brick, begin, end)]) of the brick staging."""
    nb = [-(-nmesh // b) for b in brick]
    cells = [_np_cells(pos[:, a], nmesh, box, offset, shift, kind) % nmesh for a in range(3)]
    key = ((cells[0] // brick[0]) * nb[1] + cells[1] // brick[1]) * nb[2] + cells[2] // brick[2]
    order = np.argsort(key, kind='stable')
    counts = np.bincount(key, minlength=int(np.prod(nb)))
    starts = np.concatenate([[0], np.cumsum(counts)])
    items = []
    for b in np.flatnonzero(counts):
        for begin in range(starts[b], starts[b + 1], max_points):
            items.append((b, begin, min(begin + max_points, starts[b + 1])))
    return key, order, np.array(items).reshape(-1, 3)


STAGE_CASES = [
    # nmesh, box, kind, brick (None: default), offset, shift, max_points
    (22, 50.0, 'tsc', None, 0.0, 0.0, 400),
    (30, 77.0, 'cic', (8, 5, 7), 0.3, 0.0, 250),
    (30, 60.0, 'tsc', (16, 4, 30), 0.0, 30.0, 10_000),
    (22, 50.0, 'cic', (3, 16, 5), 0.5 * 50.0 / 22, 0.0, 300),
]


@pytest.mark.parametrize('nmesh,box,kind,brick,offset,shift,max_points', STAGE_CASES)
def test_stage_bricks_matches_numpy(nmesh, box, kind, brick, offset, shift, max_points):
    """Keys, the stable order and the work list against a numpy reference
    on ragged meshes (the last brick of an axis is short), with empty
    bricks (no point has x in the upper half) and one heavy cell of 2000
    points that is cut into several items."""
    rng = np.random.default_rng(nmesh + (brick or BRICK)[1])
    n = 6000
    lo = -box / 2 - shift if kind == 'cic' else -shift
    pos = (rng.random((n, 3)) * box * np.array([0.5, 1.0, 1.0]) + lo).astype(np.float32)
    pos[:2000] = pos[0] + (rng.random((2000, 3)) * 0.2 * box / nmesh).astype(np.float32)
    w = rng.random(n).astype(np.float32)
    cols = [t(pos[:, i]) for i in range(3)] + [t(w)]
    staged, plan = stage_bricks(
        cols, nmesh, box, brick, offset=offset, shift=shift, kind=kind, max_points=max_points
    )
    brick = brick_shape(nmesh) if brick is None else brick
    key, order, items = _np_stage(pos, nmesh, box, brick, max_points, offset, shift, kind)
    got_key = brick_key(*cols[:3], nmesh, brick, box, offset, shift, kind)
    npt.assert_array_equal(got_key.numpy(), key)
    for s, c in zip(staged, cols):
        npt.assert_array_equal(s.numpy(), c.numpy()[order])
    assert plan.brick == tuple(brick)
    work = plan.work.numpy()
    assert work.dtype == np.int32
    assert len(work) == min(plan.nbricks, n) + -(-n // max_points)
    npt.assert_array_equal(work[: len(items)], items)
    assert (work[len(items):] == 0).all()
    assert plan.nbricks > len(np.unique(key))  # some bricks are empty
    heavy = key[0]
    assert (items[:, 0] == heavy).sum() >= 2000 // max_points  # the heavy brick is cut


def _displaced_case(kind, seed):
    """Random points (TSC: in [0, box); CIC: box-centred), their numpy
    weights, and a copy of the sorted stage with 400 points displaced by up
    to 3 cells along z and 100 along all three axes, past a margin of
    (0, 1, 1)."""
    nmesh, box = 40, 80.0
    rng = np.random.default_rng(seed)
    n = 8000
    lo = -box / 2 if kind == 'cic' else 0.0
    pos = (rng.random((n, 3)) * box + lo).astype(np.float32)
    w = rng.random(n).astype(np.float32)
    w[::11] = 0.0
    return nmesh, box, pos, w, rng


def _np_overflow(pos_before, pos_after, w, nmesh, box, plan, offset, kind):
    """Points of non-zero weight whose stencil, at the displaced position,
    leaves the tile of the brick they were staged in: the brick's cells and
    `margin` more each side, measured as the periodic distance of the
    displaced centre cell from the brick's first cell."""
    out = np.ones(len(w), bool)
    for a in range(3):
        b, m = plan.brick[a], plan.margin[a]
        c0 = _np_cells(pos_before[:, a], nmesh, box, offset, 0.0, kind) % nmesh
        c1 = _np_cells(pos_after[:, a], nmesh, box, offset, 0.0, kind)
        first = (c0 // b) * b
        d = (c1 - first + nmesh // 2) % nmesh - nmesh // 2
        out &= (d >= -m) & (d <= b - 1 + m)
    return int(((w != 0) & ~out).sum())


@pytest.mark.parametrize('kind', ['tsc', 'cic'])
@pytest.mark.parametrize('half_cell', [False, True])
def test_plain_deposit_over_brick_stage_matches_jax(kind, half_cell):
    """The deposit over a brick stage with a margin (0, 1, 1), some points
    then displaced up to 3 cells (past the margin): its CPU dispatch gives
    JAX's paint_3d of the displaced points, and its overflow word counts
    exactly the points that left their tile (a numpy count)."""
    nmesh, box, pos, w, rng = _displaced_case(kind, seed=3 + half_cell)
    offset = 0.5 * box / nmesh if half_cell else 0.0
    cols = [t(pos[:, i]) for i in range(3)] + [t(w)]
    margin = (0, 1, 1)
    (x, y, z, ws), plan = stage_bricks(
        cols, nmesh, box, (8, 8, 8), margin, offset=offset, kind=kind, max_points=700
    )
    before = np.stack([x.numpy(), y.numpy(), z.numpy()], 1)
    after = before.copy()
    h = box / nmesh
    after[:400, 2] += (rng.uniform(-3, 3, 400) * h).astype(np.float32)
    after[400:500] += (rng.uniform(-3, 3, (100, 3)) * h).astype(np.float32)
    grid = torch.zeros((nmesh,) * 3)
    overflow = torch.zeros(1, dtype=torch.int32)
    tsc_deposit_cells(grid, *(t(after[:, i]) for i in range(3)), ws, plan, box, offset, overflow,
                      kind)
    if kind == 'cic':
        ref = jgrid.paint_3d(jnp.asarray(after) + offset, nmesh, box, weights=ws.numpy(),
                             kind='cic', wrap=False)
    else:
        ref = jgrid.paint_3d(after, nmesh, box, weights=ws.numpy(), offset=offset, kind='tsc',
                             wrap=True)
    ref = np.asarray(ref)
    npt.assert_allclose(grid.numpy(), ref, rtol=1e-5, atol=1e-6 * np.abs(ref).max())
    want = _np_overflow(before, after, ws.numpy(), nmesh, box, plan, offset, kind)
    assert 50 < want < 500
    assert int(overflow) == want
    got = overflow_count_plain(*(t(after[:, i]) for i in range(3)), ws, plan, box, offset, kind)
    assert int(got) == want


def test_default_brick_fits_four_blocks():
    """The default brick's tile, with the box routes' z margin, leaves room
    for four blocks on an SM at every mesh the port runs; every nmesh gets
    full bricks (no divisor needed: 550 = 2 * 5^2 * 11 takes 16^3 bricks);
    `yb` sets the brick's y extent and a tile over a block's shared memory
    is refused."""
    margin = (0, 0, tpipe.RSD_MARGIN)
    for n in (8, 22, 32, 96, 128, 200, 256, 512, 550, 1024, 2048):
        brick = brick_shape(n, margin=margin)
        assert brick == tuple(min(b, n) for b in BRICK)
        # four tiles and the 1 KB each block reserves fit one SM's shared memory
        assert 4 * (tile_bytes(brick, margin) + 1024) <= MAX_SMEM_BYTES
    assert brick_shape(550) == (16, 16, 16) and tile_bytes((16, 16, 16)) == 23_328
    assert tile_bytes((16, 16, 16), margin) == 28_512
    assert brick_shape(256, yb=32) == (16, 32, 16)
    assert tile_bytes(brick_shape(256, yb=140, margin=margin), margin) <= MAX_SMEM_BYTES
    with pytest.raises(ValueError, match='use yb='):
        brick_shape(256, yb=256, margin=margin)


def test_run_hod_pk_fused_yb_sets_summation_order_only():
    """run_hod_pk_fused with another `yb` (the bricks' y extent) restages
    and gives the same spectra and galaxy counts, on the box leg and the
    light-cone leg."""
    halo, part = staged_state(3000, 12_000, 500.0, seed=9)
    for origin in (None, np.array([-260.0, -260.0, -260.0])):
        params = {'z': 0.5, 'Lbox': 500.0, 'velz2kms': 100.0, 'origin': origin}
        flags = dict(halo_lc=origin is not None)
        hod = staged_state_from_numpy(halo, part, params, TRACERS, flags, 'cpu')
        (cl_a, ng_a), (cl_b, ng_b) = (hod.run_hod_pk_fused(nmesh=32, yb=yb) for yb in (None, 4))
        assert ng_a == ng_b
        for key, v in cl_a.items():
            npt.assert_allclose(cl_b[key], v, rtol=1e-5, atol=1e-6 * np.abs(v).max(), err_msg=key)


# ---- device defaults -------------------------------------------------------


def _entry_points():
    """Each entry point that takes host (numpy) data, called without a
    device."""
    rng = np.random.default_rng(1)
    pos = (rng.random((500, 3)) * 100.0).astype(np.float32)
    halo, part = staged_state(200, 800, 100.0, seed=2)
    tp = tpop.prepare_tracer_params(TRACERS, 0.5)
    want = ('LRG', 'ELG', 'QSO')
    cargs = (halo['hpos'], halo['hvel'], halo['hmass'], halo['hid'], halo['hmultis'],
             halo['hrandoms'], halo['hveldev'], halo['hdeltac'], halo['hfenv'], halo['hshear'],
             tp, True, 0.01, 100.0, want)
    sargs = (part['ppos'], part['pvel'], part['phvel'], part['phmass'], part['phid'],
             part['pweights'], part['prandoms'], part['pdeltac'], part['pfenv'], part['pshear'],
             False, None, None, None, None, tp, True, 0.01, 100.0, want, None,
             np.zeros(800, np.int8))
    params = {'z': 0.5, 'Lbox': 100.0, 'velz2kms': 100.0, 'origin': None}
    ke2 = np.array([0.0, 4.0, 16.0], np.float32)
    me2 = np.array([0.0, 1.0], np.float32)
    return {
        'calc_power': lambda: tpow.calc_power(pos, 100.0, nmesh=8),
        'get_field': lambda: tpow.get_field(pos, 100.0, 8, 'TSC'),
        'get_field_fft': lambda: tpow.get_field_fft(pos, 100.0, 8, 'CIC', None, None, False,
                                                    False),
        'get_interlaced_field_fft': lambda: tpow.get_interlaced_field_fft(pos, 100.0, 8, 'TSC',
                                                                          None),
        'mode_bin_plan_device': lambda: tpow.mode_bin_plan_device(8, ke2, me2),
        'gen_cent': lambda: tpop.gen_cent(*cargs),
        'gen_sats': lambda: tpop.gen_sats(*sargs),
        'gen_gals': lambda: tpop.gen_gals(halo, part, TRACERS, params),
    }


@pytest.mark.parametrize('name', list(_entry_points()))
def test_entry_point_defaults_to_the_card(monkeypatch, name):
    """Called on host data without a device, each entry point goes to the
    card; where there is none it raises, and never falls back to the CPU
    or to the plain versions."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        _entry_points()[name]()


def test_tensors_keep_their_device(monkeypatch):
    """CPU tensors passed without a device stay on the CPU (the caller asked
    for it by putting them there), with or without a card."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    rng = np.random.default_rng(4)
    pos = torch.from_numpy((rng.random((2000, 3)) * 100.0).astype(np.float32))
    field = tpow.get_field(pos, 100.0, 8, 'CIC')
    assert field.device.type == 'cpu' and field.shape == (8, 8, 8)
    table = tpow.calc_power(pos, 100.0, nmesh=8)
    assert np.isfinite(table['power']).all()
