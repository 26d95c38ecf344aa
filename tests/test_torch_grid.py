"""Port parity: cell keys, staging and the TSC deposit of abacusutils_tpu_torch
against abacusutils_tpu on the same numpy inputs (JAX on CPU, the Pallas
deposit in interpret mode). The port stages by 3-D bricks; with the brick
(1, yb, nmesh) a brick is JAX's (x-cell, y-block) cell."""

import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from abacusutils_tpu.models.pipeline import group_inputs2d_device as jax_group_inputs2d_device
from abacusutils_tpu.ops.grid import cell_key_2d as jax_cell_key_2d
from abacusutils_tpu.ops.grid import paint_3d, paint_planned2
from abacusutils_tpu.ops.grid_pallas import build_paint_plan2d, paint_grouped2d
from abacusutils_tpu_torch import _build
from abacusutils_tpu_torch.ops.grid import (
    BrickPlan,
    brick_key,
    brick_shape,
    paint_3d_plain,
    stage_bricks,
    tsc_deposit_cells,
)
from abacusutils_tpu_torch.testing import edge_points
from torch_helpers import t


@pytest.mark.parametrize(
    'nmesh,yb,box,offset,shift',
    [(32, 8, 77.0, 0.0, 0.0), (64, 32, 2000.0, 0.0, 1000.0), (32, 8, 50.0, 25 / 32, 0.0)],
)
def test_cell_key_bit_exact(nmesh, yb, box, offset, shift):
    """The brick key of the brick (1, yb, nmesh) is JAX's cell key, bit for
    bit, on points placed where the cell index is fragile."""
    rng = np.random.default_rng(nmesh + yb)
    pos = edge_points(20_000, nmesh, yb, box, rng) - np.float32(shift)
    got = brick_key(
        *(t(pos[:, i]) for i in range(3)), nmesh, (1, yb, nmesh), box, offset, shift
    )
    ref = jax_cell_key_2d(
        jnp.asarray(pos[:, 0]), jnp.asarray(pos[:, 1]), nmesh, yb, box, offset, shift
    )
    assert got.dtype == torch.int32
    npt.assert_array_equal(got.numpy(), np.asarray(ref))


def test_staging_matches_jax_real_slots():
    """Staged by the brick (1, yb, nmesh), the stable sort gives exactly the
    real (non-pad) slots of the JAX padded layout, cell by cell, and the
    work list's items are its occupancy."""
    nmesh, yb, lbox = 32, 8, 500.0
    rng = np.random.default_rng(3)
    n = 40_000
    cat = {
        'x': (rng.random(n, dtype=np.float32) * lbox - lbox / 2),
        'y': (rng.random(n, dtype=np.float32) * lbox - lbox / 2),
        'z': rng.random(n, dtype=np.float32),
        'randoms': rng.random(n, dtype=np.float32),
    }
    cat['x'][:50] = np.float32(lbox / 2)  # lands on the wrapped edge
    jax_g, plan = jax_group_inputs2d_device(cat, nmesh, lbox, yb=yb, chunk=128)
    keys = list(cat)
    staged, bplan = stage_bricks(
        [t(cat[k]) for k in keys], nmesh, lbox, (1, yb, nmesh), shift=lbox / 2,
        max_points=n,
    )
    got = dict(zip(keys, staged))

    ncell = nmesh * (nmesh // yb)
    assert bplan.nbricks == ncell and bplan.work.dtype == torch.int32
    brick, begin, end = bplan.work.numpy().T
    real_items = end > begin
    assert (np.diff(brick[real_items]) > 0).all()  # one item a brick, in brick order
    assert int(begin[real_items][0]) == 0 and int(end[real_items][-1]) == n
    occ = np.zeros(ncell, np.int64)
    occ[brick[real_items]] = (end - begin)[real_items]
    assert plan.K == int(np.ceil(occ.max() / 128) * 128)
    real = np.arange(plan.K)[None, :] < occ[:, None]
    for k in cat:
        padded = np.asarray(jax_g[k]).reshape(ncell, plan.K)
        npt.assert_array_equal(got[k].numpy(), padded[real], err_msg=k)
        fill = 2.0 if k == 'randoms' else 0.0
        assert (padded[~real] == fill).all(), k


def _deposit_case(nmesh, yb, box, offset, seed, n):
    rng = np.random.default_rng(seed)
    pos = edge_points(n, nmesh, yb, box, rng)
    w = rng.random(n).astype(np.float32)
    w[::9] = 0.0
    return pos, w


@pytest.mark.parametrize(
    'nmesh,yb,box,offset',
    [(32, 8, 64.0, 0.0), (64, 32, 77.0, 0.0), (32, 8, 50.0, 25 / 32)],
)
def test_plain_deposit_matches_jax(nmesh, yb, box, offset):
    """paint_3d_plain against JAX paint_3d, the Pallas paint_grouped2d
    (interpret mode) and the y-blocked paint_planned2, at the tolerances of
    tests/test_tsc.py; the CPU dispatch of tsc_deposit_cells on the brick
    stage gives the same grid and an overflow word of 0."""
    pos, w = _deposit_case(nmesh, yb, box, offset, seed=nmesh + 1, n=20_000)
    cols = [t(pos[:, i]) for i in range(3)]
    got = paint_3d_plain(torch.zeros((nmesh,) * 3), *cols, t(w), nmesh, box, offset).numpy()

    ref = np.asarray(paint_3d(pos, nmesh, box, weights=w, offset=offset))
    npt.assert_allclose(got, ref, rtol=1e-4, atol=1e-6)
    npt.assert_allclose(got.sum(), w.sum(), rtol=1e-5)

    plan = build_paint_plan2d(pos[:, 0], pos[:, 1], nmesh, box, yb=yb, offset=offset, chunk=128)
    planned = paint_planned2(plan, pos[:, 0], pos[:, 1], pos[:, 2], weights=w, chunk=128)
    npt.assert_allclose(got, np.asarray(planned), rtol=1e-4, atol=1e-6)

    if offset == 0.0:
        idx = np.asarray(plan.pad_idx).reshape(-1)

        def grouped(a):
            return np.concatenate([a, np.zeros(1, a.dtype)])[idx].reshape(plan.ncell, plan.K)

        pallas = paint_grouped2d(
            plan, grouped(pos[:, 0]), grouped(pos[:, 1]), grouped(pos[:, 2]), grouped(w),
            chunk=64, interpret=True,
        )
        npt.assert_allclose(got, np.asarray(pallas), rtol=1e-4, atol=1e-6)

    (x, y, z, ws), bplan = stage_bricks(cols + [t(w)], nmesh, box, brick_shape(nmesh, yb),
                                        offset=offset)
    before = tsc_deposit_cells.launches
    grid = torch.zeros((nmesh,) * 3)
    overflow = torch.zeros(1, dtype=torch.int32)
    staged = tsc_deposit_cells(grid, x, y, z, ws, bplan, box, offset, overflow)
    assert tsc_deposit_cells.launches == before  # the plain version is no launch
    assert int(overflow) == 0
    npt.assert_allclose(staged.numpy(), got, rtol=1e-5, atol=1e-6)


def test_deposit_wrapper_never_falls_back(monkeypatch):
    """A non-CPU tensor goes to the kernel or raises: a brick whose tile
    does not fit shared memory is refused (brick_shape names a yb that
    fits), and a failing kernel library is not replaced by the plain
    version."""
    meta = dict(device='meta')
    grid = torch.empty((512,) * 3, **meta)
    pts = [torch.empty(10, **meta) for _ in range(4)]
    work = torch.empty((4, 3), dtype=torch.int32, **meta)
    with pytest.raises(ValueError, match='use yb=177'):
        brick_shape(512, yb=400)
    with pytest.raises(ValueError, match='over 232448 B'):
        tsc_deposit_cells(grid, *pts, BrickPlan(work, 512, (16, 400, 16), (0, 0, 0)), 1.0)

    class NoKernel(RuntimeError):
        pass

    def no_lib():
        raise NoKernel

    monkeypatch.setattr(_build, 'lib', no_lib)
    grid = torch.empty((32,) * 3, **meta)
    plan = BrickPlan(work, 32, (16, 8, 16), (0, 0, 2))
    overflow = torch.empty(1, dtype=torch.int32, **meta)
    with pytest.raises(NoKernel):
        tsc_deposit_cells(grid, *pts, plan, 1.0, overflow=overflow)
    with pytest.raises(ValueError, match='float32'):
        tsc_deposit_cells(grid, pts[0].double(), *pts[1:], plan, 1.0, overflow=overflow)
    with pytest.raises(ValueError, match='int32'):
        tsc_deposit_cells(grid, *pts, plan._replace(work=work.long()), 1.0)
