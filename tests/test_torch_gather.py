"""Port parity for K1's multi-weight gather on the CPU: the cell stage
(abacusutils_tpu_torch/ops/grid.py:stage_gather) keys each point by K1's
stencil centre bit for bit, and the gather's plain walk
(gather_deposit_plain, the CPU path of tsc_deposit_cells_multi) equals the
plain scatter paint_3d_plain once a column, JAX's paint_3d and JAX's
paint_grouped_yb_multiw within 1e-5 of max|grid| (float32 sums in another
order), on meshes where neighbour cells repeat through the wrap, odd
meshes, ragged last bricks and points on exact cell edges."""

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from abacusutils_tpu.models.pipeline import group_inputs2d
from abacusutils_tpu.ops.grid import fold_ypad, paint_3d, paint_grouped_yb_multiw
from abacusutils_tpu_torch.ops.grid import (
    GATHER_BRICK,
    _tsc_weight,
    axis_cloud,
    gather_deposit_plain,
    gather_key,
    paint_3d_multi,
    paint_3d_plain,
    stage_gather,
    tsc_deposit_cells_multi,
)
from abacusutils_tpu_torch.testing import edge_points
from torch_helpers import t

BOX = 100.0


def _points(nmesh, n, seed, edges=True):
    """n float32 points in [0, BOX]: with `edges` about half on cell edges,
    their next float up, brick edges, 0, BOX and just below 0."""
    rng = np.random.default_rng(seed)
    if edges:
        return edge_points(n, nmesh, min(8, nmesh), BOX, rng), rng
    return (rng.random((n, 3)) * BOX).astype(np.float32), rng


def _weights(rng, n, nf):
    """A unit column (None) and nf - 1 weight columns, zeros in the second."""
    ws = [None] + [rng.normal(size=n).astype(np.float32) for _ in range(nf - 1)]
    if nf > 1:
        ws[1][::7] = 0.0
    return ws


@pytest.mark.parametrize('nmesh,shift', [(3, 0.5), (4, 0.0), (7, 0.0), (7, 0.5), (33, 0.5)])
def test_stage_keys_are_k1_centre_cells(nmesh, shift):
    """Every staged point lies in the run of the key of its TSC stencil
    centre (axis_cloud's, modulo nmesh; the interlacing offset of `shift`
    cells included), the stage is stable, its offsets give axis_cloud's
    weights bit for bit, and the brick-major keys of the grid's cells are
    distinct, each brick's one run."""
    pos, rng = _points(nmesh, 4000, nmesh)
    cols = [t(pos[:, i]) for i in range(3)]
    offset = shift * BOX / nmesh
    w = t(rng.random(len(pos)).astype(np.float32))
    plan, order = stage_gather(cols + [w], nmesh, BOX, offset, return_order=True)
    assert plan.points.shape == (len(pos), 4) and plan.nweights == 1
    starts = plan.starts.long()
    assert int(starts[0]) == 0 and int(starts[-1]) == len(pos)
    key = torch.repeat_interleave(torch.arange(starts.numel() - 1), torch.diff(starts))
    cells = []
    for a, c in enumerate(cols):
        i0, ws = axis_cloud(c[order], BOX, offset, nmesh)
        cells.append(torch.remainder(i0, nmesh))
        for slot in range(3):
            assert torch.equal(_tsc_weight(slot, plan.points[:, a]), ws[slot])
    assert torch.equal(key, gather_key(*cells, nmesh))
    assert torch.equal(plan.points[:, 3], w[order])
    same = key[1:] == key[:-1]
    assert bool((order[1:][same] > order[:-1][same]).all())
    c = torch.arange(nmesh)
    grid = gather_key(*(a.reshape(-1) for a in torch.meshgrid(c, c, c, indexing='ij')), nmesh)
    assert grid.unique().numel() == nmesh**3 and int(grid.max()) < starts.numel() - 1
    brick = torch.stack(torch.meshgrid(c, c, c, indexing='ij')).reshape(3, -1)
    bid = ((brick[0] // GATHER_BRICK[0]) * 64 + brick[1] // GATHER_BRICK[1]) * 64 + (
        brick[2] // GATHER_BRICK[2])
    for b in bid.unique():
        k = grid[bid == b]
        assert int(k.max() - k.min()) < np.prod(GATHER_BRICK)


@pytest.mark.parametrize('nf', [1, 3, 5])
@pytest.mark.parametrize('nmesh', [3, 4, 7, 16])
def test_gather_walk_matches_scatter_and_jax(nmesh, nf):
    """gather_deposit_plain through tsc_deposit_cells_multi's CPU path
    writes every cell (the grids' old values go) and equals the plain
    scatter of each column on edge points, and JAX's paint_3d on random
    points (JAX's CPU paint misplaces exact cell-edge points), within 1e-5
    of max|grid|; at nmesh 3 and 4 the stencil reaches the same cell
    through the wrap."""
    for edges in (True, False):
        pos, rng = _points(nmesh, 3000, 10 * nmesh + nf, edges)
        cols = [t(pos[:, i]) for i in range(3)]
        ws = _weights(rng, len(pos), nf)
        plan = stage_gather(cols + [t(w) for w in ws[1:]], nmesh, BOX)
        grids = torch.full((nf,) + (nmesh,) * 3, 7.0)
        before = tsc_deposit_cells_multi.launches
        assert tsc_deposit_cells_multi(grids, plan) is grids
        assert tsc_deposit_cells_multi.launches == before  # the plain walk is no launch
        for f, w in enumerate(ws):
            wt = torch.ones(len(pos)) if w is None else t(w)
            ref = paint_3d_plain(torch.zeros((nmesh,) * 3), *cols, wt, nmesh, BOX).numpy()
            scale = np.abs(ref).max()
            npt.assert_allclose(grids[f].numpy(), ref, rtol=0, atol=1e-5 * scale)
            if not edges:
                jref = np.asarray(paint_3d(pos, nmesh, BOX, weights=wt.numpy()))
                npt.assert_allclose(grids[f].numpy(), jref, rtol=0, atol=1e-5 * scale)


def test_gather_walk_matches_jax_multiweight():
    """Five columns (the first a unit weight) against JAX's
    paint_grouped_yb_multiw on its (x-cell, y-block) layout, as
    tests/test_tsc.py runs it, at 1e-5 of max|grid|."""
    nmesh, B, F, n = 16, 8, 5, 4000
    rng = np.random.default_rng(9)
    pos = (rng.random((n, 3)) * BOX - BOX / 2).astype(np.float32)
    ws = np.concatenate([np.ones((1, n), np.float32),
                         rng.normal(1.0, 0.3, (F - 1, n)).astype(np.float32)])
    cat = {'x': pos[:, 0], 'y': pos[:, 1], 'z': pos[:, 2]}
    for f in range(F):
        cat[f'w{f}'] = ws[f]
    g, plan = group_inputs2d(cat, nmesh, BOX, yb=B, chunk=64)
    K, ncell = plan.K, nmesh * (nmesh // B)
    half = jnp.float32(BOX / 2)

    @jax.jit
    def multi(wgs):
        gps = jnp.zeros((F, nmesh, nmesh + 2, nmesh), jnp.float32)
        gps = paint_grouped_yb_multiw(
            gps, *((g[a] + half).reshape(ncell, K) for a in 'xyz'), wgs.reshape(F, ncell, K),
            BOX, 0.0, nmesh, B, chunk=64)
        return jnp.stack([fold_ypad(gps[f], nmesh) for f in range(F)])

    ref = np.asarray(multi(jnp.stack([g[f'w{f}'] for f in range(F)])))
    cols = [t(pos[:, i] + np.float32(BOX / 2)) for i in range(3)]
    cplan = stage_gather(cols + [t(w) for w in ws[1:]], nmesh, BOX)
    got = gather_deposit_plain(torch.empty((F,) + (nmesh,) * 3), cplan)
    for f in range(F):
        npt.assert_allclose(got[f].numpy(), ref[f], rtol=0, atol=1e-5 * np.abs(ref[f]).max())


def test_gather_wrapper_checks_its_inputs():
    """Column counts and grid shapes the gather does not take are refused
    before any launch."""
    nmesh, n = 8, 50
    pos, rng = _points(nmesh, n, 1, edges=False)
    cols = [t(pos[:, i]) for i in range(3)]
    w = [t(rng.random(n).astype(np.float32)) for _ in range(6)]
    with pytest.raises(ValueError, match='0 to 5 weight columns'):
        stage_gather(cols + w, nmesh, BOX)
    plan = stage_gather(cols + w[:2], nmesh, BOX)
    for f in (1, 4):
        with pytest.raises(ValueError, match='grids must be'):
            tsc_deposit_cells_multi(torch.empty((f,) + (nmesh,) * 3), plan)
    with pytest.raises(ValueError, match='1 to 5 weight columns'):
        paint_3d_multi(*cols, nmesh, BOX, [None] * 6)
