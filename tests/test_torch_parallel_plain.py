"""The plain versions of the sharded path's kernel forms, on the CPU: K1's
slab mode, the ky-slab mode-bin plans and binning, K5's row offset, and the
mesh helpers on a world of one gloo rank. JAX-free."""

import numpy as np
import numpy.testing as npt
import pytest
import torch

from abacusutils_tpu_torch.ops import grid as tgrid
from abacusutils_tpu_torch.ops import power as tpow
from abacusutils_tpu_torch.ops import tpcf as ttpcf
from abacusutils_tpu_torch.parallel import fft as pfft
from abacusutils_tpu_torch.parallel import mesh as pmesh
from torch_helpers import gloo_mesh, t  # noqa: F401

BOX = 300.0


def _slab_points(nmesh, ndev, rank, h, n, seed):
    """Points whose TSC centre lies in the rank's slab of a split of nmesh
    into ndev x-slabs, and with h = 2 also one cell past it on each side
    (the slack of parallel/fft.py:shard_slabs)."""
    rng = np.random.default_rng(seed)
    xl = nmesh // ndev
    lo, hi = rank * xl - (h - 1), (rank + 1) * xl + (h - 1)
    cell = rng.integers(lo, hi, n)
    x = ((cell + rng.random(n) - 0.5) * BOX / nmesh) % BOX
    pos = np.stack([x, rng.random(n) * BOX, rng.random(n) * BOX], 1).astype(np.float32)
    return pos, rng.random(n).astype(np.float32)


@pytest.mark.parametrize('h', [1, 2])
@pytest.mark.parametrize('nmesh,ndev', [(32, 4), (24, 2), (20, 1)])
def test_slab_deposit_plain_folds_to_full_grid(nmesh, ndev, h):
    """Every rank's slab deposit (slab 0 and slab n-1 across the wrap among
    them), its planes added onto the global planes x0 - h + p, equals the
    full-grid plain scatter of the same points; through stage_bricks(slab=)
    and tsc_deposit_cells it is the same deposit."""
    xl = nmesh // ndev
    for rank in range(ndev):
        pos, w = _slab_points(nmesh, ndev, rank, h, 4000, 100 * nmesh + rank)
        cols = [t(pos[:, i]) for i in range(3)]
        slab = (rank * xl, h, xl + 2 * h)
        grid = torch.zeros((xl + 2 * h, nmesh, nmesh))
        fault = tgrid.paint_slab_plain(grid, *cols, t(w), nmesh, BOX, slab)
        assert int(fault) == 0
        full = torch.zeros((nmesh,) * 3)
        full.index_add_(0, torch.remainder(torch.arange(xl + 2 * h) + rank * xl - h, nmesh), grid)
        want = tgrid.paint_3d_plain(torch.zeros((nmesh,) * 3), *cols, t(w), nmesh, BOX)
        npt.assert_allclose(full.numpy(), want.numpy(), rtol=1e-5, atol=1e-6 * float(want.max()))
        (x, y, z, ws), plan = tgrid.stage_bricks(cols + [t(w)], nmesh, BOX, slab=slab)
        assert plan.grid_shape == (xl + 2 * h, nmesh, nmesh)
        again = tgrid.tsc_deposit_cells(torch.zeros(plan.grid_shape), x, y, z, ws, plan, BOX)
        npt.assert_allclose(again.numpy(), grid.numpy(), rtol=1e-6, atol=1e-7)


def test_slab_fault_and_overflow():
    """A point whose cloud leaves the slab adds nothing and is a fault (the
    wrapper without a fault word raises); points moved after staging past
    their tile are overflow, counted apart from faults."""
    nmesh, xl, h = 32, 8, 1
    pos, w = _slab_points(nmesh, 4, 1, h, 2000, 5)
    pos[:10, 0] = (20.5 * BOX / nmesh)  # centre 20 lies outside slab 1's planes 7 .. 16
    cols = [t(pos[:, i]) for i in range(3)] + [t(w)]
    slab = (xl, h, xl + 2 * h)
    (x, y, z, ws), plan = tgrid.stage_bricks(cols, nmesh, BOX, slab=slab)
    grid = torch.zeros(plan.grid_shape)
    fault = torch.zeros(1, dtype=torch.int32)
    tgrid.tsc_deposit_cells(grid, x, y, z, ws, plan, BOX, fault=fault)
    assert int(fault) == 10
    good = torch.zeros_like(grid)
    assert int(tgrid.paint_slab_plain(good, *(c[10:] for c in cols), nmesh, BOX, slab)) == 0
    npt.assert_allclose(grid.numpy(), good.numpy(), rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match='outside the slab'):
        tgrid.tsc_deposit_cells(torch.zeros_like(grid), x, y, z, ws, plan, BOX)
    assert int(tgrid.overflow_count_plain(x, y, z, ws, plan, BOX)) == 0
    moved = y + 20 * BOX / nmesh  # most points leave their brick's tile along y
    overflow = torch.zeros(1, dtype=torch.int32)
    fault.zero_()
    tgrid.tsc_deposit_cells(torch.zeros_like(grid), x, moved, z, ws, plan, BOX, 0.0, overflow,
                            fault=fault)
    assert int(fault) == 10 and int(overflow) > 1000
    # the faults are not overflow: the stencils that leave the tile along y
    # alone, counted apart, take in only the points inside the slab
    b = plan.brick[1]
    work = plan.work.long()
    bid = torch.repeat_interleave(work[:, 0], work[:, 2] - work[:, 1])
    j = torch.div(bid, -(-nmesh // plan.brick[2]), rounding_mode='floor') % -(-nmesh // b)
    i0, _ = tgrid.axis_cloud(moved, BOX, 0.0, nmesh)
    leaves = torch.remainder(i0 - 1 - (j * b - 1), nmesh) + 2 >= b + 2
    sx, _ = tgrid.axis_cloud(x, BOX, 0.0, nmesh)
    plane = tgrid.slab_plane(sx, nmesh, slab)
    inside = (plane - 1 >= 0) & (plane + 1 < xl + 2)
    assert int(overflow) == int((leaves & inside & (ws != 0)).sum())


@pytest.mark.parametrize('ndev', [2, 4])
@pytest.mark.parametrize('n1d', [32, 30])
def test_ky_slab_plans_split_the_full_plan(n1d, ndev):
    """Each ky-slab plan's seg and pole weights are the full plan's rows,
    their counts add up to its counts (ksum to f64 round-off), their row
    spans are its rows' spans, and the slab binning (W and poles included)
    adds up to the full binning."""
    lbox, nk, nmu = 400.0, n1d // 2, 2
    kedges, muedges = tpow.get_k_mu_edges(lbox, np.pi * n1d / lbox, nk, nmu, False)
    dk = 2 * np.pi / lbox
    k2 = ((kedges / dk) ** 2).astype(np.float32)
    m2 = (muedges**2).astype(np.float32)
    kzlen = n1d // 2 + 1
    full = tpow.get_mode_bin_plan(n1d, k2, m2, (2, 4), 'cpu')
    seg = full.seg.reshape(n1d, n1d, kzlen)
    rng = np.random.default_rng(n1d + ndev)
    dks = [torch.fft.rfftn(t(rng.standard_normal((n1d,) * 3).astype(np.float32)))
           for _ in range(2)]
    W = t(tpow.get_W_compensated(lbox, n1d, 'TSC', False).astype(np.float32))
    want, want_p = tpow.bin_pair_modes_plain(dks, full.seg, W, 1e-3, nk * nmu,
                                             full.pole_w, nmu)
    yl = -(-n1d // ndev)
    counts = np.zeros_like(full.counts)
    ksum = np.zeros_like(full.ksum)
    sums, psums = torch.zeros_like(want), torch.zeros_like(want_p)
    for y0 in range(0, n1d, yl):
        ys = (y0, min(y0 + yl, n1d))
        sp = tpow.get_mode_bin_plan(n1d, k2, m2, (2, 4), 'cpu', yslab=ys)
        assert sp.yslab == ys
        npt.assert_array_equal(sp.seg.reshape(n1d, -1, kzlen).numpy(),
                               seg[:, ys[0]:ys[1]].numpy())
        for p in (2, 4):
            npt.assert_array_equal(sp.pole_w[p].reshape(n1d, -1, kzlen).numpy(),
                                   full.pole_w[p].reshape(n1d, n1d, kzlen)[:, ys[0]:ys[1]].numpy())
        rows = full.spans.bounds.reshape(n1d, n1d, 2)[:, ys[0]:ys[1]]
        npt.assert_array_equal(sp.spans.bounds.reshape(n1d, -1, 2).numpy(), rows.numpy())
        assert tpow.mode_spans(sp.seg, nk * nmu) is sp.spans
        counts += sp.counts
        ksum += sp.ksum
        s, ps = tpow.bin_pair_modes(
            [d[:, ys[0]:ys[1]] for d in dks], sp.seg, W, 1e-3, nk * nmu, sp.pole_w, nmu,
            yslab=ys)
        sums += s
        psums += ps
    npt.assert_array_equal(counts, full.counts)
    npt.assert_allclose(ksum, full.ksum, rtol=1e-12)
    npt.assert_allclose(sums.numpy(), want.numpy(), rtol=1e-9, atol=1e-12)
    npt.assert_allclose(psums.numpy(), want_p.numpy(), rtol=1e-9, atol=1e-12)


def test_ky_slab_arguments_are_checked():
    n1d = 16
    seg = tpow.get_mode_bin_plan(n1d, np.float32([0, 4, 16]), np.float32([0, 1]), (), 'cpu',
                                 yslab=(4, 8)).seg
    dk = torch.zeros((n1d, 4, n1d // 2 + 1), dtype=torch.complex64)
    tpow.bin_power_modes(dk, seg, None, 1.0, 2, yslab=(4, 8))
    with pytest.raises(ValueError, match='rfft mesh'):
        tpow.bin_power_modes(dk, seg, None, 1.0, 2)
    with pytest.raises(ValueError, match='outside'):
        tpow.get_mode_bin_plan(n1d, np.float32([0, 4]), np.float32([0, 1]), (), 'cpu',
                               yslab=(8, 20))


@pytest.mark.parametrize('mode', ['rppi', 'smu'])
def test_k5_row_offset_plain(mode):
    """The autocorrelation's counts are the sum of its row shards' counts
    against the whole set, each with its global row offset."""
    rng = np.random.default_rng(3)
    pos = torch.from_numpy(rng.random((900, 3)) * 100.0)
    cols = [pos[:, i].contiguous() for i in range(3)]
    edges2 = np.array([0.0, 4.0, 25.0, 100.0])
    want = ttpcf.count_pairs_all(cols, None, edges2, 5, mode, 100.0, 5.0)
    got = sum(ttpcf.count_pairs_all([c[a:b] for c in cols], cols, edges2, 5, mode, 100.0, 5.0,
                                    row0=a) for a, b in ((0, 300), (300, 650), (650, 900)))
    npt.assert_array_equal(got.numpy(), want.numpy())
    with pytest.raises(ValueError, match='row0'):
        ttpcf.count_pairs_all([c[:300] for c in cols], cols, edges2, 5, mode, 100.0, row0=700)


def test_make_mesh_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip('this host has a card')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        pmesh.make_mesh()


def test_one_rank_world(gloo_mesh):
    """On a world of one rank: the collectives are identities, a ring shift
    refuses (it would send to itself), a tensor of another device type than
    the mesh's raises, the slab FFT is rfftn, and the halo fold is the
    periodic wrap."""
    mesh = gloo_mesh
    assert pmesh.mesh_size(mesh) == 1 and pmesh.mesh_rank(mesh) == 0
    x = torch.arange(6.0)
    assert pmesh.all_reduce(x, mesh) is x and pmesh.all_gather_rows(x, mesh) is x
    with pytest.raises(ValueError, match='sends to itself'):
        pmesh.ring_shift(x, 1, mesh)
    with pytest.raises(ValueError, match='meta tensor on a cpu mesh'):
        pmesh.all_reduce(torch.empty(3, device='meta'), mesh)
    g = torch.from_numpy(np.random.default_rng(1).standard_normal((8, 8, 8)).astype(np.float32))
    npt.assert_allclose(pfft.slab_rfftn(g, mesh).numpy(), torch.fft.rfftn(g).numpy(),
                        rtol=1e-5, atol=1e-5)
    npt.assert_allclose(pfft.slab_irfftn(pfft.slab_rfftn(g, mesh), mesh, 8).numpy(), g.numpy(),
                        rtol=1e-5, atol=1e-5)
    slab = torch.from_numpy(np.random.default_rng(2).random((12, 4, 4)).astype(np.float32))
    want = slab[2:10].clone()
    want[:2] += slab[10:]
    want[6:] += slab[:2]
    npt.assert_array_equal(pfft.fold_halos(slab.clone(), 2, mesh).numpy(), want.numpy())
    assert pmesh.row_block(10, mesh) == (0, 10)
