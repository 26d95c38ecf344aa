"""Pair-count parity on the cell grids: boxes of 3 to 11 cells a side, the
grid of rmax / 2 and its fallbacks, the reach of three cells, the pruned
row walk and the stage shapes a finer grid makes risky, each against JAX
and the f32 brute force (tests/tpcf_helpers.py says which JAX).
"""

import numpy as np
import numpy.testing as npt
import pytest

from abacusutils_tpu.ops import tpcf as jtpcf
from abacusutils_tpu_torch.ops import tpcf as ttpcf
from torch_helpers import t
from tpcf_helpers import (
    RPBINS, RP0, PIMAX, SBINS, NMU, _mode, _points, _brute, _rules_agree, _both,
)


@pytest.mark.parametrize('lbox,nc', [(95.0, 3), (125.0, 4), (160.0, 5), (333.0, 11)])
def test_cell_grids_small_and_large(lbox, nc):
    """nc of 3 and 4 take the per-pair round, nc >= 5 the item-constant
    wrap; points on the box faces and pairs across the periodic wrap."""
    assert int(lbox // 30) == nc
    rng = np.random.default_rng(nc)
    pos = _points(2000, rng, lbox)
    pos[:50, 0] = 0.0
    pos[50:100, 2] = np.nextafter(np.float32(lbox), np.float32(0))
    pos2 = rng.random((900, 3)) * lbox
    for mode, edges, nb2 in (('rppi', RPBINS, PIMAX), ('smu', np.linspace(0.1, 30, 7), NMU)):
        for p2 in (None, pos2):
            got, ref = _both(mode, pos, edges, nb2, lbox=lbox, pos2=p2, method='cell')
            assert _rules_agree(pos, p2, edges, nb2, mode, lbox)
            npt.assert_array_equal(got, ref, err_msg=f'{mode} {_mode()}')
            npt.assert_array_equal(got, _brute(pos, p2, edges, nb2, mode, lbox))


@pytest.fixture
def fine_grid(monkeypatch):
    """Let the dispatch refine the grid whatever the density of the catalog."""
    monkeypatch.setattr(ttpcf, '_FINE_MIN_OCC', 0.0)
    ttpcf._stage_cache.clear()
    yield monkeypatch
    ttpcf._stage_cache.clear()


@pytest.mark.parametrize('cross', [False, True], ids=['auto', 'cross'])
@pytest.mark.parametrize('mode', ['rppi', 'smu'])
@pytest.mark.parametrize('refine', [1, 2])
def test_fine_grids_match_jax_and_brute(fine_grid, refine, mode, cross):
    """The plain version on grids of rmax and rmax / 2 cells (a reach of 1
    and 2 cells, items of two cells, the pruned rows) equals JAX's cell
    engine and the f32 brute force bin for bin."""
    if refine == 1:
        fine_grid.setattr(ttpcf, '_FINE_MIN_OCC', np.inf)
    rng = np.random.default_rng(20 + refine + 4 * cross)
    lbox = 200.0
    pos = _points(1500, rng, lbox)
    pos[:30, 2] = 0.0
    pos[30:60, 0] = np.nextafter(np.float32(lbox), np.float32(0))
    pos2 = _points(700, rng, lbox) if cross else None
    edges, nb2 = (RP0, PIMAX) if mode == 'rppi' else (SBINS, NMU)
    rmax = 30.0 if mode == 'rppi' else 25.0
    nc, got_refine = ttpcf.cell_grid(lbox, rmax, 700)
    assert got_refine == refine and nc == int(lbox * refine // rmax)
    walk = ttpcf.walk_rows(nc, lbox, float(ttpcf.edges_f32(edges**2)[-1]), nb2, mode, not cross)
    assert walk.reach == refine and walk.use_wrap
    got, ref = _both(mode, pos, edges, nb2, lbox=lbox, pos2=pos2, method='cell')
    assert ttpcf._stage_cache == [] and got.sum() > 0
    assert _rules_agree(pos, pos2, edges, nb2, mode, lbox)
    npt.assert_array_equal(got, ref, err_msg=_mode())
    npt.assert_array_equal(got, _brute(pos, pos2, edges, nb2, mode, lbox))


@pytest.mark.parametrize('cross', [False, True], ids=['auto', 'cross'])
@pytest.mark.parametrize('mode', ['rppi', 'smu'])
def test_reach_of_three_cells(mode, cross):
    """Cells of a third of the largest separation. In (rp, pi) with rp under
    one cell and pimax of three, the walk is 3 x 3 rows of cells that reach
    three cells along z; in (s, mu) the half walk of an autocorrelation is
    25 of the 7 x 7 rows. The plain version on those stages equals JAX's cell
    engine (on its own grid: the counts do not depend on it) and the f32
    brute force. The full (s, mu) walk of a cross-correlation is 49 rows:
    more than the kernel's 25, refused."""
    rng = np.random.default_rng(60 + cross)
    lbox, nc = 200.0, 20
    pos = _points(1500, rng, lbox)
    pos[:30, 2] = 0.0
    pos2 = _points(700, rng, lbox) if cross else None
    wrap = lambda p: [t(np.mod(p, lbox).astype(np.float32)[:, i]) for i in range(3)]  # noqa: E731
    s1 = ttpcf.stage_cells(*wrap(pos), lbox, nc, span=2)
    s2 = ttpcf.stage_cells(*wrap(pos2), lbox, nc, span=2) if cross else None
    edges, nb2 = (np.array([0.0, 0.5, 3.0, 10.0]), PIMAX) if mode == 'rppi' else (
        np.linspace(0.1, 30, 7), NMU)
    thr = ttpcf.edges_f32(edges**2)
    walk = ttpcf.walk_rows(nc, lbox, float(thr[-1]), nb2, mode, not cross)
    assert walk.reach_z == 3 and walk.use_wrap
    assert len(walk.rows) == {'rppi': (5, 9), 'smu': (25, 49)}[mode][cross]
    if len(walk.rows) > ttpcf.K4_MAX_ROWS:
        with pytest.raises(ValueError, match="exceeds the kernel's 25"):
            ttpcf.count_pairs_cells(s1, s2, thr, nb2, mode, float(nb2))
        return
    got = ttpcf.count_pairs_cells(s1, s2, thr, nb2, mode, float(nb2)).numpy()
    jax_counts = jtpcf.pair_counts_rppi if mode == 'rppi' else jtpcf.pair_counts_smu
    ref = jax_counts(pos, edges, nb2, lbox, pos2=pos2, method='cell')
    assert _rules_agree(pos, pos2, edges, nb2, mode, lbox) and got.sum() > 0
    npt.assert_array_equal(got.reshape(ref.shape), ref, err_msg=_mode())
    npt.assert_array_equal(got.reshape(ref.shape), _brute(pos, pos2, edges, nb2, mode, lbox))


@pytest.mark.parametrize('nc_max,want', [(16, (13, 2)), (12, (6, 1)), (5, (5, 1))])
def test_fine_grid_falls_back_to_a_coarser_one(fine_grid, nc_max, want):
    """A grid of rmax / 2 cells over _NC_MAX cells a side is not taken: the
    grid of rmax cells is, capped at _NC_MAX; the counts stay."""
    fine_grid.setattr(ttpcf, '_NC_MAX', nc_max)
    lbox = 200.0
    assert ttpcf.cell_grid(lbox, 30.0, 10**9) == want
    rng = np.random.default_rng(31)
    pos = _points(1200, rng, lbox)
    for mode, edges, nb2 in (('rppi', RPBINS, PIMAX), ('smu', np.linspace(0.1, 30, 7), NMU)):
        got, ref = _both(mode, pos, edges, nb2, lbox=lbox, method='cell')
        assert _rules_agree(pos, None, edges, nb2, mode, lbox)
        npt.assert_array_equal(got, ref, err_msg=f'{mode} {_mode()}')
        npt.assert_array_equal(got, _brute(pos, None, edges, nb2, mode, lbox))


def test_density_picks_the_grid(monkeypatch):
    """cell_grid refines only while the sparser side fills the cells."""
    assert ttpcf._FINE_MIN_OCC == 2.0 and ttpcf._NC_MAX == 160 and ttpcf.K4_MAX_ROWS == 25
    assert ttpcf.cell_grid(2000.0, 30.0, 14_000_000) == (133, 2)
    assert ttpcf.cell_grid(2000.0, 30.0, 1_200_000) == (66, 1)
    assert ttpcf.cell_grid(2000.0, 30.0, 10**8) == (133, 2)
    assert ttpcf.cell_grid(2000.0, 20.0, 10**9) == (100, 1)
    assert ttpcf.cell_grid(2000.0, 5.0, 10**9) == (160, 1)
    assert ttpcf.cell_grid(100.0, 30.0, 10**6) == (6, 2)
    assert ttpcf.default_span(3, 1) == 1 and ttpcf.default_span(6, 2) == 2
    assert ttpcf.default_span(133, 2, 14_000_000) == 3 and ttpcf.default_span(66, 1, 80_000) == 4
    assert ttpcf.default_span(66, 1, 10**8) == 1 and ttpcf.default_span(5, 2, 10) == 1


@pytest.mark.parametrize('seed', range(6))
def test_pruned_rows_hold_every_pair_in_range(seed):
    """No pair within the largest edge (and pimax) lies in a cell the walk
    skips: a seeded sweep over grids, bins and random points, the cells
    taken from the stage's own cell index."""
    rng = np.random.default_rng(100 + seed)
    lbox = float(rng.uniform(100, 300))
    rmax = float(rng.uniform(12, lbox / 3.2))
    refine = int(rng.integers(1, 4))  # 3: finer than the dispatch goes
    nc = int(lbox * refine // rmax)
    mode = ('rppi', 'smu')[seed % 2]
    nb2 = int(rmax * rng.uniform(0.4, 1.0)) if mode == 'rppi' else 10
    e2max = float(ttpcf.edges_f32([rmax**2])[0])
    walk = ttpcf.walk_rows(nc, lbox, e2max, nb2, mode, False)
    kd = {(int(a), int(b)): int(k) for a, b, k, _ in walk.rows}
    half = ttpcf.walk_rows(nc, lbox, e2max, nb2, mode, True)
    assert {(a, b) for a, b in kd if (a, b) >= (0, 0)} == {(int(a), int(b)) for a, b, *_ in half.rows}
    assert [int(m) for *_, m in half.rows] == [1] + [2] * (len(half.rows) - 1)
    p = (rng.random((1500, 3)) * lbox).astype(np.float32)
    # points on cell boundaries too
    p[:300] = (np.round(p[:300] / (lbox / nc)) * (lbox / nc)).astype(np.float32) % np.float32(lbox)
    cell = np.stack([ttpcf.cell_index(t(p[:, i]), lbox, nc).numpy() for i in range(3)], 1)
    d = p[:, None, :] - p[None, :, :]
    d = d - np.float32(lbox) * np.round(d / np.float32(lbox))
    r2 = d[..., 0] ** 2 + d[..., 1] ** 2
    if mode == 'smu':
        ok = r2 + d[..., 2] ** 2 < e2max
    else:
        ok = (r2 < e2max) & (np.abs(d[..., 2]) < nb2)
    i, j = np.nonzero(ok)
    off = cell[j] - cell[i]
    off = (off + nc // 2) % nc - nc // 2  # the nearest image of the offset
    assert len(i) > 1500
    for di, dj, dk in np.unique(off, axis=0):
        assert (di, dj) in kd and abs(dk) <= kd[(di, dj)], (di, dj, dk, nc, mode)


@pytest.mark.parametrize('shape', ['grid under 2 reach + 1', 'full cell beside empty ones',
                                   'item across a box face', 'points on cell edges and on lbox'])
def test_risky_stage_shapes(shape):
    """The shapes the finer grid makes risky, each through the plain version
    against the f32 brute force, auto and cross, both modes."""
    rng = np.random.default_rng(40)
    lbox, nc, span = 120.0, 8, 2  # cells of 15 for rp, s < 30: a reach of 2
    edges = np.array([0.0, 3.0, 12.0, 30.0])
    pos2 = rng.random((600, 3)) * lbox
    if shape == 'grid under 2 reach + 1':
        # 4 cells of 30 for rp < 50 (a reach of 2), and 6 cells of 20 with
        # items of 3 cells (3 + 2 * 2 cells along z): refused
        pos = rng.random((500, 3)) * lbox
        cols = [t(np.float32(pos[:, i])) for i in range(3)]
        st = ttpcf.stage_cells(*cols, lbox, 4, span=1)
        with pytest.raises(ValueError, match='visited twice'):
            ttpcf.count_pairs_cells(st, None, ttpcf.edges_f32([0.0, 50.0**2]), 30, 'rppi')
        st = ttpcf.stage_cells(*cols, lbox, 6, span=3)
        with pytest.raises(ValueError, match='visited twice'):
            ttpcf.count_pairs_cells(st, None, ttpcf.edges_f32(edges**2), 30, 'rppi')
        nc, span = 5, 1  # 2 reach + 1 cells exactly: every cell once, the per-pair round
    elif shape == 'full cell beside empty ones':
        pos = np.concatenate([rng.random((150, 3)) * 8.0 + 40.0, rng.random((150, 3)) * 8.0,
                              rng.random((60, 3)) * lbox])
    elif shape == 'item across a box face':
        pos = rng.random((700, 3)) * lbox
        pos[:, 2] = np.where(rng.random(700) < 0.5, rng.random(700) * 15, lbox - rng.random(700) * 15)
        nc, span = 8, 3  # the last group, cells 6..7, reaches 0..1 across the face
    else:
        pos = rng.random((700, 3)) * lbox
        pos[:400] = np.round(pos[:400] / 15.0) * 15.0  # cell edges of the 8^3 grid, and lbox
        pos2[:300] = np.round(pos2[:300] / 15.0) * 15.0
    wrap = lambda p: [t(np.mod(p, lbox).astype(np.float32)[:, i]) for i in range(3)]  # noqa: E731
    s1 = ttpcf.stage_cells(*wrap(pos), lbox, nc, span=span)
    s2 = ttpcf.stage_cells(*wrap(pos2), lbox, nc, span=span)
    thr = ttpcf.edges_f32(edges**2)
    for mode, nb2 in (('rppi', 30), ('smu', 7)):
        for other, p2 in ((None, None), (s2, pos2)):
            got = ttpcf.count_pairs_cells(s1, other, thr, nb2, mode, float(nb2)).numpy()
            want = _brute(pos, p2, edges, nb2, mode, lbox)
            npt.assert_array_equal(got.reshape(3, nb2), want, err_msg=f'{shape} {mode}')
            assert got.sum() > 0
