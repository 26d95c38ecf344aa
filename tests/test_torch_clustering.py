"""Port parity for the clustering methods of AbacusHOD: compute_xirppi,
compute_wp, compute_multipole and compute_clustering of abacusutils_tpu_torch
against the JAX AbacusHOD's on one three-tracer run_hod mock (the JAX
object made with object.__new__ on a synthetic staged state, as
tests/test_torch_run_hod.py does).

The mock is the JAX run_hod's, carried over with convert.mock_from_numpy, so
both packages count the same float32 positions. The test catalogs are far
below the 25,000 points at which the port's dispatch picks the cell engine
(100,000 in the JAX package, which the port follows for catalogs outside
[0, lbox), as the mock's are: `_JAX_CELL_MIN_N`), so
`_CELL_MIN_N` is lowered in both packages, and with it the port's
`_JAX_CELL_MIN_N`, for the tests that mean that engine: it is the one a real mock takes, it computes in float32 in both
packages whatever JAX's x64 flag says, and the counts are then equal.
Tolerance: rtol 1e-12 (equal integer counts, then the same float64 host
arithmetic in another order of operations). The unpatched dispatch (the
all-pairs engine for a sparse tracer) is held against the port's own
float32 all-pairs counts, and against JAX with x64 switched off for the call,
so that its tiled engine computes in float32 too.
"""

import jax
import numpy as np
import numpy.testing as npt
import pytest

from abacusutils_tpu.ops import tpcf as jtpcf
from abacusutils_tpu_torch.convert import mock_from_numpy, position_columns
from abacusutils_tpu_torch.ops import tpcf as ttpcf
from test_torch_run_hod import LBOX, _pair
from torch_helpers import staged_state

RPBINS = np.logspace(-1, np.log10(30), 9)
SBINS = np.logspace(-1, np.log10(30), 9)
PIMAX, PI_BIN, NMU = 30, 5, 20
CALLS = {
    'xirppi': (RPBINS, PIMAX, PI_BIN),
    'wp': (RPBINS, PIMAX),
    'multipole': (RPBINS, PIMAX, SBINS, NMU),
}


@pytest.fixture(scope='module')
def hods():
    """(JAX AbacusHOD, port AbacusHOD, the JAX run_hod mock as numpy)."""
    jax_hod, port = _pair(staged_state(20_000, 80_000, LBOX, seed=41), False, False)
    mock = mock_from_numpy(jax_hod.run_hod(want_rsd=True))
    assert list(mock) == ['LRG', 'ELG', 'QSO'] and min(len(m['x']) for m in mock.values()) > 300
    return jax_hod, port, mock


@pytest.fixture
def cell_engine(monkeypatch):
    monkeypatch.setattr(jtpcf, '_CELL_MIN_N', 100)
    monkeypatch.setattr(ttpcf, '_CELL_MIN_N', 100)
    monkeypatch.setattr(ttpcf, '_JAX_CELL_MIN_N', 100)
    ttpcf._stage_cache.clear()
    yield
    ttpcf._stage_cache.clear()


def _assert_same(got, ref, shape):
    assert list(got) == list(ref) and len(got) == 9
    for key, r in ref.items():
        assert got[key].shape == np.shape(r) == shape, key
        npt.assert_allclose(got[key], np.asarray(r), rtol=1e-12, atol=0, err_msg=key)
        a, b = key.split('_')
        assert got[key] is got[f'{b}_{a}'] or a == b  # a cross is stored once, under both orders


@pytest.mark.parametrize('stat', list(CALLS))
def test_clustering_methods_match_jax(hods, cell_engine, stat):
    jax_hod, port, mock = hods
    nrp = len(RPBINS) - 1
    shape = {'xirppi': (nrp, PIMAX // PI_BIN), 'wp': (nrp,), 'multipole': (3 * nrp,)}[stat]
    builds = ttpcf.stage_cells.builds
    got = getattr(port, f'compute_{stat}')(mock, *CALLS[stat])
    # one stage a tracer for the three autos and three crosses (and for wp
    # and the multipoles within compute_multipole)
    assert ttpcf.stage_cells.builds - builds == 3
    ref = getattr(jax_hod, f'compute_{stat}')(mock, *CALLS[stat])
    _assert_same(got, ref, shape)
    assert all(np.isfinite(v).all() for v in got.values())


@pytest.mark.parametrize('stat', list(CALLS))
def test_compute_clustering_picks_the_statistic(hods, cell_engine, stat):
    jax_hod, port, mock = hods
    one = {'LRG': mock['LRG']}
    port.clustering_type = jax_hod.clustering_type = stat
    try:
        got = port.compute_clustering(one, *CALLS[stat])
        ref = jax_hod.compute_clustering(one, *CALLS[stat])
        direct = getattr(port, f'compute_{stat}')(one, *CALLS[stat])
    finally:
        port.clustering_type = jax_hod.clustering_type = None
    assert list(got) == ['LRG_LRG']
    npt.assert_allclose(got['LRG_LRG'], np.asarray(ref['LRG_LRG']), rtol=1e-12)
    npt.assert_array_equal(got['LRG_LRG'], direct['LRG_LRG'])


def test_compute_clustering_without_a_type_raises(hods):
    _, port, mock = hods
    assert port.clustering_type is None
    with pytest.raises(ValueError, match='clustering_type not implemented'):
        port.compute_clustering(mock, RPBINS, PIMAX)


def test_multipole_holds_wp_then_the_poles(hods, cell_engine):
    """compute_multipole is wp(rp) followed by xi_0(s) and xi_2(s); wp is
    2 sum_pi xi(rp, pi) at unit pi bins."""
    _, port, mock = hods
    two = {k: mock[k] for k in ('LRG', 'ELG')}
    nrp = len(RPBINS) - 1
    wp = port.compute_wp(two, RPBINS, PIMAX)
    multi = port.compute_multipole(two, RPBINS, PIMAX, SBINS, NMU, orders=(0, 2, 4))
    xi1 = port.compute_xirppi(two, RPBINS, PIMAX, 1)
    for key in ('LRG_LRG', 'LRG_ELG', 'ELG_LRG', 'ELG_ELG'):
        assert multi[key].shape == (4 * nrp,)
        npt.assert_array_equal(multi[key][:nrp], wp[key])
        npt.assert_allclose(wp[key], 2 * xi1[key].sum(axis=1), rtol=1e-10)


def test_sparse_tracer_takes_the_all_pairs_engine(hods):
    """Without the lowered threshold a tracer under 25,000 points is
    counted by the all-pairs engine (K5 on the card), in float32 on the
    positions as they are."""
    jax_hod, port, mock = hods
    one = {'QSO': mock['QSO']}
    ttpcf._stage_cache.clear()
    builds = ttpcf.stage_cells.builds
    got = port.compute_wp(one, RPBINS, PIMAX)['QSO_QSO']
    assert ttpcf.stage_cells.builds == builds and not ttpcf._stage_cache
    pos = np.stack([mock['QSO'][c] for c in 'xyz'], 1).astype(np.float32)
    want = ttpcf.calc_wp_fast(rpbins=RPBINS, pimax=PIMAX, lbox=LBOX,
                              pos1=position_columns(pos, 'cpu'))
    dd = ttpcf.pair_counts_rppi(pos, RPBINS, PIMAX, LBOX, method='tile', device='cpu')
    rr = np.pi * np.diff(RPBINS**2) / LBOX**3 * len(pos) ** 2 * 2
    npt.assert_allclose(got, 2 * (dd / rr[:, None] - 1).sum(axis=1), rtol=1e-12)
    npt.assert_array_equal(got, want)
    with jax.enable_x64(False):  # JAX's tiled engine in float32 as well
        ref = jax_hod.compute_wp(one, RPBINS, PIMAX)['QSO_QSO']
    npt.assert_allclose(got, np.asarray(ref), rtol=1e-12, err_msg='JAX x64 off')


@pytest.mark.parametrize('stat,refine', [('wp', 1), ('wp', 2), ('multipole', 2)])
def test_clustering_methods_on_finer_grids(hods, cell_engine, monkeypatch, stat, refine):
    """The statistics do not depend on the cell grid: with the dispatch made
    to refine it (cells of rmax / 2, whatever the mock's density) or kept
    from it (cells of rmax) they equal the JAX package's, and every tracer
    is staged once a grid."""
    jax_hod, port, mock = hods
    monkeypatch.setattr(ttpcf, '_FINE_MIN_OCC', 0.0 if refine == 2 else np.inf)
    assert ttpcf.cell_grid(LBOX, 30.0, 300)[1] == refine
    builds = ttpcf.stage_cells.builds
    got = getattr(port, f'compute_{stat}')(mock, *CALLS[stat])
    assert ttpcf.stage_cells.builds - builds == 3
    ref = getattr(jax_hod, f'compute_{stat}')(mock, *CALLS[stat])
    nrp = len(RPBINS) - 1
    _assert_same(got, ref, {'wp': (nrp,), 'multipole': (3 * nrp,)}[stat])
