"""Port parity for pair counting: abacusutils_tpu_torch/ops/tpcf.py against
abacusutils_tpu/ops/tpcf.py (JAX on the CPU) and an f32 numpy brute force.

The same points, drawn from a seed with numpy, go through both packages; the
integer counts must be equal bin for bin. On the CPU the port's wrappers run
the kernels' plain PyTorch versions (count_pairs_cells_plain,
count_pairs_all_plain) on the stage and work list the CUDA kernels read.

Which JAX the counts are held against: tests/tpcf_helpers.py.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from abacusutils_tpu.ops import tpcf as jtpcf
from abacusutils_tpu_torch.convert import mock_from_numpy, position_columns
from abacusutils_tpu_torch.ops import tpcf as ttpcf
from torch_helpers import t
from tpcf_helpers import (
    LBOX, RPBINS, RP0, PIMAX, SBINS, S0, NMU, _x64, _mode, _tile_dtype, _points, _brute,
    _rules_agree, _both,
)


@pytest.mark.parametrize('cross', [False, True], ids=['auto', 'cross'])
@pytest.mark.parametrize('method', ['tile', 'cell'])
@pytest.mark.parametrize('mode', ['rppi', 'smu'])
def test_counts_match_jax_and_brute(mode, method, cross):
    rng = np.random.default_rng(2 + cross)
    pos = _points(2500, rng)
    pos2 = rng.random((1800, 3)) * LBOX if cross else None
    edges, nb2 = (RPBINS, PIMAX) if mode == 'rppi' else (SBINS, NMU)
    got, ref = _both(mode, pos, edges, nb2, pos2=pos2, method=method)
    assert got.dtype == np.int64 and got.shape == (len(edges) - 1, nb2)
    assert _rules_agree(pos, pos2, edges, nb2, mode), 'pick another seed: see the module docstring'
    npt.assert_array_equal(got, ref, err_msg=_mode())
    dt = np.float32 if method == 'cell' else _tile_dtype()[0]
    npt.assert_array_equal(got, _brute(pos, pos2, edges, nb2, mode, dt=dt))
    assert got.sum() > 0


@pytest.mark.parametrize('seed', [10, 11])
def test_cell_engine_edges_from_zero_and_sparse_second_tracer(seed):
    """rp and s bins that start at 0 (the pair i == j would land in bin
    (0, 0): the port skips it by index, JAX subtracts n1 on the host), a
    sparse clustered second tracer, and a point count that is no power of
    two."""
    rng = np.random.default_rng(seed)
    pos = _points(int(rng.integers(2000, 3000)), rng)
    pos[:40] = pos[40:80]  # coincident distinct points count
    pos2 = _points(int(rng.integers(300, 800)), rng)
    for mode, edges, nb2, p2 in (('rppi', RP0, PIMAX, None), ('smu', S0, NMU, None),
                                 ('rppi', RP0, PIMAX, pos2), ('smu', S0, NMU, pos2)):
        got, ref = _both(mode, pos, edges, nb2, pos2=p2, method='cell')
        assert _rules_agree(pos, p2, edges, nb2, mode)
        npt.assert_array_equal(got, ref, err_msg=f'{mode} {_mode()}')
        npt.assert_array_equal(got, _brute(pos, p2, edges, nb2, mode))
    # the all-pairs engine excludes i == j by index as well
    got_t, ref_t = _both('rppi', pos, RP0, PIMAX, method='tile')
    npt.assert_array_equal(got_t, ref_t, err_msg=_mode())
    assert got_t[0, 0] >= 80  # the coincident pairs, both orders


def test_noninteger_pimax_engines_agree():
    """dz in [int(pimax), pimax) is dropped by both engines, as in JAX."""
    rng = np.random.default_rng(5)
    pos = _points(2500, rng)
    pimax = 10.5
    got_c, ref_c = _both('rppi', pos, RPBINS, pimax, method='cell')
    got_t, ref_t = _both('rppi', pos, RPBINS, pimax, method='tile')
    assert got_c.shape == (len(RPBINS) - 1, 10)
    assert _rules_agree(pos, None, RPBINS, 10, 'rppi')
    npt.assert_array_equal(got_c, ref_c, err_msg=_mode())
    npt.assert_array_equal(got_t, ref_t, err_msg=_mode())
    npt.assert_array_equal(got_c, _brute(pos, None, RPBINS, 10, 'rppi'))
    if not _x64():
        npt.assert_array_equal(got_t, got_c)


def test_input_forms_agree():
    """Host (N, 3) arrays, an (N, 3) tensor, SoA tensors and SoA numpy
    columns count alike, in both engines, and equal JAX on its device array."""
    rng = np.random.default_rng(6)
    pos = _points(2500, rng).astype(np.float32)
    pos2 = (rng.random((700, 3)) * LBOX).astype(np.float32)
    want = jtpcf.pair_counts_rppi(jnp.asarray(pos), RPBINS, PIMAX, LBOX, method='cell')
    forms = {
        'host': pos, 'tensor': t(pos), 'soa tensors': tuple(t(pos[:, i]) for i in range(3)),
        'soa numpy': tuple(pos[:, i] for i in range(3)),
        'soa list': [pos[:, i].copy() for i in range(3)],
        'position_columns': position_columns(pos, 'cpu'),
    }
    for name, p in forms.items():
        got = ttpcf.pair_counts_rppi(p, RPBINS, PIMAX, LBOX, method='cell', device='cpu')
        npt.assert_array_equal(got, want, err_msg=name)
        got = ttpcf.pair_counts_rppi(p, RPBINS, PIMAX, LBOX, method='tile', device='cpu')
        npt.assert_array_equal(got, want, err_msg=name + ' tile')
    soa2 = tuple(t(pos2[:, i]) for i in range(3))
    want = jtpcf.pair_counts_smu(jnp.asarray(pos), SBINS, 10, LBOX, pos2=jnp.asarray(pos2),
                                 method='cell')
    got = ttpcf.pair_counts_smu(forms['soa tensors'], SBINS, 10, LBOX, pos2=soa2, method='cell')
    npt.assert_array_equal(got, want)
    got = ttpcf.pair_counts_smu(pos, SBINS, 10, LBOX, pos2=t(pos2), method='cell', device='cpu')
    npt.assert_array_equal(got, want)


def test_three_point_list_is_aos():
    """A plain nested list of three (x, y, z) points keeps the (N, 3)
    reading; tuples and lists of 1-D arrays are columns."""
    pts = [[1.0, 2.0, 3.0], [50.0, 60.0, 70.0], [90.0, 30.0, 40.0]]
    arr = np.asarray(pts)
    sbins = np.linspace(0.1, 80, 5)
    want = jtpcf.pair_counts_smu(pts, sbins, 1, LBOX)
    assert want.sum() > 0
    kw = dict(device='cpu', dtype=_tile_dtype()[1])
    npt.assert_array_equal(ttpcf.pair_counts_smu(pts, sbins, 1, LBOX, **kw), want)
    npt.assert_array_equal(ttpcf.pair_counts_smu(arr, sbins, 1, LBOX, **kw), want)
    soa_tuple = tuple(arr[:, i] for i in range(3))
    soa_list = [arr[:, i].copy() for i in range(3)]
    npt.assert_array_equal(ttpcf.pair_counts_smu(soa_tuple, sbins, 1, LBOX, **kw), want)
    npt.assert_array_equal(ttpcf.pair_counts_smu(soa_list, sbins, 1, LBOX, **kw), want)
    assert not ttpcf._is_soa(pts) and ttpcf._is_soa(soa_tuple) and ttpcf._is_soa(soa_list)
    assert ttpcf._npoints(pts) == 3 and ttpcf._npoints(soa_tuple) == 3


def test_infeasible_all_pairs_raises_like_jax():
    """Too few cells for the cell engine and too many points for all pairs:
    the same ValueError text as JAX, for each cause."""
    n = 2_000_001
    pos = np.zeros((n, 3))
    for call in (
        lambda m: m.pair_counts_smu(pos, np.array([0.1, 200.0]), 1, 500.0),
        lambda m: m.pair_counts_rppi(pos, np.array([0.1, 200.0]), 200.0, 500.0),
        lambda m: m.pair_counts_rppi(pos, np.array([0.1, 20.0]), 20.0, 500.0, method='tile'),
    ):
        with pytest.raises(ValueError, match='infeasible') as jax_err:
            call(jtpcf)
        with pytest.raises(ValueError, match='infeasible') as port_err:
            call(ttpcf)
        assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(ValueError, match='declined this workload'):
        ttpcf._check_tiled_feasible(n, n, 500.0, 20.0)


@pytest.mark.parametrize('engine', ['cell', 'all pairs'])
def test_wrappers_match_jax(engine, monkeypatch):
    """calc_xirppi_fast / calc_wp_fast / calc_multipole_fast: equal counts,
    then the same float64 host arithmetic (rtol 1e-12), autos and crosses,
    from x/y/z columns and from staged pos1/pos2. The wrappers pick the
    engine by the number of points: the threshold is lowered in both
    packages for the cell engine (float32 in both, whatever the x64 flag);
    the all-pairs engine is float32 in the port's wrappers and follows the
    flag in JAX's, so that case is held against JAX with x64 switched off."""
    if engine == 'cell':
        monkeypatch.setattr(jtpcf, '_CELL_MIN_N', 100)
        monkeypatch.setattr(ttpcf, '_CELL_MIN_N', 100)
        jax_mode = contextlib.nullcontext()
    else:
        jax_mode = jax.enable_x64(False)
    with jax_mode:
        _check_wrappers()


def _check_wrappers():
    rng = np.random.default_rng(5)
    pos = _points(2500, rng)
    pos2 = rng.random((1500, 3)) * LBOX
    x, y, z = pos.T
    x2, y2, z2 = pos2.T
    kw = dict(device='cpu')
    for cross in ({}, dict(x2=x2, y2=y2, z2=z2)):
        assert _rules_agree(pos, pos2 if cross else None, RPBINS, PIMAX, 'rppi')
        assert _rules_agree(pos, pos2 if cross else None, SBINS, NMU, 'smu')
        xi = ttpcf.calc_xirppi_fast(x, y, z, RPBINS, PIMAX, 5, LBOX, **cross, **kw)
        npt.assert_allclose(xi, jtpcf.calc_xirppi_fast(x, y, z, RPBINS, PIMAX, 5, LBOX, **cross),
                            rtol=1e-12, err_msg=_mode())
        wp = ttpcf.calc_wp_fast(x, y, z, RPBINS, PIMAX, LBOX, **cross, **kw)
        npt.assert_allclose(wp, jtpcf.calc_wp_fast(x, y, z, RPBINS, PIMAX, LBOX, **cross),
                            rtol=1e-12)
        xi1 = ttpcf.calc_xirppi_fast(x, y, z, RPBINS, PIMAX, 1, LBOX, **cross, **kw)
        npt.assert_allclose(wp, 2 * xi1.sum(axis=1), rtol=1e-10)
        ell = ttpcf.calc_multipole_fast(x, y, z, SBINS, LBOX, nbins_mu=NMU, orders=(0, 2, 4),
                                        **cross, **kw)
        npt.assert_allclose(
            ell, jtpcf.calc_multipole_fast(x, y, z, SBINS, LBOX, nbins_mu=NMU, orders=(0, 2, 4),
                                           **cross), rtol=1e-12)
        assert xi.shape == (len(RPBINS) - 1, PIMAX // 5) and len(ell) == 3 * (len(SBINS) - 1)
    p1 = position_columns(pos, 'cpu')
    wp_staged = ttpcf.calc_wp_fast(rpbins=RPBINS, pimax=PIMAX, lbox=LBOX, pos1=p1)
    jp1 = tuple(jnp.asarray(np.asarray(c)) for c in p1)
    npt.assert_allclose(
        wp_staged, jtpcf.calc_wp_fast(rpbins=RPBINS, pimax=PIMAX, lbox=LBOX, pos1=jp1), rtol=1e-12)
    for bad in (dict(pimax=30.0), dict(pimax=30, pi_bin_size=7)):
        args = dict(rpbins=RPBINS, pimax=30, pi_bin_size=5, lbox=LBOX, pos1=p1)
        with pytest.raises(ValueError, match='integer'):
            ttpcf.calc_xirppi_fast(**{**args, **bad})
    npt.assert_array_equal(ttpcf.tpcf_multipole(np.ones((3, 4)), np.linspace(0, 1, 5), 2),
                           jtpcf.tpcf_multipole(np.ones((3, 4)), np.linspace(0, 1, 5), 2))


def test_stage_cache_hits_restages_and_is_bounded():
    """A repeat on the same tensors reuses the stage (wp and the multipoles
    share it); an in-place edit of a cached column restages and the counts
    follow the new data; host arrays are never cached; at most 8 stages are
    held."""
    rng = np.random.default_rng(7)
    pos = _points(2500, rng).astype(np.float32)
    soa = tuple(t(pos[:, i]) for i in range(3))
    ttpcf._stage_cache.clear()
    builds = ttpcf.stage_cells.builds
    first = ttpcf.pair_counts_rppi(soa, RPBINS, PIMAX, LBOX, method='cell')
    assert ttpcf.stage_cells.builds == builds + 1 and len(ttpcf._stage_cache) == 1
    again = ttpcf.pair_counts_rppi(soa, RPBINS, PIMAX, LBOX, method='cell')
    ttpcf.pair_counts_smu(soa, np.linspace(0.1, 30, 5), NMU, LBOX, method='cell')  # same grid
    assert ttpcf.stage_cells.builds == builds + 1
    npt.assert_array_equal(first, again)
    ttpcf.pair_counts_smu(soa, SBINS, NMU, LBOX, method='cell')  # rmax 25: another grid
    assert ttpcf.stage_cells.builds == builds + 2 and len(ttpcf._stage_cache) == 2

    soa[0][:200] += 3.0  # in place: same tensor, new version
    moved = pos.copy()
    moved[:200, 0] += 3.0
    edited = ttpcf.pair_counts_rppi(soa, RPBINS, PIMAX, LBOX, method='cell')
    assert ttpcf.stage_cells.builds == builds + 3
    npt.assert_array_equal(edited, ttpcf.pair_counts_rppi(moved, RPBINS, PIMAX, LBOX,
                                                          method='cell', device='cpu'))
    assert not np.array_equal(edited, first)

    n = len(ttpcf._stage_cache)
    ttpcf.pair_counts_rppi(pos, RPBINS, PIMAX, LBOX, method='cell', device='cpu')
    assert len(ttpcf._stage_cache) == n  # host data: staged, not cached
    held = []
    for i in range(10):
        one = t(pos[: 300 + i])
        held.append(one)
        ttpcf.pair_counts_rppi(one, RPBINS, PIMAX, LBOX, method='cell')
    assert len(ttpcf._stage_cache) == ttpcf._STAGE_CACHE_LEN == 8
    assert ttpcf._stage_cache[0][3] is held[-1]
    ttpcf._stage_cache.clear()


def test_stage_and_work_list():
    """stage_cells: the cell key of JAX's _stage_cells, a stable sort, cell
    starts, and a work list that covers every point once in chunks of at
    most CHUNK, each inside one group of `span` cells of a row;
    candidate_pairs counts what the walk evaluates, candidate_pairs_coarse
    what the 27-cell walk of a coarse grid would."""
    rng = np.random.default_rng(8)
    nc, lbox = 7, 210.0
    pos = (rng.random((3000, 3)) * lbox).astype(np.float32)
    pos[:500] = pos[0] + rng.normal(0, 0.5, (500, 3)).astype(np.float32)  # one heavy cell
    pos = np.mod(pos, np.float32(lbox))
    cols = [t(pos[:, i]) for i in range(3)]
    st = ttpcf.stage_cells(*cols, lbox, nc)
    key_j, xs_j, ys_j, zs_j, starts_j, occ_j = jtpcf._stage_cells(
        *(jnp.asarray(pos[:, i]) for i in range(3)), jnp.float32(lbox), nc)
    npt.assert_array_equal(st.starts.numpy(), np.asarray(starts_j))
    npt.assert_array_equal(st.xs.numpy(), np.asarray(xs_j))
    npt.assert_array_equal(st.zs.numpy(), np.asarray(zs_j))
    assert st.max_occ == int(np.asarray(occ_j).max()) >= 500 and st.n == 3000
    assert st.span == ttpcf.SPAN == 2 and st.groups_per_row == 4
    work = st.work.numpy()
    assert (work[:, 2] > work[:, 1]).all() and (work[:, 2] - work[:, 1]).max() == ttpcf.CHUNK
    covered = np.concatenate([np.arange(b, e) for _, b, e in work])
    npt.assert_array_equal(np.sort(covered), np.arange(3000))
    starts = st.starts.numpy()
    for g, b, e in work:
        row, kb = divmod(g, st.groups_per_row)
        first, last = row * nc + kb * st.span, row * nc + min((kb + 1) * st.span, nc)
        assert starts[first] <= b and e <= starts[last]
    for span in (1, 3):
        other = ttpcf.stage_cells(*cols, lbox, nc, span=span)
        assert other.span == span and other.work.shape[0] != work.shape[0]
        npt.assert_array_equal(other.starts.numpy(), starts)
    occ = np.diff(starts).reshape(nc, nc, nc)
    near = sum(np.roll(occ, (-a, -b, -c), (0, 1, 2))
               for a in (-1, 0, 1) for b in (-1, 0, 1) for c in (-1, 0, 1))
    assert ttpcf.candidate_pairs_coarse(st, st, nc) == int((occ * near).sum())
    assert ttpcf.candidate_pairs_coarse(st, None, nc) < ttpcf.candidate_pairs_coarse(st, st, nc)
    thr = ttpcf.edges_f32(RPBINS**2)
    one = ttpcf.stage_cells(*cols, lbox, nc, span=1)
    # items of one cell and a reach of one cell: the same 27 cells
    assert ttpcf.candidate_pairs(one, one, thr, PIMAX, 'rppi') == int((occ * near).sum())
    assert ttpcf.candidate_pairs(st, st, thr, PIMAX, 'rppi') > int((occ * near).sum())
    assert ttpcf.candidate_pairs(st, None, thr, PIMAX, 'rppi') < ttpcf.candidate_pairs(
        st, st, thr, PIMAX, 'rppi')
    empty = ttpcf.stage_cells(*(c[:0] for c in cols), lbox, nc)
    assert empty.work.shape == (0, 3) and empty.max_occ == 0
    out = ttpcf.count_pairs_cells(empty, st, thr, PIMAX, 'rppi')
    assert out.shape == (8 * PIMAX,) and int(out.sum()) == 0


def test_kernel_wrappers_on_cpu_and_errors():
    """The wrappers take the plain versions on CPU tensors, count no launch
    there, and refuse what the kernels do not take."""
    rng = np.random.default_rng(9)
    pos = (rng.random((1500, 3)) * 160.0).astype(np.float32)
    cols = [t(pos[:, i]) for i in range(3)]
    st = ttpcf.stage_cells(*cols, 160.0, 5)
    thr = ttpcf.edges_f32(RPBINS**2)
    before = (ttpcf.count_pairs_cells.launches, ttpcf.count_pairs_all.launches)
    a = ttpcf.count_pairs_cells(st, None, thr, PIMAX, 'rppi')
    b = ttpcf.count_pairs_all(cols, None, thr, PIMAX, 'rppi', 160.0)
    assert a.dtype == torch.int64 and torch.equal(a, b)
    c = ttpcf.count_pairs_all([x.double() for x in cols], None, RPBINS**2, PIMAX, 'rppi', 160.0)
    assert int(c.sum()) > 0
    assert (ttpcf.count_pairs_cells.launches, ttpcf.count_pairs_all.launches) == before
    with pytest.raises(ValueError, match='unknown pair-count mode'):
        ttpcf.count_pairs_cells(st, None, thr, PIMAX, 'xi')
    other = ttpcf.stage_cells(*cols, 160.0, 4)
    with pytest.raises(ValueError, match='share their grid'):
        ttpcf.count_pairs_cells(st, other, thr, PIMAX, 'rppi')
    with pytest.raises(ValueError, match='float32 or float64'):
        ttpcf.count_pairs_all([x.half() for x in cols], None, thr, PIMAX, 'rppi', 160.0)
    with pytest.raises(ValueError, match='at least two'):
        ttpcf.count_pairs_all(cols, None, thr[:1], PIMAX, 'rppi', 160.0)


def test_entry_points_default_to_the_card():
    """Host data with no device named goes to the card: without one the
    entry points raise instead of counting on the CPU."""
    if torch.cuda.is_available():
        pytest.skip('this machine has a CUDA device')
    pos = np.random.default_rng(1).random((100, 3)) * LBOX
    for call in (
        lambda: ttpcf.pair_counts_rppi(pos, RPBINS, PIMAX, LBOX),
        lambda: ttpcf.pair_counts_smu(pos, SBINS, NMU, LBOX, method='cell'),
        lambda: ttpcf.calc_wp_fast(*pos.T, RPBINS, PIMAX, LBOX),
        lambda: position_columns(pos),
    ):
        with pytest.raises(RuntimeError, match='no CUDA device'):
            call()


def test_convert_helpers():
    pos = np.random.default_rng(3).random((50, 3)) * LBOX
    cols = position_columns(pos, 'cpu')
    assert len(cols) == 3 and all(c.dtype == torch.float32 and c.shape == (50,) for c in cols)
    npt.assert_array_equal(cols[1].numpy(), pos[:, 1].astype(np.float32))
    soa = position_columns(tuple(pos[:, i] for i in range(3)), 'cpu')
    assert all(torch.equal(a, b) for a, b in zip(cols, soa))
    mock = {'LRG': {'x': jnp.asarray(pos[:, 0]), 'y': pos[:, 1], 'z': pos[:, 2],
                    'Ncent': np.int64(20)}}
    out = mock_from_numpy(mock)
    assert isinstance(out['LRG']['x'], np.ndarray) and out['LRG']['Ncent'] == 20
    assert type(out['LRG']['Ncent']) is int
