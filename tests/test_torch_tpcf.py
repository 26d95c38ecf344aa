"""Port parity for pair counting: abacusutils_tpu_torch/ops/tpcf.py against
abacusutils_tpu/ops/tpcf.py (JAX on the CPU) and an f32 numpy brute force.

The same points, drawn from a seed with numpy, go through both packages; the
integer counts must be equal bin for bin. On the CPU the port's wrappers run
the kernels' plain PyTorch versions (count_pairs_cells_plain,
count_pairs_all_plain) on the stage and work list the CUDA kernels read.

Which JAX the counts were held against depends on jax's x64 flag, which other
test modules flip: MODE says it. With x64 on, JAX's tiled engine computes in
float64 (the port is asked for ``dtype=torch.float64``) and its cell engine
compares a float32 r2 with float64 squared edges, which is the port's rule
(ops/tpcf.py:edges_f32 rounds the edges up). With x64 off JAX rounds the
squared edges to the nearest float32; the two rules differ only for a pair
whose r2 is exactly the float32 just below an edge
(test_edge_rounding_rule_against_both_jax_modes builds one), and
_rules_agree checks that no test catalog holds such a pair.
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

LBOX = 400.0
RPBINS = np.logspace(-1, np.log10(30), 9)
RP0 = np.concatenate([[0.0], np.logspace(-1, np.log10(30), 6)[1:]])
PIMAX = 30
SBINS = np.linspace(0.1, 25, 9)
S0 = np.linspace(0.0, 25, 7)
NMU = 20


def _x64():
    return bool(jax.config.x64_enabled)


def _mode():
    return 'JAX x64 on' if _x64() else 'JAX x64 off'


def _tile_dtype():
    """The type JAX's tiled engine computes in under the current flag."""
    return (np.float64, torch.float64) if _x64() else (np.float32, torch.float32)


def _points(n, rng, lbox=LBOX, clustered=True):
    if not clustered:
        return rng.random((n, 3)) * lbox
    cen = rng.random((40, 3)) * lbox
    half = n // 2
    return np.concatenate(
        [
            (cen[rng.integers(0, 40, half)] + rng.normal(0, 5, (half, 3))) % lbox,
            rng.random((n - half, 3)) * lbox,
        ]
    )


def _brute(pos, pos2, edges, nb2, mode, lbox=LBOX, dt=np.float32, thr=None):
    """Ordered pair counts by brute force in `dt`: wrapped positions, the
    per-pair round-half-even minimum image, every product and sum rounded on
    its own; `thr` the squared-edge thresholds (default: the port's rule for
    float32, the exact float64 squares otherwise)."""
    auto = pos2 is None
    p1 = np.mod(pos, lbox).astype(dt)
    p2 = p1 if auto else np.mod(pos2, lbox).astype(dt)
    d = p1[:, None, :] - p2[None, :, :]
    d = (d - dt(lbox) * np.round(d / dt(lbox))).astype(dt)
    adz = np.abs(d[..., 2]).ravel()
    r2 = d[..., 0] ** 2 + d[..., 1] ** 2
    if mode == 'smu':
        r2 = r2 + d[..., 2] ** 2
    r2 = r2.ravel()
    if thr is None:
        e2 = np.asarray(edges, np.float64) ** 2
        thr = ttpcf.edges_f32(e2) if dt == np.float32 else e2
    nb1 = len(thr) - 1
    b1 = np.searchsorted(thr, r2, side='right') - 1
    ok = (b1 >= 0) & (b1 < nb1)
    if mode == 'rppi':
        b2 = np.floor(adz).astype(np.int64)
        ok &= b2 < nb2
    else:
        s = np.sqrt(r2)
        mu = np.divide(adz, s, out=np.zeros_like(s), where=s > 0)
        b2 = np.minimum((mu * dt(nb2)).astype(np.int64), nb2 - 1)
    if auto:
        n = len(p1)
        ok &= (np.arange(n)[:, None] != np.arange(n)[None, :]).ravel()
    return np.bincount((b1 * nb2 + b2)[ok], minlength=nb1 * nb2).reshape(nb1, nb2)


def _rules_agree(pos, pos2, edges, nb2, mode, lbox=LBOX):
    """True when rounding the squared edges up (the port, JAX with x64) and
    to nearest (JAX without x64) count this catalog alike."""
    e2 = np.asarray(edges, np.float64) ** 2
    up = _brute(pos, pos2, edges, nb2, mode, lbox, thr=ttpcf.edges_f32(e2))
    nearest = _brute(pos, pos2, edges, nb2, mode, lbox, thr=e2.astype(np.float32))
    return np.array_equal(up, nearest)


def _both(mode, pos, edges, nb2, lbox=LBOX, pos2=None, method=None):
    """(port counts, JAX counts) of one call; the all-pairs engine in the
    type JAX's follows."""
    kw = dict(pos2=pos2, method=method)
    tkw = dict(kw, device='cpu', dtype=_tile_dtype()[1])
    if mode == 'rppi':
        return (ttpcf.pair_counts_rppi(pos, edges, nb2, lbox, **tkw),
                jtpcf.pair_counts_rppi(pos, edges, nb2, lbox, **kw))
    return (ttpcf.pair_counts_smu(pos, edges, nb2, lbox, **tkw),
            jtpcf.pair_counts_smu(pos, edges, nb2, lbox, **kw))


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


@pytest.mark.parametrize('f64', [False, True], ids=['f32', 'f64'])
@pytest.mark.parametrize('lbox', [2000.0, 400.0, 95.0, 333.3, 1.0, 1e-3 + 7.0])
def test_round_threshold_equals_the_rounded_quotient(lbox, f64):
    """round(d / lbox) == (d > t) - (d < -t) for every value within 4000 ulps
    of +-lbox / 2 (and a coarse sweep of |d| < 1.5 lbox), with the rounded
    division of the type; and d - lbox * round(d / lbox) equals the kernel's
    d - lbox, d + lbox or d."""
    T = np.float64 if f64 else np.float32
    lb = T(lbox)
    thr = T(ttpcf.round_threshold(float(lb), f64))
    assert np.round(thr / lb) == 0 and np.round(np.nextafter(thr, T(np.inf)) / lb) == 1
    near = T(0.5) * lb + np.arange(-4000, 4001).astype(T) * np.spacing(T(0.5) * lb)
    sweep = np.linspace(-1.499, 1.499, 20001).astype(T) * lb
    for d in (near, -near, sweep):
        want = np.round(d / lb)
        got = (d > thr).astype(T) - (d < -thr).astype(T)
        npt.assert_array_equal(got, want)
        kernel = np.where(d > thr, d - lb, np.where(d < -thr, d + lb, d))
        npt.assert_array_equal(kernel, d - lb * want)
    assert set(np.round(near / lb)) == {0.0, 1.0}


_EDGE_SETS = {
    'log rp': np.logspace(-1, np.log10(30), 9),
    'linear s': np.linspace(0.1, 25, 9),
    'from 0': RP0,
    'linear from 0': S0,
    'one bin': np.array([0.5, 2.0]),
    'twenty bins': np.linspace(0.0, 40.0, 21),
    'close edges': np.array([0.0, 1.0, 1.02, 1.04, 7.0]),
}


@pytest.mark.parametrize('f64', [False, True], ids=['f32', 'f64'])
@pytest.mark.parametrize('name', list(_EDGE_SETS))
def test_bin_table_equals_searchsorted(name, f64):
    """bin_lut: the kernels' table lookup (a shift of r2's leading bits, the
    inner edges below the cell, one compare with the edge inside it) gives
    searchsorted's bin for every r2 in [lo, hi): at every edge and its two
    neighbours, and on uniform and log-uniform samples."""
    T = np.float64 if f64 else np.float32
    e2 = _EDGE_SETS[name] ** 2
    e = np.asarray(e2 if f64 else ttpcf.edges_f32(e2), T)
    lut = ttpcf.bin_lut(e, f64)
    assert lut is not None
    edge, base, shift, key0 = lut
    assert edge.dtype == T and base.dtype == np.int32 and len(edge) == len(base) <= 2048
    rng = np.random.default_rng(len(name))
    floor = max(float(e[0]), 1e-12)
    r2 = np.concatenate([
        e, np.nextafter(e, T(np.inf)), np.nextafter(e, T(-np.inf)),
        rng.uniform(e[0], e[-1], 100_000).astype(T),
        np.exp(rng.uniform(np.log(floor), np.log(e[-1]), 100_000)).astype(T)])
    r2 = r2[(r2 >= e[0]) & (r2 < e[-1])]
    lead = (r2.view(np.int64) >> 32) if f64 else r2.view(np.int32).astype(np.int64)
    key = np.maximum((lead >> shift) - key0, 0)
    assert key.max() < len(edge)
    got = base[key] + (r2 >= edge[key])
    npt.assert_array_equal(got, np.searchsorted(e, r2, side='right') - 1)


def test_bin_table_declines_what_it_cannot_hold():
    """Edges closer than 2048 cells can tell apart, unsorted, negative or
    non-finite edges get no table: the kernels then compare against every
    edge."""
    fine = np.array([1.0, 1.0 + 2.0**-20, 1.0 + 2.0**-19, 2.0], np.float32)
    assert ttpcf.bin_lut(fine) is None
    assert ttpcf.bin_lut(np.array([0.0, 1e-6, 1.001e-6, 900.0], np.float32)) is None
    assert ttpcf.bin_lut(np.array([1.0, 0.5, 2.0], np.float32)) is None
    assert ttpcf.bin_lut(np.array([-1.0, 0.5], np.float32)) is None
    assert ttpcf.bin_lut(np.array([0.0, np.inf], np.float32)) is None
    assert ttpcf.bin_lut(np.linspace(0, 150, 301) ** 2) is None


@pytest.mark.parametrize('nmu', [1, 20, 100])
def test_mu_bin_estimate_is_safe(nmu):
    """K4's mu bin: floor of an estimate adz * rsqrt(r2) * nmu whose
    reciprocal root may be off by 2^-22.9, taken only where it lies further
    than nmu * 2^-18 from an integer; there it always equals the bin of the
    exact chain int((adz / sqrt(r2)) * nmu), each step rounded to float32. The
    rest (and r2 = 0) take the exact chain."""
    rng = np.random.default_rng(nmu)
    n = 400_000
    r2 = np.exp(rng.uniform(np.log(1e-4), np.log(900.0), n)).astype(np.float32)
    mu = rng.random(n).astype(np.float32)
    mu[: n // 4] = (rng.integers(0, nmu + 1, n // 4) / nmu).astype(np.float32)  # on the boundaries
    adz = np.minimum((mu * np.sqrt(r2)).astype(np.float32), np.sqrt(r2).astype(np.float32))
    aux = np.float32(nmu)
    exact = ((adz / np.sqrt(r2)).astype(np.float32) * aux).astype(np.float32).astype(np.int64)
    margin = np.float32(aux * np.float32(2.0**-18))
    taken = 0
    for err in (-2.0**-22.9, 0.0, 2.0**-22.9):
        rs = (1.0 / np.sqrt(r2.astype(np.float64)) * (1.0 + err)).astype(np.float32)
        v = ((adz * rs).astype(np.float32) * aux).astype(np.float32)
        frac = v - np.floor(v)
        safe = (frac > margin) & (frac < np.float32(1.0) - margin)
        npt.assert_array_equal(np.floor(v[safe]).astype(np.int64), exact[safe])
        taken += int(safe.sum())
    assert taken > 2 * n  # the estimate decides nearly every pair off the boundaries


def test_dispatch_threshold(monkeypatch):
    """Below _CELL_MIN_N points the all-pairs engine counts, from it on the
    cell engine; one catalog counts alike on either side of the threshold."""
    assert ttpcf._CELL_MIN_N == 25_000
    taken = []
    zeros = torch.zeros(8 * PIMAX, dtype=torch.int64)
    monkeypatch.setattr(ttpcf, 'count_pairs_all', lambda *a, **k: taken.append('all') or zeros)
    monkeypatch.setattr(ttpcf, 'count_pairs_cells', lambda *a, **k: taken.append('cells') or zeros)
    rng = np.random.default_rng(12)
    big = rng.random((ttpcf._CELL_MIN_N, 3)) * LBOX
    ttpcf.pair_counts_rppi(big[:-1], RPBINS, PIMAX, LBOX, device='cpu')
    ttpcf.pair_counts_rppi(big, RPBINS, PIMAX, LBOX, device='cpu')
    ttpcf.pair_counts_rppi(big, RPBINS, PIMAX, 80.0, device='cpu')  # under three cells
    assert taken == ['all', 'cells', 'all']
    monkeypatch.undo()
    pos = _points(2000, rng)
    monkeypatch.setattr(ttpcf, '_CELL_MIN_N', 2001)
    below = ttpcf.pair_counts_rppi(pos, RPBINS, PIMAX, LBOX, device='cpu')
    monkeypatch.setattr(ttpcf, '_CELL_MIN_N', 2000)
    builds = ttpcf.stage_cells.builds
    above = ttpcf.pair_counts_rppi(pos, RPBINS, PIMAX, LBOX, device='cpu')
    assert ttpcf.stage_cells.builds == builds + 1
    npt.assert_array_equal(below, above)


@pytest.mark.parametrize('method', ['cell', 'tile'])
@pytest.mark.parametrize('mode', ['rppi', 'smu'])
def test_positions_outside_the_box_follow_jax_engine_by_engine(mode, method, monkeypatch):
    """Positions past the faces (RSD along z, and a few points a whole box
    off): the cell engine wraps them first and the all-pairs engine
    differences them as they are, in both packages, so each engine of the
    port equals JAX's engine of the same name, auto and cross. The default
    dispatch sends a catalog of _CELL_MIN_N points or more to the cell
    engine, unless a coordinate lies outside [0, lbox) and the catalog has
    fewer than JAX's 100,000 points: then it follows JAX's default, the
    tiled engine."""
    rng = np.random.default_rng(70)
    pos = _points(2500, rng)
    pos[:, 2] += rng.normal(0, 12, len(pos))
    pos[:60, 0] += LBOX
    pos[60:120, 1] -= LBOX
    pos2 = rng.random((1200, 3)) * LBOX
    pos2[:, 2] += rng.normal(0, 12, len(pos2))
    assert (pos[:, 2] < 0).sum() > 10 and (pos[:, 2] >= LBOX).sum() > 10
    edges, nb2 = (RP0, PIMAX) if mode == 'rppi' else (S0, NMU)
    for p2 in (pos2, None):
        got, ref = _both(mode, pos, edges, nb2, pos2=p2, method=method)
        assert _rules_agree(pos, p2, edges, nb2, mode) and got.sum() > 0
        npt.assert_array_equal(got, ref, err_msg=f'{method} {_mode()}')
        if method == 'cell':
            npt.assert_array_equal(got, _brute(pos, p2, edges, nb2, mode))
    monkeypatch.setattr(ttpcf, '_CELL_MIN_N', len(pos))
    kw = dict(device='cpu', dtype=_tile_dtype()[1])
    fn = ttpcf.pair_counts_rppi if mode == 'rppi' else ttpcf.pair_counts_smu
    if method == 'cell':
        monkeypatch.setattr(ttpcf, '_JAX_CELL_MIN_N', len(pos))
    npt.assert_array_equal(fn(pos, edges, nb2, LBOX, **kw), got)


@pytest.mark.parametrize('cross', [False, True], ids=['auto', 'cross'])
def test_default_dispatch_equals_jax_default(cross, monkeypatch):
    """Between the two packages' thresholds (lowered here, as
    test_wrappers_match_jax lowers them: the port's cell engine from 100
    points, JAX's from 3,000), the port's default calc_xirppi_fast and
    calc_multipole_fast equal JAX's default, its tiled engine in float32,
    bin for bin on coordinates in [-lbox/2, lbox/2), without staging a
    cell grid; on the same catalog shifted into [0, lbox) the port takes
    the cell engine and still equals JAX."""
    monkeypatch.setattr(jtpcf, '_CELL_MIN_N', 3000)
    monkeypatch.setattr(ttpcf, '_CELL_MIN_N', 100)
    monkeypatch.setattr(ttpcf, '_JAX_CELL_MIN_N', 3000)
    rng = np.random.default_rng(31)
    pos = _points(2500, rng) - LBOX / 2
    pos2 = rng.random((1500, 3)) * LBOX - LBOX / 2
    kw = dict(device='cpu')
    for shift, builds in ((0.0, 0), (LBOX / 2, 1 + cross)):
        x, y, z = (pos + shift).T
        other = dict(x2=pos2[:, 0] + shift, y2=pos2[:, 1] + shift, z2=pos2[:, 2] + shift) if (
            cross) else {}
        p2 = pos2 + shift if cross else None
        assert _rules_agree(pos + shift, p2, RPBINS, PIMAX, 'rppi')
        assert _rules_agree(pos + shift, p2, SBINS, NMU, 'smu')
        before = ttpcf.stage_cells.builds
        ttpcf._stage_cache.clear()
        with jax.enable_x64(False):
            npt.assert_array_equal(
                ttpcf.pair_counts_rppi(pos + shift, RPBINS, PIMAX, LBOX, pos2=p2, **kw),
                jtpcf.pair_counts_rppi(pos + shift, RPBINS, PIMAX, LBOX, pos2=p2))
            npt.assert_array_equal(
                ttpcf.pair_counts_smu(pos + shift, SBINS, NMU, LBOX, pos2=p2, **kw),
                jtpcf.pair_counts_smu(pos + shift, SBINS, NMU, LBOX, pos2=p2))
            npt.assert_allclose(
                ttpcf.calc_xirppi_fast(x, y, z, RPBINS, PIMAX, 5, LBOX, **other, **kw),
                jtpcf.calc_xirppi_fast(x, y, z, RPBINS, PIMAX, 5, LBOX, **other), rtol=1e-12)
            npt.assert_allclose(
                ttpcf.calc_multipole_fast(x, y, z, SBINS, LBOX, nbins_mu=NMU, orders=(0, 2),
                                          **other, **kw),
                jtpcf.calc_multipole_fast(x, y, z, SBINS, LBOX, nbins_mu=NMU, orders=(0, 2),
                                          **other), rtol=1e-12)
        assert (ttpcf.stage_cells.builds > before) == bool(builds), shift


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


def test_edge_rounding_rule_against_both_jax_modes():
    """edges_f32 rounds up: a float32 r2 >= t is the exact r2 >= e. One pair
    whose r2 is exactly the float32 just below the squared edge 0.1^2 (whose
    nearest float32 lies below it) is outside the bin by the exact rule, so
    for the port and for JAX with x64 on; JAX with x64 off rounds the edge
    to nearest and counts it."""
    e2 = np.array([0.1, 30.0]) ** 2
    thr = ttpcf.edges_f32(e2)
    assert thr.dtype == np.float32 and (thr.astype(np.float64) >= e2).all()
    assert (np.nextafter(thr, np.float32(0)).astype(np.float64) < e2).all()
    exact = np.array([0.25, 4.0])
    npt.assert_array_equal(ttpcf.edges_f32(exact), exact.astype(np.float32))
    target = np.float32(e2[0])  # nearest float32 of 0.1^2, below it
    assert float(target) < e2[0]
    # search dx, dy near 0.1 / sqrt(2) with dx^2 + dy^2 == target in float32
    base = np.float32(0.1 / np.sqrt(2.0))
    cand = base + np.arange(-2000, 2000, dtype=np.float32) * np.spacing(base)
    sq = (cand * cand).astype(np.float32)
    hit = np.argwhere((sq[:, None] + sq[None, :]).astype(np.float32) == target)
    assert len(hit) > 0
    dx, dy = cand[hit[0, 0]], cand[hit[0, 1]]
    # the first point at the origin, so the float32 differences are dx and dy
    pos = np.array([[0.0, 0.0, 5.0], [float(dx), float(dy), 5.0]])
    p32 = pos.astype(np.float32)
    d = p32[1] - p32[0]
    if np.float32(d[0] * d[0]) + np.float32(d[1] * d[1]) != target:
        pytest.fail('the constructed pair does not land on the float32 below the edge')
    got = ttpcf.pair_counts_rppi(pos, [0.1, 30.0], 1, 100.0, method='cell', device='cpu')
    got_t = ttpcf.pair_counts_rppi(pos, [0.1, 30.0], 1, 100.0, method='tile', device='cpu')
    assert got.sum() == 0 and got_t.sum() == 0
    ref = jtpcf.pair_counts_rppi(pos, [0.1, 30.0], 1, 100.0, method='cell')
    assert ref.sum() == (0 if _x64() else 2), _mode()


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
