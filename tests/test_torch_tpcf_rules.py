"""Pair-count rules held against JAX: the rounding of the squared edges
and of the box, the bin tables, the mu-bin estimate, and the dispatch
between the cell and the all-pairs engines, on catalogs inside and
outside the box (tests/tpcf_helpers.py says which JAX).
"""

import jax
import numpy as np
import numpy.testing as npt
import pytest
import torch

from abacusutils_tpu.ops import tpcf as jtpcf
from abacusutils_tpu_torch.ops import tpcf as ttpcf
from tpcf_helpers import (
    LBOX, RPBINS, RP0, PIMAX, SBINS, S0, NMU, _x64, _mode, _tile_dtype, _points, _brute,
    _rules_agree, _both,
)


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
