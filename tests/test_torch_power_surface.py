"""Port parity for the power-spectrum surface: the device-built mode-bin
plan, the pole rows of the all-pairs binning, the CIC paint, and
calc_power / compute_power / calc_pk_* / bin_kmu of abacusutils_tpu_torch
against abacusutils_tpu (JAX on the CPU) on the same numpy inputs.

Tolerances: seg and counts bit-equal; ksum within 1e-12 of the host build
(both sum the same f32 values in float64) and 2e-5 of the JAX device build
(its bf16 hi/lo MXU reduction); pole weights within rtol 5e-6 + atol 1e-5
(f32 powers of mu^2 in another library); power within rtol 2e-4 (deposits
and FFTs summing in other orders, the budget of tests/test_power.py),
cross spectra within 2e-4 sqrt(P_ii P_jj) where they pass through zero,
poles within rtol 2e-4 + atol 2e-4 max|pole|, mode counts exact."""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from abacusutils_tpu.models.hod.abacus_hod import AbacusHOD as JaxAbacusHOD
from abacusutils_tpu.ops import grid as jgrid
from abacusutils_tpu.ops import power as jpow
from abacusutils_tpu_torch import _build
from abacusutils_tpu_torch.ops import power as tpow
from abacusutils_tpu_torch.ops.grid import (
    MAX_SMEM_BYTES,
    BrickPlan,
    axis_cloud,
    brick_key,
    paint_3d,
    stage_bricks,
)
from abacusutils_tpu_torch.testing import edge_points_centred
from torch_helpers import t

PK_RTOL = 2e-4


def _pole_atol(p):
    """1e-5 up to l = 4; above, where the monomial terms of (2l+1) L_l dup
    reach 10^3 and cancel, two f32 ulps of the largest term."""
    if p <= 4:
        return 1e-5
    terms = sum(abs(c) for c, _ in tpow._legendre_coeffs(p)) * (2 * p + 1) * 2
    return 2 * np.finfo(np.float32).eps * terms


def _edges2(n1d, lbox, nbins_k, nbins_mu, k_max=None):
    k_max = np.pi * n1d / lbox if k_max is None else k_max
    ke, me = tpow.get_k_mu_edges(lbox, k_max, nbins_k, nbins_mu, False)
    dk = 2 * np.pi / lbox
    return ((ke / dk) ** 2).astype(np.float32), (me**2).astype(np.float32)


PLAN_CASES = [
    # n1d, nbins_k, nbins_mu, poles, k_max factor (1: Nyquist)
    (32, 16, 1, (0, 2, 4), 1.0),
    (33, 16, 4, (0, 1, 2, 3, 4), 1.0),
    (48, 20, 3, (2,), 0.6),
    (24, 30, 5, (0, 1, 6, 8), 1.8),
]


@pytest.mark.parametrize('n1d,nbins_k,nbins_mu,poles,kfac', PLAN_CASES)
def test_device_plan_matches_host_and_jax(n1d, nbins_k, nbins_mu, poles, kfac):
    """The torch plan build against the numpy mode_bin_plan, the JAX host
    build and (even poles) the JAX device build."""
    lbox = 500.0
    ke2, me2 = _edges2(n1d, lbox, nbins_k, nbins_mu, kfac * np.pi * n1d / lbox)
    seg, counts, ksum, pole_w = tpow.mode_bin_plan_device(n1d, ke2, me2, poles, 'cpu')
    assert seg.dtype == torch.int32 and counts.dtype == ksum.dtype == torch.float64
    assert set(pole_w) == {p for p in poles if p}

    seg_np, counts_np = tpow.mode_bin_plan(n1d, ke2, me2)
    npt.assert_array_equal(seg.numpy(), seg_np)
    npt.assert_array_equal(counts.numpy(), counts_np)

    host = jpow._ModeBinPlan(n1d, ke2, me2, poles)
    npt.assert_array_equal(seg.numpy(), np.asarray(host.seg))
    npt.assert_array_equal(counts.numpy(), host.counts)
    npt.assert_allclose(ksum.numpy(), host.ksum, rtol=1e-12)
    for p, w in pole_w.items():
        assert w.dtype == torch.float32
        npt.assert_allclose(
            w.numpy(), np.asarray(host.pole_w_flat[p]), rtol=5e-6, atol=_pole_atol(p)
        )

    even = [p for p in poles if p and p % 2 == 0]
    dev = jpow._ModeBinPlan.__new__(jpow._ModeBinPlan)
    dev._init_device(n1d, ke2, me2, even, nbins_k, nbins_mu, n1d // 2 + 1)
    npt.assert_array_equal(seg.numpy(), np.asarray(dev.seg))
    npt.assert_array_equal(counts.numpy(), dev.counts)
    npt.assert_allclose(ksum.numpy(), dev.ksum, rtol=2e-5)
    for p in even:
        npt.assert_allclose(
            pole_w[p].numpy(), np.asarray(dev.pole_w_flat[p]), rtol=5e-6, atol=_pole_atol(p)
        )


def test_plan_cache_keys_edges_and_poles(monkeypatch):
    """get_mode_bin_plan builds once per (n1d, edges, poles, device) and
    keeps at most four plans; its counts are read-only."""
    monkeypatch.setattr(tpow, '_BIN_PLANS', {})
    ke2, me2 = _edges2(24, 500.0, 12, 2)
    before = tpow.get_mode_bin_plan.builds
    a = tpow.get_mode_bin_plan(24, ke2, me2, (0, 2), 'cpu')
    assert tpow.get_mode_bin_plan(24, ke2, me2, (0, 2), 'cpu') is a
    assert tpow.get_mode_bin_plan.builds == before + 1
    b = tpow.get_mode_bin_plan(24, ke2, me2, (0, 2, 4), 'cpu')
    assert b is not a and set(b.pole_w) == {2, 4} and (b.nk, b.nmu) == (12, 2)
    assert not a.counts.flags.writeable and a.counts.shape == (12, 2)
    for n in (20, 22, 26, 28):
        tpow.get_mode_bin_plan(n, ke2, me2, (), 'cpu')
    assert len(tpow._BIN_PLANS) <= 4 and tpow.get_mode_bin_plan.builds == before + 6


def _ffts(n1d, nf, seed):
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(n1d,) * 3).astype(np.float32)
    return [
        np.fft.rfftn(base + 0.5 * rng.normal(size=base.shape)).astype(np.complex64)
        for _ in range(nf)
    ]


@pytest.mark.parametrize('nbins_mu', [1, 4])
@pytest.mark.parametrize('n1d', [24, 25])
def test_pair_binning_pole_rows_match_jax(n1d, nbins_mu):
    """bin_pair_modes_plain with pole rows against _segsum_matmul_pairs
    (Nmu = 1: the pole rows ride the bin one-hot) and against the gather
    plan _bin_kmu_planned (any Nmu), per pair; rows of JAX's bf16 hi/lo
    MXU sums within 1e-5 of the row's largest value."""
    lbox, nbins_k, poles = 300.0, 12, (0, 2, 4)
    ke2, me2 = _edges2(n1d, lbox, nbins_k, nbins_mu)
    plan = tpow.get_mode_bin_plan(n1d, ke2, me2, poles, 'cpu')
    dks = _ffts(n1d, 3, seed=n1d + nbins_mu)
    pole_w = {p: plan.pole_w[p] for p in (2, 4)}
    sums, psums = tpow.bin_pair_modes_plain(
        [t(d) for d in dks], plan.seg, None, 1.0, nbins_k * nbins_mu, pole_w, nbins_mu
    )
    assert sums.shape == (6, nbins_k * nbins_mu) and psums.shape == (6, 2, nbins_k)

    jplan = jpow._ModeBinPlan(n1d, ke2, me2, poles)
    kzlen = n1d // 2 + 1
    flat = [jnp.asarray(d.reshape(-1)) for d in dks]
    pairs = tpow.field_pairs(3)
    if nbins_mu == 1:
        ref = np.asarray(jpow._segsum_matmul_pairs(
            tuple(flat), jplan.seg, nbins_k, kzlen, even=n1d % 2 == 0,
            pole_w=tuple(jplan.pole_w_flat[p] for p in (2, 4)), pairs=tuple(pairs),
        ))
        for p in range(len(pairs)):
            for r, got in enumerate([sums[p].numpy(), *psums[p].numpy()]):
                npt.assert_allclose(got, ref[p, r], rtol=1e-5, atol=1e-5 * np.abs(ref[p, r]).max())
    for p, (i, j) in enumerate(pairs):
        raw = np.real(dks[i] * np.conj(dks[j])).astype(np.float32).reshape(-1)
        wsum, ps = jpow._bin_kmu_planned(
            jnp.asarray(raw), jplan.perm, jplan.bounds, jplan.kbounds, jplan.dup_sorted,
            {q: jplan.pole_w[q] for q in (2, 4)}, poles,
        )
        for got, want in [(sums[p], wsum), (psums[p, 0], ps[0]), (psums[p, 1], ps[1])]:
            want = np.asarray(want)
            npt.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_pair_binning_wrapper_checks_pole_arguments():
    """Off the CPU, K3's wrapper refuses pole arguments the kernel does not
    take before it launches: a histogram over the shared memory of a block,
    more than four non-zero poles, a degree above 8, nmu not dividing
    nbins."""
    meta = dict(device='meta')
    dks = [torch.empty((32, 32, 17), dtype=torch.complex64, **meta) for _ in range(3)]
    seg = torch.empty(32 * 32 * 17, dtype=torch.int32, **meta)

    def w(*ps):
        return {p: torch.empty(seg.shape, dtype=torch.float32, **meta) for p in ps}

    nk = MAX_SMEM_BYTES // 4 // 6 // 3
    with pytest.raises(ValueError, match='shared memory'):
        tpow.bin_pair_modes(dks, seg, None, 1.0, nk + 1, w(2, 4), 1)
    with pytest.raises(ValueError, match='at most 4'):
        tpow.bin_pair_modes(dks, seg, None, 1.0, 16, w(1, 2, 3, 4, 6), 1)
    with pytest.raises(ValueError, match='pole 10'):
        tpow.bin_pair_modes(dks, seg, None, 1.0, 16, w(10), 1)
    with pytest.raises(ValueError, match='multiple of nmu'):
        tpow.bin_pair_modes(dks, seg, None, 1.0, 18, w(2), 4)


# ---- the CIC paint -------------------------------------------------------


def _np_paint(pos, w, nmesh, box, offset, kind):
    """The 27-point scatter in numpy f32 arithmetic, unfused (each product
    and sum rounded), with np.add.at: the contract of paint_3d_plain."""
    box32, off32 = np.float32(box), np.float32(offset)
    inv_h = np.float32(nmesh) / box32
    idx, wts = [], []
    for a in range(3):
        x = pos[:, a].astype(np.float32)
        if kind == 'tsc':
            x = np.where(x >= box32, x - box32, x)
            x = np.where(x < 0, x + box32, x)
        q = (x + off32) * inv_h
        i0 = np.floor(q + np.float32(0.5))
        d = i0 - q
        if kind == 'tsc':
            h = np.float32(0.5)
            wts.append((h * (h + d) ** 2, np.float32(0.75) - d * d, h * (h - d) ** 2))
        else:
            wts.append((np.maximum(d, 0), np.float32(1) - np.abs(d), np.maximum(-d, 0)))
        idx.append(i0.astype(np.int64))
    grid = np.zeros(nmesh**3, np.float64)
    for a in range(3):
        for b in range(3):
            for c in range(3):
                f = ((idx[0] + a - 1) % nmesh * nmesh + (idx[1] + b - 1) % nmesh) * nmesh
                np.add.at(grid, f + (idx[2] + c - 1) % nmesh, wts[0][a] * wts[1][b] * wts[2][c] * w)
    return grid.reshape((nmesh,) * 3)


@pytest.mark.parametrize('kind', ['tsc', 'cic'])
@pytest.mark.parametrize('offset', [0.0, 0.3])
def test_paint_3d_matches_jax(kind, offset):
    """The port's paint_3d (the plain scatter on CPU tensors) against JAX's
    paint_3d with get_field's conventions (TSC wraps then offsets, CIC
    paints pos + offset unwrapped) on box-centred random points, some a
    cell outside the box; and, on points placed on cell edges at negative
    and positive coordinates, against the same scatter in unfused numpy f32
    arithmetic. (XLA on the CPU contracts the cell index into an FMA, so on
    exact cell edges JAX's paint_3d may put a point one cell over.)"""
    nmesh, yb, box = 24, 8, 60.0
    rng = np.random.default_rng(17)
    pos = (rng.random((20_000, 3)) * (box + 4) - box / 2 - 2).astype(np.float32)
    w = rng.random(len(pos)).astype(np.float32)

    def port(p):
        return paint_3d(*(t(p[:, i]) for i in range(3)), nmesh, box, t(w), offset, kind).numpy()

    got = port(pos)
    if kind == 'cic':
        ref = jgrid.paint_3d(
            jnp.asarray(pos) + offset, nmesh, box, weights=w, kind='cic', wrap=False
        )
    else:
        ref = jgrid.paint_3d(pos, nmesh, box, weights=w, offset=offset, kind='tsc', wrap=True)
    ref = np.asarray(ref)
    npt.assert_allclose(got, ref, rtol=1e-5, atol=1e-6 * np.abs(ref).max())
    npt.assert_allclose(got.sum(dtype=np.float64), w.sum(dtype=np.float64), rtol=1e-6)

    edge = edge_points_centred(len(w), nmesh, yb, box, rng)
    got = port(edge)
    ref = _np_paint(edge, w, nmesh, box, offset, kind)
    npt.assert_allclose(got, ref, rtol=1e-5, atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize('offset', [0.0, 0.5 * 60.0 / 24])
def test_cic_staging_key_is_the_paint_cell(offset):
    """K1 deposits a point through its brick's tile only when the point's
    stencil lies in it: the CIC brick key must give the cell of the
    unwrapped paint, including negative coordinates on cell edges (where
    floor of the raw coordinate and of the wrapped one differ in f32), and
    the sort keeps every point."""
    nmesh, yb, box = 24, 4, 60.0
    rng = np.random.default_rng(5)
    pos = edge_points_centred(50_000, nmesh, yb, box, rng)
    cols = [t(pos[:, i]) for i in range(3)]
    brick = (1, yb, nmesh)
    key = brick_key(*cols, nmesh, brick, box, offset, kind='cic')
    ix, _ = axis_cloud(cols[0], box, offset, nmesh, wrap=False, kind='cic')
    iy, _ = axis_cloud(cols[1], box, offset, nmesh, wrap=False, kind='cic')
    want = torch.remainder(ix, nmesh) * (nmesh // yb) + torch.remainder(iy, nmesh) // yb
    npt.assert_array_equal(key.numpy(), want.numpy())
    # the raw and the wrapped coordinate do not always share a cell: a key
    # built with TSC's wrap would misstage some of these points
    tsc_key = brick_key(*cols, nmesh, brick, box, offset, kind='tsc')
    assert (tsc_key != key).any()
    staged, plan = stage_bricks(cols, nmesh, box, brick, offset=offset, kind='cic')
    assert int((plan.work[:, 2] - plan.work[:, 1]).sum()) == len(pos)
    skey = brick_key(*staged, nmesh, brick, box, offset, kind='cic')
    assert bool((skey[1:] >= skey[:-1]).all())


# ---- calc_power and the spectrum functions ---------------------------------


def _cross_ok(got, ref, auto1, auto2, tol=PK_RTOL):
    scale = np.sqrt(np.abs(auto1 * auto2))
    return bool((np.abs(got - ref) <= tol * scale + 1e-30).all())


def _assert_table(got, ref, poles=True, scale=None):
    cols = set(ref.colnames)
    assert set(got) == cols
    for k in ('k_min', 'k_max', 'k_mid', 'N_mode', 'N_mode_poles', 'mu_min', 'mu_max', 'mu_mid'):
        if k in cols:
            npt.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)
    P, Pj = got['power'], np.asarray(ref['power'])
    # bins with modes, less a bin of the k = 0 mode alone, whose power is
    # the round-off of the mean subtraction
    ok = (np.asarray(ref['N_mode']) > 0) & (np.asarray(ref['k_avg']) > 0)
    if scale is None:
        npt.assert_allclose(P[ok], Pj[ok], rtol=PK_RTOL)
    else:  # a cross spectrum, against sqrt(P_ii P_jj)
        assert (np.abs(P - Pj) <= PK_RTOL * scale)[ok].all()
    npt.assert_allclose(got['k_avg'], np.asarray(ref['k_avg']), rtol=1e-6)
    if poles:
        pj = np.asarray(ref['poles'])
        npt.assert_allclose(got['poles'], pj, rtol=PK_RTOL, atol=PK_RTOL * np.abs(pj).max())


@pytest.mark.parametrize('nbins_mu', [1, 4])
@pytest.mark.parametrize('interlaced', [False, True])
@pytest.mark.parametrize('compensated', [False, True])
@pytest.mark.parametrize('paste', ['CIC', 'TSC'])
def test_calc_power_matches_jax(paste, compensated, interlaced, nbins_mu):
    """calc_power against JAX's on the random catalog of
    tests/test_power.py:test_power_consistency, poles (0, 2, 4); the port's
    monopole is the mode-weighted band mean (that test's invariant)."""
    rng = np.random.default_rng(300)
    Lbox, nmesh = 1000.0, 72
    pos = (rng.random((20000, 3)) * Lbox).astype(np.float32)
    args = (pos, Lbox, nmesh // 2, nbins_mu, np.pi * nmesh / Lbox + 1e-6, False, paste, nmesh,
            compensated, interlaced)
    ref = jpow.calc_power(*args, poles=(0, 2, 4))
    got = tpow.calc_power(*args, poles=(0, 2, 4), device='cpu')
    assert isinstance(got, tpow.SpectrumTable)
    assert got.meta == ref.meta
    _assert_table(got, ref)
    shape = (nmesh // 2, nbins_mu)
    power, nmode = got['power'].reshape(shape), got['N_mode'].reshape(shape)
    ok = nmode.sum(axis=1) > 0
    bandmean = (power * nmode).sum(axis=1)[ok] / nmode.sum(axis=1)[ok]
    npt.assert_allclose(got['poles'][ok, 0], bandmean, rtol=1e-5, atol=1e-10)


def test_calc_power_cross_weighted_and_defaults():
    """A weighted cross spectrum, default bins (kbins = nmesh, k_max at
    Nyquist, no mu columns), and the (N, 3) tensor input form."""
    rng = np.random.default_rng(8)
    Lbox, nmesh = 400.0, 32
    pos = (rng.random((8000, 3)) * Lbox).astype(np.float32)
    pos2 = (pos + rng.normal(0, 3, pos.shape)).astype(np.float32) % np.float32(Lbox)
    w = rng.random(8000).astype(np.float32)
    kw = dict(nmesh=nmesh, w=w, pos2=pos2, poles=[0, 2])
    ref = jpow.calc_power(pos, Lbox, **kw)
    got = tpow.calc_power(torch.from_numpy(pos), Lbox, **kw)
    assert got.meta == ref.meta and 'mu_mid' not in got
    autos = [
        np.asarray(jpow.calc_power(p, Lbox, nmesh=nmesh, w=wp)['power'])
        for p, wp in ((pos, w), (pos2, None))
    ]
    _assert_table(got, ref, scale=np.sqrt(np.abs(autos[0] * autos[1])))


def test_get_field_fft_and_pk_from_deltak_match_jax():
    """get_field_fft (interlaced, compensated), get_raw_power, bin_kmu,
    calc_pk_from_deltak and calc_pk_pairs_from_deltak against JAX's."""
    rng = np.random.default_rng(4)
    Lbox, nmesh = 250.0, 32
    cats = [(rng.random((6000, 3)) * Lbox).astype(np.float32) for _ in range(3)]
    W = tpow.get_W_compensated(Lbox, nmesh, 'CIC', True)
    fj = [np.asarray(jpow.get_field_fft(c, Lbox, nmesh, 'CIC', None, W, True, True)) for c in cats]
    ft = [tpow.get_field_fft(c, Lbox, nmesh, 'CIC', None, W, True, True, device='cpu')
          for c in cats]
    for a, b in zip(ft, fj):
        npt.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-4 * np.abs(b).max())
    raw = tpow.get_raw_power(ft[0], ft[1]).numpy()
    raw_j = np.asarray(jpow.get_raw_power(fj[0], fj[1]))
    npt.assert_allclose(raw, raw_j, atol=1e-3 * np.abs(raw).max())

    ke, me = tpow.get_k_mu_edges(Lbox, np.pi * nmesh / Lbox, 12, 3, False)
    bj = jpow.bin_kmu(nmesh, Lbox, ke, me, np.abs(fj[0]) ** 2, poles=np.array([0, 2]))
    bt = tpow.bin_kmu(nmesh, Lbox, ke, me, np.abs(fj[0]) ** 2, poles=[0, 2], device='cpu')
    for a, b in zip(bt, bj):
        npt.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * np.abs(b).max())
    # a real mesh: separation bins in units of the cell, as pk_to_xi bins xi
    real = np.fft.irfftn(np.abs(fj[0]) ** 2).astype(np.float32)
    re = np.linspace(0.0, Lbox / 2, 9)
    bj = jpow.bin_kmu(nmesh, Lbox, re, me, real, poles=np.array([0, 2]), fourier=False)
    bt = tpow.bin_kmu(nmesh, Lbox, re, me, real, poles=[0, 2], fourier=False, device='cpu')
    npt.assert_array_equal(bt[1], bj[1])
    npt.assert_array_equal(bt[3], bj[3])
    for a, b in zip(bt, bj):
        npt.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * np.abs(b).max())

    for mu in (me, np.array([0.0, 1.0])):
        pj = jpow.calc_pk_from_deltak(
            fj[0], Lbox, ke, mu, field2_fft=fj[2], poles=np.array([0, 2, 4])
        )
        pt = tpow.calc_pk_from_deltak(t(fj[0]), Lbox, ke, mu, field2_fft=t(fj[2]), poles=[0, 2, 4])
        auto = [tpow.calc_pk_from_deltak(t(f), Lbox, ke, mu)['power'] for f in (fj[0], fj[2])]
        npt.assert_array_equal(pt['N_mode'], pj['N_mode'])
        assert _cross_ok(pt['power'], pj['power'], *auto, tol=1e-5)
        pairs_j = jpow.calc_pk_pairs_from_deltak(fj, Lbox, ke, mu, poles=np.array([0, 2]))
        pairs_t = tpow.calc_pk_pairs_from_deltak([t(f) for f in fj], Lbox, ke, mu, poles=[0, 2])
        assert list(pairs_t) == list(pairs_j)
        for ij, ref in pairs_j.items():
            got = pairs_t[ij]
            npt.assert_array_equal(got['N_mode'], ref['N_mode'])
            npt.assert_array_equal(got['N_mode_poles'], ref['N_mode_poles'])
            pa = np.asarray(ref['binned_poles'])
            npt.assert_allclose(got['binned_poles'], pa, rtol=1e-4, atol=1e-5 * np.abs(pa).max())


@pytest.mark.parametrize('nbins_mu', [1, 4])
@pytest.mark.parametrize('interlaced', [False, True])
@pytest.mark.parametrize('compensated', [False, True])
@pytest.mark.parametrize('paste', ['CIC', 'TSC'])
def test_compute_power_matches_jax(paste, compensated, interlaced, nbins_mu):
    """AbacusHOD.compute_power on a two-tracer mock of box-centred positions
    (run_hod's frame, so CIC paints negative coordinates) against JAX's:
    keys, k_binc, mu_binc and mode counts equal, autos within rtol 2e-4,
    crosses within 2e-4 sqrt(P_ii P_jj), poles within 2e-4 of their
    largest value."""
    from abacusutils_tpu_torch.convert import staged_state_from_numpy
    from torch_helpers import TRACERS, staged_state

    rng = np.random.default_rng(31)
    lbox, nmesh = 250.0, 32
    mock = {}
    for tr, n in (('LRG', 20_000), ('ELG', 12_000)):
        pos = (rng.random((n, 3)) * lbox - lbox / 2).astype(np.float32)
        mock[tr] = {'x': pos[:, 0], 'y': pos[:, 1], 'z': pos[:, 2]}
    mock['ELG']['w'] = rng.random(12_000).astype(np.float32)
    args = (mock, 10, nbins_mu, np.pi * nmesh / lbox, False)
    kw = dict(poles=(0, 2, 4), paste=paste, num_cells=nmesh, compensated=compensated,
              interlaced=interlaced)
    ref = JaxAbacusHOD.compute_power(SimpleNamespace(lbox=lbox), *args, **kw)
    halo, part = staged_state(500, 2000, lbox, seed=1)
    port = staged_state_from_numpy(
        halo, part, {'z': 0.5, 'Lbox': lbox, 'velz2kms': 100.0}, TRACERS, {}, 'cpu'
    )
    got = port.compute_power(*args, **kw)
    assert set(got) == set(ref)
    npt.assert_array_equal(got['k_binc'], ref['k_binc'])
    npt.assert_array_equal(got['mu_binc'], ref['mu_binc'])
    for key in ref:
        if key.endswith('_modes'):
            npt.assert_array_equal(got[key], ref[key], err_msg=key)
    for t1 in mock:
        for t2 in mock:
            key = f'{t1}_{t2}'
            g, r = got[key], np.asarray(ref[key])
            if t1 == t2:
                npt.assert_allclose(g, r, rtol=PK_RTOL, err_msg=key)
            else:
                assert _cross_ok(g, r, ref[f'{t1}_{t1}'], ref[f'{t2}_{t2}']), key
            pj = np.asarray(ref[key + '_ell'])
            atol = PK_RTOL * np.abs(pj).max()
            npt.assert_allclose(got[key + '_ell'], pj, rtol=PK_RTOL, atol=atol)


def test_cic_deposit_wrapper_never_falls_back(monkeypatch):
    """Off the CPU, K1's wrapper launches for either kind or raises: an
    unknown kind is refused, and a missing kernel library is not caught."""
    from abacusutils_tpu_torch.ops.grid import tsc_deposit_cells

    class NoKernel(RuntimeError):
        pass

    def no_lib():
        raise NoKernel

    meta = dict(device='meta')
    nmesh = 16
    grid = torch.empty((nmesh,) * 3, **meta)
    x, y, z, w = (torch.empty(100, **meta) for _ in range(4))
    plan = BrickPlan(torch.empty((3, 3), dtype=torch.int32, **meta), nmesh, (16, 8, 16), (0,) * 3)
    overflow = torch.empty(1, dtype=torch.int32, **meta)
    with pytest.raises(ValueError, match='unknown mass assignment'):
        tsc_deposit_cells(grid, x, y, z, w, plan, 10.0, overflow=overflow, kind='ngp')
    monkeypatch.setattr(_build, 'lib', no_lib)
    for kind in ('tsc', 'cic'):
        with pytest.raises(NoKernel):
            tsc_deposit_cells(grid, x, y, z, w, plan, 10.0, overflow=overflow, kind=kind)


# ---------------------------------------------------------------------------
# The rest of the public surface: host helpers, field helpers, poles, xi(r)
# ---------------------------------------------------------------------------


def _kmag2_grids(n1d, lbox):
    """The |k|^2 of every rfft mode: integers in units of the fundamental
    mode (the plans' and expand_poles_to_3d's), and the window's f32 sum of
    squared f32 k components in h/Mpc."""
    i = np.arange(n1d)
    f = np.where(i < n1d // 2, i, i - n1d)
    kz = np.arange(n1d // 2 + 1)
    ints = (f[:, None, None] ** 2 + f[None, :, None] ** 2 + kz[None, None, :] ** 2)
    kv = f.astype(np.float32) * np.float32(2 * np.pi / lbox)
    kzv = kz.astype(np.float32) * np.float32(2 * np.pi / lbox)
    phys = kv[:, None, None] ** 2 + kv[None, :, None] ** 2 + kzv[None, None, :] ** 2
    return ints.astype(np.float32), phys.astype(np.float32)


@pytest.mark.parametrize('n1d', [31, 32])
def test_sqrt_rn_f32_is_numpys_root(n1d):
    """The shared root helper is bit-equal to numpy's correctly rounded f32
    sqrt on every |k|^2 of the mesh, in both forms the port takes roots of
    (torch's own CPU f32 sqrt is not, on AVX-512 hosts)."""
    for k2 in _kmag2_grids(n1d, 250.0):
        got = tpow._sqrt_rn_f32(t(k2))
        assert got.dtype == torch.float32
        npt.assert_array_equal(got.numpy(), np.sqrt(k2))


def test_host_helpers_match_jax():
    """factorial, factorial_slow, n_choose_k exactly; P_n of mu^2 up to l = 8
    within 4 f32 ulps of its largest term (JAX's and torch's pow differ by an
    ulp); linear_interp exactly (both numpy)."""
    for n in range(21):
        assert tpow.factorial(n) == jpow.factorial(n) == tpow.factorial_slow(n)
        for k in range(n + 1):
            assert tpow.n_choose_k(n, k) == jpow.n_choose_k(n, k)
    with pytest.raises(ValueError):
        tpow.factorial(21)
    mu2 = np.random.default_rng(5).random(500).astype(np.float32)
    mu2[:3] = (0.0, 1.0, 0.5)
    for ell in range(9):
        got, want = tpow.P_n(mu2, ell), jpow.P_n(mu2, ell)
        assert got.dtype == np.float32 and got.shape == mu2.shape
        terms = sum(abs(c) for c, _ in tpow._legendre_coeffs(ell))
        npt.assert_allclose(got, want, rtol=0, atol=4 * np.finfo(np.float32).eps * terms)
    x = np.linspace(0.0, 2.0, 11)
    y = np.cos(x)
    xd = np.linspace(-0.5, 2.5, 97)
    npt.assert_array_equal(tpow.linear_interp(xd, x, y), jpow.linear_interp(xd, x, y))


@pytest.mark.parametrize('n1d', [16, 31, 32])
def test_field_helpers_match_jax(n1d):
    """normalize_field (bit-equal: the same f32 steps and numpy's sum, then a
    float64 torch sum for a tensor within 1 ulp), shift_field_fft (the
    interlace combination, within 1e-5 of max|F|: exp and the phase in
    another library), get_delta_mu2 (bit-equal), get_smoothing (within 2 f32
    ulps: exp in another library)."""
    rng = np.random.default_rng(n1d)
    lbox = 120.0
    field = rng.random((n1d,) * 3).astype(np.float32)
    want = jpow.normalize_field(field)
    npt.assert_array_equal(tpow.normalize_field(field, device='cpu').numpy(), want)
    npt.assert_allclose(tpow.normalize_field(t(field)).numpy(), want, rtol=0,
                        atol=2 * np.finfo(np.float32).eps * np.abs(want).max())
    npt.assert_array_equal(tpow.normalize_field(field, 7.5, device='cpu').numpy(),
                           jpow.normalize_field(field, 7.5))
    copy = field.copy()
    assert tpow.normalize_field(copy, inplace=True, device='cpu') is copy
    npt.assert_array_equal(copy, want)

    F, Fs = (np.fft.rfftn(rng.normal(size=(n1d,) * 3)).astype(np.complex64) for _ in range(2))
    d = lbox / n1d
    got = tpow.shift_field_fft(F, Fs, n1d, lbox, d, device='cpu')
    assert got.dtype == torch.complex64
    want = jpow.shift_field_fft(F, Fs, n1d, lbox, d)
    npt.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())

    npt.assert_array_equal(tpow.get_delta_mu2(F, n1d, device='cpu').numpy(),
                           np.asarray(jpow.get_delta_mu2(F, n1d)))
    got = tpow.get_smoothing(n1d, lbox, 7.0, device='cpu')
    assert got.shape == (n1d, n1d, n1d // 2 + 1) and got.dtype == torch.float32
    npt.assert_allclose(got.numpy(), np.asarray(jpow.get_smoothing(n1d, lbox, 7.0)), rtol=0,
                        atol=2 * np.finfo(np.float32).eps)


def _expand_reference(k_ell, P_ell, n1d, lbox, poles, fma):
    """expand_poles_to_3d in numpy f32 steps; with fma=True each step XLA's
    CPU code contracts into a fused multiply-add (|k| dk - k0, and y0 +
    frac (y1 - y0)) is rounded once, as JAX runs it. Returns (P, floor)."""
    kmag2, _ = _kmag2_grids(n1d, lbox)
    kz = np.arange(n1d // 2 + 1, dtype=np.float32) ** 2
    mu2 = np.where(kmag2 > 0, kz[None, None, :] / np.maximum(kmag2, 1), 0).astype(np.float32)
    root, dk = np.sqrt(kmag2), np.float32(2 * np.pi / lbox)
    kmag = root * dk
    k_ell = k_ell.astype(np.float32)
    x0, dx = k_ell[0], np.float32(k_ell[1] - k_ell[0])
    if fma:
        t_ = (root.astype(np.float64) * dk - np.float64(x0)).astype(np.float32)
    else:
        t_ = kmag - x0
    f = np.clip(t_ / dx, np.float32(0), np.float32(len(k_ell) - 1.000001))
    fl = np.floor(f).astype(np.int64)
    frac = f - fl.astype(np.float32)
    out = np.zeros_like(kmag)
    for ip, pole in enumerate(poles):
        y = P_ell[ip].astype(np.float32)
        y0, y1 = y[fl], y[np.minimum(fl + 1, len(y) - 1)]
        if fma:
            v = (frac.astype(np.float64) * (y1 - y0) + y0).astype(np.float32)
        else:
            v = y0 + frac * (y1 - y0)
        v = np.where(kmag <= x0, y[0], np.where(kmag >= k_ell[-1], y[-1], v))
        if pole:
            v = v * tpow.P_n(mu2, pole)
        out = out + v
    return out, fl


@pytest.mark.parametrize('n1d', [16, 31, 32])
def test_expand_poles_to_3d_matches_jax(n1d):
    """expand_poles_to_3d: bit-equal to its unfused f32 steps in numpy, and to
    JAX's program with its two fused multiply-adds emulated on every mode
    where the floor of the table position agrees; where one rounding moves
    that floor (f within an ulp of an integer), the two differ by at most
    the table's largest step times the poles' Legendre bound, and such modes
    are under 1 %. Against JAX itself: within 3e-5 of max|P| everywhere."""
    rng = np.random.default_rng(n1d + 1)
    lbox, poles = 100.0, (0, 2, 4)
    k_ell = np.linspace(0.01, 0.6, 40)
    P_ell = rng.random((3, 40)).astype(np.float32)
    got = tpow.expand_poles_to_3d(k_ell, P_ell, n1d, lbox, poles, device='cpu').numpy()
    plain, fl = _expand_reference(k_ell, P_ell, n1d, lbox, poles, fma=False)
    npt.assert_array_equal(got, plain)
    jax_emul, fl_j = _expand_reference(k_ell, P_ell, n1d, lbox, poles, fma=True)
    want = np.asarray(jpow.expand_poles_to_3d(k_ell, P_ell, n1d, lbox, poles))
    npt.assert_allclose(jax_emul, want, rtol=0, atol=4 * np.finfo(np.float32).eps * 3)
    flips = fl != fl_j
    assert flips.mean() < 0.01
    step = np.abs(np.diff(P_ell, axis=1)).max() * 3
    assert (np.abs(got - want)[flips] <= step).all()
    npt.assert_allclose(got, want, rtol=0, atol=3e-5 * np.abs(want).max())
    with pytest.raises(ValueError, match='equidistant'):
        tpow.expand_poles_to_3d(np.geomspace(0.01, 0.6, 40), P_ell, n1d, lbox, poles,
                                device='cpu')


def _lattice_with_mode(nmesh, lbox, amp, mode_idx):
    """Points at cell corners weighted 1 + amp cos(2 pi m x / L), the
    single-mode lattice of tests/test_power.py."""
    x = np.arange(nmesh) * (lbox / nmesh)
    X, Y, Z = np.meshgrid(x, x, x, indexing='ij')
    pos = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1).astype(np.float32)
    w = (1.0 + amp * np.cos(2 * np.pi * mode_idx * X.ravel() / lbox)).astype(np.float32)
    return pos, w


@pytest.mark.parametrize('n1d', [16, 31, 32])
def test_pk_to_xi_and_poles_match_jax(n1d):
    """pk_to_xi and project_3d_to_poles on the 3-D power of the single-mode
    lattice (tests/test_power.py:test_pk_to_xi_roundtrip) and of a random
    field: counts equal; xi_l within 2e-5 of max|xi_l| (irfftn: pocketfft
    here, XLA's FFT in JAX, then K3's plain sums); poles within 1e-5 of
    max|P_l|."""
    lbox = 100.0
    pos, w = _lattice_with_mode(n1d, lbox, 0.2, 3)
    F = tpow.get_field_fft(pos, lbox, n1d, 'TSC', w, None, False, False, device='cpu')
    lattice = (tpow.get_raw_power(F).numpy() * lbox**3).astype(np.float32)
    rng = np.random.default_rng(n1d)
    noise = (np.abs(np.fft.rfftn(rng.normal(size=(n1d,) * 3))) ** 2).astype(np.float32)
    r_bins = np.linspace(0, 50, 26)
    for p3d in (lattice, noise):
        r_binc, xi, n_xi = tpow.pk_to_xi(p3d, lbox, r_bins, poles=[0, 2, 4], device='cpu')
        jr, jxi, jn = jpow.pk_to_xi(p3d, lbox, r_bins, poles=[0, 2, 4])
        assert xi.shape == (3, 25) and np.isfinite(xi).all()
        npt.assert_array_equal(r_binc, jr)
        npt.assert_array_equal(n_xi, jn)
        for ell in range(3):
            npt.assert_allclose(xi[ell], jxi[ell], rtol=0, atol=2e-5 * np.abs(jxi[ell]).max())
        kb = np.linspace(0, np.pi * n1d / lbox, 17)
        got, n_p = tpow.project_3d_to_poles(kb, p3d / lbox**3, lbox, [0, 2], device='cpu')
        want, jn = jpow.project_3d_to_poles(kb, p3d / lbox**3, lbox, [0, 2])
        assert got.shape == (2, 16)
        npt.assert_array_equal(n_p, jn)
        for ell in range(2):
            npt.assert_allclose(got[ell], want[ell], rtol=0, atol=1e-5 * np.abs(want[ell]).max())
    _, xi, _ = tpow.pk_to_xi(lattice, lbox, r_bins, poles=[0, 2, 4], device='cpu')
    assert xi[0, 0] > 0


def test_all_holds_the_public_power_spectrum_api():
    """ops/power.py's __all__ holds every name abacusnbody's
    analysis/power_spectrum.py exports, plus StagedPower, each defined."""
    import ast
    from pathlib import Path

    src = Path(__file__).resolve().parent.parent / 'abacusnbody/analysis/power_spectrum.py'
    names = {a.name for node in ast.walk(ast.parse(src.read_text()))
             if isinstance(node, ast.ImportFrom) for a in node.names}
    assert len(names) == 22
    missing = (names | {'StagedPower'}) - set(tpow.__all__)
    assert not missing
    for name in tpow.__all__:
        assert hasattr(tpow, name), name
