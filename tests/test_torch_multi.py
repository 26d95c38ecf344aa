"""Port parity for the multi-tracer fused step: ELG and QSO markers, the
priority keep codes, the light-cone RSD, the linked staging, the all-pairs
binning and hod_pk_fused_multi / populate_lc_multi / pk_grouped_multi of
abacusutils_tpu_torch on the CPU against abacusutils_tpu (JAX on CPU), on
the same numpy catalogs.

Tolerances: markers at rtol 5e-5 + atol 1e-6 (torch and XLA round log10,
erf and erfc differently; tests/test_torch_population.py), keep codes equal
apart from near ties within that budget, spectra at rtol 2e-4 (two deposit
layouts summing in other orders, the budget of tests/test_pipeline.py) and
cross spectra at |d| <= 2e-4 sqrt(P_ii P_jj), since a cross bin sum may
cancel to near zero."""

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from abacusutils_tpu.models import pipeline as jpipe
from abacusutils_tpu.models.hod import population as jpop
from abacusutils_tpu.ops import grid as jgrid
from abacusutils_tpu.ops import power as jpow
from abacusutils_tpu_torch import _build
from abacusutils_tpu_torch.convert import params_to_tensors
from abacusutils_tpu_torch.models import pipeline as tpipe
from abacusutils_tpu_torch.models.hod import population as tpop
from abacusutils_tpu_torch.ops.grid import MAX_SMEM_BYTES, brick_shape, stage_bricks
from abacusutils_tpu_torch.ops.power import (
    MAX_FIELDS,
    bin_pair_modes,
    bin_pair_modes_plain,
    bin_power_modes_plain,
    field_pairs,
    get_W_compensated,
)
from torch_helpers import TRACERS, catalog_tensors, linked_inputs, t

LBOX = 500.0
NMESH = 32
NBINS_K = 16
WANT = ('LRG', 'ELG', 'QSO')
MARKER_RTOL = 5e-5
MARKER_ATOL = 1e-6
PK_RTOL = 2e-4


def _tracer_params(**extra):
    """prepare_tracer_params of the test tracers, with `extra` set on each."""
    return jpop.prepare_tracer_params({k: dict(v, **extra) for k, v in TRACERS.items()}, z=0.5)


def _tensors(tp):
    return {k: params_to_tensors(v, 'cpu') for k, v in tp.items()}


def _near_ties(keep_t, keep_j, randoms, levels):
    """Count of differing keep codes, after checking that each random ties
    one of the stacked marker levels (T, N) within the marker budget."""
    diff = np.flatnonzero(keep_t != keep_j)
    lv = levels[:, diff]
    tie = MARKER_RTOL * np.abs(lv) + MARKER_ATOL
    assert (np.abs(randoms[diff] - lv) <= tie).any(axis=0).all()
    return diff.size


def _assert_spectra(got, ref, want, tol=PK_RTOL):
    """Auto spectra at rtol `tol`; cross spectra at |d| <= tol sqrt(P_ii P_jj)."""
    for i, t1 in enumerate(want):
        for t2 in want[i:]:
            g, r = np.asarray(got[(t1, t2)], np.float64), np.asarray(ref[(t1, t2)], np.float64)
            if t1 == t2:
                npt.assert_allclose(g, r, rtol=tol, err_msg=t1)
            else:
                scale = np.sqrt(np.abs(np.asarray(ref[(t1, t1)]) * np.asarray(ref[(t2, t2)])))
                assert (np.abs(g - r) <= tol * scale).all(), (t1, t2)


# ---- markers, keep codes, host helpers -------------------------------------


def _env(n, seed):
    rng = np.random.default_rng(seed)
    mass = (10 ** (11 + 4 * rng.random(n))).astype(np.float32)
    deltac, fenv, shear = (rng.uniform(-0.5, 0.5, n).astype(np.float32) for _ in range(3))
    keep_cent = rng.integers(0, 3, n).astype(np.int8)
    return mass, deltac, fenv, shear, keep_cent


@pytest.mark.parametrize('tracer', ['ELG', 'QSO'])
@pytest.mark.parametrize('shear', ['column', 'zero'])
def test_elg_qso_markers_match(tracer, shear):
    """Central and satellite markers with assembly bias, the ELG shear
    terms (a column, or the Python float 0.0 of a stage without shear) and
    ELG conformity on the host's central code."""
    n = 60_000
    mass, deltac, fenv, shear_col, keep_cent = _env(n, seed=len(tracer))
    p = _tracer_params(
        Acent=0.1, Asat=-0.2, Bcent=0.05, Bsat=0.1, Ccent=0.07, Csat=-0.05, ic=0.9,
        logM1_EE=13.1, alpha_EE=0.9, logM1_EL=13.9, alpha_EL=0.7,
    )[tracer]
    pj = {k: jnp.float32(v) for k, v in p.items()}
    pt = params_to_tensors(p, 'cpu')
    sj = shear_col if shear == 'column' else 0.0
    st = t(shear_col) if shear == 'column' else 0.0

    cent = jax.jit(lambda m, d, f, s: jpop._cent_marker(tracer, pj, m, d, f, s))
    sat = jax.jit(lambda m, d, f, s, k: jpop._sat_base(tracer, pj, m, d, f, s, k))
    m_cj = np.asarray(cent(mass, deltac, fenv, sj))
    m_sj = np.asarray(sat(mass, deltac, fenv, sj, keep_cent))
    m_ct = tpop._cent_marker(tracer, pt, t(mass), t(deltac), t(fenv), st).numpy()
    m_st = tpop._sat_base(tracer, pt, t(mass), t(deltac), t(fenv), st, t(keep_cent)).numpy()
    assert m_ct.dtype == np.float32 and m_st.dtype == np.float32
    npt.assert_allclose(m_ct, m_cj, rtol=MARKER_RTOL, atol=MARKER_ATOL)
    npt.assert_allclose(m_st, m_sj, rtol=MARKER_RTOL, atol=MARKER_ATOL)
    assert m_cj.max() > 0.01 and m_sj.max() > 0.01  # the markers are not all zero


@pytest.mark.parametrize('extras', ['plain', 'shear_ranks'])
def test_keep_codes_match(extras):
    """_cent_codes / _sat_codes: int8 codes equal apart from near ties
    (the count is reported), with the conformity link, and with shear
    columns and rank decorations."""
    halo, part, _ = linked_inputs(30_000, 120_000, LBOX, seed=3)
    rng = np.random.default_rng(4)
    halo['deltac'], halo['fenv'] = (rng.uniform(-0.5, 0.5, 30_000).astype(np.float32)
                                    for _ in range(2))
    part['deltac'] = halo['deltac'][part['hidx']]
    part['fenv'] = halo['fenv'][part['hidx']]
    ab = dict(Acent=0.05, Asat=-0.1, Bcent=0.03, Bsat=0.05)
    if extras == 'shear_ranks':
        halo['shear'] = rng.uniform(-0.5, 0.5, 30_000).astype(np.float32)
        part['shear'] = halo['shear'][part['hidx']]
        for k in ('ranks', 'ranksv', 'ranksp', 'ranksr'):
            part[k] = (rng.random(120_000) - 0.5).astype(np.float32)
        ab.update(Ccent=0.1, Csat=-0.1, s=0.4, s_v=-0.3, s_p=0.2, s_r=-0.1)
    tp = _tracer_params(**ab)
    hidx = part.pop('hidx')

    keep_cj = np.asarray(jax.jit(jpipe._cent_codes, static_argnums=2)(halo, tp, WANT))
    keep_sj = np.asarray(
        jax.jit(jpipe._sat_codes, static_argnums=2)(part, tp, WANT, keep_cj[hidx])
    )
    th, tpart = catalog_tensors(halo), catalog_tensors(part)
    keep_ct = tpipe._cent_codes(th, _tensors(tp), WANT)
    keep_st = tpipe._sat_codes(tpart, _tensors(tp), WANT, keep_ct[t(hidx)])
    assert keep_ct.dtype == torch.int8 and keep_st.dtype == torch.int8
    assert set(np.unique(keep_cj)) == {0, 1, 2, 3}

    # a flip must be a near tie of the random with one of the stacked markers
    levels_c = np.cumsum([
        np.asarray(jpop._cent_marker(tr, tp[tr], halo['mass'], halo['deltac'], halo['fenv'],
                                     halo.get('shear', 0.0))) * halo['multis']
        for tr in WANT
    ], axis=0)
    levels_s = []
    for tr in WANT:
        p = tp[tr]
        base = jpop._sat_base(tr, p, part['hmass'], part['deltac'], part['fenv'],
                              part.get('shear', 0.0), keep_cj[hidx]) * part['weights'] * p['ic']
        if 'ranks' in part:
            base = base * jpop._rank_multiplier(p, part)
        levels_s.append(np.asarray(base))
    levels_s = np.cumsum(levels_s, axis=0)
    flips_c = _near_ties(keep_ct.numpy(), keep_cj, halo['randoms'], levels_c)
    flips_s = _near_ties(keep_st.numpy(), keep_sj, part['randoms'], levels_s)
    print(f'keep-code flips (all near ties): centrals {flips_c}, satellites {flips_s}')


def test_prepare_tracer_params_matches():
    tracers = {k: dict(v) for k, v in TRACERS.items()}
    tracers['ELG'].update(z_pivot=0.8, logM_cut_pr=0.3, logM1_pr=-0.2, logM1_EE=12.9, Ccent=0.1)
    tracers['QSO']['edges'] = [1.0, 2.0]  # not a scalar: dropped
    for z in (0.5, 1.1):
        assert tpop.prepare_tracer_params(tracers, z) == jpop.prepare_tracer_params(tracers, z)


@pytest.mark.parametrize('mode', ['origin', 'box', 'off'])
def test_apply_rsd_matches(mode):
    """Line-of-sight RSD from an origin outside the box corner, the
    plane-parallel z with its single wrap, and no RSD; atol 1e-5, one ULP at
    |x| = 250 (XLA may fuse multiply-adds)."""
    rng = np.random.default_rng(11)
    n = 50_000
    cols = [(rng.random(n) * LBOX - LBOX / 2).astype(np.float32) for _ in range(3)]
    cols += [rng.normal(0, 300, n).astype(np.float32) for _ in range(3)]
    origin = np.float32([-260.0, -255.0, -270.0]) if mode == 'origin' else None
    inv = float(np.float32(1.0 / 97.3))
    args = (mode != 'off', inv, LBOX)
    ref = jax.jit(
        lambda *c: jpop._apply_rsd(*c, *args, None if origin is None else jnp.asarray(origin))
    )(*cols)
    got = tpop._apply_rsd(*map(t, cols), *args, None if origin is None else t(origin))
    for g, r in zip(got, ref):
        npt.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6, atol=1e-5)
    if mode == 'box':
        assert float(got[2].max()) < LBOX / 2 and float(got[2].min()) >= -LBOX / 2


# ---- linked staging, the multi-tracer step ---------------------------------


def test_linked_staging_links_host():
    """For every particle, the staged halo at hkeep_at is its host halo
    (original index hidx), and both catalogs keep their rows."""
    halo, part, _ = linked_inputs(30_000, 120_000, LBOX, seed=5)
    halo['orig'] = np.arange(30_000, dtype=np.float32)
    part['host'] = part['hidx'].astype(np.float32)
    halo_g, part_g, s_h, s_p = tpipe.group_inputs2d_linked_device(
        catalog_tensors(halo), catalog_tensors(part), NMESH, LBOX, 8
    )
    assert 'hidx' not in part_g and part_g['hkeep_at'].dtype == torch.int32
    npt.assert_array_equal(
        halo_g['orig'][part_g['hkeep_at'].long()].numpy(), part_g['host'].numpy()
    )
    for plan, n in ((s_h, 30_000), (s_p, 120_000)):
        assert int((plan.work[:, 2] - plan.work[:, 1]).sum()) == n
    npt.assert_array_equal(np.sort(halo_g['orig'].numpy()), halo['orig'])


def _jax_multi(halo, part, tp, want, Wcomp, yb=8):
    halo_g, part_g, plan_h, plan_p = jpipe.group_inputs2d_linked(
        halo, dict(part), NMESH, LBOX, yb=yb, chunk=128
    )
    binplan, _ = jpipe.make_bin_plan_arrays(NMESH, LBOX, NBINS_K)
    return jpipe.hod_pk_fused_multi(
        halo_g, part_g, tp, binplan, Wcomp, LBOX, 100.0, want, NMESH, yb, NBINS_K,
        plan_h.K, plan_p.K, rsd=True, chunk_h=128, chunk_p=128,
    )


def _port_multi(halo, part, tp, want, Wcomp, yb=8):
    halo_g, part_g, s_h, s_p = tpipe.group_inputs2d_linked_device(
        catalog_tensors(halo), catalog_tensors(part), NMESH, LBOX, yb
    )
    seg, _ = tpipe.make_bin_plan_arrays(NMESH, LBOX, NBINS_K, 'cpu')
    W = None if Wcomp is None else t(Wcomp)
    return tpipe.hod_pk_fused_multi(
        halo_g, part_g, _tensors(tp), seg, W, LBOX, 100.0, want, NMESH, yb, NBINS_K,
        s_h, s_p, rsd=True,
    )


@pytest.mark.parametrize('window', [True, False])
def test_hod_pk_fused_multi_matches_jax(window):
    """Against JAX's hod_pk_fused_multi fed by group_inputs2d_linked:
    per-tracer n_gal exact, the same pair keys in the same order, auto and
    cross spectra within the stated budget."""
    halo, part, _ = linked_inputs(30_000, 120_000, LBOX, seed=7)
    tp = _tracer_params()
    Wcomp = get_W_compensated(LBOX, NMESH, 'TSC', False).astype(np.float32) if window else None
    ref, n_ref = _jax_multi(halo, part, tp, WANT, Wcomp)
    got, n_got = _port_multi(halo, part, tp, WANT, Wcomp)
    # jit returns dicts with sorted keys; the port keeps the i-major order
    assert set(got) == set(ref)
    assert list(got) == [(a, b) for i, a in enumerate(WANT) for b in WANT[i:]]
    assert all(v.dtype == torch.float64 and v.shape == (NBINS_K,) for v in got.values())
    for tracer in WANT:
        assert float(n_got[tracer]) == float(n_ref[tracer]) > 0, tracer
    _assert_spectra(got, ref, WANT)


def test_multi_tracer_priority_and_spectra():
    """tests/test_pipeline.py::test_multi_tracer_priority_and_spectra on the
    port: every tracer populated, finite non-negative autos, finite crosses,
    and lower-priority tracers cannot change the LRG count."""
    halo, part, _ = linked_inputs(30_000, 120_000, LBOX, seed=7)
    tp = _tracer_params()
    spectra, n_gal = _port_multi(halo, part, tp, WANT, None)
    for tr in WANT:
        assert float(n_gal[tr]) > 0, tr
        assert torch.isfinite(spectra[(tr, tr)]).all()
        assert (spectra[(tr, tr)] >= 0).all()
    assert torch.isfinite(spectra[('LRG', 'ELG')]).all()
    assert torch.isfinite(spectra[('ELG', 'QSO')]).all()
    _, n_gal_l = _port_multi(halo, part, {'LRG': tp['LRG']}, ('LRG',), None)
    assert float(n_gal_l['LRG']) == float(n_gal['LRG'])


def test_elg_conformity_direction():
    """tests/test_pipeline.py::test_elg_conformity_direction on the port:
    a brighter logM1_EE (more satellites around ELG centrals) does not
    decrease the ELG count and leaves the LRG count alone."""
    halo, part, _ = linked_inputs(30_000, 120_000, LBOX, seed=11)
    tp = _tracer_params()
    want = ('LRG', 'ELG')
    _, n0 = _port_multi(halo, part, tp, want, None)
    tp2 = {k: dict(v) for k, v in tp.items()}
    tp2['ELG']['logM1_EE'] = 12.0
    _, n1 = _port_multi(halo, part, tp2, want, None)
    assert float(n1['ELG']) > float(n0['ELG'])
    assert float(n1['LRG']) == float(n0['LRG'])


# ---- the light-cone leg ----------------------------------------------------


def _lc_catalogs(n_halo, n_part, seed):
    """Flat light-cone catalogs (numpy) with 3-D velocities."""
    halo, part, _ = linked_inputs(n_halo, n_part, LBOX, seed=seed)
    rng = np.random.default_rng(seed + 2)
    for a in 'xy':
        halo[f'v{a}'] = rng.normal(0, 300, n_halo).astype(np.float32)
        halo[f'vdev{a}'] = rng.normal(0, 100, n_halo).astype(np.float32)
        part[f'v{a}'] = rng.normal(0, 300, n_part).astype(np.float32)
    for a in 'xyz':
        part[f'hvel{a}'] = halo[f'v{a}'][part['hidx']]
    return halo, part


@pytest.mark.parametrize('rsd', [True, False])
def test_populate_lc_multi_matches_jax(rsd):
    halo, part = _lc_catalogs(20_000, 80_000, seed=13)
    tp = _tracer_params()
    origin = np.float32([-260.0, -260.0, -260.0])
    inv = 1.0 / 97.3
    jhalo = dict(halo)
    jpart = dict(part, hidx=part['hidx'].astype(np.int32))
    ref, n_ref = jpipe.populate_lc_multi(jhalo, jpart, tp, WANT, rsd, inv, jnp.asarray(origin))
    got, n_got = tpipe.populate_lc_multi(
        catalog_tensors(halo), catalog_tensors(part), _tensors(tp), WANT, rsd,
        float(np.float32(inv)), t(origin),
    )
    flips = 0
    for tr in WANT:
        g, r = got[tr], [np.asarray(a) for a in ref[tr]]
        for k in (0, 1, 2, 4, 5, 6):
            npt.assert_allclose(g[k].numpy(), r[k], rtol=1e-6, atol=1e-5, err_msg=f'{tr} {k}')
        flips += int((g[3].numpy() != r[3]).sum() + (g[7].numpy() != r[7]).sum())
        assert float(n_got[tr]) == float(n_ref[tr]), tr
    assert flips == 0


def test_pk_grouped_multi_matches_jax():
    """The light-cone deposit + all-pairs binning on galaxies staged with
    shift=0 (raw coordinates, some displaced past the box edge), against
    JAX's pk_grouped_multi on its padded layout."""
    halo, part = _lc_catalogs(20_000, 80_000, seed=17)
    tp = _tracer_params()
    origin = np.float32([-260.0, -260.0, -260.0])
    got_tr, ng = tpipe.populate_lc_multi(
        catalog_tensors(halo), catalog_tensors(part), _tensors(tp), WANT, True,
        float(np.float32(0.05)), t(origin),
    )
    yb = 8
    groups_t, groups_j, Ks = {}, {}, []
    for tr in WANT:
        xc, yc, zc, wc, xs, ys, zs, ws = got_tr[tr]
        cols = [torch.cat(p) for p in ((xc, xs), (yc, ys), (zc, zs), (wc, ws))]
        staged, plan = stage_bricks(cols, NMESH, LBOX, brick_shape(NMESH, yb))
        groups_t[tr] = [(*staged, plan)]
        sj, K = jgrid.stage_grouped2d(
            [c.numpy() for c in cols], NMESH, LBOX, yb, fills=(0.0,) * 4, chunk=128, shift=0.0
        )
        groups_j[tr] = tuple(sj)
        Ks.append(int(K))
    assert float(torch.cat([g[0][0] for g in groups_t.values()]).abs().max()) > LBOX / 2
    binplan, _ = jpipe.make_bin_plan_arrays(NMESH, LBOX, NBINS_K)
    Wcomp = get_W_compensated(LBOX, NMESH, 'TSC', False).astype(np.float32)
    ng_j = {k: jnp.float32(float(v)) for k, v in ng.items()}
    ref, _ = jpipe.pk_grouped_multi(
        groups_j, ng_j, binplan, jnp.asarray(Wcomp), LBOX, NMESH, yb, NBINS_K,
        tuple(Ks), (128,) * 3, WANT,
    )
    seg, _ = tpipe.make_bin_plan_arrays(NMESH, LBOX, NBINS_K, 'cpu')
    got, _ = tpipe.pk_grouped_multi(groups_t, ng, seg, t(Wcomp), LBOX, NMESH, yb, NBINS_K, WANT)
    assert set(got) == set(ref)
    _assert_spectra(got, ref, WANT)


# ---- the all-pairs binning (K3's plain version) ----------------------------


def _meshes(n1d, nf, seed):
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(n1d,) * 3).astype(np.float32)
    # correlated fields, so cross sums do not cancel to noise
    fields = [base + 0.5 * rng.normal(size=(n1d,) * 3).astype(np.float32) for _ in range(nf)]
    return [torch.fft.rfftn(t(f)) for f in fields]


@pytest.mark.parametrize('n1d,nbins', [(32, 16), (33, 16)])
@pytest.mark.parametrize('window', [True, False])
def test_bin_pair_modes_plain_matches_segsum(n1d, nbins, window):
    """Every pair against JAX's (d_i conj(d_j)).real -> _segsum_matmul (the
    per-pair loop of hod_pk_fused_multi) and against _segsum_matmul_pairs
    without poles, at rtol 1e-5 (bf16 hi/lo contraction) for autos and
    1e-5 sqrt(P_ii P_jj) for crosses."""
    lbox, nf = 500.0, 3
    seg, _ = tpipe.make_bin_plan_arrays(n1d, lbox, nbins, 'cpu')
    dks = _meshes(n1d, nf, seed=n1d)
    W = t(get_W_compensated(lbox, n1d, 'TSC', False).astype(np.float32)) if window else None
    scale = 1.0 / n1d**3
    got = bin_pair_modes(dks, seg, W, scale, nbins)
    assert got.dtype == torch.float64 and got.shape == (nf * (nf + 1) // 2, nbins)
    assert bin_pair_modes.launches == 0  # CPU tensors: the plain version, no launch

    kzlen = n1d // 2 + 1
    dj = []
    for dk in dks:
        d = jnp.asarray(dk.numpy()) * jnp.float32(scale)
        if W is not None:
            Wj = jnp.asarray(W.numpy())
            d = d / (Wj[:, None, None] * Wj[None, :, None] * Wj[None, None, :kzlen])
        dj.append(d)
        segj = jnp.asarray(seg.numpy())
    pairs = field_pairs(nf)
    loop = {
        (i, j): np.asarray(jpow._segsum_matmul(
            (dj[i] * jnp.conj(dj[j])).real.reshape(-1), segj, nbins, kzlen, even=n1d % 2 == 0
        ))
        for i, j in pairs
    }
    fused = np.asarray(jpow._segsum_matmul_pairs(
        tuple(d.reshape(-1) for d in dj), segj, nbins, kzlen, even=n1d % 2 == 0,
        pairs=tuple(pairs),
    ))[:, 0]
    for ref in (loop, dict(zip(pairs, fused))):
        _assert_spectra({p: got[k] for k, p in enumerate(pairs)}, ref, range(nf), tol=1e-5)


def test_bin_pair_modes_one_field_is_bin_power_modes():
    seg, _ = tpipe.make_bin_plan_arrays(32, LBOX, 16, 'cpu')
    (dk,) = _meshes(32, 1, seed=3)
    got = bin_pair_modes_plain([dk], seg, None, 1 / 32**3, 16)
    npt.assert_allclose(got[0].float().numpy(), bin_power_modes_plain(dk, seg, None, 1 / 32**3, 16))


def test_pair_binning_wrapper_never_falls_back(monkeypatch):
    """Off the CPU the wrapper launches K3 or raises: bad arguments raise
    before the launch, and a missing kernel library is not caught."""
    meta = dict(device='meta')
    dks = [torch.empty((32, 32, 17), dtype=torch.complex64, **meta) for _ in range(3)]
    seg = torch.empty(32 * 32 * 17, dtype=torch.int32, **meta)
    with pytest.raises(ValueError, match='shared memory'):
        bin_pair_modes(dks, seg, None, 1.0, MAX_SMEM_BYTES // 4 // 6 + 1)
    with pytest.raises(ValueError, match='fields'):
        bin_pair_modes(dks * 3, seg, None, 1.0, 16)
    assert len(dks * 3) > MAX_FIELDS

    class NoKernel(RuntimeError):
        pass

    def no_lib():
        raise NoKernel

    monkeypatch.setattr(_build, 'lib', no_lib)
    with pytest.raises(NoKernel):
        bin_pair_modes(dks, seg, None, 1.0, 16)
    with pytest.raises(ValueError, match='one shape'):
        bin_pair_modes(dks + [torch.empty((32, 32, 16), dtype=torch.complex64, **meta)],
                       seg, None, 1.0, 16)


# ---- the two faults repaired in this slice, and the small helpers ----------


def test_bin_plan_cache_builds_once(monkeypatch):
    """A second call with the same arguments builds no plan (the device
    build, ops.power.mode_bin_plan_device, runs once): the same seg tensor
    and read-only counts come back. At most four plans are kept."""
    from abacusutils_tpu_torch.ops import power as tpow

    monkeypatch.setattr(tpow, '_BIN_PLANS', {})
    calls = []
    real = tpow.mode_bin_plan_device
    monkeypatch.setattr(tpow, 'mode_bin_plan_device', lambda *a: calls.append(a) or real(*a))
    before = tpipe.make_bin_plan_arrays.builds
    seg, counts = tpipe.make_bin_plan_arrays(24, LBOX, 12, 'cpu')
    seg2, counts2 = tpipe.make_bin_plan_arrays(24, LBOX, 12, 'cpu')
    assert seg2 is seg and not counts.flags.writeable and not counts2.flags.writeable
    npt.assert_array_equal(counts2, counts)
    assert len(calls) == 1 and tpipe.make_bin_plan_arrays.builds == before + 1
    for n in (20, 22, 26, 28, 30):
        tpipe.make_bin_plan_arrays(n, LBOX, 10, 'cpu')
    assert len(tpow._BIN_PLANS) <= 4 and len(calls) == 6


def test_stage_returns_order_and_example_link():
    rng = np.random.default_rng(1)
    x, y = (t((rng.random(5000) * LBOX).astype(np.float32)) for _ in range(2))
    (xs, ys), plan, order = stage_bricks([x, y], NMESH, LBOX, zi=1, return_order=True)
    assert order.dtype == torch.int64 and plan.work.dtype == torch.int32
    npt.assert_array_equal(xs.numpy(), x[order].numpy())
    gen = torch.Generator(device='cpu')
    gen.manual_seed(2)
    halo, part, _ = tpipe.make_example_inputs_device(1000, 4000, LBOX, gen, 'cpu', link=True)
    hidx = part['hidx']
    assert hidx.dtype == torch.int32 and int(hidx.min()) >= 0 and int(hidx.max()) < 1000
    npt.assert_array_equal(part['hmass'].numpy(), halo['mass'][hidx.long()].numpy())
