"""Port parity for the Zel'dovich control variates: ic_fields, the advection, the multi-field FFTs, the 15 P_ij and the tracer
spectra, the window engines, the ZA templates, run_zcv and apply_zcv of
abacusutils_tpu_torch against abacusutils_tpu (JAX on the CPU) on the same
inputs.

The JAX side is the synthetic fixture of tests/common.py
(make_synthetic_zcv_dir: nmesh 16, AbacusSummit_base_c000_ph006 at z 0.8),
read back with the JAX package's own reader. Both packages' ZA q-functions
run on a coarse q grid (QGRID) while the fixture is in use: the templates
are then cheap, and both sides compute the same table.

Tolerances: ic fields within 1e-5 of each
field's largest value (f32 FFTs of two libraries); advected positions
bit-equal; F-field FFTs equal to F single calls (the same plain deposit on
the CPU) and within 1e-5 of the largest mode of JAX's get_field_fft; the
advected fields within the f32 floor both packages share (see
test_field_ffts_match_advect_fields_main); P_ij and the tracer spectra of
the same fields within the budget tests/test_torch_power_surface.py holds
calc_power to (rtol 2e-4, atol 2e-4 of the array's largest value), mode
counts exact; window mode counts exact, the other sums within 1e-6 of
(2l + 1) x the bin's count, the window matrix within 1e-6; ZA templates and
run_zcv within rtol 1e-10; apply_zcv within the measured differences noted
at APPLY_RTOL.
"""

import copy
import functools
import logging
from types import SimpleNamespace

import numpy as np
import numpy.testing as npt
import pytest
import torch

from abacusutils_tpu.io.asdf_file import open_asdf
from abacusutils_tpu.models.hod.abacus_hod import AbacusHOD as JaxAbacusHOD
from abacusutils_tpu.models.zcv import apply as japply
from abacusutils_tpu.models.zcv import ic_fields as jic
from abacusutils_tpu.models.zcv import tools_cv as jtools
from abacusutils_tpu.models.zcv import tracer_power as jtp
from abacusutils_tpu.models.zcv import zenbu_native as jzn
from abacusutils_tpu.models.zcv import zenbu_window as jzw
from abacusutils_tpu.ops import power as jpow
from abacusutils_tpu_torch.convert import staged_state_from_numpy
from abacusutils_tpu_torch.models.zcv import advect_fields as tadv
from abacusutils_tpu_torch.models.zcv import cosmo as tcosmo
from abacusutils_tpu_torch.models.zcv import ic_fields as tic
from abacusutils_tpu_torch.models.zcv import tools_cv as ttools
from abacusutils_tpu_torch.models.zcv import tracer_power as ttp
from abacusutils_tpu_torch.models.zcv import zenbu_native as tzn
from abacusutils_tpu_torch.models.zcv import zenbu_window as tzw
from abacusutils_tpu_torch.models.zcv.precompute import zcv_products
from abacusutils_tpu_torch.ops import power as tpow
from common import make_synthetic_zcv_dir
from torch_helpers import TRACERS, staged_state

SIM, Z, NMESH, LBOX = 'AbacusSummit_base_c000_ph006', 0.8, 16, 2000.0
# a coarse q grid for the ZA q-functions of both packages (the default grid
# takes ~40 s to build)
QGRID = np.concatenate([np.geomspace(1e-2, 20.0, 40, endpoint=False), np.arange(20.0, 600.0, 3.0)])
PK_RTOL = 2e-4
# apply_zcv against JAX on the fixture, relative to each output's largest
# value: measured on the CPU (JAX x64 off / on) 1.3e-6 on the tracer
# spectra, 3.5e-4 on the bias, 5.2e-4 on rho_tr_ZD and 3.0e-3 on the ZD
# model spectra, which carry the port's and JAX's delta field, each at its
# own f32 floor (see _floor); held at 1e-2
APPLY_RTOL = 1e-2


def _cheap_qfuncs(cls):
    return functools.partial(cls, qgrid=QGRID, nk=768)


def make_fixture(zdir):
    """The JAX fixture on disk in `zdir` and the port's products from the
    same IC (call with both packages' ZAQFuncs on QGRID)."""
    config, _ = make_synthetic_zcv_dir(zdir, save_3D_power=False)
    with open_asdf(zdir / SIM / f'ic_filt_nmesh{NMESH}.asdf') as f:
        dens = np.asarray(f['data']['dens'])
        disp = tuple(np.asarray(f['data'][f'disp_{a}']) for a in 'xyz')
    meta = tcosmo.get_meta(SIM, redshift=Z)
    zcv = zcv_products(dens, disp, LBOX, NMESH, config, meta, filter_ic=False, engine='host',
                       device='cpu')
    return SimpleNamespace(config=config, zdir=zdir, zz=zdir / SIM / f'z{Z:.3f}', dens=dens,
                           disp=disp, meta=meta, zcv=zcv)


@pytest.fixture(scope='module')
def fix(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    for mod in (jzn, tzn):
        mp.setattr(mod, 'ZAQFuncs', _cheap_qfuncs(mod.ZAQFuncs))
        mod._QF_CACHE.clear()
    try:
        yield make_fixture(tmp_path_factory.mktemp('zcv'))
    finally:
        mp.undo()
        for mod in (jzn, tzn):
            mod._QF_CACHE.clear()


def _data(fn):
    with open_asdf(fn) as f:
        return {k: np.asarray(v) for k, v in f['data'].items()}


def _floor(lbox=LBOX, nmesh=NMESH):
    """The f32 floor of a normalized mode of the fixture's fields: both
    packages transform field - 1 in f32, and the FFT's round-off of that
    constant is about eps32 log2(N) N^(-3/2), up to 1 / min(W)^3 after
    compensation. It dominates the k = 0 mode of every field and the
    fixture's delta^2, s^2 and nabla^2 fields, whose weights are ~1e-6."""
    W = tpow.get_W_compensated(lbox, nmesh, 'TSC', True)
    return np.finfo(np.float32).eps * np.log2(nmesh) * nmesh**-1.5 / W.min() ** 3


def _assert_spectra(got, ref, what, autos, lbox=LBOX, nmesh=NMESH):
    """P arrays within rtol PK_RTOL + atol PK_RTOL max|P|, plus, for the
    (i, j) spectrum, the floor carried into it: L^3 floor (|F_i| + |F_j|)
    with |F| = sqrt(P_auto / L^3) of each side's (k, mu) auto (autos:
    {field: P_kmu auto}), times 2l + 1 for the l-th pole."""
    assert set(got) == set(ref), what
    for key, r in ref.items():
        g = np.asarray(got[key])
        if key.startswith('N_'):
            npt.assert_array_equal(g, r, err_msg=f'{what} {key}')
        elif key in ('k_binc', 'mu_binc'):
            npt.assert_allclose(g, r, rtol=1e-12, err_msg=f'{what} {key}')
        else:
            a, b = key[6:].split('_')  # P_kmu_{a}_{b} or P_ell_{a}_{b}
            amp = sum(np.sqrt(np.abs(autos[f]) / lbox**3) for f in (a, b))
            carried = lbox**3 * _floor(lbox, nmesh) * amp
            if key.startswith('P_ell'):
                carried = np.array([1, 5, 9])[:, None] * carried[None, :]
            tol = PK_RTOL * np.abs(r) + PK_RTOL * np.abs(r).max() + carried
            assert (np.abs(g - r) <= tol).all(), (
                f'{what} {key}: max |d| / tol {(np.abs(g - r) / tol).max():.3f}\n{g}\n{r}')


def _autos(pk):
    return {k[6:].split('_')[0]: np.asarray(v) for k, v in pk.items()
            if k.startswith('P_kmu_') and len(set(k[6:].split('_'))) == 1}


@pytest.mark.parametrize('nmesh,lbox', [(24, 500.0), (16, 2000.0)])
def test_get_fields_matches_jax(nmesh, lbox):
    dens = np.random.default_rng(nmesh).normal(0, 1, (nmesh,) * 3).astype(np.float32)
    ref = jic.get_fields(dens, lbox, nmesh)
    got = tic.get_fields(dens, lbox, nmesh, device='cpu')
    for name, g, r in zip(('delta', 'delta2', 's2', 'n2'), got, ref):
        assert g.dtype == torch.float32 and g.shape == (nmesh,) * 3
        npt.assert_allclose(g.numpy(), r, rtol=0, atol=1e-5 * np.abs(r).max(), err_msg=name)
    kcut = 0.3
    npt.assert_allclose(tic.gaussian_filter(dens, nmesh, lbox, kcut, 'cpu').numpy(),
                        jic.gaussian_filter(dens, nmesh, lbox, kcut), rtol=0, atol=1e-5)
    dk = np.fft.rfftn(dens).astype(np.complex64)
    r = np.asarray(jic.get_n2_fft(dk, nmesh, lbox))
    npt.assert_allclose(tic.get_n2_fft(dk, nmesh, lbox, 'cpu').numpy(), r, rtol=1e-6,
                        atol=1e-6 * np.abs(r).max())
    for i, j in ((0, 0), (1, 2)):
        r = np.asarray(jic.get_sij_fft(i, j, dk, nmesh, lbox))
        npt.assert_allclose(tic.get_sij_fft(i, j, dk, nmesh, lbox, 'cpu').numpy(), r,
                            rtol=1e-6, atol=1e-6 * np.abs(r).max())
    r = np.asarray(jic.filter_field(dk, nmesh, lbox, kcut))
    npt.assert_allclose(tic.filter_field(dk, nmesh, lbox, kcut, 'cpu').numpy(), r, rtol=1e-6,
                        atol=1e-6 * np.abs(r).max())


# ---------------------------------------------------------------------------
# advection and the field FFTs
# ---------------------------------------------------------------------------


def _advect_numpy(disp, Lbox, nmesh, D, f_growth):
    """advect_fields.py:97-109 as it stands there."""
    disp_pos = np.zeros((nmesh**3, 3), np.float32)
    disp_pos[:, 0] = disp[0].flatten() * D
    disp_pos[:, 1] = disp[1].flatten() * D
    disp_pos[:, 2] = disp[2].flatten() * D * (1 + f_growth)
    grid = np.arange(nmesh, dtype=np.float32) / nmesh
    gx, gy, gz = np.meshgrid(grid, grid, grid, indexing='ij')
    disp_pos[:, 0] += gx.flatten()
    disp_pos[:, 1] += gy.flatten()
    disp_pos[:, 2] += gz.flatten()
    disp_pos *= Lbox
    disp_pos %= Lbox
    return disp_pos


@pytest.mark.parametrize('rsd', [True, False])
def test_advected_positions_bit_equal(rsd):
    nmesh = 16
    rng = np.random.default_rng(5)
    # displacements of up to a few cells, so the lattice wraps both ways
    disp = tuple(rng.normal(0, 0.05, (nmesh,) * 3).astype(np.float32) for _ in range(3))
    D, f = tcosmo.growth_factors(SIM, Z, want_rsd=rsd)
    ref = _advect_numpy(disp, LBOX, nmesh, D, f)
    got = tadv.advected_positions(disp, LBOX, nmesh, D, f, device='cpu')
    npt.assert_array_equal(np.stack([c.numpy() for c in got], 1), ref)
    assert (ref < 0.01 * LBOX).any() and (ref > 0.99 * LBOX).any()


def test_field_ffts_equal_single_calls():
    n, nmesh, lbox = 4000, 16, 300.0
    rng = np.random.default_rng(8)
    pos = (rng.random((n, 3)) * lbox).astype(np.float32)
    ws = [None] + [rng.normal(size=n).astype(np.float32) for _ in range(4)]
    for compensated, interlaced in ((True, True), (False, False)):
        W = tpow.get_W_compensated(lbox, nmesh, 'TSC', interlaced)
        got = tpow.get_field_ffts(pos, lbox, nmesh, 'TSC', ws, W if compensated else None,
                                  compensated, interlaced, device='cpu')
        for w, g in zip(ws, got):
            one = tpow.get_field_fft(pos, lbox, nmesh, 'TSC', w, W, compensated, interlaced,
                                     device='cpu')
            npt.assert_array_equal(g.numpy(), one.numpy())
            ref = np.asarray(jpow.get_field_fft(pos, lbox, nmesh, 'TSC', w, W, compensated,
                                                interlaced))
            npt.assert_allclose(g.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    with pytest.raises(NotImplementedError):
        tpow.get_field_ffts(pos, lbox, nmesh, 'CIC', ws, None, False, False, device='cpu')


@pytest.mark.parametrize('rsd', [True, False])
def test_advected_fields_and_power_ij_match_jax_chain(rsd):
    """advected_field_ffts and power_ij on fields far above the f32 floor
    (an IC of delta ~ 0.3 in a (250 Mpc/h)^3 box, so delta^2, s^2 and
    nabla^2 delta weigh 1e-2 to 1e-1) against the JAX chain of
    advect_fields.main: JAX's get_fields, the numpy advection, one
    get_field_fft a field and calc_pk_pairs_from_deltak scaled by the
    growth. Every field and every P_ij is compared: the fields within 1e-5
    of each field's largest mode above k = 0 plus the f32 floor (_floor,
    about 1e-5 of those modes here), the spectra as
    _assert_spectra holds the fixture's (calc_power's budget plus the
    f32 floor of 1cb's k = 0 mode carried into the first bin), mode counts
    exact."""
    nmesh, lbox = 16, 250.0
    rng = np.random.default_rng(21)
    dens = rng.normal(0, 0.3, (nmesh,) * 3).astype(np.float32)
    D, f = tcosmo.growth_factors(SIM, Z, want_rsd=rsd)
    # displacements of about half a cell once scaled by D
    disp = tuple(rng.normal(0, 0.5 / (nmesh * D), (nmesh,) * 3).astype(np.float32)
                 for _ in range(3))
    pp = {'nbins_k': nmesh // 2, 'nbins_mu': 1, 'poles': [0, 2, 4],
          'k_hMpc_max': np.pi * nmesh / lbox, 'logk': False, 'paste': 'TSC',
          'compensated': True, 'interlaced': True}

    jfields = [np.asarray(a).ravel() for a in jic.get_fields(dens, lbox, nmesh)]
    assert min(np.abs(w).max() for w in jfields) > 1e-2
    pos = _advect_numpy(disp, lbox, nmesh, D, f)
    W = jpow.get_W_compensated(lbox, nmesh, 'TSC', True)
    ref = {kn: np.asarray(jpow.get_field_fft(pos, lbox, nmesh, 'TSC', w, W, True, True))
           for kn, w in zip(ttools.ZCV_FIELDS, [None] + jfields)}
    got = tadv.advected_field_ffts(disp, tic.get_fields(dens, lbox, nmesh, device='cpu'),
                                   lbox, nmesh, D, f, pp, device='cpu')
    assert list(got) == list(ttools.ZCV_FIELDS)
    for kn, r in ref.items():
        # every weighted field's k = 0 mode is -1: the scale is the others'
        npt.assert_allclose(got[kn].numpy(), r, rtol=0, err_msg=kn,
                            atol=1e-5 * np.abs(r.reshape(-1)[1:]).max() + _floor(lbox, nmesh))

    k_edges, mu_edges = jpow.get_k_mu_edges(lbox, pp['k_hMpc_max'], pp['nbins_k'],
                                            pp['nbins_mu'], pp['logk'])
    res = jpow.calc_pk_pairs_from_deltak(list(ref.values()), lbox, k_edges, mu_edges,
                                         poles=np.asarray(pp['poles']))
    growth = [1, D, D**2, D**2, D]  # advect_fields.py main's field_D
    want = {'k_binc': (k_edges[1:] + k_edges[:-1]) * 0.5,
            'mu_binc': (mu_edges[1:] + mu_edges[:-1]) * 0.5}
    for (i, j), P in res.items():
        kn = f'{ttools.ZCV_FIELDS[i]}_{ttools.ZCV_FIELDS[j]}'
        want[f'P_kmu_{kn}'] = np.asarray(P['power']) * growth[i] * growth[j]
        want[f'N_kmu_{kn}'] = np.asarray(P['N_mode'])
        want[f'P_ell_{kn}'] = np.asarray(P['binned_poles']) * growth[i] * growth[j]
        want[f'N_ell_{kn}'] = np.asarray(P['N_mode_poles'])
    _assert_spectra(tadv.power_ij(got, lbox, pp, D), want, f'P_ij rsd={rsd}', _autos(want),
                    lbox, nmesh)

def _jax_field_ffts(fix, rsd):
    """The advected field FFTs advect_fields.main wrote, as tensors."""
    out = {}
    for kn in ttools.ZCV_FIELDS:
        d = _data(fix.zz / f'advected_{kn}_field{"_rsd" if rsd else ""}_fft_nmesh{NMESH}.asdf')
        out[kn] = torch.from_numpy((d[f'{kn}_Re'] + 1j * d[f'{kn}_Im']).astype(np.complex64))
    return out


def test_field_ffts_match_advect_fields_main(fix):
    """The port's five advected fields against advect_fields.main's, mode
    by mode, within FLOOR: both packages transform the f32 field - 1, whose
    constant leaves an FFT round-off of about eps32 log2(N) N^(-3/2) a
    normalized mode (up to 1 / min(W)^3 after compensation). The fixture's
    delta^2, s^2 and nabla^2 weights (~1e-6) put those fields at that
    floor; 1cb and delta lie far above it."""
    W = tpow.get_W_compensated(LBOX, NMESH, 'TSC', True)
    floor = np.finfo(np.float32).eps * np.log2(NMESH) * NMESH**-1.5 / W.min() ** 3
    for rsd in (True, False):
        ref = _jax_field_ffts(fix, rsd)
        assert list(fix.zcv.field_ffts[rsd]) == list(ref)
        for kn, r in ref.items():
            g = fix.zcv.field_ffts[rsd][kn]
            assert g.dtype == torch.complex64 and g.shape == r.shape
            npt.assert_allclose(g.numpy(), r.numpy(), rtol=0, atol=floor, err_msg=kn)
    # 1cb lies 1e4 x above the floor: there the fields agree as K1 deposits do
    for rsd in (True, False):
        r = _jax_field_ffts(fix, rsd)['1cb'].numpy()
        npt.assert_allclose(fix.zcv.field_ffts[rsd]['1cb'].numpy(), r, rtol=0,
                            atol=1e-5 * np.abs(r).max())


def test_power_ij_matches_advect_fields_main(fix):
    """power_ij on the fields advect_fields.main wrote against the P_ij it
    wrote; the port's own P_ij have the same keys, shapes and mode counts."""
    D, _ = tcosmo.growth_factors(SIM, Z)
    for rsd, rsd_str in ((True, '_rsd'), (False, '')):
        ref = _data(fix.zz / f'power{rsd_str}_ij_nmesh{NMESH}.asdf')
        _assert_spectra(tadv.power_ij(_jax_field_ffts(fix, rsd), LBOX, fix.config['power_params'],
                                      D), ref, f'P_ij{rsd_str}', _autos(ref))
        own = fix.zcv.pk_ij[rsd]
        assert set(own) == set(ref)
        for key, r in ref.items():
            assert np.shape(own[key]) == np.shape(r), key
            if key.startswith('N_'):
                npt.assert_array_equal(own[key], r)


def _tracer(seed, n=6000):
    return (np.random.default_rng(seed).random((n, 3)) * LBOX - LBOX / 2).astype(np.float32)


def test_tracer_power_matches_jax(fix):
    pos = _tracer(3)
    for rsd, rsd_str in ((True, '_rsd'), (False, '')):
        ref = jtp.get_tracer_power(pos, rsd, fix.config, want_save=False)
        got = ttp.get_tracer_power(pos, rsd, fix.config, _jax_field_ffts(fix, rsd), fix.meta,
                                   device='cpu')
        autos = _autos(_data(fix.zz / f'power{rsd_str}_ij_nmesh{NMESH}.asdf'))
        autos['tr'] = ref['P_kmu_tr_tr']
        _assert_spectra(got, ref, f'tracer rsd={rsd}', autos)
        own = ttp.get_tracer_power(pos, rsd, fix.config, fix.zcv.field_ffts[rsd], fix.meta,
                                   device='cpu')
        for key in ('P_kmu_tr_tr', 'P_ell_tr_tr', 'P_kmu_1cb_tr', 'P_ell_1cb_tr'):
            npt.assert_allclose(own[key], ref[key], rtol=PK_RTOL,
                                atol=PK_RTOL * np.abs(ref[key]).max(), err_msg=key)


# ---------------------------------------------------------------------------
# the window and the templates
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('nmesh', [32, 31])  # the Nyquist plane exists only when even
@pytest.mark.parametrize('log', [False, True])
def test_window_engines_match_jax_host(nmesh, log):
    lbox = 250.0
    kout = (np.concatenate([[0.0], np.geomspace(2 * np.pi / lbox, np.pi * nmesh / lbox, 16)])
            if log else np.linspace(0, np.pi * nmesh / lbox, nmesh // 2 + 1))
    S0, n0, k0 = jzw._window_mode_sums_host(nmesh, lbox, kout)
    pref = np.array([1, 5, 9])[:, None, None]
    for engine, (S, n, k) in (
        ('host', tzw._window_mode_sums_host(nmesh, lbox, kout)),
        ('device', tzw._window_mode_sums_device(nmesh, lbox, kout, 'cpu')),
    ):
        npt.assert_array_equal(n, n0, err_msg=engine)
        assert (np.abs(S - S0) <= 1e-6 * pref * n0[None, None, :]).all(), engine
        npt.assert_allclose(k, k0, rtol=1e-6, err_msg=engine)
    kin = np.linspace(1e-3, np.pi * nmesh / lbox, 200)
    wh, kh = jzw.periodic_window_function(nmesh, lbox, kout, kin, engine='host')
    for engine in ('host', 'device'):
        w, k = tzw.periodic_window_function(nmesh, lbox, kout, kin, engine=engine, device='cpu')
        npt.assert_allclose(w, wh, atol=1e-6, err_msg=engine)
        npt.assert_allclose(k, kh, rtol=1e-6, err_msg=engine)


def test_window_plain_counts_every_mode_once():
    """The counts row of the plain K8 version sums to the mesh's modes in
    bins, each kz > 0 mode twice (the Nyquist plane included)."""
    nmesh, lbox = 12, 100.0
    kv, kz = (torch.from_numpy(a) for a in tzw._mode_kgrids(nmesh, lbox))
    edges = torch.tensor([0.0, 1e9], dtype=torch.float32)
    out = tzw.window_mode_sums_plain(kv, kz, edges, 1)
    assert out.shape == (7, 1) and out.dtype == torch.float64
    assert out[0, 0].item() == nmesh * nmesh * (1 + 2 * (nmesh // 2))


def test_templates_and_window_match_zenbu_window_main(fix):
    win = np.load(fix.zdir / SIM / f'window_nmesh{NMESH}.npz')
    npt.assert_allclose(fix.zcv.window, win['window'], atol=1e-6)
    npt.assert_allclose(fix.zcv.keff, win['keff'], rtol=1e-6)
    for rsd, rsd_str in ((True, '_rsd'), (False, '')):
        tpl = np.load(fix.zz / f'zenbu_pk{rsd_str}_ij_lpt_nmesh{NMESH}.npz')
        npt.assert_allclose(fix.zcv.templates[rsd], tpl['pk_ij_zenbu'], rtol=1e-10, atol=0)
        npt.assert_array_equal(fix.zcv.k_binc, tpl['k_binc'])


def test_templates_in_processes_report_a_failure(monkeypatch):
    """When k is split over processes, a process that fails raises its
    error here and every process is stopped (the simulation is checked
    before the q-functions are built, so this is cheap)."""
    monkeypatch.setattr(tzw, '_K_PER_PROCESS', 1)
    monkeypatch.setattr(tzw.os, 'sched_getaffinity', lambda pid: {0, 1})
    started = []
    popen = tzw.subprocess.Popen

    def spy(*a, **k):
        started.append(popen(*a, **k))
        return started[-1]

    monkeypatch.setattr(tzw.subprocess, 'Popen', spy)
    cfg = {'sim_name': 'AbacusSummit_base_c001_ph000', 'surrogate_gaussian_cutoff': 0.2}
    kth = np.geomspace(1e-3, 1.0, 50)
    with pytest.raises(RuntimeError, match='is not in metadata files'):
        tzw._templates(np.array([0.01, 0.02]), Z, cfg, kth, kth**-1, [True], {})
    assert len(started) == 2 and all(p.poll() is not None for p in started)

def test_zenbu_native_matches_jax(fix):
    """The numpy copy against the JAX package's on the same tables, in real
    and redshift space; k split into runs gives the same bits."""
    meta = fix.meta
    kth = meta['CLASS_power_spectrum']['k (h/Mpc)']
    pth = meta['CLASS_power_spectrum']['P (Mpc/h)^3'] * 1e-3
    k = np.linspace(0.002, 0.03, 6)
    for f in (0.0, 0.8):
        ref = jzn.za_basis_spectra(k, kth, pth, f=f, cutoff=0.2)
        got = tzn.za_basis_spectra(k, kth, pth, f=f, cutoff=0.2)
        npt.assert_allclose(got, ref, rtol=1e-10, atol=0)
        parts = [tzn.za_basis_spectra(c, kth, pth, f=f, cutoff=0.2)
                 for c in np.array_split(k, 3)]
        npt.assert_array_equal(np.concatenate(parts, axis=-1), got)
    cfg = {'sim_name': SIM, 'surrogate_gaussian_cutoff': 0.2, 'z_ic': 99.0}
    ref, _ = jzw.zenbu_spectra(k, Z, cfg, kth, pth, rsd=False)
    got, _ = tzw.zenbu_spectra(k, Z, cfg, kth, pth, rsd=False)
    npt.assert_allclose(got, ref, rtol=1e-10, atol=0)


# ---------------------------------------------------------------------------
# run_zcv and apply_zcv
# ---------------------------------------------------------------------------


def _zcv_dicts(fix, config, pos):
    rsd = config['HOD_params']['want_rsd']
    tr = {r: jtp.get_tracer_power(pos, r, config, want_save=False) for r in {rsd, False}}
    rsd_str = '_rsd' if rsd else ''
    ij = {r: _data(fix.zz / f'power{s}_ij_nmesh{NMESH}.asdf') for r, s in
          {(rsd, rsd_str), (False, '')}}
    return tr[rsd], ij[rsd], (tr[False] if rsd else None), (ij[False] if rsd else None)


def _assert_zcv(got, ref, rtol):
    assert set(got) == set(ref)
    for key, r in ref.items():
        g, r = np.asarray(got[key]), np.asarray(r)
        npt.assert_allclose(g, r, rtol=rtol, atol=rtol * np.abs(r).max() if r.size else 0,
                            err_msg=key)


@pytest.mark.parametrize('want_rsd', [True, False])
def test_run_zcv_matches_jax(fix, want_rsd):
    config = copy.deepcopy(fix.config)
    config['HOD_params']['want_rsd'] = want_rsd
    dicts = _zcv_dicts(fix, config, _tracer(4))
    ref = jtools.run_zcv(*dicts, config)
    rsd_str = '_rsd' if want_rsd else ''
    win = np.load(fix.zdir / SIM / f'window_nmesh{NMESH}.npz')
    tpl = np.load(fix.zz / f'zenbu_pk{rsd_str}_ij_lpt_nmesh{NMESH}.npz')
    got = ttools.run_zcv(*dicts, config, window=win['window'], keff=win['keff'],
                         pk_ij_zenbu=tpl['pk_ij_zenbu'])
    _assert_zcv(got, ref, 1e-10)
    # without the arrays, run_zcv reads the same npz files
    _assert_zcv(ttools.run_zcv(*dicts, config), ref, 1e-10)


def _balls(config):
    """(JAX AbacusHOD, port AbacusHOD) on one synthetic staged state in the
    fixture's (2000 Mpc/h)^3 box (test_torch_run_hod.py's construction)."""
    halo, part = staged_state(20_000, 60_000, LBOX, seed=61)
    tracers = {t: dict(TRACERS[t]) for t in ('LRG', 'ELG')}
    params = {'z': Z, 'Lbox': LBOX, 'velz2kms': 100.0, 'origin': None, 'chunk': -1}
    flags = dict(want_ranks=False, want_shear=False, want_expvel=False, halo_lc=False,
                 z_type='primary')
    jball = object.__new__(JaxAbacusHOD)
    hmass = halo['hmass']
    jball.__dict__.update(
        halo_data=dict(halo), particle_data=dict(part), params=params, tracers=tracers,
        lbox=LBOX, z_mock=Z, want_AB=True, logger=logging.getLogger('AbacusHOD'),
        _fused_stage=None, mock_dir='.',
        logMbins=np.linspace(np.log10(hmass.min()), np.log10(hmass.max()), 101),
        deltacbins=np.linspace(-0.5, 0.5, 101), fenvbins=np.linspace(-0.5, 0.5, 101),
        shearbins=np.linspace(-0.5, 0.5, 101), **flags,
    )
    return jball, staged_state_from_numpy(halo, part, params, tracers, flags, 'cpu')


def test_apply_zcv_matches_jax(fix, tmp_path):
    """The slice: AbacusHOD.apply_zcv of both packages on one RSD mock of two
    tracers, each re-populating its real-space counterpart with its own
    run_hod, the JAX side reading the fixture's files and the port the
    in-memory products."""
    config = copy.deepcopy(fix.config)
    config['zcv_params']['tracer_dir'] = str(tmp_path)
    config['zcv_params']['fields'] = ['1cb', 'delta']  # a unique fit minimum
    jball, tball = _balls(config)
    mock = jball.run_hod(jball.tracers, want_rsd=True, write_to_disk=False)
    assert all(len(mock[t]['x']) > 100 for t in mock)
    ref = japply.apply_zcv(jball, copy.deepcopy(mock), copy.deepcopy(config))
    zcv = copy.copy(fix.zcv)
    zcv.tracer_spectra = {}
    got = tball.apply_zcv(copy.deepcopy(mock), copy.deepcopy(config), zcv)
    assert set(got) == set(ref) == {'LRG', 'ELG'}
    for t in ref:
        _assert_zcv(got[t], ref[t], APPLY_RTOL)
        assert np.isfinite(got[t]['Pk_tr_tr_ell_zcv']).all()
    # the tracer spectra are kept: load_presaved reads them back
    again = tball.apply_zcv(copy.deepcopy(mock), copy.deepcopy(config), zcv, load_presaved=True)
    for t in got:
        _assert_zcv(again[t], got[t], 0.0)
    zcv.tracer_spectra = {}
    with pytest.raises(KeyError, match='load_presaved'):
        tball.apply_zcv(copy.deepcopy(mock), copy.deepcopy(config), zcv, load_presaved=True)


def test_zcv_kernel_wrappers_never_fall_back(monkeypatch):
    """Off the CPU, K1's multi-weight wrapper and K8's launch or raise: a
    missing kernel library is not replaced by the plain versions, and
    shapes and column counts the kernels do not take are refused."""
    from abacusutils_tpu_torch import _build
    from abacusutils_tpu_torch.ops.grid import CellPlan, tsc_deposit_cells_multi

    class NoKernel(RuntimeError):
        pass

    def no_lib():
        raise NoKernel

    meta = dict(device='meta')
    nmesh, n = 32, 100
    # one weight column; 4 x 4 x 1 bricks of 8 x 8 x 32 cells
    plan = CellPlan(torch.empty((n, 4), **meta), torch.empty(32**3 + 1, dtype=torch.int32, **meta),
                    nmesh, 1)
    grids = torch.empty((2,) + (nmesh,) * 3, **meta)
    with pytest.raises(ValueError, match='grids must be'):
        tsc_deposit_cells_multi(torch.empty((3,) + (nmesh,) * 3, **meta), plan)
    with pytest.raises(ValueError, match='plan.points must be'):
        tsc_deposit_cells_multi(grids, plan._replace(points=torch.empty((n, 8), **meta)))
    with pytest.raises(ValueError, match='plan.starts must be'):
        tsc_deposit_cells_multi(grids, plan._replace(starts=plan.starts[1:]))
    kv = torch.empty(nmesh, **meta)
    kz = torch.empty(nmesh // 2 + 1, **meta)
    with pytest.raises(ValueError, match='edges must be'):
        tzw.window_plan(kv, kz, torch.empty(5, **meta), 8)
    # a plan of tensors off the CPU (its fields' values do not matter here)
    t = torch.empty(9, **meta)
    wplan = tzw.WindowPlan(kv, kz, t, t, kz, kv, kv.double(), kv.int(), kv.int(), t.double(),
                           t[:8].int(), 8, 1)
    monkeypatch.setattr(_build, 'lib', no_lib)
    with pytest.raises(NoKernel):
        tsc_deposit_cells_multi(grids, plan)
    with pytest.raises(NoKernel):
        tzw.window_mode_sums(wplan)
