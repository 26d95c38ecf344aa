"""Port parity for the field-level ZCV and the LCV flows: linear_fields and
lcv_products, get_recon_power, run_lcv, run_lcv_field, run_zcv_field and
AbacusHOD.apply_zcv_xi of abacusutils_tpu_torch against abacusutils_tpu
(JAX on the CPU) on the same inputs.

ZCV: the synthetic fixture of tests/common.py (make_synthetic_zcv_dir:
nmesh 16, AbacusSummit_base_c000_ph006 at z 0.8, with the 3-D cubes), its
ZA templates on a coarse q grid (QGRID of tests/test_torch_zcv.py). The
port runs on the advected fields, window and templates the JAX chain wrote
(read back with the JAX package's reader), so the two sides differ only in
the flows under test; fields 1cb and delta, as
tests/test_zcv.py:test_zcv_field_vs_k_level uses them, for a unique fit
minimum. LCV: tests/test_zcv.py's LCV setup (nmesh 8, a Gaussian IC of
sigma 0.05 in the 2000 Mpc/h box, CIC, compensated and interlaced), and the
same at nmesh 64 with 20,000 tracers drawn on the IC, where kR of reciso's
smoothing (R 10 Mpc/h) reaches 1 at the Nyquist k.

Tolerances, each no looser than test_zcv_field_vs_k_level's and
test_lcv_field_vs_k_level's for the same quantity: the spectra and poles
of the two packages within rtol 2e-4 + atol 2e-4 of the array's largest
value (calc_power's budget, tests/test_torch_power_surface.py), the linear
fields' 3-D forms within 1e-5 of the cube's largest value (f32 FFTs of two
libraries), mode counts exact; run_lcv on the same input dicts within rtol
1e-10 (the same host numpy); the field flows (FIELD_RTOL): bias rtol 1e-4;
the measured and the reduced poles within rtol 2e-4, the model, cross and
template poles within rtol 2e-3, each plus 1e-4 of the array's largest
value (test_zcv_field_vs_k_level's pairs: the k = 0 bin holds the product
of two f32 round-off modes, up to 1.5e-3 apart between the packages);
rho within 1e-4; xi_ell within rtol 2e-4 + 1e-4 of the largest value; the
reduced cube within 1e-4 of its largest value. The field flow against the
k-level flow: test_lcv_field_vs_k_level's tolerances (bias rtol 1e-3; the
measured poles rtol 2e-4, the model and cross poles 2e-3, each + 1e-4 of
the largest value; rho 5e-3 + 1e-3). Its reduced poles are held to the JAX
package's field flow only: with beta in play (21 bins or more) the two
flows' reduced poles leave test_lcv_field_vs_k_level's band at low k in
the JAX package too (tests/lcv_flows_readings.py). Under reciso the two
flows differ by design, in the JAX package too: the field flow smooths
each mode at its own |k|, the k-level flow at its bin's centre. So
reciso's field flow is held to its k-level flow with the smoothing taken
at the bin centres (testing.smoothing_at_bin_centres), and its gap to the
k-level flow, with each mode smoothed at its own |k|, to the JAX
package's gap within 2e-3 of the k-level value plus 1e-4 of its largest
value.
"""

import copy
import functools

import numpy as np
import numpy.testing as npt
import pytest
import torch

from abacusutils_tpu.io.asdf_file import open_asdf
from abacusutils_tpu.models.zcv import apply as japply
from abacusutils_tpu.models.zcv import linear_fields as jlin
from abacusutils_tpu.models.zcv import tools_cv as jtools
from abacusutils_tpu.models.zcv import tracer_power as jtp
from abacusutils_tpu.models.zcv import zenbu_native as jzn
from abacusutils_tpu.models.zcv.ic_fields import compress_asdf
from abacusutils_tpu.models.zcv.zenbu_window import periodic_window_function
from abacusutils_tpu.ops.power import get_k_mu_edges
from abacusutils_tpu_torch.convert import staged_state_from_numpy
from abacusutils_tpu_torch.models.zcv import cosmo as tcosmo
from abacusutils_tpu_torch.models.zcv import tools_cv as ttools
from abacusutils_tpu_torch.models.zcv import tracer_power as ttp
from abacusutils_tpu_torch.models.zcv.precompute import ZCVProducts, lcv_products
from abacusutils_tpu_torch.testing import smoothing_at_bin_centres
from common import make_synthetic_zcv_dir
from torch_helpers import TRACERS, staged_state

SIM, Z, NMESH, LBOX = 'AbacusSummit_base_c000_ph006', 0.8, 16, 2000.0
LCV_NMESH = 8
LCV_NMESH_WIDE = 64  # kR = 1 at the Nyquist k for R = 10 Mpc/h
QGRID = np.concatenate([np.geomspace(1e-2, 20.0, 40, endpoint=False), np.arange(20.0, 600.0, 3.0)])
PK_RTOL = 2e-4
# rtol of each field-flow pole stack against JAX, beside an atol of 1e-4 of
# its largest value (test_zcv_field_vs_k_level's pairs)
FIELD_RTOL = {'Pk_tr_tr_ell': 2e-4, 'Pk_tr_tr_ell_zcv': 2e-4, 'Pk_tr_tr_ell_lcv': 2e-4}


def _data(fn):
    with open_asdf(fn) as f:
        return {k: np.asarray(v) for k, v in f['data'].items()}


def _zcv_side(zdir):
    """The JAX ZCV chain on disk and the port's ZCVProducts of its files."""
    config, _ = make_synthetic_zcv_dir(zdir)
    config['zcv_params']['fields'] = ['1cb', 'delta']  # a unique fit minimum
    zz = zdir / SIM / f'z{Z:.3f}'
    field_ffts = {}
    for rsd in (True, False):
        field_ffts[rsd] = {}
        for kn in jtools.ZCV_FIELDS:
            d = _data(zz / f'advected_{kn}_field{"_rsd" if rsd else ""}_fft_nmesh{NMESH}.asdf')
            field_ffts[rsd][kn] = torch.from_numpy(
                (d[f'{kn}_Re'] + 1j * d[f'{kn}_Im']).astype(np.complex64))
    win = np.load(zdir / SIM / f'window_nmesh{NMESH}.npz')
    templates = {rsd: np.load(zz / f'zenbu_pk{s}_ij_lpt_nmesh{NMESH}.npz')['pk_ij_zenbu']
                 for rsd, s in ((True, '_rsd'), (False, ''))}
    k_bins, _ = get_k_mu_edges(LBOX, np.pi * NMESH / LBOX, NMESH // 2, 1, False)
    zcv = ZCVProducts(field_ffts, {}, win['window'], win['keff'], 0.5 * (k_bins[1:] + k_bins[:-1]),
                      config['zcv_params']['kcut'], templates, tcosmo.get_meta(SIM, redshift=Z))

    # tracers drawn with weight 1 + 0.7 delta / sigma on the IC cells
    # (test_zcv_field_vs_k_level's sample)
    rng = np.random.default_rng(77)
    with open_asdf(zdir / SIM / f'ic_filt_nmesh{NMESH}.asdf') as f:
        dens = np.asarray(f['data']['dens'])
    w = np.clip(1.0 + 0.7 * dens / dens.std(), 0.05, None).ravel()
    cells = rng.choice(w.size, size=6000, p=w / w.sum())
    ix, iy, iz = np.unravel_index(cells, (NMESH,) * 3)
    pos = ((np.stack([ix, iy, iz], axis=1) + rng.random((6000, 3))) * (LBOX / NMESH)
           - LBOX / 2).astype(np.float32)
    return config, zz, zcv, pos


def _lcv_side(ldir, nmesh=LCV_NMESH, n_drawn=0):
    """tests/test_zcv.py's LCV setup at `nmesh`, the JAX linear fields
    (binned and 3-D) and the window file, and the port's LCVProducts of the
    same IC. The tracer: 500 uniform points, or with n_drawn, that many
    drawn with weight 1 + 0.7 delta / sigma on the IC cells."""
    kcut = 0.2261946710584651
    rng = np.random.default_rng(7)
    dens = rng.normal(0, 0.05, (nmesh,) * 3).astype(np.float32)
    (ldir / SIM).mkdir(parents=True)
    compress_asdf(str(ldir / SIM / f'ic_filt_nmesh{nmesh}.asdf'), {'dens': dens},
                  {'sim_name': SIM, 'Lbox': LBOX, 'nmesh': nmesh, 'kcut': kcut})
    config = {
        'sim_params': {'sim_name': SIM, 'z_mock': Z},
        'HOD_params': {'want_rsd': True, 'rec_algo': 'recsym', 'smoothing': 10.0},
        'lcv_params': {'lcv_dir': str(ldir), 'ic_dir': str(ldir), 'nmesh': nmesh,
                       'kcut': kcut},
        'power_params': {
            'nbins_k': nmesh // 2, 'nbins_mu': 1, 'poles': [0, 2, 4],
            'k_hMpc_max': np.pi * nmesh / LBOX, 'paste': 'CIC', 'compensated': True,
            'interlaced': True, 'logk': False, 'nmesh': nmesh,
        },
    }
    import yaml

    cfg_fn = ldir / 'cfg.yaml'
    yaml.safe_dump(config, open(cfg_fn, 'w'))
    pk_lin = jlin.main(str(cfg_fn))
    lin_fns = jlin.main(str(cfg_fn), save_3D_power=True)
    kout, _ = get_k_mu_edges(LBOX, config['power_params']['k_hMpc_max'], nmesh // 2, 1, False)
    window, keff = periodic_window_function(nmesh, LBOX, kout, 0.5 * (kout[1:] + kout[:-1]))
    np.savez(ldir / SIM / f'window_nmesh{nmesh}.npz', window=window, keff=keff)
    lcv = lcv_products(dens, LBOX, nmesh, config, tcosmo.get_meta(SIM, redshift=Z),
                       filter_ic=False, engine='host', device='cpu')
    if n_drawn:
        w = np.clip(1.0 + 0.7 * dens / dens.std(), 0.05, None).ravel()
        cells = rng.choice(w.size, size=n_drawn, p=w / w.sum())
        ijk = np.stack(np.unravel_index(cells, (nmesh,) * 3), axis=1)
        tracer = ((ijk + rng.random((n_drawn, 3))) * (LBOX / nmesh)).astype(np.float32)
    else:
        tracer = (rng.random((500, 3)) * LBOX).astype(np.float32)
    randoms = (np.random.default_rng(9).random((1500, 3)) * LBOX).astype(np.float32)
    return dict(config=config, dens=dens, pk_lin=pk_lin, lin_fns=lin_fns, window=window,
                keff=keff, lcv=lcv, tracer=tracer, randoms=randoms, k_bins=kout)


@pytest.fixture(scope='module')
def fix(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setattr(jzn, 'ZAQFuncs', functools.partial(jzn.ZAQFuncs, qgrid=QGRID, nk=768))
    jzn._QF_CACHE.clear()
    try:
        config, zz, zcv, pos = _zcv_side(tmp_path_factory.mktemp('zcv'))
    finally:
        mp.undo()
        jzn._QF_CACHE.clear()
    lcv = _lcv_side(tmp_path_factory.mktemp('lcv'))
    wide = _lcv_side(tmp_path_factory.mktemp('lcv_wide'), LCV_NMESH_WIDE, 20_000)
    return dict(config=config, zz=zz, zcv=zcv, pos=pos, lcv=lcv, lcv_wide=wide)


def _close(got, ref, rtol, what, atol_frac=None):
    """got within rtol |ref| + atol_frac max|ref| (atol_frac: rtol)."""
    g, r = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    atol = (rtol if atol_frac is None else atol_frac) * np.abs(r).max() if r.size else 0
    npt.assert_allclose(g, r, rtol=rtol, atol=atol, err_msg=what)


def _assert_spectra(got, ref, what):
    assert set(got) == set(ref), what
    for key, r in ref.items():
        if key.startswith('N_'):
            npt.assert_array_equal(got[key], r, err_msg=f'{what} {key}')
        else:
            _close(got[key], r, PK_RTOL, f'{what} {key}')


# ---------------------------------------------------------------------------
# LCV
# ---------------------------------------------------------------------------


def test_linear_fields_and_lcv_products_match_jax(fix):
    lcv = fix['lcv']['lcv']
    _assert_spectra(lcv.pk_lin, fix['lcv']['pk_lin'], 'pk_lin')
    names = [('delta', 'delta'), ('deltamu2', 'delta'), ('deltamu2', 'deltamu2')]
    assert len(fix['lcv']['lin_fns']) == len(names)
    for fn, (a, b) in zip(fix['lcv']['lin_fns'], names):
        ref = _data(fn)[f'P_k3D_{a}_{b}']
        got = ttools.field_cube(lcv.field_ffts[a], lcv.field_ffts[b])
        assert got.dtype == torch.float32 and got.shape == ref.shape
        npt.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max(), err_msg=fn)
    npt.assert_allclose(lcv.window, fix['lcv']['window'], atol=1e-6)
    npt.assert_allclose(lcv.keff, fix['lcv']['keff'], rtol=1e-6)
    # the device engine of the window (K8's plain version on the CPU)
    again = lcv_products(fix['lcv']['dens'], LBOX, LCV_NMESH, fix['lcv']['config'], lcv.meta,
                         filter_ic=False, engine='device', device='cpu')
    npt.assert_allclose(again.window, fix['lcv']['window'], atol=1e-6)


@pytest.mark.parametrize('with_randoms', [False, True])
def test_get_recon_power_matches_jax(fix, with_randoms):
    config = fix['lcv']['config']
    rn = fix['lcv']['randoms'] if with_randoms else None
    ref = jtp.get_recon_power(fix['lcv']['tracer'], rn, True, config, want_save=True)
    lcv = fix['lcv']['lcv']
    got = ttp.get_recon_power(fix['lcv']['tracer'], rn, True, config, lcv.field_ffts, lcv.meta,
                              device='cpu')
    _assert_spectra(got, ref, f'recon randoms={with_randoms}')
    # the 3-D forms the field-level flow reads, and the tracer field taken
    # back instead of painted (the JAX package's want_load_tr_fft)
    fns = jtp.get_recon_power(None, None, True, config, want_load_tr_fft=True,
                              save_3D_power=True)
    tr = ttp.get_recon_power(fix['lcv']['tracer'], rn, True, config, meta=lcv.meta, device='cpu',
                             save_3D_power=True)
    for fn, (a, b) in zip(fns, [(tr, tr), (lcv.field_ffts['delta'], tr),
                                (lcv.field_ffts['deltamu2'], tr)]):
        ref3 = next(iter(_data(fn).values()))
        npt.assert_allclose(ttools.field_cube(a, b).numpy(), ref3, rtol=0,
                            atol=1e-5 * np.abs(ref3).max(), err_msg=str(fn))
    again = ttp.get_recon_power(None, None, True, config, lcv.field_ffts, lcv.meta,
                                tr_field_fft=tr)
    for key in got:
        npt.assert_array_equal(again[key], got[key], err_msg=key)


def _lcv_config(fix, rec_algo):
    config = copy.deepcopy(fix['lcv']['config'])
    config['HOD_params']['rec_algo'] = rec_algo
    return config


@pytest.mark.parametrize('rec_algo', ['recsym', 'reciso'])
def test_run_lcv_matches_jax(fix, rec_algo):
    """run_lcv of both packages on the JAX spectra (the same host numpy), and
    the port's own chain (lcv_products, get_recon_power) against JAX's."""
    config = _lcv_config(fix, rec_algo)
    lcv = fix['lcv']['lcv']
    tr_ref = jtp.get_recon_power(fix['lcv']['tracer'], None, True, config, want_save=False)
    ref = jtools.run_lcv(tr_ref, fix['lcv']['pk_lin'], config)
    got = ttools.run_lcv(tr_ref, fix['lcv']['pk_lin'], config, window=lcv.window, keff=lcv.keff,
                         meta=lcv.meta)
    assert set(got) == set(ref)
    for key in ref:
        _close(got[key], ref[key], 1e-10, key)
    # without the arrays, the window npz under lcv_dir
    npt.assert_allclose(ttools.run_lcv(tr_ref, fix['lcv']['pk_lin'], config)['Pk_tr_tr_ell_lcv'],
                        ref['Pk_tr_tr_ell_lcv'], rtol=1e-10)
    tr_own = ttp.get_recon_power(fix['lcv']['tracer'], None, True, config, lcv.field_ffts,
                                 lcv.meta, device='cpu')
    own = ttools.run_lcv(tr_own, lcv.pk_lin, config, window=lcv.window, keff=lcv.keff,
                         meta=lcv.meta)
    npt.assert_allclose(own['bias'], ref['bias'], rtol=1e-4)
    for key in ('Pk_tr_tr_ell', 'Pk_lf_lf_ell', 'Pk_tr_lf_ell', 'Pk_tr_tr_ell_lcv',
                'Pk_lf_lf_ell_CLASS'):
        _close(own[key], ref[key], PK_RTOL, key)
    npt.assert_allclose(own['rho_tr_lf'], ref['rho_tr_lf'], rtol=0, atol=1e-4)


def _assert_field_flow(got, ref, rho_key, red_key):
    assert set(got) == set(ref)
    npt.assert_allclose(np.asarray(got['bias']), np.asarray(ref['bias']), rtol=1e-4)
    npt.assert_array_equal(got['Nk_tr_tr_ell'], np.asarray(ref['Nk_tr_tr_ell']).ravel())
    npt.assert_allclose(got['k_binc'], ref['k_binc'], rtol=1e-12)
    npt.assert_allclose(got[rho_key], ref[rho_key], rtol=0, atol=1e-4)
    for key in ref:
        if key.startswith('Pk_'):
            _close(got[key], ref[key], FIELD_RTOL.get(key, 2e-3), key, atol_frac=1e-4)
    assert np.isfinite(got[red_key]).all()


@pytest.mark.parametrize('rec_algo,side', [
    pytest.param('recsym', 'lcv', id='recsym'),
    pytest.param('reciso', 'lcv', id='reciso'),
    pytest.param('reciso', 'lcv_wide', id='reciso-nmesh64'),
])
def test_run_lcv_field_matches_jax(fix, rec_algo, side, monkeypatch):
    """run_lcv_field of both packages on the same IC and tracer (JAX reads
    its cubes from files, the port builds them from the Fourier fields), the
    reduced cube against the one JAX writes, and the port's field flow
    against its k-level flow at test_lcv_field_vs_k_level's tolerances, with
    reciso's smoothing taken at the bin centres; each mode smoothed at its
    own |k|, reciso's gap between the two flows is the JAX package's."""
    lf = fix[side]
    config = copy.deepcopy(lf['config'])
    config['HOD_params']['rec_algo'] = rec_algo
    nmesh = config['lcv_params']['nmesh']
    lcv = lf['lcv']
    tr_ref = jtp.get_recon_power(lf['tracer'], None, True, config, want_save=True)
    tr_fns = jtp.get_recon_power(None, None, True, config, want_load_tr_fft=True,
                                 save_3D_power=True)
    ref = jtools.run_lcv_field(tr_fns, lf['lin_fns'], config)
    tr = ttp.get_recon_power(lf['tracer'], None, True, config, meta=lcv.meta,
                             device='cpu', save_3D_power=True)
    out = {}
    got = ttools.run_lcv_field(tr, lcv.field_ffts, config, meta=lcv.meta, out=out)
    _assert_field_flow(got, ref, 'rho_tr_lf', 'Pk_tr_tr_ell_lcv')
    cube = _data(tr_fns[0].parent / f'power_rsd_LCV_tr_{rec_algo}_nmesh{nmesh}.asdf')
    cube = cube['P_k3D_tr_tr_lcv']
    assert out['P_k3D_tr_tr_lcv'].dtype == torch.float64
    npt.assert_allclose(out['P_k3D_tr_tr_lcv'].numpy(), cube, rtol=0,
                        atol=1e-4 * np.abs(cube).max())

    lk = ttools.run_lcv(ttp.get_recon_power(None, None, True, config, lcv.field_ffts, lcv.meta,
                                            tr_field_fft=tr),
                        lcv.pk_lin, config, window=lcv.window, keff=lcv.keff, meta=lcv.meta)
    if rec_algo == 'reciso':
        # the model and cross poles of the field flow leave
        # test_lcv_field_vs_k_level's band somewhere, in both packages, by
        # the same amount
        jk = jtools.run_lcv(tr_ref, lf['pk_lin'], config)
        for key in ('Pk_lf_lf_ell', 'Pk_tr_lf_ell'):
            a = np.asarray(jk[key], np.float64)
            band = 2e-3 * np.abs(a) + 1e-4 * np.abs(a).max()
            gap_jax = np.asarray(ref[key], np.float64) - a
            gap = np.asarray(got[key], np.float64) - np.asarray(lk[key], np.float64)
            assert (np.abs(gap_jax) > band).any(), key
            assert (np.abs(gap - gap_jax) <= band).all(), key
        monkeypatch.setattr(ttools, 'get_smoothing', smoothing_at_bin_centres(lf['k_bins']))
        got = ttools.run_lcv_field(tr, lcv.field_ffts, config, meta=lcv.meta)
    # against the port's k-level flow (test_lcv_field_vs_k_level)
    npt.assert_allclose(got['bias'], lk['bias'], rtol=1e-3)
    for key, rtol in (('Pk_tr_tr_ell', 2e-4), ('Pk_lf_lf_ell', 2e-3), ('Pk_tr_lf_ell', 2e-3)):
        _close(got[key], lk[key], rtol, key, atol_frac=1e-4)
    npt.assert_allclose(got['rho_tr_lf'], lk['rho_tr_lf'], rtol=5e-3, atol=1e-3)


# ---------------------------------------------------------------------------
# field-level ZCV
# ---------------------------------------------------------------------------


def test_run_zcv_field_matches_jax(fix):
    config = copy.deepcopy(fix['config'])
    zcv, pos = fix['zcv'], fix['pos']
    fns = {rsd: jtp.get_tracer_power(pos, rsd, config, save_3D_power=True) for rsd in (True, False)}
    keynames = config['zcv_params']['fields']

    def ij_fns(rsd_str):
        return [fix['zz'] / f'power{rsd_str}_{keynames[i]}_{keynames[j]}_nmesh{NMESH}.asdf'
                for i in range(len(keynames)) for j in range(i + 1)]

    ref = jtools.run_zcv_field(fns[True], ij_fns('_rsd'), fns[False], ij_fns(''), config)
    tr = {rsd: ttp.get_tracer_power(pos, rsd, config, meta=zcv.meta, device='cpu',
                                    save_3D_power=True) for rsd in (True, False)}
    for rsd in (True, False):
        r = _data(fns[rsd][0])['P_k3D_tr_tr']
        npt.assert_allclose(ttools.field_cube(tr[rsd], tr[rsd]).numpy(), r, rtol=0,
                            atol=1e-5 * np.abs(r).max())
    out = {}
    got = ttools.run_zcv_field(tr, zcv.field_ffts, config, pk_ij_zenbu=zcv.templates[True],
                               meta=zcv.meta, out=out)
    _assert_field_flow(got, ref, 'rho_tr_ZD', 'Pk_tr_tr_ell_zcv')
    cube = _data(fix['zz'] / f'power_rsd_ZCV_tr_nmesh{NMESH}.asdf')['P_k3D_tr_tr_zcv']
    npt.assert_allclose(out['P_k3D_tr_tr_zcv'].numpy(), cube, rtol=0,
                        atol=1e-4 * np.abs(cube).max())
    # the templates read from zcv_dir when not given
    again = ttools.run_zcv_field(tr, zcv.field_ffts, config, meta=zcv.meta)
    npt.assert_array_equal(again['Pk_tr_tr_ell_zcv'], got['Pk_tr_tr_ell_zcv'])
    with pytest.raises(ValueError, match='k bins'):
        ttools.run_zcv_field(tr, zcv.field_ffts, config, pk_ij_zenbu=zcv.templates[True][..., 1:],
                             meta=zcv.meta)


def _balls(config):
    """(JAX AbacusHOD, port AbacusHOD) on one synthetic staged state in the
    fixture's box (tests/test_torch_zcv.py's construction)."""
    import logging

    from abacusutils_tpu.models.hod.abacus_hod import AbacusHOD as JaxAbacusHOD

    halo, part = staged_state(20_000, 60_000, LBOX, seed=61)
    tracers = {'LRG': dict(TRACERS['LRG'])}
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


def test_apply_zcv_xi_matches_jax(fix):
    """AbacusHOD.apply_zcv_xi of both packages on one single-tracer RSD mock,
    each re-populating the real-space tracer with its own run_hod; the
    tracer fields are kept and load_presaved reads them back."""
    config = copy.deepcopy(fix['config'])
    jball, tball = _balls(config)
    mock = jball.run_hod(jball.tracers, want_rsd=True, write_to_disk=False)
    assert len(mock['LRG']['x']) > 100
    ref = japply.apply_zcv_xi(jball, copy.deepcopy(mock), copy.deepcopy(config))
    zcv = copy.copy(fix['zcv'])
    zcv.tracer_ffts = {}
    got = tball.apply_zcv_xi(copy.deepcopy(mock), copy.deepcopy(config), zcv)
    _assert_field_flow({k: v for k, v in got.items() if not k.startswith(('Xi', 'Np', 'r_'))},
                       {k: v for k, v in ref.items() if not k.startswith(('Xi', 'Np', 'r_'))},
                       'rho_tr_ZD', 'Pk_tr_tr_ell_zcv')
    npt.assert_array_equal(got['r_binc'], ref['r_binc'])
    npt.assert_array_equal(got['Np_tr_tr_ell'], np.asarray(ref['Np_tr_tr_ell']))
    for key in ('Xi_tr_tr_ell', 'Xi_tr_tr_ell_zcv'):
        _close(got[key], ref[key], PK_RTOL, key, atol_frac=1e-4)
        assert np.isfinite(got[key]).all()
    again = tball.apply_zcv_xi(copy.deepcopy(mock), copy.deepcopy(config), zcv,
                               load_presaved=True)
    for key in got:
        npt.assert_array_equal(np.asarray(again[key]), np.asarray(got[key]), err_msg=key)
    zcv.tracer_ffts = {}
    with pytest.raises(KeyError, match='load_presaved'):
        tball.apply_zcv_xi(copy.deepcopy(mock), copy.deepcopy(config), zcv, load_presaved=True)
    two = dict(mock, ELG=mock['LRG'])
    with pytest.raises(AssertionError):
        tball.apply_zcv_xi(two, copy.deepcopy(config), zcv)
