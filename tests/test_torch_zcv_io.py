"""The port's ZCV / LCV chain on files (abacusutils_tpu_torch/models/zcv:
ic_fields, advect_fields, linear_fields and zenbu_window ``main``,
ZCVProducts / LCVProducts ``from_dir``, the tracer-power file layer and
apply_zcv / apply_zcv_xi with ``zcv=None``) against the JAX package's.

The JAX chain is tests/common.py:make_synthetic_zcv_dir (nmesh 16,
AbacusSummit_base_c000_ph006 at z 0.8, with the 3-D cubes); the port runs
its own mains on the same filtered IC and the same config, given as JSON,
in a second zcv_dir. Both packages' ZA q-functions run on the coarse q grid
of tests/test_torch_zcv.py (QGRID). Every file the JAX chain writes, the
port writes under the same name with the same columns, dtypes, shapes and
header; the port reads JAX's files and JAX reads the port's.

Tolerances, as tests/test_torch_zcv.py and test_torch_cv_field.py state
them for the same functions: filtered IC and bias fields within 1e-5 of
each field's largest value; advected fields within the f32 floor of field
- 1 (test_torch_zcv._floor; 1cb within 1e-5 of its largest mode); P_ij and
tracer spectra within PK_RTOL (2e-4) of each value plus 2e-4 of the largest
and the floor carried into the pair; mode counts exact; the 3-D cubes within
2e-4 of the cube's largest value plus the floor of each field carried into
the pair; window atol 1e-6,
templates rtol 1e-10; apply_zcv within APPLY_RTOL (1e-2); apply_zcv_xi at
test_torch_cv_field's field-flow tolerances.
"""

import copy
import functools
import json
import shutil

import numpy as np
import numpy.testing as npt
import pytest
import torch
import yaml

from abacusutils_tpu.io.asdf_file import open_asdf as jopen
from abacusutils_tpu.io.asdf_file import write_asdf as jwrite
from abacusutils_tpu.models.zcv import advect_fields as jadv
from abacusutils_tpu.models.zcv import apply as japply
from abacusutils_tpu.models.zcv import ic_fields as jic
from abacusutils_tpu.models.zcv import linear_fields as jlin
from abacusutils_tpu.models.zcv import tracer_power as jtp
from abacusutils_tpu.models.zcv import zenbu_native as jzn
from abacusutils_tpu_torch.io.asdf_file import open_asdf as topen
from abacusutils_tpu_torch.models.zcv import advect_fields as tadv
from abacusutils_tpu_torch.models.zcv import cosmo as tcosmo
from abacusutils_tpu_torch.models.zcv import ic_fields as tic
from abacusutils_tpu_torch.models.zcv import linear_fields as tlin
from abacusutils_tpu_torch.models.zcv import tracer_power as ttp
from abacusutils_tpu_torch.models.zcv import zenbu_native as tzn
from abacusutils_tpu_torch.models.zcv import zenbu_window as tzw
from abacusutils_tpu_torch.models.zcv.precompute import LCVProducts, ZCVProducts
from common import make_synthetic_zcv_dir
from torch_helpers import gloo_mesh  # noqa: F401
from test_torch_zcv import APPLY_RTOL, PK_RTOL, QGRID, _assert_spectra, _autos, _balls, _floor

SIM, Z, NMESH, LBOX = 'AbacusSummit_base_c000_ph006', 0.8, 16, 2000.0


def _cheap(cls):
    return functools.partial(cls, qgrid=QGRID, nk=768)


def _json(config, path):
    path.write_text(json.dumps(config))
    return str(path)


@pytest.fixture(scope='module')
def chain(tmp_path_factory):
    """The JAX chain in `jdir`, the port's mains on the same IC and config in
    `pdir`."""
    mp = pytest.MonkeyPatch()
    for mod in (jzn, tzn):
        mp.setattr(mod, 'ZAQFuncs', _cheap(mod.ZAQFuncs))
        mod._QF_CACHE.clear()
    root = tmp_path_factory.mktemp('zcv_io')
    jdir, pdir = root / 'jax', root / 'port'
    try:
        config, _ = make_synthetic_zcv_dir(jdir)
        pconfig = copy.deepcopy(config)
        pconfig['zcv_params'].update(zcv_dir=str(pdir), ic_dir=str(pdir))
        (pdir / SIM).mkdir(parents=True)
        shutil.copy(jdir / SIM / f'ic_filt_nmesh{NMESH}.asdf', pdir / SIM)
        cfg = _json(pconfig, root / 'port.json')
        tic.main(cfg, device='cpu')
        for rsd in (True, False):
            tadv.main(cfg, want_rsd=rsd, device='cpu')
            tadv.main(cfg, want_rsd=rsd, save_3D_power=True, device='cpu')
        tzw.main(cfg, engine='host', device='cpu')
        # JAX's spectra and cubes of the port's advected fields: its main on
        # a copy of the port's directory without them
        odir = root / 'jax_on_port'
        shutil.copytree(pdir, odir)
        for fn in (odir / SIM / f'z{Z:.3f}').glob('power*'):
            fn.unlink()
        oconfig = copy.deepcopy(config)
        oconfig['zcv_params'].update(zcv_dir=str(odir), ic_dir=str(odir))
        ocfg = root / 'jax_on_port.yaml'
        yaml.safe_dump(oconfig, open(ocfg, 'w'))
        for rsd in (True, False):
            jadv.main(str(ocfg), want_rsd=rsd)
            jadv.main(str(ocfg), want_rsd=rsd, save_3D_power=True)
        yield dict(config=config, pconfig=pconfig, jdir=jdir, pdir=pdir, odir=odir, root=root,
                   cfg=cfg)
    finally:
        mp.undo()
        for mod in (jzn, tzn):
            mod._QF_CACHE.clear()


def _files(d):
    return sorted(str(p.relative_to(d)) for p in d.rglob('*') if p.is_file())


def _read(fn):
    if fn.suffix == '.npz':
        with np.load(fn) as f:
            return {k: f[k] for k in f.files}, {}
    with jopen(fn) as f:
        return {k: np.asarray(v) for k, v in f['data'].items()}, dict(f['header'])


def test_every_file_matches_jax(chain):
    """Names, columns, dtypes, shapes and headers of every file. The filtered
    IC, bias fields, advected fields, window and templates against JAX's
    chain; the P_ij tables and 3-D cubes against JAX's advect_fields.main on
    the port's advected fields (the same fields: the delta^2, s^2 and
    nabla^2 fields lie at the f32 floor of field - 1 in both packages, so
    their spectra are held on the same fields, as tests/test_torch_zcv.py
    holds power_ij)."""
    jdir, pdir, odir = chain['jdir'], chain['pdir'], chain['odir']
    names = [n for n in _files(jdir) if not n.endswith('.yaml')]
    assert names == _files(pdir) == _files(odir)
    assert len(names) == 1 + 1 + 1 + 2 * (5 + 1 + 15 + 1)
    for name in names:
        ref, rh = _read(jdir / name)
        got, gh = _read(pdir / name)
        assert set(gh) == set(rh), name
        for k, v in rh.items():
            if isinstance(v, float):
                assert np.isclose(gh[k], v), (name, k)
            else:
                assert gh[k] == v, (name, k)
        assert list(got) == list(ref), name
        if '/power' in name:
            ref, _ = _read(odir / name)
        for k, r in ref.items():
            g = got[k]
            assert g.dtype == r.dtype and g.shape == r.shape, (name, k)
            if name.startswith((f'{SIM}/ic_filt', f'{SIM}/fields')):
                npt.assert_allclose(g, r, rtol=0, atol=1e-5 * np.abs(r).max(), err_msg=name)
            elif 'advected_' in name:
                atol = 1e-5 * np.abs(r).max() if '1cb' in name else _floor()
                npt.assert_allclose(g, r, rtol=0, atol=atol, err_msg=f'{name} {k}')
            elif 'window' in name:
                npt.assert_allclose(g, r, rtol=1e-6, atol=1e-6, err_msg=f'{name} {k}')
            elif 'zenbu' in name:
                npt.assert_allclose(g, r, rtol=1e-10, atol=0, err_msg=f'{name} {k}')
            elif k.startswith('P_k3D_'):
                npt.assert_allclose(g, r, rtol=0, atol=PK_RTOL * np.abs(r).max(),
                                    err_msg=f'{name} {k}')
        if name.endswith(f'_ij_nmesh{NMESH}.asdf'):
            _assert_spectra(got, ref, name, _autos(ref))


def test_each_package_reads_the_others_files(chain):
    """JAX's readers on the port's files and the port's on JAX's: the P_ij
    table a second main returns is the file's, and from_dir of either
    directory gives the same products within the chain's tolerances."""
    jcfg = chain['root'] / 'jax.yaml'
    pcfg_yaml = chain['root'] / 'port.yaml'
    yaml.safe_dump(chain['config'], open(jcfg, 'w'))
    yaml.safe_dump(chain['pconfig'], open(pcfg_yaml, 'w'))
    for rsd in (True, False):
        rsd_str = '_rsd' if rsd else ''
        fn = f'{SIM}/z{Z:.3f}/power{rsd_str}_ij_nmesh{NMESH}.asdf'
        # an existing table is returned as read: JAX on the port's file,
        # the port on JAX's
        got = jadv.main(str(pcfg_yaml), want_rsd=rsd)
        with topen(chain['pdir'] / fn) as f:
            for k, v in f['data'].items():
                npt.assert_array_equal(np.asarray(got[k]), np.asarray(v))
        jcfg_json = _json(chain['config'], chain['root'] / 'jax.json')
        got = tadv.main(jcfg_json, want_rsd=rsd, device='cpu')
        with jopen(chain['jdir'] / fn) as f:
            for k, v in f['data'].items():
                npt.assert_array_equal(got[k], np.asarray(v))
    a = ZCVProducts.from_dir(chain['config'], device='cpu')
    b = ZCVProducts.from_dir(chain['cfg'], device='cpu')
    assert list(a.field_ffts) == list(b.field_ffts) == [True, False]
    for rsd in (True, False):
        rsd_str = '_rsd' if rsd else ''
        assert list(a.field_ffts[rsd]) == chain['config']['zcv_params']['fields']
        for prod, d in ((a, chain['jdir']), (b, chain['pdir'])):
            ref, _ = _read(d / f'{SIM}/z{Z:.3f}/power{rsd_str}_ij_nmesh{NMESH}.asdf')
            assert set(prod.pk_ij[rsd]) == set(ref)
            for k, v in ref.items():
                npt.assert_array_equal(prod.pk_ij[rsd][k], v)
            for kn in prod.field_ffts[rsd]:
                d_ = _read(d / f'{SIM}/z{Z:.3f}/advected_{kn}_field{rsd_str}_fft_nmesh{NMESH}'
                              '.asdf')[0]
                npt.assert_array_equal(prod.field_ffts[rsd][kn].real.numpy(), d_[f'{kn}_Re'])
                npt.assert_array_equal(prod.field_ffts[rsd][kn].imag.numpy(), d_[f'{kn}_Im'])
        npt.assert_allclose(b.templates[rsd], a.templates[rsd], rtol=1e-10, atol=0)
        F = a.field_ffts[rsd]['1cb']
        assert F.dtype == torch.complex64 and F.shape == (NMESH, NMESH, NMESH // 2 + 1)
    npt.assert_allclose(b.window, a.window, atol=1e-6)
    npt.assert_array_equal(a.k_binc, b.k_binc)
    bad = copy.deepcopy(chain['config'])
    bad['zcv_params']['kcut'] = 0.3
    with pytest.raises(AssertionError, match='Mismatching file'):
        ZCVProducts.from_dir(bad, device='cpu')


def test_ic_fields_main_from_the_ic_matches_jax(tmp_path):
    """ic_fields.main from ic_dens / ic_disp files: the filtered IC and the
    bias fields of both packages, and a second call skips both files."""
    rng = np.random.default_rng(4)
    dens = rng.normal(0, 0.02, (NMESH,) * 3).astype(np.float32)
    disp = rng.normal(0, 5.0, (NMESH,) * 3 + (3,)).astype(np.float32)
    ic = tmp_path / 'ic' / SIM
    ic.mkdir(parents=True)
    jwrite(str(ic / f'ic_dens_N{NMESH}.asdf'), {'data': {'density': dens},
                                               'header': {'BoxSize': LBOX}})
    jwrite(str(ic / f'ic_disp_N{NMESH}.asdf'), {'data': {'displacements': disp},
                                               'header': {'BoxSize': LBOX}})
    out = {}
    for name in ('jax', 'port'):
        config = {'sim_params': {'sim_name': SIM, 'z_mock': Z},
                  'zcv_params': {'zcv_dir': str(tmp_path / name), 'ic_dir': str(tmp_path / 'ic'),
                                 'nmesh': NMESH, 'kcut': 0.05}}
        cfg = _json(config, tmp_path / f'{name}.json')  # JSON is YAML too
        if name == 'jax':
            jic.main(cfg)
        else:
            tic.main(cfg, device='cpu')
        out[name] = tmp_path / name / SIM
    for stem in (f'ic_filt_nmesh{NMESH}.asdf', f'fields_nmesh{NMESH}.asdf'):
        ref, rh = _read(out['jax'] / stem)
        got, gh = _read(out['port'] / stem)
        assert gh == rh and list(got) == list(ref)
        for k, r in ref.items():
            assert got[k].dtype == r.dtype == np.float32
            npt.assert_allclose(got[k], r, rtol=0, atol=1e-5 * np.abs(r).max(), err_msg=k)
    before = {p: p.stat().st_mtime_ns for p in out['port'].iterdir()}
    tic.main(_json({'sim_params': {'sim_name': SIM, 'z_mock': Z},
                    'zcv_params': {'zcv_dir': str(tmp_path / 'port'), 'ic_dir': 'nowhere',
                                   'nmesh': NMESH, 'kcut': 0.05}}, tmp_path / 'again.json'),
             device='cpu')
    assert before == {p: p.stat().st_mtime_ns for p in out['port'].iterdir()}


def _tracer(seed, n=6000):
    return (np.random.default_rng(seed).random((n, 3)) * LBOX - LBOX / 2).astype(np.float32)


def test_tracer_power_files_match_jax(chain, tmp_path):
    """get_tracer_power with want_save and a tracer tag, both packages
    reading the port's advected fields from zcv_dir: the same spectra, and
    the files JAX writes under tracer_dir."""
    pos = _tracer(5)
    for name in ('jax', 'port'):
        conf = copy.deepcopy(chain['pconfig'])  # both read the port's fields
        conf['zcv_params']['tracer_dir'] = str(tmp_path / name)
        for rsd in (True, False):
            if name == 'jax':
                ref = jtp.get_tracer_power(pos, rsd, conf, tracer_tag='LRG')
                jtp.get_tracer_power(pos, rsd, conf, save_3D_power=True, tracer_tag='LRG')
            else:
                got = ttp.get_tracer_power(pos, rsd, conf, device='cpu', want_save=True,
                                           tracer_tag='LRG')
                F = ttp.get_tracer_power(pos, rsd, conf, device='cpu', want_save=True,
                                         tracer_tag='LRG', save_3D_power=True)
                assert F.dtype == torch.complex64
        if name == 'port':
            autos = _autos(_read(chain['pdir'] / f'{SIM}/z{Z:.3f}/power_ij_nmesh{NMESH}.asdf')[0])
            autos['tr'] = ref['P_kmu_tr_tr']
            _assert_spectra(got, ref, 'tracer', autos)
    jf, pf = _files(tmp_path / 'jax'), _files(tmp_path / 'port')
    assert jf == pf and len(jf) == 2 * (1 + 1 + 1 + 5)
    for name in jf:
        ref, rh = _read(tmp_path / 'jax' / name)
        got, gh = _read(tmp_path / 'port' / name)
        assert set(got) == set(ref) and rh.keys() == gh.keys(), name
        for k, r in ref.items():
            assert got[k].dtype == r.dtype and got[k].shape == r.shape, (name, k)


def _copies(chain, tmp_path, fields=('1cb', 'delta')):
    """(JAX's config, the port's config) on two copies of JAX's zcv_dir, the
    fields `fields` (a unique fit minimum)."""
    out = []
    for name in ('jax', 'port'):
        shutil.copytree(chain['jdir'], tmp_path / name)
        conf = copy.deepcopy(chain['config'])
        conf['zcv_params'].update(zcv_dir=str(tmp_path / name), fields=list(fields))
        out.append(conf)
    return out


def test_apply_zcv_from_dir_matches_jax(chain, tmp_path):
    """AbacusHOD.apply_zcv with zcv=None on a copy of JAX's zcv_dir against
    JAX's apply_zcv on another, two tracers; both write the same tracer
    files, and load_presaved reads them back in both packages (JAX reading
    the port's)."""
    jconf, tconf = _copies(chain, tmp_path)
    jball, tball = _balls(jconf)
    mock = jball.run_hod(jball.tracers, want_rsd=True, write_to_disk=False)
    before = _files(tmp_path / 'port')
    ref = japply.apply_zcv(jball, copy.deepcopy(mock), copy.deepcopy(jconf))
    got = tball.apply_zcv(copy.deepcopy(mock), copy.deepcopy(tconf))
    assert set(got) == set(ref) == {'LRG', 'ELG'}
    for t in ref:
        for key, r in ref[t].items():
            r = np.asarray(r)
            npt.assert_allclose(np.asarray(got[t][key]), r, rtol=APPLY_RTOL,
                                atol=APPLY_RTOL * np.abs(r).max() if r.size else 0, err_msg=key)
    new = sorted(set(_files(tmp_path / 'port')) - set(before))
    assert new == sorted(set(_files(tmp_path / 'jax')) - set(before)) and len(new) == 2 * 2 * 2
    again = tball.apply_zcv(copy.deepcopy(mock), copy.deepcopy(tconf), load_presaved=True)
    jagain = japply.apply_zcv(jball, copy.deepcopy(mock), copy.deepcopy(tconf), load_presaved=True)
    for t in got:
        for key in got[t]:
            g = np.asarray(got[t][key])
            npt.assert_array_equal(np.asarray(again[t][key]), g)
            npt.assert_allclose(np.asarray(jagain[t][key]), g, rtol=1e-10,
                                atol=1e-10 * np.abs(g).max() if g.size else 0)


def test_apply_zcv_xi_from_dir_matches_jax(chain, tmp_path):
    """AbacusHOD.apply_zcv_xi with zcv=None: the port on a copy of JAX's
    zcv_dir against JAX's apply_zcv_xi on another, then load_presaved from
    the tracer fields the first call wrote."""
    jconf, tconf = _copies(chain, tmp_path)
    jball, tball = _balls(jconf)
    mock = jball.run_hod(jball.tracers, want_rsd=True, write_to_disk=False)
    mock = {'LRG': mock['LRG']}
    ref = japply.apply_zcv_xi(jball, copy.deepcopy(mock), copy.deepcopy(jconf))
    got = tball.apply_zcv_xi(copy.deepcopy(mock), copy.deepcopy(tconf))
    npt.assert_allclose(np.asarray(got['bias']), np.asarray(ref['bias']), rtol=1e-4)
    npt.assert_allclose(got['rho_tr_ZD'], ref['rho_tr_ZD'], rtol=0, atol=1e-4)
    npt.assert_array_equal(got['r_binc'], ref['r_binc'])
    for key in ('Pk_tr_tr_ell', 'Pk_tr_tr_ell_zcv', 'Xi_tr_tr_ell', 'Xi_tr_tr_ell_zcv'):
        r = np.asarray(ref[key], np.float64)
        npt.assert_allclose(np.asarray(got[key], np.float64), r, rtol=2e-4,
                            atol=1e-4 * np.abs(r).max(), err_msg=key)
    zz = tmp_path / 'port' / SIM / f'z{Z:.3f}'
    assert (zz / f'tr_field_rsd_fft_nmesh{NMESH}.asdf').is_file()
    assert (zz / f'power_rsd_ZCV_tr_nmesh{NMESH}.asdf').is_file()
    again = tball.apply_zcv_xi(copy.deepcopy(mock), copy.deepcopy(tconf), load_presaved=True)
    for key in got:
        npt.assert_array_equal(np.asarray(again[key]), np.asarray(got[key]), err_msg=key)


def test_lcv_main_and_from_dir_match_jax(tmp_path):
    """linear_fields.main of both packages on one filtered IC, binned and in
    3-D, and LCVProducts.from_dir against the JAX files."""
    kcut, nmesh = 0.2261946710584651, 8
    dens = np.random.default_rng(7).normal(0, 0.05, (nmesh,) * 3).astype(np.float32)
    config = {
        'sim_params': {'sim_name': SIM, 'z_mock': Z},
        'HOD_params': {'want_rsd': True, 'rec_algo': 'recsym', 'smoothing': 10.0},
        'lcv_params': {'nmesh': nmesh, 'kcut': kcut},
        'power_params': {'nbins_k': nmesh // 2, 'nbins_mu': 1, 'poles': [0, 2, 4],
                         'k_hMpc_max': np.pi * nmesh / LBOX, 'paste': 'CIC',
                         'compensated': True, 'interlaced': True, 'logk': False,
                         'nmesh': nmesh},
    }
    res, fns = {}, {}
    for name in ('jax', 'port'):
        conf = copy.deepcopy(config)
        conf['lcv_params'].update(lcv_dir=str(tmp_path / name), ic_dir=str(tmp_path / name))
        (tmp_path / name / SIM).mkdir(parents=True)
        jwrite(str(tmp_path / name / SIM / f'ic_filt_nmesh{nmesh}.asdf'),
               {'data': {'dens': dens}, 'header': {'sim_name': SIM, 'Lbox': LBOX,
                                                   'nmesh': nmesh, 'kcut': kcut}},
               compression='blsc')
        cfg = _json(conf, tmp_path / f'{name}.json')
        mod = jlin if name == 'jax' else tlin
        kw = {} if name == 'jax' else {'device': 'cpu'}
        res[name] = mod.main(cfg, **kw)
        fns[name] = mod.main(cfg, save_3D_power=True, **kw)
    for k, r in res['jax'].items():
        r = np.asarray(r)
        if k.startswith('N_'):
            npt.assert_array_equal(res['port'][k], r)
        else:
            npt.assert_allclose(res['port'][k], r, rtol=PK_RTOL, atol=PK_RTOL * np.abs(r).max(),
                                err_msg=k)
    assert [p.name for p in fns['port']] == [p.name for p in fns['jax']]
    for a, b in zip(fns['jax'], fns['port']):
        ref, rh = _read(a)
        got, gh = _read(b)
        assert gh == rh and list(got) == list(ref)
        for k, r in ref.items():
            npt.assert_allclose(got[k], r, rtol=0, atol=1e-5 * np.abs(r).max(), err_msg=k)
    conf = copy.deepcopy(config)
    conf['lcv_params'].update(lcv_dir=str(tmp_path / 'jax'))
    lcv = LCVProducts.from_dir(conf, device='cpu')
    assert (tmp_path / 'jax' / SIM / f'window_nmesh{nmesh}.npz').is_file()
    for k, v in res['jax'].items():
        npt.assert_array_equal(lcv.pk_lin[k], np.asarray(v))
    assert set(lcv.field_ffts) == {'delta', 'deltamu2'}
    assert lcv.window.shape == (3 * (nmesh // 2), 3 * (nmesh // 2))
    # get_recon_power reads the linear fields from lcv_dir when not given
    tracer = (np.random.default_rng(3).random((500, 3)) * LBOX).astype(np.float32)
    conf['lcv_params']['lcv_dir'] = str(tmp_path / 'port')
    got = ttp.get_recon_power(tracer, None, True, conf, device='cpu', want_save=True)
    again = ttp.get_recon_power(None, None, True, conf, device='cpu', want_load_tr_fft=True)
    for k in got:
        npt.assert_array_equal(again[k], got[k])
    assert (tmp_path / 'port' / SIM / f'z{Z:.3f}' / f'power_rsd_tr_recsym_lin_nmesh{nmesh}.asdf'
            ).is_file()


def test_mesh_is_refused(chain, gloo_mesh, tmp_path):
    """advect_fields.main(mesh=) is no longer refused: on a world of one gloo
    rank it paints and transforms each field with parallel/fft.py's
    field_fft_slab and writes the Fourier fields the unsharded main writes,
    within tests/test_parallel.py's budget for JAX's sharded advection
    (atol 1e-4 of the scale, rtol 1e-3)."""
    out = {}
    for tag, mesh in (('single', None), ('slab', gloo_mesh)):
        d = tmp_path / tag
        shutil.copytree(chain['pdir'], d)
        zdir = d / SIM / f'z{Z:.3f}'
        for fn in [*zdir.glob('advected_*'), *zdir.glob('power*')]:
            fn.unlink()
        config = copy.deepcopy(chain['pconfig'])
        config['zcv_params'].update(zcv_dir=str(d), ic_dir=str(d))
        tadv.main(_json(config, tmp_path / f'{tag}.json'), want_rsd=False, mesh=mesh,
                  device='cpu')
        out[tag] = zdir
    for kn in ('1cb', 'delta', 'delta2', 'tidal2', 'nabla2'):
        vals = {}
        for tag, zdir in out.items():
            with topen(zdir / f'advected_{kn}_field_fft_nmesh{NMESH}.asdf') as f:
                data = f['data']
                vals[tag] = np.asarray(data[f'{kn}_Re']) + 1j * np.asarray(data[f'{kn}_Im'])
        scale = np.abs(vals['single']).max()
        npt.assert_allclose(vals['slab'], vals['single'], atol=1e-4 * scale, rtol=1e-3, err_msg=kn)
