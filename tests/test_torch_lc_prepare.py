"""The light cone's disk path in the port against the JAX package's, on a
synthetic halo light cone (testing.synthetic_compaso_lc: 8,000 halos in
the octant of a shell around z = 0.5, three observers) written with the
JAX package's write_asdf: prepare_sim.main with halo_lc (one file, no env
sidecar, the randoms-normalized Menv at the footprint's edges), staging,
run_hod and run_hod_pk_fused from AbacusHOD.from_config.

The rules of tests/test_torch_prepare_sim_io.py: the tables of the port's
'host' engines equal JAX's h5 column for column (Menv's randoms loop
included); the device engines' (the kernels' plain versions on the CPU)
with ranksc and fenv_rank tie-aware; staging key by key, bit for bit; run_hod's
galaxies as tests/test_torch_run_hod.py holds them (no keep-code flip,
positions and velocities within 2 float32 ulps); run_hod_pk_fused within
PK_RTOL of each pair's scale, n_gal and the mode counts exact. want_shear
on a light cone reads a box's field files, and raises in both packages
when there are none."""

import glob
import os

import h5py
import numpy as np
import pytest
import yaml

from abacusutils_tpu.io.asdf_file import write_asdf as jax_write_asdf
from abacusutils_tpu.models.hod import prepare_sim as jps
from abacusutils_tpu.models.hod.abacus_hod import AbacusHOD as JaxAbacusHOD
from abacusutils_tpu_torch.models.hod import prepare_sim as tps
from abacusutils_tpu_torch.models.hod.abacus_hod import AbacusHOD
from abacusutils_tpu_torch.models.hod.staging import staging
from abacusutils_tpu_torch.testing import LC_ORIGINS, synthetic_compaso_lc, write_compaso_lc
from test_torch_run_hod import _assert_mock
from torch_disk import assert_fenv_tie_aware, assert_tables_equal, config

PK_RTOL = 2e-4
N_HALO = 8000


def _lc_config(root, name, subsample, engines):
    cfg = config(root, name, subsample, engines)
    cfg['sim_params'].update(sim_dir=f'{root}/halo_light_cones/', halo_lc=True)
    cfg['HOD_params']['want_shear'] = False
    return cfg


def _savedir(cfg):
    sp = cfg['sim_params']
    return f'{sp["subsample_dir"]}{sp["sim_name"]}/z0.500'


@pytest.fixture(scope='module')
def lc(tmp_path_factory):
    root = tmp_path_factory.mktemp('lc_prepare')
    sim = synthetic_compaso_lc(N_HALO, seed=6)
    write_compaso_lc(root, sim, writer=jax_write_asdf)
    name = sim['header']['SimName']
    cfg = {k: _lc_config(root, name, k, engines) for k, engines in
           (('jax', 'host'), ('port_host', 'host'), ('port_device', 'auto'))}
    path = root / 'jax.yaml'
    with open(path, 'w') as f:
        yaml.safe_dump(cfg['jax'], f)
    jps.main(str(path))
    tps.main(cfg['port_host'], device='cpu')
    tps.main(cfg['port_device'], device='cpu')
    return root, sim, cfg, JaxAbacusHOD(cfg['jax']['sim_params'], cfg['jax']['HOD_params'])


@pytest.mark.parametrize('engines', ['port_host', 'port_device'], ids=['host', 'device'])
def test_lc_main_tables_match_jax(lc, engines):
    _, sim, cfg, _ = lc
    ref_names = sorted(os.path.basename(f) for f in glob.glob(f'{_savedir(cfg["jax"])}/*'))
    names = sorted(os.path.basename(f) for f in glob.glob(f'{_savedir(cfg[engines])}/*'))
    assert names == [n[:-3] + '.npz' for n in ref_names] and len(names) == 2  # no env sidecar
    tables = {}
    for kind in ('halos', 'particles'):
        (ref_fn,) = glob.glob(f'{_savedir(cfg["jax"])}/{kind}_xcom_0_*.h5')
        with h5py.File(ref_fn) as f:
            ref = f[kind][:]
        with np.load(f'{_savedir(cfg[engines])}/{os.path.basename(ref_fn)[:-3]}.npz') as f:
            got = f[kind]
        assert len(ref) > 500
        tables[kind] = got, ref
    if engines == 'port_host':
        for got, ref in tables.values():
            assert_tables_equal(got, ref)
    else:
        assert_fenv_tie_aware(tables, sim['halos']['N_interp'],
                              sim['header']['ParticleMassHMsun'])
    # the footprint's edges hold halos, so the randoms loop ran
    h = sim['halos']
    pos = np.where(np.any(h['pos_avg'], axis=1)[:, None], h['pos_avg'], h['pos_interp'])
    index_bounds, rand_norm = tps.lc_randoms_norm(pos, np.full(len(pos), 1.0, np.float32),
                                                  LC_ORIGINS, 2000.0, 10, 1)
    assert 0.05 * N_HALO < len(index_bounds) < 0.5 * N_HALO and rand_norm.max() > 0


def test_lc_staging_matches_jax(lc):
    _, _, cfg, ref = lc
    halo, part, params, mock_dir = staging(cfg['port_host']['sim_params'],
                                           cfg['port_host']['HOD_params'])
    assert mock_dir == ref.mock_dir and set(params) == set(ref.params)
    for k, v in ref.params.items():
        np.testing.assert_array_equal(params[k], v, err_msg=k)
    np.testing.assert_array_equal(params['origin'], LC_ORIGINS[:3])
    for got, want in ((halo, ref.halo_data), (part, ref.particle_data)):
        assert list(got) == list(want)
        for k in want:
            a = np.asarray(want[k])
            assert got[k].dtype == a.dtype and got[k].shape == a.shape, k
            np.testing.assert_array_equal(got[k], a, err_msg=k)
    assert halo['hid'].dtype == np.int64 and np.all(np.diff(halo['hid']) > 0)
    assert np.all(halo['hid'][part['pinds']] == part['phid']) and len(part['pinds']) > 1000
    assert np.abs(halo['hfenv']).max() > 0.4  # the tables' own fenv: no global re-rank


def test_lc_run_hod_matches_jax(lc):
    _, _, cfg, ref = lc
    port = AbacusHOD.from_config(cfg['port_device']['sim_params'],
                                 cfg['port_device']['HOD_params'], device='cpu')
    assert port.halo_lc and port.z_type == 'lightcone'
    for rsd in (True, False):
        _assert_mock(port.run_hod(want_rsd=rsd), ref.run_hod(ref.tracers, want_rsd=rsd))


def test_lc_run_hod_pk_fused_matches_jax(lc):
    _, _, cfg, ref = lc
    port = AbacusHOD.from_config(cfg['port_device']['sim_params'],
                                 cfg['port_device']['HOD_params'], device='cpu')
    kw = dict(nmesh=32, nbins_k=16)
    (cl, ng), (cl_j, ng_j) = port.run_hod_pk_fused(**kw), ref.run_hod_pk_fused(**kw)
    assert ng == ng_j and all(v > 50 for v in ng.values()) and set(cl) == set(cl_j)
    np.testing.assert_array_equal(cl['k_binc'], cl_j['k_binc'])
    for t1 in ng:
        for t2 in ng:
            key = f'{t1}_{t2}'
            np.testing.assert_array_equal(cl[key + '_modes'], cl_j[key + '_modes'])
            scale = np.sqrt(np.abs(cl_j[f'{t1}_{t1}'] * cl_j[f'{t2}_{t2}']))
            assert (np.abs(cl[key] - cl_j[key]) <= PK_RTOL * scale).all(), key


def test_lc_shear_needs_box_files_in_both(lc, tmp_path):
    root, sim, _, _ = lc
    name = sim['header']['SimName']
    for main, kind in ((jps.main, 'jax'), (tps.main, 'port')):
        cfg = _lc_config(root, name, f'shear_{kind}', 'host')
        cfg['HOD_params']['want_shear'] = True
        if kind == 'jax':
            path = tmp_path / 'shear.yaml'
            with open(path, 'w') as f:
                yaml.safe_dump(cfg, f)
            cfg = str(path)
        with pytest.raises(ValueError, match='concatenate'):
            main(cfg) if kind == 'jax' else main(cfg, device='cpu')
