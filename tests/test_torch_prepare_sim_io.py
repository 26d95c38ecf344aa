"""The disk path of the port against the JAX package's, on the synthetic
simulation of tests/torch_disk.py: prepare_sim.main (CompaSO files ->
subsample tables, with ranks, the padded env's Menv and the shear field at
32^3), AbacusHOD's staging of those tables, and run_hod_pk_fused on the
staged object.

JAX's main reads a YAML config (written with yaml.safe_dump) and writes h5;
the port's main takes the config as a dict or a JSON file and writes npz
under the same stems. JAX runs its 'host' ranks and Menv engines (no jit);
the port runs them too (every column equal, Menv exact), and its device
engines (the kernels' plain versions on the CPU: ranksc tie-aware, Menv at
rtol 1e-12 with the same zeros, the rules of tests/test_torch_prepare_sim.py).
The shear field: calc_shearmark of both packages on the same np.random
stream agree at the shear's tolerance (tests/test_torch_shear.py: rtol 2e-4,
atol 1e-5 of the field's largest value); both mains then rank halos on
JAX's field (main reuses a saved field, as JAX's does), so the tables can
be held exactly. Staging equals JAX's key by key and bit for bit;
run_hod_pk_fused from AbacusHOD.from_config equals JAX's call at the
tolerance of tests/test_torch_abacus_hod.py (auto spectra rtol 2e-4, cross
spectra 2e-4 sqrt(P_ii P_jj), n_gal and the mode counts exact).
"""

import glob
import json
import os
import shutil
from concurrent.futures.process import BrokenProcessPool

import h5py
import numpy as np
import pytest
import yaml

from abacusutils_tpu.models.hod import prepare_sim as jps
from abacusutils_tpu.models.hod.abacus_hod import AbacusHOD as JaxAbacusHOD
from abacusutils_tpu_torch.models.hod import prepare_sim as tps
from abacusutils_tpu_torch.models.hod.abacus_hod import AbacusHOD
from abacusutils_tpu_torch.models.hod.staging import staging
from torch_disk import assert_tables_equal, config, exit_in_worker, jax_written_sim

PK_RTOL = 2e-4
SHEAR = 'shear_N32_R2_down1.npy'


def _savedir(cfg):
    sp = cfg['sim_params']
    return f'{sp["subsample_dir"]}{sp["sim_name"]}/z0.500'


def _port_main(cfg, jax_shear, path=None, **kw):
    os.makedirs(_savedir(cfg), exist_ok=True)
    shutil.copy(jax_shear, _savedir(cfg))
    tps.main(cfg if path is None else path, device='cpu', **kw)


@pytest.fixture(scope='module')
def disk(tmp_path_factory):
    root = tmp_path_factory.mktemp('disk')
    sim, _ = jax_written_sim(root)
    name = sim['header']['SimName']
    cfg = {k: config(root, name, k, engines) for k, engines in
           (('jax', 'host'), ('port_host', 'host'), ('port_device', 'auto'))}
    path = root / 'jax.yaml'
    with open(path, 'w') as f:
        yaml.safe_dump(cfg['jax'], f)
    np.random.seed(7)
    jps.main(str(path))
    jax_shear = f'{_savedir(cfg["jax"])}/{SHEAR}'
    _port_main(cfg['port_host'], jax_shear)
    _port_main(cfg['port_device'], jax_shear)
    return root, name, cfg, jax_shear


def _tables(savedir, i, ext):
    out = []
    for kind in ('halos', 'particles'):
        (fn,) = glob.glob(f'{savedir}/{kind}_xcom_{i}_seed600_abacushod_oldfenv_MT*_new.{ext}')
        out.append(fn)
    env = f'{savedir}/env_xcom_{i}_abacushod_localenv_new.{ext}'
    if ext == 'h5':
        with h5py.File(out[0]) as f, h5py.File(out[1]) as g, h5py.File(env) as e:
            return f['halos'][:], g['particles'][:], {k: e[k][:] for k in ('id', 'mass', 'Menv')}
    with np.load(out[0]) as f, np.load(out[1]) as g, np.load(env) as e:
        return f['halos'], g['particles'], {k: e[k] for k in ('id', 'mass', 'Menv')}


@pytest.mark.parametrize('engines', ['port_host', 'port_device'], ids=['host', 'device'])
def test_main_tables_match_jax(disk, engines):
    _, _, cfg, _ = disk
    names = sorted(os.path.basename(f) for f in glob.glob(f'{_savedir(cfg[engines])}/*.npz'))
    ref_names = sorted(os.path.basename(f) for f in glob.glob(f'{_savedir(cfg["jax"])}/*.h5'))
    assert names == [n[:-3] + '.npz' for n in ref_names] and len(names) == 9
    for i in range(3):
        ref = _tables(_savedir(cfg['jax']), i, 'h5')
        got = _tables(_savedir(cfg[engines]), i, 'npz')
        assert len(ref[1]) > 300 and ref[1]['ranks'].max() > 0 and ref[0]['shear_rank'].any()
        for g, r in zip(got, ref):
            assert_tables_equal(g, r, exact_menv=engines == 'port_host')


def test_calc_shearmark_matches_jax(disk, tmp_path):
    root, name, _, jax_shear = disk
    np.random.seed(7)
    got = tps.calc_shearmark(str(root), name, 0.5, 32, 2, str(tmp_path / 'shear'), 1,
                             device='cpu')
    ref = np.load(jax_shear)
    assert got.dtype == np.float32 and got.shape == (32,) * 3
    np.testing.assert_array_equal(np.load(tmp_path / 'shear.npy'), got)
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=1e-5 * float(np.abs(ref).max()))


def test_pool_and_json_config_match_serial(disk, tmp_path):
    """Nparallel_load 2 (spawned workers) from a JSON config on slabs 0 and 2:
    the serial run's tables, bit for bit."""
    _, _, cfg, jax_shear = disk
    pooled = json.loads(json.dumps(cfg['port_device']))
    pooled['sim_params']['subsample_dir'] = f'{tmp_path}/pool/'
    pooled['prepare_sim']['Nparallel_load'] = 2
    path = tmp_path / 'pool.json'
    path.write_text(json.dumps(pooled))
    _port_main(pooled, jax_shear, path=str(path), slabs=[0, 2])
    for i in (0, 2):
        for g, r in zip(_tables(_savedir(pooled), i, 'npz'),
                        _tables(_savedir(cfg['port_device']), i, 'npz')):
            if isinstance(r, dict):
                for k in r:
                    np.testing.assert_array_equal(g[k], r[k])
            else:
                assert g.dtype == r.dtype and g.tobytes() == r.tobytes()
    assert not glob.glob(f'{_savedir(pooled)}/*_1_*.npz')


def test_broken_pool_raises(disk, tmp_path, monkeypatch):
    """A pool worker that dies breaks the pool, and main raises: the JAX
    package reruns the slabs serially instead (prepare_sim.py:1005-1010)."""
    _, _, cfg, jax_shear = disk
    pooled = json.loads(json.dumps(cfg['port_device']))
    pooled['sim_params']['subsample_dir'] = f'{tmp_path}/broken/'
    pooled['prepare_sim']['Nparallel_load'] = 2
    monkeypatch.setattr(tps, 'prepare_slab', exit_in_worker)
    with pytest.raises(BrokenProcessPool):
        _port_main(pooled, jax_shear, slabs=[0, 1])


def _jax_hod(cfg):
    return JaxAbacusHOD(cfg['sim_params'], cfg['HOD_params'])


def test_staging_matches_jax(disk):
    _, _, cfg, _ = disk
    ref = _jax_hod(cfg['jax'])
    halo, part, params, mock_dir = staging(cfg['port_host']['sim_params'],
                                           cfg['port_host']['HOD_params'])
    assert mock_dir == ref.mock_dir and params == ref.params
    for got, want in ((halo, ref.halo_data), (part, ref.particle_data)):
        assert list(got) == list(want)
        for k in want:
            a = np.asarray(want[k])
            assert got[k].dtype == a.dtype and got[k].shape == a.shape, k
            np.testing.assert_array_equal(got[k], a, err_msg=k)
    assert np.abs(halo['hfenv']).max() > 0.4 and len(part['pinds']) > 1000


def test_from_config_run_hod_pk_fused_matches_jax(disk):
    _, _, cfg, _ = disk
    ref = _jax_hod(cfg['jax'])
    port = AbacusHOD.from_config(cfg['port_device']['sim_params'],
                                 cfg['port_device']['HOD_params'], device='cpu')
    assert port.mock_dir == ref.mock_dir and port.tracers == ref.tracers
    kw = dict(nmesh=32, nbins_k=16)
    (cl, ng), (cl_j, ng_j) = port.run_hod_pk_fused(**kw), ref.run_hod_pk_fused(**kw)
    assert ng == ng_j and all(v > 0 for v in ng.values()) and set(cl) == set(cl_j)
    np.testing.assert_array_equal(cl['k_binc'], cl_j['k_binc'])
    for t1 in ng:
        for t2 in ng:
            key = f'{t1}_{t2}'
            np.testing.assert_array_equal(cl[key + '_modes'], cl_j[key + '_modes'])
            scale = np.sqrt(np.abs(cl_j[f'{t1}_{t1}'] * cl_j[f'{t2}_{t2}']))
            assert (np.abs(cl[key] - cl_j[key]) <= PK_RTOL * scale).all(), key


def test_refusals(disk):
    _, _, cfg, _ = disk
    bad = json.loads(json.dumps(cfg['port_host']))
    bad['sim_params']['z_mock'] = 0.55
    with pytest.raises(ValueError, match='redshift'):
        tps.main(bad, device='cpu')
