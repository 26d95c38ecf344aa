"""The prepare_sim slice as a whole: abacusutils_tpu_torch's
prepare_slab_tables against the h5 files the JAX package's prepare_slab
writes from the same synthetic slab.

JAX's prepare_slab reads its slab through CompaSOHaloCatalog and its padded
env through load_env_halos; both are replaced here by functions that serve
synthetic abacusutils_tpu.io.table.Table catalogs (nothing in the JAX
package changes). Its h5 output is read back and held against the port's
columns, run with the device engines (their plain versions on the CPU) and
with the 'host' engines: every column with its dtype exact (masks,
multi_halos, the randoms, fenv, deltac and shear ranks, the particles' halo
columns), the rank fields exact and ranksc tie-aware (the NN rank's mutual
nearest neighbours tie), the env sidecar's Menv at rtol 1e-12 with the same
zeros.
"""

import h5py
import numpy as np
import numpy.testing as npt
import pytest

from abacusutils_tpu.io.table import Table
from abacusutils_tpu.models.hod import prepare_sim as jps
from abacusutils_tpu_torch.models.hod import prepare_sim as tps

LBOX = 200.0
MPART = 2e9
NUMSLABS = 2
NEWSEED = 600
HEADER = {'BoxSizeHMpc': LBOX, 'ParticleMassHMsun': MPART, 'H0': 67.36,
          'LightConeOrigins': [0.0, 0.0, 0.0]}


def _halos(rng, n, x_lo, x_hi, id0, lc=False):
    """A halo table with its A-subsample particles laid out halo by halo;
    a few halos have N = 0 (dropped by cleaning)."""
    N = np.exp(rng.uniform(np.log(40), np.log(20000), n)).astype(np.int64)
    N[rng.random(n) < 0.03] = 0
    if lc:
        u = rng.normal(size=(n, 3))
        pos = u / np.linalg.norm(u, axis=1)[:, None] * rng.uniform(40, 85, n)[:, None]
    else:
        pos = np.stack([rng.uniform(x_lo, x_hi, n), rng.uniform(-LBOX / 2, LBOX / 2, n),
                        rng.uniform(-LBOX / 2, LBOX / 2, n)], 1)
        # clumps, so Menv has neighbours
        pos[: n // 2, 1:] = pos[n // 4: 3 * n // 4, 1:] * 0.05
    pos = pos.astype(np.float32)
    npout = np.minimum(N // 25, 60).astype(np.int64)
    cols = {
        'N': N, 'x_L2com': pos, 'v_L2com': rng.normal(0, 300, (n, 3)).astype(np.float32),
        'r90_L2com': rng.uniform(0.1, 0.8, n).astype(np.float32),
        'r25_L2com': rng.uniform(0.03, 0.2, n).astype(np.float32),
        'r98_L2com': rng.uniform(0.3, 1.5, n).astype(np.float32),
        'npstartA': np.concatenate([[0], np.cumsum(npout)[:-1]]), 'npoutA': npout,
        'id': np.arange(id0, id0 + n, dtype=np.int64),
        'sigmav3d_L2com': rng.uniform(50, 400, n).astype(np.float32),
    }
    if lc:
        cols = {{'N': 'N_interp', 'x_L2com': 'pos_interp', 'v_L2com': 'vel_interp',
                 'id': 'index_halo'}.get(k, k): v for k, v in cols.items()}
    ntot = int(npout.sum())
    owner = np.repeat(np.arange(n), npout)
    parts = {'pos': (pos[owner] + rng.normal(0, 0.3, (ntot, 3))).astype(np.float32),
             'vel': rng.normal(0, 200, (ntot, 3)).astype(np.float32)}
    return cols, parts


def _slabs(lc):
    rng = np.random.default_rng(21 if lc else 20)
    if lc:
        return [_halos(rng, 1500, 0, 0, 0, lc=True)]
    edges = np.linspace(-LBOX / 2, LBOX / 2, NUMSLABS + 1)
    return [_halos(rng, 900, edges[s], edges[s + 1], 10**6 * (s + 1)) for s in range(NUMSLABS)]


def _run_jax(tmp_path, monkeypatch, slabs, i, lc, shearmark):
    class Catalog:
        def __init__(self, slabname, subsamples=False, fields=None, cleaned=True,
                     filter_func=None):
            s = 0 if lc else int(slabname.split('_')[-1].split('.')[0])
            halos, parts = slabs[s]
            self.halos = Table(halos)
            self.subsamples = Table(parts)
            self.header = HEADER
            self.halo_lc = lc

    def load_env(slabname, cleaning, filter_func=None):
        t = Catalog(slabname).halos
        if cleaning:
            t = t[t['N'] > 0]
        return t[filter_func(t)] if filter_func is not None else t

    monkeypatch.setattr(jps, 'CompaSOHaloCatalog', Catalog)
    monkeypatch.setattr(jps, 'load_env_halos', load_env)
    jps.prepare_slab(
        i, savedir=str(tmp_path), simdir=str(tmp_path), simname='Synthetic', z_mock=0.5,
        z_type='lightcone' if lc else 'primary', tracer_flags={'LRG': True, 'ELG': True},
        MT=True, want_ranks=True, want_AB=True, want_shear=True, shearmark=shearmark,
        cleaning=True, newseed=NEWSEED, halo_lc=lc, numslabs=NUMSLABS,
    )
    stem = f'{tmp_path}/%s_xcom_{i}_seed{NEWSEED}_abacushod_oldfenv_MT'
    with h5py.File(stem % 'halos' + '_new.h5') as f:
        halos = f['halos'][:]
    with h5py.File(stem % 'particles' + '_withranks_new.h5') as f:
        parts = f['particles'][:]
    env = None
    if not lc:
        with h5py.File(f'{tmp_path}/env_xcom_{i}_abacushod_localenv_new.h5') as f:
            env = {k: f[k][:] for k in ('id', 'mass', 'Menv')}
    return halos, parts, env


def _port(slabs, i, lc, shearmark, engine):
    halos, parts = slabs[0 if lc else i]
    env_halos = None
    if not lc:
        env_halos = []
        for s, keep in tps.env_pad_slabs(halos['x_L2com'][:, 0], i, NUMSLABS, LBOX, 10):
            t = {k: v[slabs[s][0]['N'] > 0] for k, v in slabs[s][0].items()}
            env_halos.append({k: v[keep(t)] for k, v in t.items()})
    return tps.prepare_slab_tables(
        halos, parts, HEADER, i=i, MT=True, want_ranks=True, want_AB=True, want_shear=True,
        shearmark=shearmark, newseed=NEWSEED, halo_lc=lc, env_halos=env_halos, cleaning=True,
        ranks_engine=engine, menv_engine=engine, device='cpu',
    )


@pytest.mark.parametrize('lc', [False, True], ids=['box', 'light cone'])
def test_prepare_slab_tables_match_jax_prepare_slab(lc, tmp_path, monkeypatch):
    slabs = _slabs(lc)
    i = 0
    shearmark = np.random.default_rng(5).random((16, 16, 16)).astype(np.float32)
    halos_j, parts_j, env_j = _run_jax(tmp_path, monkeypatch, slabs, i, lc, shearmark)
    assert len(parts_j) > 1000 and parts_j['ranks'].max() > 0
    for engine in ('auto', 'host'):
        out = _port(slabs, i, lc, shearmark, engine)
        assert list(out['halos']) == list(halos_j.dtype.names)
        assert list(out['particles']) == list(parts_j.dtype.names)
        for name in halos_j.dtype.names:
            got = out['halos'][name]
            assert got.dtype == halos_j[name].dtype, name
            npt.assert_array_equal(got, halos_j[name], err_msg=f'{engine} halos {name}')
        for name in parts_j.dtype.names:
            got = out['particles'][name]
            assert got.dtype == parts_j[name].dtype, name
            if name != 'ranksc':
                npt.assert_array_equal(got, parts_j[name], err_msg=f'{engine} particles {name}')
        # ranksc: mutual nearest neighbours tie; the rank multisets of each
        # halo are equal, and nearly every rank is
        got = out['particles']['ranksc']
        for hid in np.unique(parts_j['halo_id']):
            m = parts_j['halo_id'] == hid
            npt.assert_array_equal(np.sort(got[m]), np.sort(parts_j['ranksc'][m]))
        assert (got == parts_j['ranksc']).mean() > 0.9
        if lc:
            assert out['env'] is None
            assert np.abs(halos_j['fenv_rank']).max() > 0
            continue
        for k in ('id', 'mass'):
            npt.assert_array_equal(out['env'][k], env_j[k])
            assert out['env'][k].dtype == env_j[k].dtype
        npt.assert_allclose(out['env']['Menv'], env_j['Menv'], rtol=1e-12, atol=0.0)
        npt.assert_array_equal(out['env']['Menv'] == 0, env_j['Menv'] == 0)
        assert np.count_nonzero(env_j['Menv']) > 10


def test_engine_names():
    with pytest.raises(ValueError, match='float64'):
        tps._do_menv('device-exact32', np.zeros((2, 3)), np.ones(2), 0.1, 1.0, False, 10.0)
    with pytest.raises(ValueError, match='float64'):
        tps.prepare_slab_tables({}, None, HEADER, i=0, MT=True, want_ranks=True, want_AB=False,
                                want_shear=False, shearmark=None, newseed=1, halo_lc=False,
                                ranks_engine='device-exact32')
    with pytest.raises(ValueError, match='unknown'):
        tps._do_menv('gpu', np.zeros((2, 3)), np.ones(2), 0.1, 1.0, False, 10.0)
    pos = np.random.default_rng(1).random((50, 3)).astype(np.float32) * 20
    mass = np.full(50, 2e12)
    npt.assert_array_equal(
        tps._do_menv('device-x64', pos, mass, 0.5, 5.0, False, 20.0, device='cpu'),
        tps._do_menv('device', pos, mass, 0.5, 5.0, False, 20.0, device='cpu'))
