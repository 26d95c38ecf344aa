"""Port parity for NFW satellites and the ECSV catalogs: gen_sats_nfw,
AbacusHOD.run_hod(want_nfw=True) (also at a secondary redshift),
run_hod(write_to_disk=True) and gal_reader of abacusutils_tpu_torch against
the JAX package on one synthetic staged state (tests/torch_helpers.py), and
the port's Table against the JAX package's Table in both directions.

Tolerances: NFW satellites bit-equal (the same host numpy on one PCG64
stream, the same halo columns and keep codes); centrals as
tests/test_torch_run_hod.py holds them (keep codes exact, 0 flips;
positions within atol 1e-5 + 2 f32 ulps, velocities within 2 f32 ulps of
the column's largest value: the port populates in f32, JAX under x64 in
f64); tables bit for bit, columns and meta, and the port's file byte for
byte the JAX writer's.
"""

import logging

import numpy as np
import numpy.testing as npt
import pytest
import torch

from abacusutils_tpu.io.table import Table as JaxTable
from abacusutils_tpu.models.hod import nfw as jnfw
from abacusutils_tpu.models.hod import population as jpop
from abacusutils_tpu.models.hod.abacus_hod import AbacusHOD as JaxAbacusHOD
from abacusutils_tpu_torch.convert import staged_state_from_numpy
from abacusutils_tpu_torch.io.table import Table
from abacusutils_tpu_torch.models.hod import nfw as tnfw
from abacusutils_tpu_torch.models.hod import population as tpop
from abacusutils_tpu_torch.testing import nfw_draw
from torch_helpers import TRACERS, staged_state

LBOX, Z, SIM = 500.0, 0.5, 'AbacusSummit_base_c000_ph000'
EPS32 = float(np.finfo(np.float32).eps)
C_MAX = 30.0
WANT = ('LRG', 'ELG', 'QSO')


def _tracers():
    tr = {k: dict(v) for k, v in TRACERS.items()}
    for p in tr.values():
        p.update(Acent=0.05, Asat=-0.1, Bcent=0.03, Bsat=0.05, f_sigv=0.8)
    tr['ELG'].update(Ccent=0.1, Csat=-0.1, logM1_EE=13.1, logM1_EL=13.8)
    return tr


@pytest.fixture(scope='module')
def fix():
    halo, _ = staged_state(20_000, 0, LBOX, seed=71)
    rng = np.random.default_rng(72)
    # the staged catalogs' ranges: c = r98 / r25 of a few, r98 up to ~2 Mpc/h
    halo['hc'] = rng.uniform(2.0, 12.0, len(halo['hmass']))
    halo['hrvir'] = 0.2 * (halo['hmass'] / 1e12) ** (1 / 3)
    empty = {k: np.empty(0) for k in ('ppos', 'pvel', 'phvel', 'phmass', 'pweights', 'prandoms',
                                      'pranks', 'pranksv', 'pranksp', 'pranksr', 'pranksc')}
    empty['phid'] = np.empty(0, np.int64)
    empty['pinds'] = np.empty(0, np.int64)
    return dict(halo=halo, part=empty, draw=nfw_draw(100_000, C_MAX, 73))


def _pair(fix, tmp_path, z_type='secondary'):
    """(JAX AbacusHOD, port AbacusHOD) on copies of the fixture's state,
    both writing catalogs under tmp_path/out/SIM/z0.500."""
    params = {'z': Z, 'Lbox': LBOX, 'velz2kms': 100.0, 'origin': None, 'chunk': -1}
    flags = dict(want_ranks=False, want_shear=True, want_expvel=False, halo_lc=False,
                 z_type=z_type)
    mock_dir = tmp_path / 'out' / SIM / f'z{Z:.3f}'
    jball = object.__new__(JaxAbacusHOD)
    hmass = fix['halo']['hmass']
    jball.__dict__.update(
        halo_data=dict(fix['halo']), particle_data=dict(fix['part']), params=dict(params),
        tracers=_tracers(), lbox=LBOX, z_mock=Z, want_AB=True,
        logger=logging.getLogger('AbacusHOD'), _fused_stage=None, mock_dir=str(mock_dir),
        output_dir=str(tmp_path / 'out'), sim_name=SIM,
        logMbins=np.linspace(np.log10(hmass.min()), np.log10(hmass.max()), 101),
        deltacbins=np.linspace(-0.5, 0.5, 101), fenvbins=np.linspace(-0.5, 0.5, 101),
        shearbins=np.linspace(-0.5, 0.5, 101), **flags,
    )
    port = staged_state_from_numpy(fix['halo'], fix['part'], params, _tracers(), flags, 'cpu',
                                   mock_dir=mock_dir)
    return jball, port


def _seeded_rng(monkeypatch, seed):
    """Both packages' np.random.default_rng replaced by one seeded factory."""
    make = np.random.default_rng
    monkeypatch.setattr(np.random, 'default_rng', lambda *a, **k: make(seed))


def _assert_equal_cat(got, ref, what):
    """Equal column sets, dtypes and bits (Ncent, an int, equal)."""
    assert set(got) == set(ref), what
    assert got.get('Ncent') == ref.get('Ncent'), what
    for k, r in ref.items():
        if k == 'Ncent':
            continue
        assert got[k].dtype == r.dtype, f'{what} {k}: {got[k].dtype} vs {r.dtype}'
        npt.assert_array_equal(got[k], r, err_msg=f'{what} {k}')


@pytest.mark.parametrize('exp_frac', [0.0, 0.3])
@pytest.mark.parametrize('rsd', [True, False])
def test_gen_sats_nfw_bit_equal(fix, exp_frac, rsd):
    """gen_sats_nfw of both packages at one seed, LRG, ELG and QSO, with and
    without the exponential mixture and RSD."""
    tr = _tracers()
    for p in tr.values():
        p.update(exp_frac=exp_frac, exp_scale=0.7, nfw_rescale=0.9)
    tp = jpop.prepare_tracer_params(tr, Z)
    keep = np.random.default_rng(5).integers(0, 4, len(fix['halo']['hmass'])).astype(np.int8)
    args = (fix['draw'], fix['halo'], tp, WANT, rsd, 0.01, LBOX, keep, {})
    ref = jnfw.gen_sats_nfw(*args, seed=11)
    got = tnfw.gen_sats_nfw(*args, seed=11)
    assert list(got) == list(ref) == list(WANT)
    for t in WANT:
        assert len(ref[t]['x']) > 100, t
        _assert_equal_cat(got[t], ref[t], t)
    # the same draws from the numpy columns' tensors
    halo_t = {k: torch.from_numpy(np.asarray(v)) for k, v in fix['halo'].items()}
    got_t = tnfw.gen_sats_nfw(fix['draw'], halo_t, tp, WANT, rsd, 0.01, LBOX, keep, {}, seed=11)
    for t in WANT:
        _assert_equal_cat(got_t[t], ref[t], f'{t} (tensor columns)')
    r = np.random.default_rng(3)
    npt.assert_array_equal(tnfw.getPointsOnSphere(50, seed=4), jnfw.getPointsOnSphere(50, seed=4))
    x = r.uniform(11, 15, 20)
    npt.assert_array_equal(tnfw.phi_fun(x, 12.0, 0.3), jnfw.phi_fun(x, 12.0, 0.3))
    npt.assert_array_equal(tnfw.Phi_fun(x, 12.0, 0.3, 1.2), jnfw.Phi_fun(x, 12.0, 0.3, 1.2))


def test_compute_fast_nfw_bit_equal(fix):
    h = fix['halo']
    n = 300
    num_sat = np.random.default_rng(6).poisson(1.5, n)
    rd = np.random.default_rng(7).normal(size=(int(num_sat.sum()), 3))
    args = (fix['draw'], h['hid'][:n], *(h['hpos'][:n, i] for i in range(3)),
            *(h['hvel'][:n, i] for i in range(3)), h['hsigma3d'][:n], h['hc'][:n],
            h['hmass'][:n], h['hrvir'][:n], rd, num_sat, 0.8)
    ref = jnfw.compute_fast_NFW(*args, exp_frac=0.2, seed=9)
    got = tnfw.compute_fast_NFW(*args, exp_frac=0.2, seed=9)
    for g, r in zip(got, ref):
        npt.assert_array_equal(g, r)


def _assert_nfw_mock(got, ref):
    """Centrals as test_torch_run_hod.py holds them, satellites bit-equal."""
    assert list(got) == list(ref)
    for t, r in ref.items():
        g, nc = got[t], r['Ncent']
        assert g['Ncent'] == nc and len(g['x']) == len(r['x']) > nc, t
        assert g['id'].dtype == np.int64
        npt.assert_array_equal(g['id'], r['id'])
        npt.assert_array_equal(g['mass'], r['mass'])
        for k in ('x', 'y', 'z', 'vx', 'vy', 'vz'):
            assert g[k].dtype == r[k].dtype == np.float64, (t, k)
            npt.assert_array_equal(g[k][nc:], r[k][nc:], err_msg=f'{t} {k} satellites')
            atol = 1e-5 if k in 'xyz' else 2 * EPS32 * np.abs(r[k][:nc]).max()
            rtol = 2 * EPS32 if k in 'xyz' else 0
            npt.assert_allclose(g[k][:nc], r[k][:nc], rtol=rtol, atol=atol,
                                err_msg=f'{t} {k} centrals')


@pytest.mark.parametrize('rsd', [True, False])
def test_run_hod_nfw_matches_jax(fix, tmp_path, monkeypatch, rsd):
    """run_hod(want_nfw=True) of both packages at a secondary redshift (no
    particles) with default_rng seeded alike; gen_gals(nfw=True) and a
    primary redshift give the same catalog."""
    jball, port = _pair(fix, tmp_path)
    _seeded_rng(monkeypatch, 21)
    ref = jball.run_hod(want_rsd=rsd, want_nfw=True, NFW_draw=fix['draw'])
    got = port.run_hod(want_rsd=rsd, want_nfw=True, NFW_draw=fix['draw'])
    _assert_nfw_mock(got, ref)
    assert port._flat_stage_cache[1][1] is None  # no particle was staged
    again = tpop.gen_gals(fix['halo'], None, _tracers(), port.params, rsd=rsd, nfw=True,
                          NFW_draw=fix['draw'], device='cpu')
    for t in got:
        _assert_equal_cat(again[t], got[t], t)
    with pytest.raises(RuntimeError, match='Secondary'):
        port.run_hod()
    with pytest.raises(ValueError, match='NFW_draw'):
        port.run_hod(want_nfw=True)


def test_tables_round_trip_both_ways(tmp_path):
    rng = np.random.default_rng(8)
    cols = {'x': rng.normal(size=200).astype(np.float32), 'vx': rng.normal(0, 300, 200),
            'mass': 10 ** rng.uniform(11, 15, 200), 'id': rng.integers(0, 2**62, 200),
            'n': rng.integers(-5, 5, 200).astype(np.int32)}
    meta = {'Ncent': 17, 'Gal_type': 'ELG', 'logM_cut': 11.6, 'kappa': 1.0, 'tiny': 1e-17,
            'huge': 3e20, 'f32': np.float32(0.1), 'flag': True, 'none': None, 'word': 'yes',
            'num': '1.5', 'neg': -2}
    Table(cols, meta=meta).write(tmp_path / 'port.dat')
    JaxTable(cols, meta=meta).write(tmp_path / 'jax.dat')
    assert (tmp_path / 'port.dat').read_bytes() == (tmp_path / 'jax.dat').read_bytes()
    for got, ref in ((JaxTable.read(tmp_path / 'port.dat'), Table.read(tmp_path / 'jax.dat')),
                     (Table.read(tmp_path / 'port.dat'), JaxTable.read(tmp_path / 'jax.dat'))):
        assert got.colnames == ref.colnames == list(cols)
        for k, c in cols.items():
            _assert_equal_cat({k: got[k]}, {k: c}, 'column')
            _assert_equal_cat({k: ref[k]}, {k: c}, 'column')
        assert got.meta == ref.meta
        assert got.meta['f32'] == float(np.float32(0.1)) and got.meta['word'] == 'yes'
    t = Table.read(tmp_path / 'port.dat')
    assert len(t) == 200 and len(t[:5]) == 5 and t[['x', 'id']].colnames == ['x', 'id']
    # strings PyYAML may write in another style still read back alike
    odd = {'quote': "it's", 'colon': 'a: b', 'space': 'two words', 'empty': ''}
    Table(cols, meta=odd).write(tmp_path / 'odd.dat')
    assert JaxTable.read(tmp_path / 'odd.dat').meta == Table.read(tmp_path / 'odd.dat').meta == odd
    with pytest.raises(NotImplementedError):
        Table({'a': np.zeros(3)}, meta={'nested': {'b': 1}}).write(tmp_path / 'bad.dat')


@pytest.mark.parametrize('chunk', [-1, 2])
def test_write_to_disk_and_gal_reader(fix, tmp_path, monkeypatch, chunk):
    """run_hod(write_to_disk=True) of both packages into the same layout
    (galaxies{_rsd}{fn_ext}/{tracer}s.dat, or _chunk{n}), the port's tables
    read by JAX's Table and the JAX tables by the port's, and gal_reader of
    both on the same directory."""
    jball, port = _pair(fix, tmp_path / 'p')
    jball_j, _ = _pair(fix, tmp_path / 'j')
    for b in (jball, jball_j, port):
        b.params['chunk'] = chunk
    _seeded_rng(monkeypatch, 23)
    got = port.run_hod(want_nfw=True, NFW_draw=fix['draw'], write_to_disk=True, fn_ext='_v1')
    ref = jball_j.run_hod(want_nfw=True, NFW_draw=fix['draw'], write_to_disk=True, fn_ext='_v1')
    name = 's.dat' if chunk == -1 else f's_chunk{chunk}.dat'
    for t in WANT:
        fp = port.mock_dir / 'galaxies_rsd_v1' / f'{t}{name}'
        fj = tmp_path / 'j' / 'out' / SIM / f'z{Z:.3f}' / 'galaxies_rsd_v1' / f'{t}{name}'
        assert fp.exists() and fj.exists()
        for tab in (JaxTable.read(fp), Table.read(fj)):
            assert tab.meta['Ncent'] == got[t]['Ncent'] == ref[t]['Ncent']
            assert tab.meta['Gal_type'] == t and tab.meta['logM_cut'] == _tracers()[t]['logM_cut']
        jt = JaxTable.read(fp)
        _assert_equal_cat({k: jt[k] for k in jt.colnames},
                          {k: v for k, v in got[t].items() if k != 'Ncent'}, t)
    if chunk != -1:
        return
    # gal_reader reads galaxies{_rsd} without fn_ext, as the JAX one does
    _seeded_rng(monkeypatch, 23)
    port.run_hod(want_nfw=True, NFW_draw=fix['draw'], write_to_disk=True, want_rsd=False)
    jball.run_hod(want_nfw=True, NFW_draw=fix['draw'], want_rsd=False)
    mine = port.gal_reader(want_rsd=False)
    theirs = jball.gal_reader(want_rsd=False)
    again = port.gal_reader(output_dir=tmp_path / 'p' / 'out', simname=SIM, want_rsd=False)
    for t in WANT:
        for tab in (theirs[t], again[t]):
            assert tab.meta == mine[t].meta
            _assert_equal_cat({k: tab[k] for k in tab.colnames},
                              {k: mine[t][k] for k in mine[t].colnames}, t)
    port.mock_dir = None
    with pytest.raises(ValueError, match='mock_dir'):
        port.run_hod(want_nfw=True, NFW_draw=fix['draw'], write_to_disk=True)
    with pytest.raises(ValueError, match='mock_dir'):
        port.gal_reader()


def test_gen_gal_cat_writes_what_jax_writes(fix, tmp_path, monkeypatch):
    """gen_gal_cat(nfw=True, write_to_disk=True) of both packages: the same
    files, read back with the JAX Table, hold the same ids and Ncent and
    bit-equal satellite rows (centrals as _assert_nfw_mock holds them)."""
    params = {'z': Z, 'Lbox': LBOX, 'velz2kms': 100.0, 'origin': None}
    kw = dict(nfw=True, NFW_draw=fix['draw'], write_to_disk=True, fn_ext='_a')
    _seeded_rng(monkeypatch, 29)
    got = tpop.gen_gal_cat(fix['halo'], fix['part'], _tracers(), params, savedir=tmp_path / 'p',
                           device='cpu', **kw)
    ref = jpop.gen_gal_cat(fix['halo'], fix['part'], _tracers(), params, savedir=tmp_path / 'j',
                           **kw)
    _assert_nfw_mock(got, ref)
    for t in WANT:
        a, b = (JaxTable.read(tmp_path / d / 'galaxies_rsd_a' / f'{t}s.dat') for d in 'pj')
        assert a.colnames == b.colnames and a.meta == b.meta
        _assert_nfw_mock({t: dict(a.columns, Ncent=a.meta['Ncent'])},
                         {t: dict(b.columns, Ncent=b.meta['Ncent'])})
    with pytest.raises(ValueError, match='boolean'):
        tpop.gen_gal_cat(fix['halo'], fix['part'], _tracers(), params, rsd=1, device='cpu')
