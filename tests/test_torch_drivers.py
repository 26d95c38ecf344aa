"""Port parity for the scripts under scripts/torch/: generate_cf, the
likelihood of run_emcee / run_nested, bench_ranks and bench_multitracer's
step, each against the JAX package's script on the same numpy inputs, and
the attributes AbacusHOD.from_config takes from a config, against the JAX
constructor's.

Tolerances: pair counts and galaxy counts exact; xi and the log-likelihood
at rtol 1e-12 (equal integer counts, then float64 host arithmetic in
another order of operations, as tests/test_torch_clustering.py); the
spectra at tests/test_torch_multi.py's budget (auto rtol 2e-4, cross 2e-4
sqrt(P_ii P_jj)); ranks with 0 flips against the host loop.
"""

import importlib.util
import sys
from pathlib import Path

import numpy as np
import numpy.testing as npt
import pytest
import torch

from abacusutils_tpu.models.hod import population as jpop
from abacusutils_tpu.ops import tpcf as jtpcf
from abacusutils_tpu_torch.io.asdf_file import open_asdf
from abacusutils_tpu_torch.models import pipeline as tpipe
from abacusutils_tpu_torch.models.hod import staging as tstaging
from abacusutils_tpu_torch.models.hod.abacus_hod import AbacusHOD
from abacusutils_tpu_torch.ops import tpcf as ttpcf
from abacusutils_tpu_torch.ops.power import get_W_compensated
from abacusutils_tpu_torch.testing import synthetic_compaso, write_compaso_sim
from test_torch_multi import _assert_spectra, _jax_multi
from test_torch_run_hod import LBOX, _pair
from torch_helpers import TRACERS, catalog_tensors, linked_inputs, staged_state

REPO = Path(__file__).resolve().parent.parent
RTOL = 1e-12


def _load(path, name, extra_path=None):
    """The script at `path` (relative to the repo) as module `name`."""
    if name in sys.modules:
        return sys.modules[name]
    if extra_path is not None and str(REPO / extra_path) not in sys.path:
        sys.path.insert(0, str(REPO / extra_path))
    spec = importlib.util.spec_from_file_location(name, REPO / path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _port(path):
    return _load(f'scripts/torch/{path}.py', 'torch_script_' + path.replace('/', '_'))


def _jax(path):
    """A JAX script; the HOD scripts import their sibling `likelihood`."""
    return _load(f'scripts/{path}.py', 'jax_script_' + path.replace('/', '_'),
                 extra_path=str(Path('scripts', path).parent))


@pytest.fixture
def cell_engine(monkeypatch):
    """Both packages count with their cell engine (float32 in both, whatever
    JAX's x64 flag), as tests/test_torch_clustering.py does."""
    monkeypatch.setattr(jtpcf, '_CELL_MIN_N', 100)
    monkeypatch.setattr(ttpcf, '_CELL_MIN_N', 100)
    monkeypatch.setattr(ttpcf, '_JAX_CELL_MIN_N', 100)
    ttpcf._stage_cache.clear()
    yield
    ttpcf._stage_cache.clear()


# ---- AbacusHOD.from_config ---------------------------------------------------


CLUSTERING = [
    {'clustering_type': 'xirppi', 'bin_params': {'logmin': -0.77, 'logmax': 1.47, 'nbins': 8},
     'pimax': 30, 'pi_bin_size': 5},
    {'bin_params': {'logmin': -1.0, 'logmax': 1.5, 'nbins': 5}},
    None,
]


@pytest.mark.parametrize('want_rsd', [True, False])
@pytest.mark.parametrize('case', range(len(CLUSTERING)))
def test_from_config_attributes_match_jax(case, want_rsd, monkeypatch):
    """want_rsd, pimax, pi_bin_size, rpbins and clustering_type of
    from_config equal the JAX constructor's for the same config (the port's
    staging replaced by a synthetic staged state: no files)."""
    from abacusutils_tpu.models.hod.abacus_hod import AbacusHOD as JaxAbacusHOD

    halo, part = staged_state(500, 2000, LBOX, seed=3)
    params = {'z': 0.5, 'Lbox': LBOX, 'velz2kms': 100.0, 'origin': None, 'chunk': -1}
    monkeypatch.setattr(tstaging, 'staging', lambda *a: (halo, part, params, None))
    sim = {'sim_name': 'AbacusSummit_base_c000_ph000', 'sim_dir': 'sims/',
           'subsample_dir': 'subs/', 'z_mock': 0.5, 'output_dir': 'mocks/'}
    hod_params = {'tracer_flags': {'LRG': True, 'ELG': False}, 'want_rsd': want_rsd,
                  'LRG_params': dict(TRACERS['LRG']), 'ELG_params': dict(TRACERS['ELG'])}
    clustering = CLUSTERING[case]
    ref = JaxAbacusHOD(sim, hod_params, clustering, skip_staging=True)
    got = AbacusHOD.from_config(sim, hod_params, clustering, device='cpu')
    assert got.want_rsd is ref.want_rsd is want_rsd
    assert list(got.tracers) == list(ref.tracers) == ['LRG']
    names = ('pimax', 'pi_bin_size', 'rpbins', 'clustering_type')
    if clustering is None:
        assert not any(hasattr(ref, k) for k in names)
        assert not any(hasattr(got, k) for k in names[:3]) and got.clustering_type is None
        return
    for k in names[:2] + names[3:]:
        assert getattr(got, k) == getattr(ref, k), k
    npt.assert_array_equal(got.rpbins, ref.rpbins)


# ---- generate_cf --------------------------------------------------------------


@pytest.fixture(scope='module')
def halo_catalog(tmp_path_factory):
    """A synthetic CompaSO redshift directory written by JAX's writer."""
    from abacusutils_tpu.io.asdf_file import write_asdf as jax_write_asdf

    root = tmp_path_factory.mktemp('cf')
    sim = synthetic_compaso(2, 3000, 2000, 100, seed=9)
    return write_compaso_sim(root, sim, writer=jax_write_asdf)['groupdir']


def test_generate_cf_matches_jax(halo_catalog, cell_engine, tmp_path):
    """prepare_cat + generate_cf of both scripts on one catalog: the same
    selection, npairs equal, xi at RTOL; the port's file reads back through
    JAX's open_asdf with its meta, and main writes it."""
    from abacusutils_tpu.io.asdf_file import open_asdf as jax_open_asdf

    port, ref_mod = _port('emulator/generate_cf'), _jax('emulator/generate_cf')
    ndens = 2500 / 2000.0**3
    cat = port.prepare_cat(halo_catalog, ndens)
    ref_cat = ref_mod.prepare_cat(halo_catalog, ndens)
    assert len(cat.halos) == len(ref_cat.halos) == 2500
    npt.assert_array_equal(cat.halos['N'], ref_cat.halos['N'])
    npt.assert_array_equal(cat.halos['x_L2com'], ref_cat.halos['x_L2com'])
    cf = port.generate_cf(cat, device='cpu')
    ref = ref_mod.generate_cf(ref_cat)
    assert cf.colnames == list(ref.colnames)
    assert cf['npairs'].dtype == np.uint64 and int(cf['npairs'].sum()) > 100
    npt.assert_array_equal(cf['npairs'], np.asarray(ref['npairs']))
    npt.assert_allclose(cf['xi'], np.asarray(ref['xi']), rtol=RTOL)
    assert cf.meta['zname'] == ref.meta['zname'] == 'z0.500'

    fn = port.main(halo_catalog, ndens=ndens, nthread=2, outdir=tmp_path, device='cpu')
    assert fn == tmp_path / 'AbacusSummit_base_c000_ph000-z0.500-cf.asdf'
    back = jax_open_asdf(fn)
    data = back['data']
    for k in cf.colnames:
        npt.assert_array_equal(np.asarray(data[k]), cf[k], err_msg=k)
    assert data.meta['zname'] == 'z0.500' and data.meta['BoxSize'] == 2000.0
    assert back['generate_cf_args']['ndens'] == ndens
    with open_asdf(fn) as af:
        npt.assert_array_equal(np.asarray(af['data']['npairs']), cf['npairs'])


# ---- the likelihood -----------------------------------------------------------


def _data_files(tmp_path, combos, nrp, npi):
    """data_params of a data vector of xi = 0.5 for each combination and an
    identity covariance, as .npz files."""
    out = {}
    for combo in combos:
        np.savez(tmp_path / f'{combo}_xi.npz', xirppi=np.full((nrp, npi), 0.5))
        np.savez(tmp_path / f'{combo}_cov.npz', cov=np.eye(nrp * npi))
        out[combo] = {'path2power': str(tmp_path / f'{combo}_xi.npz'),
                      'path2cov': str(tmp_path / f'{combo}_cov.npz')}
    return {'tracer_combos': out}


@pytest.mark.parametrize('sampler', ['run_emcee', 'run_nested'])
def test_lnprob_matches_jax(sampler, cell_engine, tmp_path):
    """Both packages' lnprob on the same Data and the same staged state (the
    JAX AbacusHOD made with object.__new__, the port's by
    staged_state_from_numpy), the second of the fitted parameters on ELG."""
    port, ref_mod = _port(f'hod/{sampler}'), _jax(f'hod/{sampler}')
    jax_hod, port_hod = _pair(staged_state(5_000, 20_000, LBOX, seed=17), False, False)
    rpbins = np.logspace(-1, np.log10(30), 7)
    for hod in (jax_hod, port_hod):
        hod.__dict__.update(want_rsd=True, rpbins=rpbins, pimax=30, pi_bin_size=5,
                            clustering_type='xirppi')
    data_params = _data_files(tmp_path, ['LRG_LRG', 'LRG_ELG'], 6, 6)
    data = port.Data(data_params, {})
    ref_data = ref_mod.Data(data_params, {})
    mapping = {'logM_cut': 0, 'alpha': 1}
    tracer = {'logM_cut': 'LRG', 'alpha': 'ELG'}
    p = np.array([12.7, 0.9])
    got = port.lnprob(p, mapping, tracer, data, port_hod)
    ref = ref_mod.lnprob(p, mapping, tracer, ref_data, jax_hod)
    assert got < 0 and np.isfinite(got)
    npt.assert_allclose(got, ref, rtol=RTOL)
    assert port_hod.tracers['ELG']['alpha'] == 0.9 and port_hod.tracers['LRG']['logM_cut'] == 12.7


def test_samplers_exit_without_their_package(monkeypatch):
    """main raises SystemExit with JAX's message where the sampler is not
    installed (it is imported by main only)."""
    for sampler, package in (('run_emcee', 'emcee'), ('run_nested', 'dynesty')):
        monkeypatch.setitem(sys.modules, package, None)
        with pytest.raises(SystemExit, match=f'{package} is not installed in this environment'):
            _port(f'hod/{sampler}').main('no_config.json')


# ---- the benches --------------------------------------------------------------


def test_bench_ranks_has_no_flips():
    """The JAX script's synthetic slab, draw for draw, and 0 flips between
    the device engine (its plain versions here) and the host loop."""
    port, ref = _port('hod/bench_ranks'), _jax('hod/bench_ranks')
    for a, b in zip(port.synth_slab(3000), ref.synth_slab(3000)):
        npt.assert_array_equal(a, b)
    out = port.run(12_000, host=True, verbose=False, device='cpu')
    assert set(out) == {'n_part', 'n_halo', 'backend', 'device_cold_s', 'device_warm_s',
                        'host_loop_s', 'speedup_warm', 'mismatch_frac', 'key_flips', 'nn_flips'}
    assert out['key_flips'] == 0 and out['nn_flips'] == 0 and out['n_halo'] > 50


def test_bench_multitracer_step_matches_jax():
    """make_step on a catalog staged by group_inputs2d_linked_device against
    JAX's hod_pk_fused_multi with the script's tracers (nmesh 32, TSC
    compensation, RSD): n_gal exact, the six spectra within the budget;
    then main at a small size prints the JAX script's keys."""
    bench = _port('hod/bench_multitracer')
    halo, part, _ = linked_inputs(8_000, 32_000, 500.0, seed=13)
    tp = jpop.prepare_tracer_params({k: dict(v) for k, v in bench.TRACERS.items()}, z=0.5)
    Wcomp = get_W_compensated(500.0, 32, 'TSC', False).astype(np.float32)
    ref, n_ref = _jax_multi(halo, part, tp, bench.WANT, Wcomp)
    staged = tpipe.group_inputs2d_linked_device(catalog_tensors(halo), catalog_tensors(part),
                                                32, 500.0, None)
    got, n_got = bench.make_step(*staged, 32, 500.0)()
    for tracer in bench.WANT:
        assert float(n_got[tracer]) == float(n_ref[tracer]) > 0, tracer
    assert len(got) == 6
    _assert_spectra(got, ref, bench.WANT)

    record, step, spectra = bench.main(3_000, 12_000, nmesh=16, lbox=500.0, n_iter=1,
                                       device='cpu')
    assert set(record) == {'metric', 'value', 'unit', 'detail'}
    assert set(record['detail']) == {
        'tracers', 'n_gal', 'n_spectra', 'step_seconds', 'per_tracer_seconds',
        'staging_seconds', 'staging_first_call_seconds', 'compile_seconds', 'K_h', 'K_p',
        'nmesh', 'lbox', 'device'}
    assert record['detail']['n_spectra'] == 6 and record['detail']['device'] == 'cpu'
    assert all(torch.isfinite(v).all() for v in spectra.values())
