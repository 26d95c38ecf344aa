"""The synthetic AbacusSummit simulation of the disk-path parity tests
(tests/test_torch_compaso.py, tests/test_torch_prepare_sim_io.py): three
x-slabs of ~2,000 halos each in the AbacusSummit encodings (int16 radius
ratios, RVint subsamples, blsc blocks, cleaning files with ~5 % of the
halos merged), drawn by abacusutils_tpu_torch.testing.synthetic_compaso and
written with the JAX package's write_asdf; and the configs that run both
packages' prepare_sim and AbacusHOD on it."""

import multiprocessing
import os

import numpy as np

from abacusutils_tpu_torch.testing import synthetic_compaso, write_compaso_sim
from torch_helpers import TRACERS

SIM = dict(n_slabs=3, n_halo=6000, n_part=40_000, n_field=30_000, seed=5)
FIELDS = ['N', 'x_L2com', 'v_L2com', 'r90_L2com', 'r25_L2com', 'r98_L2com', 'npstartA',
          'npoutA', 'id', 'sigmav3d_L2com']


def jax_written_sim(root):
    """(sim, write info) of the synthetic simulation written under `root`
    with the JAX package's write_asdf (imported here: the rest of this module
    is JAX-free, for the card's tests)."""
    from abacusutils_tpu.io.asdf_file import write_asdf as jax_write_asdf

    sim = synthetic_compaso(**SIM)
    return sim, write_compaso_sim(root, sim, writer=jax_write_asdf)


def exit_in_worker(i, **kwargs):
    """A stand-in for prepare_sim.prepare_slab whose pool worker dies at
    once, which breaks the pool; called in the parent process, it raises."""
    if multiprocessing.parent_process() is None:
        raise AssertionError(f'slab {i} ran in the parent process')
    os._exit(1)


def tracers():
    """LRG, ELG and QSO with assembly bias on."""
    tr = {k: dict(v) for k, v in TRACERS.items()}
    for p in tr.values():
        p.update(Acent=0.05, Asat=-0.1, Bcent=0.03, Bsat=0.05)
    return tr


def config(root, sim_name, subsample, engines='auto', nparallel=1):
    """A prepare_sim / AbacusHOD config of the simulation under `root`: its
    tables under `root`/`subsample`, ranks, env and shear (at 32^3, R 2, every
    particle) on, the ranks and Menv engines `engines`."""
    return {
        'sim_params': {
            'sim_name': sim_name, 'sim_dir': f'{root}/', 'subsample_dir': f'{root}/{subsample}/',
            'output_dir': f'{root}/mocks/', 'z_mock': 0.5, 'cleaned_halos': True,
        },
        'HOD_params': {
            'tracer_flags': {'LRG': True, 'ELG': True, 'QSO': True}, 'want_ranks': True,
            'want_AB': True, 'want_shear': True, 'shear_N': 32, 'shear_R': 2, 'partdown': 1,
            'want_rsd': True, **{f'{k}_params': v for k, v in tracers().items()},
        },
        'prepare_sim': {'Nparallel_load': nparallel, 'Nthread_per_load': 1,
                        'ranks_engine': engines, 'menv_engine': engines},
    }


def assert_tables_equal(got, ref, exact_menv=True):
    """Tables of both packages' prepare_slab (structured arrays, or the env
    sidecar's dicts): every column with its dtype exact, ranksc tie-aware
    (mutual nearest neighbours tie: equal as multisets a halo), Menv exact or
    at rtol 1e-12 with the same zeros."""
    if isinstance(ref, dict):
        for k in ('id', 'mass'):
            assert got[k].dtype == ref[k].dtype
            np.testing.assert_array_equal(got[k], ref[k])
        if exact_menv:
            np.testing.assert_array_equal(got['Menv'], ref['Menv'])
        else:
            np.testing.assert_allclose(got['Menv'], ref['Menv'], rtol=1e-12, atol=0.0)
            np.testing.assert_array_equal(got['Menv'] == 0, ref['Menv'] == 0)
        return
    assert got.dtype == ref.dtype
    for name in ref.dtype.names:
        if name != 'ranksc':
            np.testing.assert_array_equal(got[name], ref[name], err_msg=name)
    if 'ranksc' in ref.dtype.names:
        oa = np.lexsort((got['ranksc'], got['halo_id']))
        ob = np.lexsort((ref['ranksc'], ref['halo_id']))
        np.testing.assert_array_equal(got['ranksc'][oa], ref['ranksc'][ob])
        assert (got['ranksc'] == ref['ranksc']).mean() > 0.9
