"""AbacusHOD's staging from disk (the counterpart of
abacusutils_tpu/models/hod/abacus_hod.py:AbacusHOD.staging, :132-323): the
tables prepare_sim wrote for a simulation and redshift, read into the flat
halo and particle column dicts ``AbacusHOD`` computes on, with the global
fenv re-ranking from the env sidecars.

The tables are the ``.npz`` files of the port's prepare_sim
(``prepare_sim.slab_filenames``); the JAX package's h5 subsample
directories are not read (the machine with the card has no h5py). The
halo_info header comes through ``io/asdf_file.py``. The light cone waits
with its catalogs (ROADMAP.md).
"""

import logging
from pathlib import Path

import numpy as np

from ...io.asdf_file import open_asdf
from .prepare_sim import slab_filenames, z_type_of

__all__ = ['subsample_fns', 'calc_fenv_rank', 'staging']

_log = logging.getLogger('AbacusHOD')


def subsample_fns(subsample_dir, eslab, mt, want_ranks):
    """(halos, particles) tables of slab `eslab` (abacus_hod.py:_subsample_fns:
    seed 600, '_MT' when ELG or QSO are traced or ``force_mt``)."""
    halos, parts, _ = slab_filenames(subsample_dir, eslab, 600, mt, want_ranks)
    return Path(halos), Path(parts)


def calc_fenv_rank(Menv, mbins, halosM):
    """Rank Menv within mass bins, scaled to [-0.5, 0.5]
    (abacus_hod.py:calc_fenv_rank, :1079)."""
    fenv_rank = np.zeros(len(Menv))
    for ibin in range(len(mbins) - 1):
        mmask = (halosM > mbins[ibin]) & (halosM < mbins[ibin + 1])
        Nmask = np.sum(mmask)
        if Nmask > 1:
            r = Menv[mmask].argsort().argsort()
            fenv_rank[mmask] = r / (Nmask - 1) - 0.5
    return fenv_rank


def staging(sim_params, HOD_params, chunk=-1, n_chunks=1):
    """(halo_data, particle_data, params, mock_dir) of the simulation and
    redshift of `sim_params` (``sim_name``, ``sim_dir``, ``subsample_dir``,
    ``z_mock``, ``output_dir``, ``force_mt``, ``local_env``), with the
    flags and tracers of `HOD_params`, as abacus_hod.py:staging returns
    them: the same keys and dtypes, halos sorted by id, ``pinds`` the
    particles' halos, ``hfenv`` / ``pfenv`` re-ranked over every slab's env
    sidecar when ``want_AB`` is set. `chunk` / `n_chunks` select a run of
    slabs (-1: all, in one chunk)."""
    if sim_params.get('halo_lc', False):
        raise NotImplementedError('staging a light cone: its catalogs are not read by the port '
                                  'yet (ROADMAP.md, queue 1)')
    z_mock = sim_params['z_mock']
    z_type = z_type_of(z_mock)
    flags = HOD_params['tracer_flags']
    tracers = [k for k in flags if flags[k]]
    want_ranks = HOD_params.get('want_ranks', False)
    want_AB = HOD_params.get('want_AB', False)
    want_shear = HOD_params.get('want_shear', False)
    mt = 'ELG' in tracers or 'QSO' in tracers or sim_params.get('force_mt', False)

    simname, sim_dir = Path(sim_params['sim_name']), Path(sim_params['sim_dir'])
    mock_dir = Path(sim_params.get('output_dir', './')) / simname / ('z%4.3f' % z_mock)
    subsample_dir = Path(sim_params['subsample_dir']) / simname / ('z%4.3f' % z_mock)
    if not (sim_dir / simname).exists():
        raise FileNotFoundError(f'Simulation directory {sim_dir / simname} not found.')
    if not subsample_dir.exists():
        raise FileNotFoundError(f'Subsample directory {subsample_dir} not found.')
    halo_info_fns = sorted(
        (sim_dir / simname / 'halos' / ('z%4.3f' % z_mock) / 'halo_info').glob('*.asdf'))
    with open_asdf(halo_info_fns[0]) as f:
        header = dict(f['header'])

    params = {'z': z_mock, 'h': header['H0'] / 100.0, 'Lbox': header['BoxSize'],
              'Mpart': header['ParticleMassHMsun'], 'origin': None, 'chunk': chunk}
    params['velz2kms'] = header['VelZSpace_to_kms'] / params['Lbox']
    n_jump = int(np.ceil(len(halo_info_fns) / n_chunks))
    start = (0 if chunk == -1 else chunk) * n_jump
    end = min(start + n_jump, len(halo_info_fns))
    params['numslabs'] = end - start

    load_parts = z_type == 'primary'
    halo_chunks, part_chunks = [], []
    for eslab in range(start, end):
        _log.info(f'Loading simulation slab {eslab}')
        halofn, partfn = subsample_fns(subsample_dir, eslab, mt, want_ranks)
        with np.load(halofn) as f:
            halo_chunks.append(f['halos'])
        if load_parts:
            with np.load(partfn) as f:
                part_chunks.append(f['particles'])
    halos = np.concatenate(halo_chunks)
    parts = np.concatenate(part_chunks) if load_parts else None

    hveldev = halos['randoms_exp' if HOD_params.get('want_expvel', False)
                    else 'randoms_gaus_vrms']
    if hveldev.ndim == 1:
        _log.warning('galaxy x, y velocity bias randoms not set; using z randoms')
        hveldev = np.stack([hveldev] * 3, axis=1)
    halo_data = {
        'hpos': np.asarray(halos['x_L2com'], np.float64),
        'hvel': np.asarray(halos['v_L2com'], np.float64),
        'hmass': halos['N'].astype(np.float64) * params['Mpart'],
        'hid': halos['id'].astype(np.int64),
        'hmultis': np.asarray(halos['multi_halos'], np.float64),
        'hrandoms': np.asarray(halos['randoms'], np.float64),
        'hveldev': np.asarray(hveldev, np.float64),
        'hsigma3d': np.asarray(halos['sigmav3d_L2com'], np.float64),
        'hc': np.asarray(halos['r98_L2com'] / halos['r25_L2com'], np.float64),
        'hrvir': np.asarray(halos['r98_L2com'], np.float64),
    }
    if want_AB:
        halo_data['hdeltac'] = np.asarray(halos['deltac_rank'], np.float64)
        halo_data['hfenv'] = np.asarray(halos['fenv_rank'], np.float64)
    if want_shear:
        halo_data['hshear'] = np.asarray(halos['shear_rank'], np.float64)

    # halos sorted by id: the particles' map to their halos
    hid = halo_data['hid']
    if not np.all(hid[:-1] <= hid[1:]):
        order = np.argsort(hid)
        for k in halo_data:
            halo_data[k] = halo_data[k][order]

    if load_parts:
        phid = parts['halo_id'].astype(np.int64)
        particle_data = {
            'ppos': np.asarray(parts['pos'], np.float64),
            'pvel': np.asarray(parts['vel'], np.float64),
            'phvel': np.asarray(parts['halo_vel'], np.float64),
            'phmass': np.asarray(parts['halo_mass'], np.float64),
            'phid': phid,
            'pweights': 1 / np.asarray(parts['Np'], np.float64)
            / np.asarray(parts['downsample_halo'], np.float64),
            'prandoms': np.asarray(parts['randoms'], np.float64),
        }
        if want_AB:
            particle_data['pdeltac'] = np.asarray(parts['halo_deltac'], np.float64)
            particle_data['pfenv'] = np.asarray(parts['halo_fenv'], np.float64)
        if want_shear:
            particle_data['pshear'] = np.asarray(parts['halo_shear'], np.float64)
        names = parts.dtype.names
        for k, col in (('pranks', 'ranks'), ('pranksv', 'ranksv'), ('pranksp', 'ranksp'),
                       ('pranksr', 'ranksr'), ('pranksc', 'ranksc')):
            if not want_ranks:
                particle_data[k] = np.ones(len(phid))
            elif col in names:
                particle_data[k] = np.asarray(parts[col], np.float64)
            elif col in ('ranks', 'ranksv'):
                raise KeyError(f'want_ranks: the particle tables have no {col!r} column')
            else:
                particle_data[k] = np.zeros(len(phid))
        particle_data['pinds'] = np.searchsorted(halo_data['hid'], phid)
    else:
        particle_data = {k: np.empty(0) for k in (
            'ppos', 'pvel', 'phvel', 'phmass', 'pweights', 'prandoms', 'pranks', 'pranksv',
            'pranksp', 'pranksr', 'pranksc')}
        particle_data['phid'] = np.empty(0, np.int64)
        particle_data['pinds'] = np.empty(0, np.int64)

    # global fenv re-ranking from the env sidecars (abacus_hod.py:262-320)
    if want_AB:
        local_env = sim_params.get('local_env', {})
        mcut_env, nbins_env = local_env.get('mcut', 1e11), local_env.get('nbins', 100)
        env = {'id': [], 'mass': [], 'Menv': []}
        for eslab in range(len(halo_info_fns)):
            envfn = subsample_dir / f'env_xcom_{eslab}_abacushod_localenv_new.npz'
            if not envfn.exists():
                raise FileNotFoundError(f'Missing env sidecar: {envfn}')
            with np.load(envfn) as f:
                for k in env:
                    env[k].append(f[k])
        env_id = np.concatenate(env['id']).astype(np.int64)
        mbins_env = np.logspace(np.log10(mcut_env), 15.5, nbins_env + 1)
        hfenv_full = calc_fenv_rank(np.concatenate(env['Menv']), mbins_env,
                                    np.concatenate(env['mass']))
        order = np.argsort(env_id)
        env_id, hfenv_full = env_id[order], hfenv_full[order]
        hmatch = np.searchsorted(env_id, halo_data['hid'])
        if not np.all(env_id[np.minimum(hmatch, len(env_id) - 1)] == halo_data['hid']):
            raise RuntimeError('Failed to map global env sidecars onto staged halos by halo ID.')
        halo_data['hfenv'] = hfenv_full[hmatch]
        if load_parts:
            pinds = particle_data['pinds']
            if not np.all(halo_data['hid'][pinds] == particle_data['phid']):
                raise RuntimeError('Particle-to-halo mapping pinds is inconsistent with phid.')
            particle_data['pfenv'] = halo_data['hfenv'][pinds]

    return halo_data, particle_data, params, mock_dir
