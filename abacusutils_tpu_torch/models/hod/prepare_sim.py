r"""prepare_sim: CompaSO slabs on disk -> the staged subsample tables.

Counterpart of abacusutils_tpu/models/hod/prepare_sim.py.
:func:`prepare_slab_tables` is the body of ``prepare_slab`` on dicts of
numpy columns and returns the columns that function writes;
:func:`prepare_slab` adds its file I/O (:func:`read_slab`, the catalog read
through ``io/compaso.py``, then :func:`write_slab_tables`), and :func:`main`
drives it over every slab, serially or in a process pool, after
:func:`calc_shearmark`. The command line is JAX's (``python -m
abacusutils_tpu_torch.models.hod.prepare_sim --path2config cfg.json``, plus
``--device``).

- Host helpers, numpy copies of the JAX package's: the down-sampling curves
  (:func:`subsample_halos`, :func:`submask_particles`), the env padding
  arithmetic (:func:`periodic_dx`, :func:`make_edge_pad_filter`,
  :func:`unwrap_x_for_slab`, :func:`env_pad_slabs`), :func:`calc_fenv_opt`,
  the light-cone randoms (:func:`get_vertices_cube`, :func:`is_in_cube`,
  :func:`gen_rand`, :func:`lc_randoms_norm`) and :func:`_rank_fields`, the
  per-halo cKDTree loop (the ``'host'`` ranks engine).
- The device engines: ranks (:func:`~.ranks_device.rank_fields_device`, K6
  and sorts), Menv (:func:`~.menv_device.do_menv_device`, K7) and the shear
  field (ops/grid.py:tsc_parallel, K1, then ops/shear.py), chosen by
  :func:`_do_menv` and ``ranks_engine``.

The random draws follow the reference's protocol exactly: ``default_rng(
newseed + i)`` seeds the legacy ``np.random``, the halo mask is drawn, then
one ``np.random.choice(..., replace=False)`` submask per kept halo in halo
order (these cannot be batched without changing the stream; the columns
they select are filled after them, all kept halos at once), then the halo
randoms and the particle randoms. The engines draw nothing, so the tables
do not depend on which engine ran.

Formats: the tables are written as ``.npz`` where the JAX package writes
h5 (the machine with the card has no h5py), under the JAX package's file
stems with ``_new.npz`` for ``_new.h5``; each holds the structured array of
JAX's dataset (``halos``, ``particles``; the env sidecar's ``id``,
``mass`` and ``Menv``). The config is a dict or a JSON file (no yaml on
the card). A light cone (``halo_lc``) is one slab, read from
``{sim_dir}/{sim_name}/z{z}/lc_halo_info.asdf`` and ``lc_pid_rv.asdf``.
"""

import concurrent.futures
import glob
import math
import multiprocessing
import os
from pathlib import Path

import numpy as np

from ...config import DEFAULT_CONFIG, load_config
from ...convert import resolve_device
from ...io.compaso import CompaSOHaloCatalog
from ...io.read_abacus import read_asdf
from .menv import do_Menv_from_tree

__all__ = [
    'subsample_halos', 'submask_particles', 'periodic_dx', 'make_edge_pad_filter',
    'unwrap_x_for_slab', 'env_pad_slabs', 'calc_fenv_opt', 'get_vertices_cube', 'is_in_cube',
    'gen_rand', 'env_menv_periodic', 'lc_randoms_norm', 'env_menv_lc', 'shear_rank',
    'shearmark_from_positions', 'prepare_slab_tables', 'HALO_ORDER', 'HALO_ORDER_LC',
    'HALO_EXTRA', 'PRIMARY_REDSHIFTS', 'SECONDARY_REDSHIFTS', 'SLAB_FIELDS', 'SLAB_FIELDS_LC',
    'load_env_halos', 'slab_filenames', 'read_slab', 'write_slab_tables', 'prepare_slab',
    'calc_shearmark', 'load_config', 'main', 'z_type_of',
]

PRIMARY_REDSHIFTS = [3.0, 2.5, 2.0, 1.7, 1.4, 1.1, 0.8, 0.5, 0.4, 0.3, 0.2, 0.1, 0.0]
SECONDARY_REDSHIFTS = [
    0.15, 0.25, 0.35, 0.45, 0.575, 0.65, 0.725, 0.875, 0.95, 1.025, 1.175,
    1.25, 1.325, 1.475, 1.55, 1.625, 1.85, 2.25, 2.75, 3.0, 5.0, 8.0,
]


def z_type_of(z_mock, halo_lc=False):
    """'lightcone', 'primary' (particle subsamples) or 'secondary' (none)
    of a redshift (prepare_sim.py:925-932)."""
    if halo_lc:
        return 'lightcone'
    if z_mock in PRIMARY_REDSHIFTS:
        return 'primary'
    if z_mock in SECONDARY_REDSHIFTS:
        return 'secondary'
    raise ValueError(f'illegal redshift {z_mock}')


def _do_menv(engine, pos, mass, r_inner, r_outer, halo_lc, Lbox, nthread=1, mcut=1e11,
             device=None):
    """Menv engine dispatch: 'auto' and 'device' take K7 on `device` (None:
    the card; 'cpu' runs its plain version), 'device-x64' is 'device' (the
    card computes in float64), 'host' the scipy KDTree engine."""
    if engine in ('auto', 'device', 'device-x64'):
        from .menv_device import do_menv_device

        return do_menv_device(pos, mass, r_inner=r_inner, r_outer=r_outer, halo_lc=halo_lc,
                              Lbox=Lbox, mcut=mcut, device=device)
    if engine == 'host':
        return do_Menv_from_tree(pos, mass, r_inner=r_inner, r_outer=r_outer, halo_lc=halo_lc,
                                 Lbox=Lbox, nthread=nthread, mcut=mcut)
    raise ValueError(_engine_error('menv_engine', engine))


def _engine_error(name, engine):
    if engine == 'device-exact32':
        return (f"{name}='device-exact32' is the double-float32 arithmetic of an f32-only TPU; "
                "Hopper runs float64, so the card computes in it: use 'device' (or 'auto')")
    return f"unknown {name} {engine!r}: use 'auto', 'device', 'device-x64' or 'host'"


# ---------------------------------------------------------------------------
# down-sampling curves (reference :83-173; DESI-tuned sigmoids)
# ---------------------------------------------------------------------------


def subsample_halos(m, MT):
    """Halo retention probability against mass."""
    x = np.log10(m)
    downfactors = np.zeros(len(x))
    if MT:
        mask1 = x < 11.4
        mask2 = x < 11.6
        downfactors[mask1] = 0.2 / (1.0 + 10 * np.exp(-(x[mask1] - 11.2) * 25))
        downfactors[mask2 & (~mask1)] = 0.4 / (
            1.0 + 10 * np.exp(-(x[mask2 & (~mask1)] - 11.3) * 25)
        )
        downfactors[~mask2] = 1.0 / (1.0 + 0.1 * np.exp(-(x[~mask2] - 11.7) * 10))
        return downfactors
    downfactors = 1.0 / (1.0 + 0.1 * np.exp(-(x - 11.8) * 10))
    downfactors[x > 13.0] = 1
    return downfactors


def submask_particles(m_in, n_in, MT):
    """Per-halo particle submask with a mass-dependent target count; draws
    from the legacy np.random exactly as the reference does (:152-173)."""
    x = np.log10(m_in)
    if MT:
        if m_in < 1e11:
            return np.zeros(n_in)
        ntarget = np.minimum(n_in, int(1 + 1.5 * 10 ** (x - 12.5)))
        ntarget = np.minimum(ntarget, 100)
    else:
        if 10**x < 1e12:
            return np.zeros(n_in)
        ntarget = np.minimum(n_in, int(1 + 1.5 * 10 ** (x - 13)))
    submask = np.zeros(n_in).astype(int)
    submask[np.random.choice(n_in, ntarget, replace=False)] = 1
    return submask


# ---------------------------------------------------------------------------
# env padding helpers (reference :40-78)
# ---------------------------------------------------------------------------


def periodic_dx(x, x0, Lbox):
    return ((x - x0 + 0.5 * Lbox) % Lbox) - 0.5 * Lbox


def make_edge_pad_filter(xedge, rad_outer, Lbox):
    def _filter(h):
        dx = periodic_dx(h['x_L2com'][:, 0], xedge, Lbox)
        return np.abs(dx) <= rad_outer

    return _filter


def unwrap_x_for_slab(x, i, numslabs, Lbox):
    dx_slab = Lbox / numslabs
    x_center = -0.5 * Lbox + (i + 0.5) * dx_slab
    dx = ((x - x_center + 0.5 * Lbox) % Lbox) - 0.5 * Lbox
    return x_center + dx


def env_pad_slabs(central_x, i, numslabs, Lbox, rad_outer):
    """The neighbour slabs the padded env of slab i reads, as a list of
    (slab index, filter) in the order prepare_slab loads them (:698-716):
    each filter keeps the halos within rad_outer of the central slab's
    unwrapped x extent. A caller loads each slab's halos (N, x_L2com,
    r98_L2com, id; cleaned if the slab is), applies its filter and passes
    the tables to :func:`prepare_slab_tables` as `env_halos`."""
    if numslabs is None:
        raise ValueError('the padded env calculation needs numslabs')
    x_unwrap = unwrap_x_for_slab(np.asarray(central_x), i, numslabs, Lbox)
    n_pad_slabs = max(1, int(math.ceil(rad_outer / (Lbox / numslabs))))
    left = make_edge_pad_filter(x_unwrap.min(), rad_outer, Lbox)
    right = make_edge_pad_filter(x_unwrap.max(), rad_outer, Lbox)
    out = []
    for d in range(1, n_pad_slabs + 1):
        out += [((i - d) % numslabs, left), ((i + d) % numslabs, right)]
    return out


def calc_fenv_opt(Menv, mbins, halosM):
    """Mass-binned environment rank in [-0.5, 0.5] (reference :281-292)."""
    fenv_rank = np.zeros(len(Menv))
    for ibin in range(len(mbins) - 1):
        mmask = (halosM > mbins[ibin]) & (halosM < mbins[ibin + 1])
        Nmask = np.sum(mmask)
        if Nmask > 1:
            r = Menv[mmask].argsort().argsort()
            fenv_rank[mmask] = r / (Nmask - 1) - 0.5
    return fenv_rank


# ---------------------------------------------------------------------------
# light-cone randoms (reference :176-278)
# ---------------------------------------------------------------------------


def get_vertices_cube(units=0.5, N=3):
    """All 2**N corner sign combinations of an N-cube, scaled by `units`."""
    axes = np.meshgrid(*([np.array([-1.0, 1.0])] * N), indexing='ij')
    return units * np.stack([a.ravel() for a in axes], axis=-1)


def is_in_cube(x_pos, y_pos, z_pos, verts):
    return (
        (x_pos > verts[:, 0].min())
        & (x_pos <= verts[:, 0].max())
        & (y_pos > verts[:, 1].min())
        & (y_pos <= verts[:, 1].max())
        & (z_pos > verts[:, 2].min())
        & (z_pos <= verts[:, 2].max())
    )


def gen_rand(N, chi_min, chi_max, fac, Lbox, offset, origins, rng):
    """Randoms over the light-cone footprint (octant or full sphere), in the
    reference's draw order (two angles, then the radius)."""
    N_rands = fac * N
    origin = origins[0]

    if origins.shape[0] > 1:
        assert origins.shape[0] == 3
        assert np.all(origins[1] + np.array([0.0, 0.0, Lbox]) == origins[0])
        assert np.all(origins[2] + np.array([0.0, Lbox, 0.0]) == origins[0])
        costheta = rng.random(N_rands)
        phi = rng.random(N_rands) * np.pi / 2.0
    else:
        costheta = rng.random(N_rands) * 2.0 - 1.0
        phi = rng.random(N_rands) * 2.0 * np.pi
    theta = np.arccos(costheta)
    rands_chis = rng.random(N_rands) * (chi_max - chi_min) + chi_min
    sin_t = np.sin(theta)
    x_cart = sin_t * np.cos(phi) * rands_chis
    y_cart = sin_t * np.sin(phi) * rands_chis
    z_cart = np.cos(theta) * rands_chis

    box0 = np.array([0.0, 0.0, 0.0]) - origin
    if origins.shape[0] > 1:
        box1 = np.array([0.0, 0.0, Lbox]) - origin
        box2 = np.array([0.0, Lbox, 0.0]) - origin

    # pull the cube faces inward by `offset` (the light-cone catalogs lack
    # the box edges): both x faces; -y/-z always; +y/+z only for the
    # single-origin footprint
    vert = get_vertices_cube(units=Lbox / 2.0)
    sgn = np.sign(vert)
    vert[:, 0] -= sgn[:, 0] * offset
    for ax in (1, 2):
        vert[sgn[:, ax] < 0, ax] += offset
        if origins.shape[0] == 1:
            vert[sgn[:, ax] > 0, ax] -= offset

    vert0 = box0 + vert
    mask = is_in_cube(x_cart, y_cart, z_cart, vert0)
    if origins.shape[0] > 1 and chi_max >= (Lbox - offset):
        mask |= is_in_cube(x_cart, y_cart, z_cart, box1 + vert)
        mask |= is_in_cube(x_cart, y_cart, z_cart, box2 + vert)

    rands_pos = np.vstack((x_cart[mask], y_cart[mask], z_cart[mask])).T
    rands_chis = rands_chis[mask]
    rands_pos += origin
    return rands_pos, rands_chis


# ---------------------------------------------------------------------------
# the 'host' ranks engine (reference :886-977)
# ---------------------------------------------------------------------------


def _rank_fields(
    indices_parts, pos_sub, vel_sub, pos_all, halo_pos, halo_vel, m_msunh, rs, r98, h,
    ranks_parts, ranksv_parts, ranksp_parts, ranksr_parts, ranksc_parts,
):
    """Per-particle rank decorations within one halo (reference :886-977)."""
    from scipy.spatial import cKDTree

    parts_tree = cKDTree(pos_all)
    dist2_neighbors = parts_tree.query(pos_sub, k=2)[0][:, 1]
    newranksc = dist2_neighbors.argsort().argsort()
    ranksc_parts[indices_parts] = (newranksc - np.mean(newranksc)) / np.mean(newranksc)

    dist2_rel = np.sum((pos_sub - halo_pos) ** 2, axis=1)
    newranks = dist2_rel.argsort().argsort()
    ranks_parts[indices_parts] = (newranks - np.mean(newranks)) / np.mean(newranks)

    v2_rel = np.sum((vel_sub - halo_vel) ** 2, axis=1)
    newranksv = v2_rel.argsort().argsort()
    ranksv_parts[indices_parts] = (newranksv - np.mean(newranksv)) / np.mean(newranksv)

    r_rel = pos_sub - halo_pos
    r0 = np.sqrt(np.sum(r_rel**2, axis=1))
    r_rel_norm = r_rel / r0[:, None]

    vels_rel = vel_sub - halo_vel
    v_rel2 = np.sum(vels_rel**2, axis=1)
    vel_rad = np.sum(vels_rel * r_rel_norm, axis=1)
    newranksr = vel_rad.argsort().argsort()
    ranksr_parts[indices_parts] = (newranksr - np.mean(newranksr)) / np.mean(newranksr)

    v_rad2 = vel_rad**2
    v_tan2 = v_rel2 - v_rad2

    # NFW perihelion iteration (reference :943-977)
    m = m_msunh / h  # "in kg" per the reference comment; kept as-is for parity
    c = r98 / rs
    r0_kpc = r0 * 1000
    alpha = (
        1.0 / (np.log(1 + c) - c / (1 + c))
        * 2 * 6.67e-11 * m * 2e30 / r0_kpc / 3.086e19 / 1e6
    )
    x2 = v_tan2 / (v_tan2 + v_rad2)
    factorA = v_tan2 + v_rad2
    factorB = np.log(1 + r0_kpc / rs)
    with np.errstate(invalid='ignore', divide='ignore'):
        for _ in range(20):
            oldx = np.sqrt(x2)
            x2 = v_tan2 / (
                factorA + alpha * (np.log(1 + oldx * r0_kpc / rs) / oldx - factorB)
            )
    x2[np.isnan(x2)] = 1
    rp2 = r0_kpc**2 * x2
    newranksp = rp2.argsort().argsort()
    ranksp_parts[indices_parts] = (newranksp - np.mean(newranksp)) / np.mean(newranksp)


# ---------------------------------------------------------------------------
# the environment and shear ranks
# ---------------------------------------------------------------------------


def env_menv_periodic(central, env_halos, Mpart, Lbox, rad_outer, mcut, engine='auto',
                      nthread=1, device=None):
    """The padded-slab Menv of a periodic box's central halos (the compute of
    prepare_sim.py:_env_periodic, :675-747): the centrals, then each
    neighbour table of `env_halos` (as :func:`env_pad_slabs` describes
    them), deduplicated by id keeping first occurrences, through the Menv
    engine. central and each env table: dicts with 'x_L2com', 'N',
    'r98_L2com' and 'id'. Returns the env sidecar {'id', 'mass', 'Menv'} of
    the centrals."""
    central_pos = np.asarray(central['x_L2com'])
    central_mass = np.asarray(central['N']) * Mpart
    central_id = np.asarray(central['id']).astype(np.int64)
    if len(np.unique(central_id)) != len(central_id):
        raise RuntimeError('duplicate halo ids in the central slab')
    ncentral = len(central_id)
    env_pos, env_mass = [central_pos], [np.asarray(central_mass)]
    env_rvir, env_id = [np.asarray(central['r98_L2com'])], [central_id]
    for nbr in env_halos or ():
        if len(nbr['id']) > 0:
            env_pos.append(np.asarray(nbr['x_L2com']))
            env_mass.append(np.asarray(nbr['N'] * Mpart))
            env_rvir.append(np.asarray(nbr['r98_L2com']))
            env_id.append(np.asarray(nbr['id'], np.int64))
    env_pos = np.concatenate(env_pos, axis=0)
    env_mass = np.concatenate(env_mass)
    env_rvir = np.concatenate(env_rvir)
    env_id = np.concatenate(env_id)

    _, uniq_idx = np.unique(env_id, return_index=True)
    uniq_idx = np.sort(uniq_idx)
    env_pos, env_mass, env_rvir = env_pos[uniq_idx], env_mass[uniq_idx], env_rvir[uniq_idx]

    menv_all = _do_menv(engine, env_pos, env_mass, r_inner=env_rvir, r_outer=rad_outer,
                        halo_lc=False, Lbox=Lbox, nthread=nthread, mcut=mcut, device=device)
    return {'id': central_id, 'mass': np.asarray(central_mass, np.float64),
            'Menv': menv_all[:ncentral]}


def lc_randoms_norm(allpos, r98, origins, Lbox, rad_outer, randoms_seed, nthread=1):
    """The light cone's boundary correction (prepare_sim.py:_env_halo_lc,
    :750-832): the halos within rad_outer of the footprint's edges, and for
    each the randoms counted in its annulus (r98, rad_outer], normalized by
    the annulus's volume times the randoms' density. Randoms are drawn
    (:func:`gen_rand`, one batch of len(allpos) a round) until those near the
    edges number ten times the edge halos. Host numpy and scipy's cKDTree,
    whose ball counts (``return_length``) are the lengths of the JAX
    package's neighbour lists. Returns (index_bounds, rand_norm)."""
    from scipy.spatial import cKDTree

    origins = np.asarray(origins).reshape(-1, 3)
    alldist = np.sqrt(np.sum((allpos - origins[0]) ** 2.0, axis=1))
    offset = 10.0

    r_min, r_max = alldist.min(), alldist.max()
    lim = Lbox / 2.0 - offset - rad_outer
    if origins.shape[0] == 1:
        ymax = zmax = lim
    else:
        ymax = zmax = 3.0 / 2 * Lbox - rad_outer

    bounds_edge = (
        (-lim <= allpos[:, 0]) & (lim >= allpos[:, 0])
        & (-lim <= allpos[:, 1]) & (ymax >= allpos[:, 1])
        & (-lim <= allpos[:, 2]) & (zmax >= allpos[:, 2])
        & (r_min + rad_outer <= alldist) & (r_max - rad_outer >= alldist)
    )
    index_bounds = np.arange(allpos.shape[0])[~bounds_edge]

    rand_norm = np.zeros(len(index_bounds))
    if len(index_bounds) > 0:
        lim2 = Lbox / 2.0 - offset - 2.0 * rad_outer
        if origins.shape[0] == 1:
            ymax2 = zmax2 = lim2
        else:
            ymax2 = zmax2 = 3.0 / 2 * Lbox - 2.0 * rad_outer
        r_min_edge2 = r_min + 2.0 * rad_outer
        r_max_edge2 = r_max - 2.0 * rad_outer

        rand = 1
        rand_N = int(allpos.shape[0] * rand)
        if origins.shape[0] == 1:
            rand_n = rand_N / (4.0 / 3.0 * np.pi * (r_max**3 - r_min**3))
        else:
            rand_n = rand_N / (4.0 / 3.0 / 8.0 * np.pi * (r_max**3 - r_min**3))

        rand_final = 10
        count = 0
        repeats = 0
        rng = np.random.default_rng(randoms_seed)

        while count < len(index_bounds) * rand_final:
            randpos, randdist = gen_rand(
                allpos.shape[0], r_min, r_max, rand, Lbox, offset, origins, rng
            )
            randbounds_edge = (
                (-lim2 <= randpos[:, 0]) & (lim2 >= randpos[:, 0])
                & (-lim2 <= randpos[:, 1]) & (ymax2 >= randpos[:, 1])
                & (-lim2 <= randpos[:, 2]) & (zmax2 >= randpos[:, 2])
                & (r_min_edge2 <= randdist) & (r_max_edge2 >= randdist)
            )
            randpos = randpos[~randbounds_edge]

            if randpos.shape[0] > 0:
                tree = cKDTree(randpos)
                inner = tree.query_ball_point(allpos[index_bounds], r=r98[index_bounds],
                                              workers=nthread, return_length=True)
                outer = tree.query_ball_point(allpos[index_bounds], r=rad_outer,
                                              workers=nthread, return_length=True)
                rand_norm += outer - inner

            repeats += 1
            count += randpos.shape[0]

        rand_n *= repeats
        rand_norm /= (
            (rad_outer**3.0 - r98[index_bounds] ** 3.0) * 4.0 / 3.0 * np.pi * rand_n
        )
    return index_bounds, rand_norm


def env_menv_lc(allpos, r98, allmasses, origins, Lbox, rad_outer, mcut, mbins,
                randoms_seed, engine='auto', nthread=1, device=None):
    """The light cone's Menv with its randoms-normalized boundary correction
    (:func:`lc_randoms_norm`), ranked into fenv (the compute of
    prepare_sim.py:_env_halo_lc, :750-848); the Menv engine is `engine`.
    Returns fenv_rank."""
    allpos = np.asarray(allpos)
    r98 = np.asarray(r98)
    index_bounds, rand_norm = lc_randoms_norm(allpos, r98, origins, Lbox, rad_outer,
                                              randoms_seed, nthread)

    Menv = _do_menv(engine, allpos, np.asarray(allmasses), r_inner=r98, r_outer=rad_outer,
                    halo_lc=True, Lbox=Lbox, nthread=nthread, mcut=mcut, device=device)

    if len(index_bounds) > 0:
        mask = rand_norm == 0.0
        rand_norm[mask] = 1.0
        tmp = Menv[index_bounds]
        tmp /= rand_norm
        tmp[mask] = 0.0
        Menv[index_bounds] = tmp

    return calc_fenv_opt(Menv, mbins, np.asarray(allmasses))


def shear_rank(halo_pos, allmasses, mbins, shearmark, Lbox):
    """Per-mass-bin rank in [-0.5, 0.5] of the shear at each halo's cell
    (prepare_sim.py:389-408: interpn of the shear grid at integer cells)."""
    from scipy.interpolate import interpn

    shearmark = np.asarray(shearmark)
    assert len(np.unique(shearmark.shape)) == 1
    halo_pos = np.asarray(halo_pos)
    N_dim = len(shearmark)
    cell = Lbox / N_dim
    out = np.zeros(len(halo_pos))
    for ibin in range(len(mbins) - 1):
        mmask = (allmasses > mbins[ibin]) & (allmasses < mbins[ibin + 1])
        if np.sum(mmask) > 1:
            GroupPos = (halo_pos[mmask] / cell).astype(int) % N_dim
            halo_shears = interpn((np.arange(N_dim),) * 3, shearmark, GroupPos)
            r = halo_shears.argsort().argsort()
            out[mmask] = r / np.max(r) - 0.5
    return out


def shearmark_from_positions(pos, N_dim, R, Lbox, device=None):
    """The shear field of prepare_sim.py:calc_shearmark (:851-877) from the
    down-sampled particle positions: TSC paint (K1) on `device` (None: the
    card), the host Gaussian filter, then the shear invariant on `device`.
    Returns (N_dim,)*3 float32 numpy."""
    from ...ops.grid import tsc_parallel
    from ...ops.shear import get_shear, smooth_density

    dens = tsc_parallel(pos, N_dim, Lbox, device=device)
    dens_smooth = smooth_density(dens, R, N_dim, Lbox)
    return get_shear(dens_smooth, N_dim, Lbox, device=device)


# ---------------------------------------------------------------------------
# the slab
# ---------------------------------------------------------------------------

# the h5 column orders of prepare_slab (:560-574): the reference's table
# construction order, which fixes the golden dtypes
HALO_ORDER = ['x_L2com', 'v_L2com', 'r90_L2com', 'r25_L2com', 'r98_L2com', 'id',
              'sigmav3d_L2com', 'N', 'npstartA', 'npoutA']
HALO_ORDER_LC = ['N_interp', 'pos_interp', 'vel_interp', 'r90_L2com', 'r25_L2com', 'r98_L2com',
                 'npstartA', 'npoutA', 'index_halo', 'sigmav3d_L2com', 'id', 'x_L2com',
                 'v_L2com', 'N']
HALO_EXTRA = ['mask_subsample', 'multi_halos', 'fenv_rank', 'deltac_rank', 'shear_rank',
              'randoms', 'randoms_exp', 'randoms_gaus_vrms']


def _take(table, mask):
    return {k: np.asarray(v)[mask] for k, v in table.items()}


def prepare_slab_tables(
    halos, parts, header, *, i, MT, want_ranks, want_AB, want_shear, shearmark, newseed,
    halo_lc, mcut=1e11, rad_outer=10, env_halos=None, cleaning=False, ranks_engine='auto',
    menv_engine='auto', nthread=1, device=None,
):
    """The tables prepare_slab writes for slab i (prepare_sim.py:292-613),
    from the slab's columns.

    halos: dict of the halo columns prepare_slab reads (N, x_L2com, v_L2com,
    r90_L2com, r25_L2com, r98_L2com, npstartA, npoutA, id, sigmav3d_L2com;
    for a light cone N_interp, pos_interp, vel_interp and index_halo in place
    of N, x_L2com, v_L2com and id). parts: dict with the A subsample's 'pos'
    and 'vel', or None where the redshift has no particles. header: the
    catalog header (BoxSizeHMpc, ParticleMassHMsun, H0; LightConeOrigins for
    a light cone). env_halos: a periodic box's neighbour tables for the
    padded env (:func:`env_pad_slabs`; None: none, as for a single slab).
    cleaning: drop halos with N = 0 first, as prepare_slab does for cleaned
    catalogs. ranks_engine / menv_engine: 'auto' or 'device' (the card, or
    the plain versions where `device` is 'cpu'), 'device-x64' (the same),
    or 'host'.

    Returns {'halos': the halo columns of the kept halos in HALO_ORDER (or
    HALO_ORDER_LC) + HALO_EXTRA, 'particles': the kept particles' columns
    in prepare_slab's order (None without parts), 'env': the env sidecar
    {'id', 'mass', 'Menv'} (None unless want_AB in a box)}, each a dict of
    numpy arrays."""
    for name, engine in (('ranks_engine', ranks_engine), ('menv_engine', menv_engine)):
        if engine not in ('auto', 'device', 'device-x64', 'host'):
            raise ValueError(_engine_error(name, engine))

    # exact RNG protocol of the reference (:345-347)
    seeder = np.random.default_rng(newseed + i)
    np.random.seed(seeder.integers(0, 2**32 - 1))
    halo_lc_randoms_seed = seeder.integers(0, 2**32 - 1)

    halos = {k: np.asarray(v) for k, v in halos.items()}
    if halo_lc:
        halos['id'] = halos['index_halo']
        halos['x_L2com'] = halos['pos_interp']
        halos['v_L2com'] = halos['vel_interp']
        halos['N'] = halos['N_interp']
    if cleaning:
        halos = _take(halos, halos['N'] > 0)
    nh = len(halos['N'])

    Lbox = header['BoxSizeHMpc']
    Mpart = header['ParticleMassHMsun']
    h = header['H0'] / 100.0

    # halo down-sampling draw
    p_halos = subsample_halos(halos['N'] * Mpart, MT)
    mask_halos = np.random.random(nh) < p_halos
    halos['mask_subsample'] = mask_halos
    halos['multi_halos'] = 1.0 / p_halos

    nbins = 100
    mbins = np.logspace(np.log10(mcut), 15.5, nbins + 1)
    allmasses = halos['N'] * Mpart

    env = None
    if want_AB:
        if halo_lc:
            halos['fenv_rank'] = env_menv_lc(
                halos['x_L2com'], halos['r98_L2com'], allmasses, header['LightConeOrigins'],
                Lbox, rad_outer, mcut, mbins, halo_lc_randoms_seed, engine=menv_engine,
                nthread=nthread, device=device)
        else:
            env = env_menv_periodic(halos, env_halos, Mpart, Lbox, rad_outer, mcut,
                                    engine=menv_engine, nthread=nthread, device=device)
            # fenv is re-ranked globally at staging time
            halos['fenv_rank'] = np.zeros(nh)

        halos_c = halos['r98_L2com'] / halos['r25_L2com']
        deltac_rank = np.zeros(nh)
        for ibin in range(nbins):
            mmask = (allmasses > mbins[ibin]) & (allmasses < mbins[ibin + 1])
            if np.sum(mmask) > 0:
                if np.sum(mmask) == 1:
                    deltac_rank[mmask] = 0
                else:
                    new_deltac = halos_c[mmask] - np.median(halos_c[mmask])
                    r = new_deltac.argsort().argsort()
                    deltac_rank[mmask] = r / np.max(r) - 0.5
        halos['deltac_rank'] = deltac_rank
    else:
        halos['fenv_rank'] = np.zeros(nh)
        halos['deltac_rank'] = np.zeros(nh)

    if want_shear:
        halos['shear_rank'] = shear_rank(halos['x_L2com'], allmasses, mbins, shearmark, Lbox)
    else:
        halos['shear_rank'] = np.zeros(nh)

    # particle submasks, per-halo fields and the rank fields
    halos_pstart = halos['npstartA']
    halos_pnum = halos['npoutA']
    halos_pstart_new = np.zeros(nh)
    halos_pnum_new = np.zeros(nh)

    out_parts = None
    if parts is not None:
        len_old = len(parts['pos'])
        mask_parts = np.zeros(len_old)
        ranks_parts = [np.full(len_old, -1.0) for _ in range(5)]  # r, v, p, r(rad), c
        hvel_parts = np.full((len_old, 3), -1.0)
        Mh_parts = np.full(len_old, -1.0)
        Np_parts = np.full(len_old, -1.0)
        downsample_parts = np.full(len_old, -1.0)
        idh_parts = np.full(len_old, -1)
        deltach_parts = np.full(len_old, -1.0)
        fenvh_parts = np.full(len_old, -1.0)
        shearh_parts = np.full(len_old, -1.0)
        ppos_all = np.asarray(parts['pos'])
        pvel_all = np.asarray(parts['vel'])

        # the random draws: one submask a kept halo, in halo order (the
        # reference's stream); the per-particle columns and the rank
        # engines' inputs are filled after them, for every kept halo at once
        kept = np.flatnonzero(mask_halos & (halos_pnum > 0))
        submasks = [submask_particles(halos['N'][j] * Mpart, int(halos_pnum[j]), MT)
                    for j in kept]
        ps = halos_pstart[kept].astype(np.int64)
        pn = halos_pnum[kept].astype(np.int64)
        first = np.cumsum(pn) - pn  # each kept halo's first row in `idx`
        idx = np.repeat(ps - first, pn) + np.arange(int(pn.sum()))
        owner = np.repeat(kept, pn)
        sub = np.concatenate(submasks) if submasks else np.zeros(0)
        nsub = np.add.reduceat(sub, first) if len(kept) else np.zeros(0)

        mask_parts[idx] = sub
        downsample_parts[idx] = p_halos[owner]
        hvel_parts[idx] = halos['v_L2com'][owner]
        Mh_parts[idx] = halos['N'][owner] * Mpart
        Np_parts[idx] = np.repeat(nsub, pn)
        idh_parts[idx] = halos['id'][owner]
        deltach_parts[idx] = halos['deltac_rank'][owner]
        fenvh_parts[idx] = halos['fenv_rank'][owner]
        shearh_parts[idx] = halos['shear_rank'][owner]
        halos_pstart_new[:] = -1
        halos_pnum_new[:] = -1
        halos_pstart_new[kept] = np.cumsum(nsub) - nsub
        halos_pnum_new[kept] = nsub

        use_device_ranks = want_ranks and ranks_engine != 'host'
        ranked_ps = []
        if want_ranks:
            # a halo's one chosen particle ranks 0; halos of two or more run
            # through the engine (the device engine: all at once after this)
            chosen = sub.astype(bool)
            for arr in ranks_parts:
                arr[idx[chosen & np.repeat(nsub == 1, pn)]] = 0
            multi = nsub >= 2
            rows = np.repeat(multi, pn)
            if use_device_ranks:
                seg_parts = np.full(len_old, -1, np.int32)
                nsub_parts = np.zeros(len_old, np.float64)
                hpos_parts = np.zeros((len_old, 3), np.float32)
                r25h_parts = np.zeros(len_old, np.float32)
                r98h_parts = np.zeros(len_old, np.float32)
                seg_parts[idx[rows]] = np.repeat(np.arange(int(multi.sum())), pn[multi])
                nsub_parts[idx[rows]] = np.repeat(nsub[multi], pn[multi])
                for out, col in ((hpos_parts, 'x_L2com'), (r25h_parts, 'r25_L2com'),
                                 (r98h_parts, 'r98_L2com')):
                    out[idx[rows]] = halos[col][owner[rows]]
                ranked_ps, ranked_pn = ps[multi], pn[multi]
            else:
                r_, rv, rp_, rr, rc = ranks_parts
                for k in np.flatnonzero(multi):
                    j, sl, m = kept[k], slice(ps[k], ps[k] + pn[k]), submasks[k].astype(bool)
                    _rank_fields(
                        np.arange(ps[k], ps[k] + pn[k])[m], ppos_all[sl][m], pvel_all[sl][m],
                        ppos_all[sl], halos['x_L2com'][j], halos['v_L2com'][j],
                        halos['N'][j] * Mpart, halos['r25_L2com'][j], halos['r98_L2com'][j], h,
                        r_, rv, rp_, rr, rc,
                    )

        if use_device_ranks and len(ranked_ps):
            from .ranks_device import rank_fields_device

            dev_ranks = rank_fields_device(
                ppos_all, pvel_all, mask_parts.astype(bool), seg_parts, nsub_parts,
                np.asarray(ranked_ps), np.asarray(ranked_pn), hpos_parts, hvel_parts, Mh_parts,
                r25h_parts, r98h_parts, h, device=device,
            )
            upd = seg_parts >= 0  # keep the loop's -1 and singleton fills
            for arr, new in zip(ranks_parts, dev_ranks):
                arr[upd] = new[upd]

    halos['npstartA'] = halos_pstart_new
    halos['npoutA'] = halos_pnum_new
    halos['randoms'] = np.random.random(nh)
    halos['randoms_exp'] = (
        np.random.randint(0, 2, size=(nh, 3)) * 2 - 1
    ) * np.random.exponential(
        scale=np.repeat(halos['sigmav3d_L2com'], 3).reshape((-1, 3)) / np.sqrt(3),
        size=(nh, 3),
    )
    halos['randoms_gaus_vrms'] = np.random.normal(
        loc=0,
        scale=np.repeat(halos['sigmav3d_L2com'], 3).reshape((-1, 3)) / np.sqrt(3),
        size=(nh, 3),
    )
    order = (HALO_ORDER_LC if halo_lc else HALO_ORDER) + HALO_EXTRA
    out_halos = {k: halos[k][mask_halos] for k in order}

    if parts is not None:
        mask_parts = mask_parts.astype(bool)
        out_parts = {'pos': ppos_all[mask_parts], 'vel': pvel_all[mask_parts]}
        if want_ranks:
            r_, rv, rp_, rr, rc = ranks_parts
            out_parts.update(ranks=r_[mask_parts], ranksv=rv[mask_parts],
                             ranksr=rr[mask_parts], ranksp=rp_[mask_parts],
                             ranksc=rc[mask_parts])
        out_parts['downsample_halo'] = downsample_parts[mask_parts]
        out_parts['halo_vel'] = hvel_parts[mask_parts]
        out_parts['halo_mass'] = Mh_parts[mask_parts]
        out_parts['Np'] = Np_parts[mask_parts]
        out_parts['halo_id'] = idh_parts[mask_parts]
        out_parts['randoms'] = np.random.random(int(mask_parts.sum()))
        out_parts['halo_deltac'] = deltach_parts[mask_parts]
        out_parts['halo_fenv'] = fenvh_parts[mask_parts]
        out_parts['halo_shear'] = shearh_parts[mask_parts]
    return {'halos': out_halos, 'particles': out_parts, 'env': env}


# ---------------------------------------------------------------------------
# the file I/O of prepare_slab and main
# ---------------------------------------------------------------------------

# the halo_info fields prepare_slab reads (:318-321), and a light cone's
SLAB_FIELDS = ['N', 'x_L2com', 'v_L2com', 'r90_L2com', 'r25_L2com', 'r98_L2com', 'npstartA',
               'npoutA', 'id', 'sigmav3d_L2com']
SLAB_FIELDS_LC = ['N_interp', 'pos_interp', 'vel_interp', 'r90_L2com', 'r25_L2com', 'r98_L2com',
                  'npstartA', 'npoutA', 'index_halo', 'sigmav3d_L2com']


def load_env_halos(slabname, cleaning, filter_func=None):
    """The env halos of one slab (prepare_sim.py:125): N, x_L2com, r98_L2com
    and id of the halos `filter_func` keeps, those merged away dropped."""
    halos = CompaSOHaloCatalog(slabname, fields=['N', 'x_L2com', 'r98_L2com', 'id'],
                               cleaned=cleaning, filter_func=filter_func).halos
    if cleaning:
        halos = halos[halos['N'] > 0]
    return halos


def _zdir(simdir, simname, z_mock):
    return f'{simdir}/{simname}/halos/z{str(z_mock).ljust(5, "0")}'


def slab_filenames(savedir, i, newseed, MT, want_ranks):
    """(halos, particles, env) file names of slab i: the JAX package's stems
    (prepare_sim.py:278-290) with _new.npz for _new.h5."""
    halos = f'{savedir}/halos_xcom_{i}_seed{newseed}_abacushod_oldfenv'
    parts = f'{savedir}/particles_xcom_{i}_seed{newseed}_abacushod_oldfenv'
    if MT:
        halos += '_MT'
        parts += '_MT'
    if want_ranks:
        parts += '_withranks'
    env = f'{savedir}/env_xcom_{i}_abacushod_localenv_new.npz'
    return halos + '_new.npz', parts + '_new.npz', env


def read_slab(i, simdir, simname, z_mock, z_type, cleaning, want_AB, numslabs, rad_outer=10,
              halo_lc=False):
    """What prepare_slab reads for box slab i, or with `halo_lc` for the
    light cone: (halo columns, the A particles' pos and vel or None where
    the redshift has none, the header, the padded env's neighbour tables or
    None without want_AB or for a light cone), the arguments of
    :func:`prepare_slab_tables`."""
    zdir = _zdir(simdir, simname, z_mock)
    load_parts = z_type in ('primary', 'lightcone')
    fn = (f'{simdir}/{simname}/z{str(z_mock).ljust(5, "0")}/lc_halo_info.asdf' if halo_lc
          else f'{zdir}/halo_info/halo_info_{i:03d}.asdf')
    cat = CompaSOHaloCatalog(fn, fields=SLAB_FIELDS_LC if halo_lc else SLAB_FIELDS,
                             subsamples=dict(A=True, rv=True) if load_parts else False,
                             cleaned=cleaning)
    if cat.halo_lc != bool(halo_lc):
        raise ValueError(f'{fn}: read as a light cone {cat.halo_lc}, asked for {halo_lc}')
    halos = {k: cat.halos[k] for k in cat.halos.colnames}
    parts = {k: cat.subsamples[k] for k in ('pos', 'vel')} if load_parts else None
    env_halos = None
    if want_AB and not halo_lc:
        x = halos['x_L2com'][:, 0]
        if cleaning:
            x = x[halos['N'] > 0]
        env_halos = []
        for islab, keep in env_pad_slabs(x, i, numslabs, cat.header['BoxSizeHMpc'], rad_outer):
            t = load_env_halos(f'{zdir}/halo_info/halo_info_{islab:03d}.asdf', cleaning,
                               filter_func=keep)
            env_halos.append({k: t[k] for k in t.colnames})
    return halos, parts, cat.header, env_halos


def _to_struct(cols):
    """A dict of columns (in order) as one structured array
    (prepare_sim.py:_table_to_struct)."""
    dt = [(k, v.dtype, v.shape[1:]) if v.ndim > 1 else (k, v.dtype) for k, v in cols.items()]
    out = np.empty(len(next(iter(cols.values()))), dtype=dt)
    for k, v in cols.items():
        out[k] = v
    return out


def write_slab_tables(tables, halos_fn, parts_fn, env_fn):
    """Write the tables of :func:`prepare_slab_tables`: the halos' and the
    particles' structured arrays, and the env sidecar's three arrays."""
    np.savez(halos_fn, halos=_to_struct(tables['halos']))
    if tables['particles'] is not None:
        np.savez(parts_fn, particles=_to_struct(tables['particles']))
    if tables['env'] is not None:
        np.savez(env_fn, **tables['env'])


def prepare_slab(
    i, savedir, simdir, simname, z_mock, z_type, tracer_flags, MT, want_ranks, want_AB,
    want_shear, shearmark, cleaning, newseed, halo_lc=False, nthread=1, overwrite=1,
    mcut=1e11, rad_outer=10, numslabs=None, ranks_engine='auto', menv_engine='auto',
    device=None,
):
    """Read box slab i (with `halo_lc`, the light cone, slab 0), compute its
    tables on `device` (None: the card; 'cpu' runs the kernels' plain
    versions) and write them (prepare_sim.py:254); a light cone writes no
    env sidecar. `shearmark`: the shear field, or the path of its .npy file.
    Skips the slab when its files exist and `overwrite` is 0."""
    halos_fn, parts_fn, env_fn = slab_filenames(savedir, i, newseed, MT, want_ranks)
    if not int(overwrite) and all(os.path.exists(f) for f in (
            [halos_fn, parts_fn] + ([env_fn] if want_AB and not halo_lc else []))):
        print('files exists, skipping ', i)
        return 0
    print('processing slab ', i)
    if isinstance(shearmark, (str, Path)):
        shearmark = np.load(shearmark, mmap_mode='r')
    halos, parts, header, env_halos = read_slab(i, simdir, simname, z_mock, z_type, cleaning,
                                                want_AB, numslabs, rad_outer, halo_lc=halo_lc)
    tables = prepare_slab_tables(
        halos, parts, header, i=i, MT=MT, want_ranks=want_ranks, want_AB=want_AB,
        want_shear=want_shear, shearmark=shearmark, newseed=newseed, halo_lc=halo_lc, mcut=mcut,
        rad_outer=rad_outer, env_halos=env_halos, cleaning=cleaning, ranks_engine=ranks_engine,
        menv_engine=menv_engine, nthread=nthread, device=device)
    write_slab_tables(tables, halos_fn, parts_fn, env_fn)


def calc_shearmark(simdir, simname, z_mock, N_dim, R, fn, partdown=100, device=None):
    """The shear field of prepare_sim.py:calc_shearmark (:851): a random
    1/`partdown` of the field and halo A particles (drawn from the legacy
    np.random, file by file), painted with K1 on `device` (None: the card),
    smoothed on the host and turned into the shear invariant; saved as
    `fn`.npy and returned."""
    zdir = _zdir(simdir, simname, z_mock)
    partpos = []
    for sub in ('field_rv_A', 'halo_rv_A'):
        for efn in glob.glob(f'{zdir}/{sub}/*asdf'):
            pos = read_asdf(efn, load=['pos'])['pos']
            sel = np.random.choice(len(pos), size=int(len(pos) / partdown), replace=False)
            partpos.append(pos[sel])
    pos_parts = np.concatenate(partpos)
    print('compiled all particles', len(pos_parts))
    lbox = CompaSOHaloCatalog(zdir, fields=['N'], cleaned=True).header['BoxSizeHMpc']
    shearmark = shearmark_from_positions(pos_parts, N_dim, R, lbox, device=device)
    np.save(fn + '.npy', shearmark)
    return shearmark


def main(path2config, params=None, alt_simname=None, alt_z=None, newseed=600, halo_lc=False,
         overwrite=1, device=None, slabs=None):
    """Drive prepare_slab over the superslabs, or over the light cone's one
    file with ``sim_params.halo_lc`` (or `halo_lc`) set (prepare_sim.py:main,
    :896).

    path2config: the config (``sim_params``, ``HOD_params``, ``prepare_sim``)
    as a dict or a JSON file; `params` updates it. device: where the engines
    run (None: the card; 'cpu' their plain versions), handed to each pool
    worker. slabs: the slab indices to process (None: all). With
    ``prepare_sim.Nparallel_load`` > 1 the slabs run in a pool of spawned
    processes; each slab reseeds at entry, so the tables equal the serial
    run's. A pool that breaks raises."""
    config = load_config(path2config)
    if params:
        config.update(params)
    if alt_simname:
        config['sim_params']['sim_name'] = alt_simname
    if alt_z:
        config['sim_params']['z_mock'] = alt_z
    simname = config['sim_params']['sim_name']
    simdir = config['sim_params']['sim_dir']
    z_mock = float(config['sim_params']['z_mock'])
    savedir = config['sim_params']['subsample_dir'] + simname + '/z' + str(z_mock).ljust(5, '0')
    cleaning = config['sim_params']['cleaned_halos']
    halo_lc = config['sim_params'].get('halo_lc', halo_lc)
    ztype = z_type_of(z_mock, halo_lc)
    if halo_lc:
        numslabs = 1  # one light-cone file (prepare_sim.py:934-937)
    else:
        search_path = Path(simdir) / simname / 'halos' / ('z%4.3f' % z_mock) / 'halo_info'
        numslabs = len(list(search_path.glob('*.asdf')))
        if not numslabs:
            raise ValueError(f'no halo info files found in {search_path}')
    os.makedirs(savedir, exist_ok=True)
    device = str(resolve_device(device))

    hod = config['HOD_params']
    tracer_flags = hod['tracer_flags']
    MT = bool(tracer_flags['ELG'] or tracer_flags['QSO'])
    want_ranks = hod.get('want_ranks', False)
    want_AB = hod.get('want_AB', False)
    want_shear = hod.get('want_shear', False)
    shearmark = shear_fn = None
    if want_shear:
        if ztype != 'primary' and not halo_lc:
            raise ValueError('redshift does not have particle data, cant compute shear')
        Ndim, Rsm = hod.get('shear_N', 1000), hod.get('shear_R', 2)
        partdown = hod.get('partdown', 100)
        shear_fn = f'{savedir}/shear_N{Ndim}_R{Rsm}_down{partdown}'
        if os.path.exists(shear_fn + '.npy'):
            shearmark = np.load(shear_fn + '.npy')
        else:
            print('computing shear field')
            shearmark = calc_shearmark(simdir, simname, z_mock, Ndim, Rsm, shear_fn, partdown,
                                       device=device)

    prep = config.get('prepare_sim', {})
    nparallel = prep.get('Nparallel_load', 1)
    nthread = prep.get('Nthread_per_load', 'auto')
    nthread = (max(1, len(os.sched_getaffinity(0)) // nparallel) if nthread == 'auto'
               else int(nthread))
    kwargs = dict(
        savedir=savedir, simdir=simdir, simname=simname, z_mock=z_mock, z_type=ztype,
        tracer_flags=tracer_flags, MT=MT, want_ranks=want_ranks, want_AB=want_AB,
        want_shear=want_shear, shearmark=shearmark, cleaning=cleaning, newseed=newseed,
        halo_lc=halo_lc, nthread=nthread, overwrite=overwrite, numslabs=numslabs,
        ranks_engine=prep.get('ranks_engine', 'auto'),
        menv_engine=prep.get('menv_engine', 'auto'), device=device,
    )
    slabs = list(range(numslabs)) if slabs is None else list(slabs)
    if nparallel <= 1 or len(slabs) == 1:
        for i in slabs:
            prepare_slab(i, **kwargs)
        return
    # each slab reseeds np.random at entry, so the pool's tables equal the
    # serial run's; the workers read the shear field from its file
    if want_shear:
        kwargs['shearmark'] = shear_fn + '.npy'
    with concurrent.futures.ProcessPoolExecutor(
        max_workers=nparallel, mp_context=multiprocessing.get_context('spawn'),
    ) as pool:
        futures = [pool.submit(prepare_slab, i, **kwargs) for i in slabs]
        for future in concurrent.futures.as_completed(futures):
            future.result()


def _cli(argv=None):
    """The command line of prepare_sim.py's ``__main__`` (its flags and
    defaults; --path2config a JSON file), with --device."""
    import argparse

    from .utils import ArgParseFormatter

    parser = argparse.ArgumentParser(description=__doc__, formatter_class=ArgParseFormatter)
    parser.add_argument('--path2config', help='Path to the config file (JSON)',
                        default=DEFAULT_CONFIG)
    parser.add_argument('--alt_simname', help='alternative simname to process')
    parser.add_argument('--alt_z', help='alternative z to process, like "0.8"', type=float)
    parser.add_argument('--newseed', help='alternative random number seed, positive integer',
                        default=600, type=int)
    parser.add_argument('--overwrite', help='overwrite existing subsamples', default=1, type=int)
    parser.add_argument('--halo_lc', help='process the light cone halo catalogs', default=False,
                        action='store_true')
    parser.add_argument('--device', help='torch device of the engines (default: the card)')
    main(**vars(parser.parse_args(argv)))
    print('done')


if __name__ == '__main__':
    _cli()
