r"""Central/satellite galaxy population (elementwise PyTorch).

Counterpart of abacusutils_tpu/models/hod/population.py: the markers
``_cent_marker`` and ``_sat_base`` for LRG, ELG (with conformity and the
shear terms) and QSO, the priority keep codes ``_cent_codes`` /
``_sat_codes`` (shared with the fused route of models/pipeline.py),
``_apply_rsd`` (plane-parallel z and the light-cone line of sight),
``_rank_multiplier``, the host function ``prepare_tracer_params``, and the
two-step population ``gen_cent``, ``gen_sats`` and ``gen_gals`` with
``_compact``, which selects each tracer's kept rows on the device and copies
only those to the host.

Markers take 0-d float32 parameter tensors (``convert.params_to_tensors``),
so their scalar arithmetic runs in float32, as under jax.jit.
"""

import numpy as np
import torch

from ...convert import params_to_tensors, resolve_device
from . import shapes

__all__ = [
    'TRACER_ORDER',
    'prepare_tracer_params',
    'halo_catalog',
    'flat_catalogs',
    'populate_nfw',
    'gen_gal_cat',
    'write_catalogs',
    'gen_cent',
    'compute_cent_keep',
    'gen_sats',
    'gen_gals',
    'wrap',
    'fast_concatenate',
]

TRACER_ORDER = ('LRG', 'ELG', 'QSO')


def _wrap_centered(x, L):
    """Wrap to [-L/2, L/2) with a single correction (reference wrap:128-136)."""
    L2 = L / 2
    x = torch.where(x >= L2, x - L, x)
    return torch.where(x < -L2, x + L, x)


def _cent_marker(tracer, p, mass, deltac, fenv, shear):
    """Expected central occupation for one tracer with assembly bias."""
    if tracer == 'LRG':
        logM_cut = p['logM_cut'] + p['Acent'] * deltac + p['Bcent'] * fenv
        return shapes.n_cen_LRG(mass, logM_cut, p['sigma']) * p['ic']
    if tracer == 'ELG':
        logM_cut = p['logM_cut'] + p['Acent'] * deltac + p['Bcent'] * fenv + p['Ccent'] * shear
        return (
            shapes.N_cen_ELG_v1(mass, p['p_max'], p['Q'], logM_cut, p['sigma'], p['gamma'])
            * p['ic']
        )
    if tracer == 'QSO':
        logM_cut = p['logM_cut'] + p['Acent'] * deltac + p['Bcent'] * fenv
        return shapes.N_cen_QSO(mass, logM_cut, p['sigma']) * p['ic']
    raise ValueError(tracer)


def _sat_base(tracer, p, mass, deltac, fenv, shear, keep_cent):
    """Expected satellite count per particle for one tracer (before weights);
    `keep_cent` is the host halo's central keep code (ELG conformity)."""
    if tracer == 'LRG':
        M1 = 10 ** (p['logM1'] + p['Asat'] * deltac + p['Bsat'] * fenv)
        logM_cut = p['logM_cut'] + p['Acent'] * deltac + p['Bcent'] * fenv
        return shapes.n_sat_LRG_modified(
            mass, logM_cut, 10**logM_cut, M1, p['sigma'], p['alpha'], p['kappa']
        )
    if tracer == 'ELG':
        logM_cut = p['logM_cut'] + p['Acent'] * deltac + p['Bcent'] * fenv + p['Ccent'] * shear
        Mcut = 10**logM_cut
        M1 = 10 ** (p['logM1'] + p['Asat'] * deltac + p['Bsat'] * fenv + p['Csat'] * shear)
        base = shapes.N_sat_elg(mass, Mcut, p['kappa'], M1, p['alpha'], p['A_s'])
        # conformity: host has an LRG (1) or ELG (2) central
        M1_EL = 10 ** (p['logM1_EL'] + p['Asat'] * deltac + p['Bsat'] * fenv)
        base_EL = shapes.N_sat_elg(mass, Mcut, p['kappa'], M1_EL, p['alpha_EL'], p['A_s'])
        M1_EE = 10 ** (p['logM1_EE'] + p['Asat'] * deltac + p['Bsat'] * fenv)
        base_EE = shapes.N_sat_elg(mass, Mcut, p['kappa'], M1_EE, p['alpha_EE'], p['A_s'])
        base = torch.where(keep_cent == 1, base_EL, base)
        return torch.where(keep_cent == 2, base_EE, base)
    if tracer == 'QSO':
        M1 = 10 ** (p['logM1'] + p['Asat'] * deltac + p['Bsat'] * fenv)
        logM_cut = p['logM_cut'] + p['Acent'] * deltac + p['Bcent'] * fenv
        return shapes.N_sat_generic(mass, 10**logM_cut, p['kappa'], M1, p['alpha'])
    raise ValueError(tracer)


def _apply_rsd(x, y, z, vx, vy, vz, rsd, inv_velz2kms, lbox, origin):
    """Redshift-space positions: along the line of sight from `origin` (a
    (3,) tensor) when given, else along z with a single periodic wrap."""
    if not rsd:
        return x, y, z
    if origin is not None:
        nx = x - origin[0]
        ny = y - origin[1]
        nz = z - origin[2]
        # a division, as XLA computes 1.0 / sqrt (not an rsqrt)
        inv_norm = 1.0 / torch.sqrt(nx * nx + ny * ny + nz * nz)
        nx = nx * inv_norm
        ny = ny * inv_norm
        nz = nz * inv_norm
        proj = inv_velz2kms * (vx * nx + vy * ny + vz * nz)
        return x + proj * nx, y + proj * ny, z + proj * nz
    return x, y, _wrap_centered(z + vz * inv_velz2kms, lbox)


def _rank_multiplier(p, part):
    """Velocity/distance rank decoration factor on the satellite rate
    (reference GRAND_HOD.py:1042-1050); `part` carries the staged
    ranks/ranksv/ranksp/ranksr columns."""
    return (
        1
        + p['s'] * part['ranks']
        + p['s_v'] * part['ranksv']
        + p['s_p'] * part['ranksp']
        + p['s_r'] * part['ranksr']
    )


def prepare_tracer_params(tracers, z):
    """Fill in defaults + z-evolution for each tracer's HOD parameters
    (reference gen_gals GRAND_HOD.py:1341-1468). Host Python floats."""
    out = {}
    for tracer, HOD in tracers.items():
        p = {k: float(v) for k, v in HOD.items() if np.isscalar(v)}
        Delta_a = 1.0 / (1 + z) - 1.0 / (1 + HOD.get('z_pivot', z))
        p['logM_cut'] = HOD['logM_cut'] + HOD.get('logM_cut_pr', 0.0) * Delta_a
        p['logM1'] = HOD['logM1'] + HOD.get('logM1_pr', 0.0) * Delta_a
        for k, default in [
            ('Acent', 0.0), ('Asat', 0.0), ('Bcent', 0.0), ('Bsat', 0.0),
            ('ic', 1.0), ('f_sigv', 0.0), ('alpha_c', 0.0), ('alpha_s', 1.0),
            ('s', 0.0), ('s_v', 0.0), ('s_p', 0.0), ('s_r', 0.0),
        ]:
            p.setdefault(k, default)
        if tracer == 'ELG':
            p.setdefault('Ccent', HOD.get('Ccent', 0.0))
            p.setdefault('Csat', HOD.get('Csat', 0.0))
            p['logM1_EE'] = HOD.get('logM1_EE', p['logM1'])
            p['alpha_EE'] = HOD.get('alpha_EE', p['alpha'])
            p['logM1_EL'] = HOD.get('logM1_EL', p['logM1'])
            p['alpha_EL'] = HOD.get('alpha_EL', p['alpha'])
            p.setdefault('exp_frac', 0.0)
            p.setdefault('exp_scale', 1.0)
            p.setdefault('nfw_rescale', 1.0)
        out[tracer] = p
    return out


def _cent_codes(halo, params, want):
    """Central priority keep codes (int8) over stacked tracer markers (one
    random per halo, reference gen_cent GRAND_HOD.py:213-252)."""
    marker = torch.zeros_like(halo['mass'])
    keep_c = torch.zeros(halo['mass'].shape, dtype=torch.int8, device=halo['mass'].device)
    for code, tracer in enumerate(TRACER_ORDER, 1):
        if tracer not in want:
            continue
        m = _cent_marker(
            tracer, params[tracer], halo['mass'], halo['deltac'], halo['fenv'],
            halo.get('shear', 0.0),
        )
        marker = marker + m * halo['multis']
        keep_c.masked_fill_((keep_c == 0) & (halo['randoms'] <= marker), code)
    return keep_c


def _sat_codes(part, params, want, keep_cent_p):
    """Satellite priority keep codes (int8; reference gen_sats
    GRAND_HOD.py:948-1095); `keep_cent_p` is each particle's host-central
    code (conformity). Rank decorations multiply the base rate when the
    staged columns are present (reference GRAND_HOD.py:1042-1050)."""
    marker = torch.zeros_like(part['hmass'])
    keep_s = torch.zeros(part['hmass'].shape, dtype=torch.int8, device=part['hmass'].device)
    for code, tracer in enumerate(TRACER_ORDER, 1):
        if tracer not in want:
            continue
        p = params[tracer]
        base = _sat_base(
            tracer, p, part['hmass'], part['deltac'], part['fenv'],
            part.get('shear', 0.0), keep_cent_p,
        )
        base = base * part['weights'] * p['ic']
        if 'ranks' in part:
            # multiply AFTER weights*ic, matching _sat_core's f32 rounding
            base = base * _rank_multiplier(p, part)
        marker = marker + base
        keep_s.masked_fill_((keep_s == 0) & (part['randoms'] <= marker), code)
    return keep_s


_RANK_COLUMNS = (('ranks', 'pranks'), ('ranksv', 'pranksv'), ('ranksp', 'pranksp'),
                 ('ranksr', 'pranksr'))


def _column(a, device, k=None):
    """Column `a` (or column k of an (N, 3) array) as float32 on `device`;
    numpy arrays and tensors alike."""
    if isinstance(a, torch.Tensor):
        a = a if k is None else a[:, k]
        return a.to(device, torch.float32).contiguous()
    a = np.asarray(a) if k is None else np.asarray(a)[:, k]
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(device)


def _index(a, device):
    """An index column as int32 on `device`."""
    if isinstance(a, torch.Tensor):
        return a.to(device, torch.int32)
    return torch.from_numpy(np.asarray(a, np.int32)).to(device)


def _or_zeros(data, key, like, device):
    """Column `key` as float32 on `device`, or zeros as long as column `like`
    where the data has no such column."""
    if key in data:
        return _column(data[key], device)
    return torch.zeros(len(data[like]), dtype=torch.float32, device=device)


def _exact(a, device):
    """A column on `device` in its own dtype (the catalog's mass and id come
    back exactly)."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def halo_catalog(halo_data, device, shear=False):
    """The halo half of :func:`flat_catalogs`: the staged halo columns as
    flat tensors on `device` (x/y/z, vx/vy/vz, vdevx/..., mass, multis,
    randoms, deltac, fenv, with `shear` the ``hshear`` column when present,
    and cat_mass and cat_id in their own dtypes)."""
    hd = halo_data
    halo = {
        'mass': _column(hd['hmass'], device), 'multis': _column(hd['hmultis'], device),
        'randoms': _column(hd['hrandoms'], device),
        'deltac': _or_zeros(hd, 'hdeltac', 'hmass', device),
        'fenv': _or_zeros(hd, 'hfenv', 'hmass', device),
        'cat_mass': _exact(hd['hmass'], device), 'cat_id': _exact(hd['hid'], device),
    }
    for i, a in enumerate('xyz'):
        halo[a] = _column(hd['hpos'], device, i)
        halo[f'v{a}'] = _column(hd['hvel'], device, i)
        halo[f'vdev{a}'] = _column(hd['hveldev'], device, i)
    if shear and 'hshear' in hd:
        halo['shear'] = _column(hd['hshear'], device)
    return halo


def flat_catalogs(halo_data, particle_data, device, shear=False, ranks=False):
    """The staged column dicts of AbacusHOD.staging() (``hpos``, ``hvel``,
    ``hveldev``, ``hmass``, ``hid``, ... and ``ppos``, ``pvel``, ``phvel``,
    ``phmass``, ``phid``, ``pinds``, ...) as flat tensors on `device`, in
    catalog order: float32 x/y/z, vx/vy/vz and vdevx/... (halos) or
    hvelx/... (particles), the marker columns (deltac and fenv as zeros
    where absent), with `shear` the ``hshear`` / ``pshear`` columns that
    exist, the four rank columns with `ranks`, part['hidx'], each
    particle's int32 host index, and the catalog columns ``cat_mass`` and
    ``cat_id`` in their own dtypes (run_hod's mass and id)."""
    pd = particle_data

    def c(a, k=None):
        return _column(a, device, k)

    halo = halo_catalog(halo_data, device, shear)
    part = {
        'hmass': c(pd['phmass']), 'weights': c(pd['pweights']), 'randoms': c(pd['prandoms']),
        'deltac': _or_zeros(pd, 'pdeltac', 'phmass', device),
        'fenv': _or_zeros(pd, 'pfenv', 'phmass', device),
        'hidx': _index(pd['pinds'], device),
        'cat_mass': _exact(pd['phmass'], device), 'cat_id': _exact(pd['phid'], device),
    }
    for i, a in enumerate('xyz'):
        part[a] = c(pd['ppos'], i)
        part[f'v{a}'] = c(pd['pvel'], i)
        part[f'hvel{a}'] = c(pd['phvel'], i)
    if shear and 'pshear' in pd:
        part['shear'] = c(pd['pshear'])
    if ranks:
        for k, col in _RANK_COLUMNS:
            part[k] = c(pd[col])
    return halo, part


def _phase_space(cat, params, want, rsd, inv_velz2kms, lbox, origin, central):
    """Per tracer, the galaxy positions after RSD and velocities of every
    object: centrals vel + alpha_c vdev, satellites hvel + alpha_s
    (pvel - hvel) (_cent_core / _sat_core)."""
    out = {}
    for tracer in want:
        p = params[tracer]
        if central:
            v = [cat[f'v{a}'] + p['alpha_c'] * cat[f'vdev{a}'] for a in 'xyz']
        else:
            v = [cat[f'hvel{a}'] + p['alpha_s'] * (cat[f'v{a}'] - cat[f'hvel{a}']) for a in 'xyz']
        x, y, z = _apply_rsd(cat['x'], cat['y'], cat['z'], *v, rsd, inv_velz2kms, lbox, origin)
        out[tracer] = (x, y, z, *v)
    return out


def _to_host(t):
    """A tensor as a numpy array; from the device through a pinned buffer,
    so the copy runs at DMA speed and the array stays in page-locked memory
    (a later upload of it, in compute_power, is fast too)."""
    if t.device.type == 'cpu':
        return t.numpy()
    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    buf.copy_(t)
    return buf.numpy()


def _compact(parts, want):
    """Each tracer's kept rows as a host numpy dict {Ncent, x, y, z, vx, vy,
    vz, mass, id} (population.py:_compact and gen_gals' concatenation).
    `parts` is a list of (keep codes, phase space, catalog mass, catalog
    id) on the device, centrals first; Ncent counts the rows of the first.
    The rows are selected on the device by the mask keep == code, in
    flatnonzero order, gathered into one block per tracer, and only they
    are copied to the host; id is int64."""
    result = {}
    for tracer in want:
        code = TRACER_ORDER.index(tracer) + 1
        sels = [torch.nonzero(keep == code).squeeze(1) for keep, *_ in parts]

        def rows(get):
            return torch.cat([get(part).index_select(0, s) for part, s in zip(parts, sels)])

        phase = torch.stack([rows(lambda part, k=k: part[1][tracer][k]) for k in range(6)])
        td = {'Ncent': int(sels[0].numel())}
        td.update(zip(('x', 'y', 'z', 'vx', 'vy', 'vz'), _to_host(phase)))
        td['mass'] = _to_host(rows(lambda part: part[2]))
        td['id'] = _to_host(rows(lambda part: part[3]).to(torch.int64))
        result[tracer] = td
    return result


def _tensor_params(tracer_params, want, device):
    return {t: params_to_tensors(tracer_params[t], device) for t in want}


def _origin(origin, device):
    if origin is None:
        return None
    return torch.from_numpy(np.asarray(origin, np.float32).reshape(3)).to(device)


def _inv_velz2kms(velz2kms):
    # 1.0 / velz2kms on the host, then f32, as a jit argument rounds it
    return float(np.float32(1.0 / float(velz2kms)))


def _cols3(a, device):
    return {ax: _column(a, device, i) for i, ax in enumerate('xyz')}


def _one(cats):
    """gen_cent / gen_sats catalogs: without gen_gals' Ncent."""
    for td in cats.values():
        del td['Ncent']
    return cats


def gen_cent(
    pos, vel, mass, ids, multis, randoms, vdev, deltac, fenv, shear,
    tracer_params, rsd, inv_velz2kms, lbox, want, origin=None, device='cuda',
):
    """Populate central galaxies on `device` (population.py:gen_cent; the
    card unless the caller names another; raises where there is none).
    tracer_params comes from :func:`prepare_tracer_params`. Returns (dict of
    tracer -> catalog, keep codes as int8 numpy)."""
    device = resolve_device(device)
    halo = {
        'mass': _column(mass, device), 'multis': _column(multis, device),
        'randoms': _column(randoms, device), 'deltac': _column(deltac, device),
        'fenv': _column(fenv, device), 'shear': _column(shear, device),
    }
    halo.update(_cols3(pos, device))
    for k, v in _cols3(vel, device).items():
        halo[f'v{k}'] = v
    for k, v in _cols3(vdev, device).items():
        halo[f'vdev{k}'] = v
    params = _tensor_params(tracer_params, want, device)
    keep = _cent_codes(halo, params, want)
    out = _phase_space(
        halo, params, want, rsd, float(np.float32(inv_velz2kms)), lbox, _origin(origin, device),
        True,
    )
    cats = _compact([(keep, out, _exact(mass, device), _exact(ids, device))], want)
    return _one(cats), keep.cpu().numpy()


def compute_cent_keep(*args, **kwargs):
    """The central keep codes alone (population.py:compute_cent_keep): the
    second result of :func:`gen_cent` on the same arguments."""
    return gen_cent(*args, **kwargs)[1]


def gen_sats(
    ppos, pvel, hvel, hmass, hid, weights, randoms, hdeltac, hfenv, hshear,
    enable_ranks, ranks, ranksv, ranksp, ranksr,
    tracer_params, rsd, inv_velz2kms, lbox, want, origin, keep_cent, device='cuda',
):
    """Populate satellite galaxies on `device` (population.py:gen_sats; the
    card unless the caller names another); `keep_cent` is each particle's
    host-central keep code (conformity). Returns the dict of tracer ->
    catalog."""
    device = resolve_device(device)
    part = {
        'hmass': _column(hmass, device), 'weights': _column(weights, device),
        'randoms': _column(randoms, device), 'deltac': _column(hdeltac, device),
        'fenv': _column(hfenv, device), 'shear': _column(hshear, device),
    }
    part.update(_cols3(ppos, device))
    for k, v in _cols3(pvel, device).items():
        part[f'v{k}'] = v
    for k, v in _cols3(hvel, device).items():
        part[f'hvel{k}'] = v
    if enable_ranks:
        for k, a in zip(('ranks', 'ranksv', 'ranksp', 'ranksr'), (ranks, ranksv, ranksp, ranksr)):
            part[k] = _column(a, device)
    keep_cent = torch.as_tensor(np.asarray(keep_cent, np.int8)).to(device)
    params = _tensor_params(tracer_params, want, device)
    keep = _sat_codes(part, params, want, keep_cent)
    out = _phase_space(
        part, params, want, rsd, float(np.float32(inv_velz2kms)), lbox, _origin(origin, device),
        False,
    )
    return _one(_compact([(keep, out, _exact(hmass, device), _exact(hid, device))], want))


def populate_flat(halo, part, tracer_params, want, rsd, velz2kms, lbox, origin, verbose=False):
    """The two-step population on flat device catalogs (:func:`flat_catalogs`):
    the keep codes of the fused route (_cent_codes, then _sat_codes through
    part['hidx']), the phase space of every object, and the compaction.
    Returns the gen_gals mock dict: per tracer {Ncent, x, y, z, vx, vy, vz,
    mass, id}, centrals first."""
    device = halo['x'].device
    params = _tensor_params(tracer_params, want, device)
    inv = _inv_velz2kms(velz2kms)
    org = _origin(origin, device)
    keep_c = _cent_codes(halo, params, want)
    keep_s = _sat_codes(part, params, want, keep_c[part['hidx']])
    mock = _compact([
        (keep_c, _phase_space(halo, params, want, rsd, inv, lbox, org, True),
         halo['cat_mass'], halo['cat_id']),
        (keep_s, _phase_space(part, params, want, rsd, inv, lbox, org, False),
         part['cat_mass'], part['cat_id']),
    ], want)
    if verbose:
        for tracer, td in mock.items():
            n = len(td['x'])
            print(tracer, 'number of galaxies', n)
            print('satellite fraction', (n - td['Ncent']) / max(n, 1))
    return mock


def populate_nfw(halo, halos_array, tracer_params, want, rsd, velz2kms, lbox, origin, NFW_draw,
                 verbose=False):
    """The two-step population with NFW satellites (population.py:gen_gals
    with nfw=True): the centrals' keep codes and phase space on the device
    from the flat halo catalog `halo` (:func:`halo_catalog`), the keep codes
    downloaded once, and the satellites of :func:`nfw.gen_sats_nfw` drawn on
    the host from the staged halo columns `halos_array` (no particle is
    read). Returns the gen_gals mock dict, centrals first, the columns of
    both concatenated as numpy concatenates them (float64 positions and
    velocities, int64 id)."""
    from .nfw import gen_sats_nfw

    device = halo['x'].device
    params = _tensor_params(tracer_params, want, device)
    keep_c = _cent_codes(halo, params, want)
    cent = _compact([
        (keep_c, _phase_space(halo, params, want, rsd, _inv_velz2kms(velz2kms), lbox,
                              _origin(origin, device), True),
         halo['cat_mass'], halo['cat_id']),
    ], want)
    sats = gen_sats_nfw(NFW_draw, halos_array, tracer_params, want, rsd, 1.0 / velz2kms, lbox,
                        _to_host(keep_c), None)
    mock = {}
    for tracer in want:
        c, sat = cent[tracer], sats[tracer]
        td = {'Ncent': c['Ncent']}
        for k in ('x', 'y', 'z', 'vx', 'vy', 'vz', 'mass'):
            td[k] = np.concatenate([c[k], sat[k]])
        td['id'] = np.concatenate([c['id'], sat['id'].astype(np.int64)])
        if verbose:
            print(tracer, 'number of galaxies', len(td['x']))
            print('satellite fraction', len(sat['x']) / max(len(td['x']), 1))
        mock[tracer] = td
    return mock


def gen_gals(
    halos_array, subsample, tracers, params, Nthread=None, enable_ranks=False, rsd=True,
    verbose=False, nfw=False, NFW_draw=None, device='cuda',
):
    """Multi-tracer population: centrals + satellites -> mock dict
    (population.py:gen_gals): per tracer {Ncent, x, y, z, vx, vy, vz, mass,
    id}, centrals first. The staged columns go to `device` (the card unless
    the caller names another) once; only the kept rows come back. With
    `nfw`, the satellites follow NFW profiles (:func:`populate_nfw`, drawn
    from `NFW_draw`) and `subsample` is not read."""
    device = resolve_device(device)
    want = tuple(t for t in TRACER_ORDER if t in tracers)
    tparams = prepare_tracer_params({t: tracers[t] for t in want}, params['z'])
    if nfw:
        return populate_nfw(
            halo_catalog(halos_array, device, True), halos_array, tparams, want, rsd,
            params['velz2kms'], params['Lbox'], params['origin'], NFW_draw, verbose,
        )
    halo, part = flat_catalogs(halos_array, subsample, device, True, enable_ranks)
    return populate_flat(
        halo, part, tparams, want, rsd, params['velz2kms'], params['Lbox'], params['origin'],
        verbose,
    )


def write_catalogs(HOD_dict, tracers, outdir, chunk=-1):
    """One ECSV table a tracer of the mock dict in `outdir`, made if need
    be: ``{tracer}s.dat``, or ``{tracer}s_chunk{n}.dat`` for a chunk n other
    than -1; the columns of the mock, meta Ncent, Gal_type and the tracer's
    HOD parameters (abacus_hod.py:run_hod, population.py:gen_gal_cat;
    io/table.py)."""
    from pathlib import Path

    from ...io.table import Table

    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    for tracer in tracers:
        td = dict(HOD_dict[tracer])
        Ncent = td.pop('Ncent')
        name = f'{tracer}s.dat' if chunk == -1 else f'{tracer}s_chunk{chunk:d}.dat'
        Table(td, meta={'Ncent': Ncent, 'Gal_type': tracer, **tracers[tracer]}).write(
            outdir / name)


def gen_gal_cat(
    halo_data, particle_data, tracers, params, Nthread=16, enable_ranks=False, rsd=True,
    nfw=False, NFW_draw=None, write_to_disk=False, savedir='./', verbose=False, fn_ext=None,
    device='cuda',
):
    """gen_gals plus, with write_to_disk, one ECSV table a tracer
    (population.py:gen_gal_cat): ``{savedir}/galaxies{_rsd}{fn_ext}/
    {tracer}s.dat`` (:func:`write_catalogs`)."""
    import os

    if not isinstance(rsd, bool):
        raise ValueError('Error: rsd has to be a boolean')
    HOD_dict = gen_gals(halo_data, particle_data, tracers, params, Nthread, enable_ranks, rsd,
                        verbose, nfw, NFW_draw, device)
    if write_to_disk and tracers:
        write_catalogs(HOD_dict, tracers, os.path.join(
            savedir, 'galaxies' + ('_rsd' if rsd else '') + (fn_ext or '')))
    return HOD_dict


def wrap(x, L):
    """Scalar periodic wrap into [-L/2, L/2) (reference GRAND_HOD.py:129-136)."""
    L2 = L / 2
    if x >= L2:
        return x - L
    if x < -L2:
        return x + L
    return x


def fast_concatenate(array1, array2, Nthread=1):
    """Concatenate two arrays (population.py:fast_concatenate)."""
    if len(array1) == 0:
        return array2
    if len(array2) == 0:
        return array1
    return np.concatenate([array1, array2])
