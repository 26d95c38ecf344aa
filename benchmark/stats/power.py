"""``AbacusHOD.run_hod`` then ``compute_power``: the galaxy catalogs on the
host, then P(k, mu) and the Legendre poles of every tracer pair on a mesh of
``num_cells`` (docs/hod.md's two-step route). The reference populates the
catalog itself and paints, transforms and bins its own galaxies."""

import numpy as np

from benchmark.reference import hod as ref_hod
from benchmark.reference import mesh as ref_mesh
from benchmark.stats import common

# the AbacusHOD method whose return value is the answer (the tests' answer fault)
PRODUCES = 'compute_power'

# the CPU tests' small size: a 40^3 mesh, 16 k bins to k = 0.06 h/Mpc
SMALL = {'call': {'num_cells': 40, 'nbins_k': 16, 'k_hMpc_max': 0.06}}


def _edges(call, lbox):
    nk, nmu = int(call['nbins_k']), int(call['nbins_mu'])
    kmax = float(call['k_hMpc_max'])
    if call.get('logk'):
        kedges = np.geomspace((1.0 - 1.0e-4) * 2.0 * np.pi / lbox, kmax, nk + 1)
    else:
        kedges = np.linspace(0.0, kmax, nk + 1)
    return kedges, np.linspace(0.0, 1.0, nmu + 1)


def _answer(res, ts, n_gal):
    keys = common.pairs(ts)
    return {
        'pk': {(a, b): np.asarray(res[f'{a}_{b}']) for a, b in keys},
        'modes': {(a, b): np.asarray(res[f'{a}_{b}_modes']) for a, b in keys},
        'ell': {(a, b): np.asarray(res[f'{a}_{b}_ell']) for a, b in keys},
        'ell_modes': {(a, b): np.asarray(res[f'{a}_{b}_ell_modes']) for a, b in keys},
        'n_gal': n_gal,
    }


def evaluate(hod, tracers, call):
    """The program's answer ({'pk', 'modes', 'ell', 'ell_modes', 'n_gal'})
    and its mock."""
    mock = hod.run_hod(tracers=tracers, want_rsd=call.get('want_rsd', True))
    kw = {k: call[k] for k in ('nbins_k', 'nbins_mu', 'k_hMpc_max', 'logk', 'poles',
                               'num_cells', 'paste', 'compensated', 'interlaced') if k in call}
    res = hod.compute_power(mock, **kw)
    ts = common.want(tracers)
    return _answer(res, ts, {t: float(len(mock[t]['x'])) for t in ts}), mock


def reference(cat, cfg, tracers, call, P):
    if call.get('interlaced') or call.get('paste', 'TSC').upper() != 'TSC':
        raise ValueError('the reference paints TSC without interlacing')
    lbox = float(cfg['Lbox'])
    n = int(call['num_cells'])
    gals = ref_hod.galaxies(cat, cfg, tracers, P, rsd=call.get('want_rsd', True))
    ts = common.want(tracers)
    fields = [ref_mesh.fourier_field(gals[t]['pos'], n, lbox, P) for t in ts]
    kedges, muedges = _edges(call, lbox)
    poles = tuple(int(p) for p in call.get('poles', ()))
    window = ref_mesh.tsc_compensation(n, lbox) if call.get('compensated') else None
    spectra, counts, pcounts = ref_mesh.binned_spectra(fields, lbox, kedges, muedges, poles,
                                                       window, P)
    del fields
    res = {}
    for (i, j), (pk, pp) in spectra.items():
        a, b = ts[i], ts[j]
        res[f'{a}_{b}'] = pk[:, 0] if pk.shape[1] == 1 else pk
        res[f'{a}_{b}_modes'] = counts[:, 0] if counts.shape[1] == 1 else counts
        res[f'{a}_{b}_ell'] = pp.T
        res[f'{a}_{b}_ell_modes'] = pcounts
    keep = {t: (g['id'], g['pos'], g['vel']) for t, g in gals.items()}
    return _answer(res, ts, {t: float(gals[t]['pos'].shape[0]) for t in ts}), keep


def compare(got, got_keep, ref, ref_keep, cfg):
    dev = next(iter(ref_keep.values()))[0].device
    out = {'ngal_gap': common.ngal_gap(got['n_gal'], ref['n_gal'])}
    out.update(common.mock_gaps(common.as_columns(got_keep, dev), ref_keep, float(cfg['Lbox'])))
    # each k bin's scale: the autos' power averaged over mu
    autos = {t: np.asarray(ref['pk'][(t, t)]).reshape(len(ref['ell_modes'][(t, t)]), -1).mean(1)
             for t in ref['n_gal']}
    t = next(iter(ref['n_gal']))
    modes = ref['ell_modes'][(t, t)]
    out['pk_gap'] = max(common.spectrum_gap(got['pk'], ref['pk'], autos, modes),
                        common.spectrum_gap(got['ell'], ref['ell'], autos, modes))
    out['modes_gap'] = max(common.modes_gap(got['modes'], ref['modes']),
                           common.modes_gap(got['ell_modes'], ref['ell_modes']))
    return out


def work(answer, _keep, call, cfg):
    """Galaxies deposited into each tracer's mesh, and one binning."""
    n = int(call['num_cells'])
    return {
        'grids': [(float(v), n) for v in answer['n_gal'].values()],
        'binnings': [{'nmesh': n, 'kmax': float(call['k_hMpc_max']), 'lbox': float(cfg['Lbox']),
                      'nfields': len(answer['n_gal'])}],
    }
