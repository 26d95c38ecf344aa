"""``AbacusHOD.run_hod`` then ``compute_xirppi``: the galaxy catalogs on
the host, then xi(rp, pi) of every tracer pair (upstream's MCMC likelihood).
The reference populates the catalog itself and counts the pairs of its own
galaxies."""

import math

import numpy as np

from benchmark.reference import hod as ref_hod
from benchmark.reference import pairs as ref_pairs
from benchmark.stats import common

# the AbacusHOD method whose return value is the answer (the tests' answer fault)
PRODUCES = 'compute_xirppi'

# the CPU tests' small size: the cell's own call on 4,000 halos, where the
# reference's pair count stays quick
SMALL = {'config': {'n_halo': 4_000, 'n_part': 20_000}}


def _bins(call):
    return np.asarray(call['rpbins'], np.float64), int(call['pimax']), int(call['pi_bin_size'])


def evaluate(hod, tracers, call):
    """The program's answer ({'xi', 'n_gal'}) and its mock."""
    rpbins, pimax, pib = _bins(call)
    mock = hod.run_hod(tracers=tracers, want_rsd=call.get('want_rsd', True))
    xi = hod.compute_xirppi(mock, rpbins, pimax, pib)
    ts = common.want(tracers)
    return ({'xi': {(a, b): xi[f'{a}_{b}'] for a, b in common.pairs(ts)},
             'n_gal': {t: float(len(mock[t]['x'])) for t in ts}}, mock)


def reference(cat, cfg, tracers, call, P):
    rpbins, pimax, pib = _bins(call)
    lbox = float(cfg['Lbox'])
    gals = ref_hod.galaxies(cat, cfg, tracers, P, rsd=call.get('want_rsd', True))
    ts = common.want(tracers)
    xi = {(a, b): ref_pairs.xirppi(gals[a]['pos'], lbox, rpbins, pimax, pib, P,
                                   None if a == b else gals[b]['pos'])
          for a, b in common.pairs(ts)}
    keep = {t: (g['id'], g['pos'], g['vel']) for t, g in gals.items()}
    return {'xi': xi, 'n_gal': {t: float(gals[t]['pos'].shape[0]) for t in ts}}, keep


def xi_gap(got, ref):
    """The largest |xi - xi_ref| / (1 + xi_ref) over pairs and bins: the
    relative gap of the pair counts; bins the reference finds empty left out."""
    gap = 0.0
    for k, r in ref.items():
        g = np.asarray(got[k], np.float64)
        den = 1.0 + np.asarray(r, np.float64)
        ok = den > 0
        if ok.any():
            gap = max(gap, float(np.max(np.abs(g - r)[ok] / den[ok])))
    return gap


def compare(got, got_keep, ref, ref_keep, cfg):
    dev = next(iter(ref_keep.values()))[0].device
    out = {'ngal_gap': common.ngal_gap(got['n_gal'], ref['n_gal'])}
    out.update(common.mock_gaps(common.as_columns(got_keep, dev), ref_keep, float(cfg['Lbox'])))
    out['xi_gap'] = xi_gap(got['xi'], ref['xi'])
    return out


def work(answer, _keep, call, cfg):
    """Each pair count: the points of both sides and the pairs its
    histogram holds (an autocorrelation's unordered pairs)."""
    rpbins, _, pib = _bins(call)
    lbox = float(cfg['Lbox'])
    shell = math.pi * (rpbins[1:] ** 2 - rpbins[:-1] ** 2) * pib / lbox**3 * 2.0
    out = []
    for (a, b), xi in answer['xi'].items():
        n1, n2 = answer['n_gal'][a], answer['n_gal'][b]
        dd = float(np.sum((np.asarray(xi) + 1.0) * (shell * n1 * n2)[:, None]))
        out.append({'n1': n1, 'n2': n2 if a != b else 0.0, 'pairs': dd / 2 if a == b else dd})
    return {'pair_counts': out}
