"""``AbacusHOD.run_hod_pk_fused``: every auto and cross P(k) of the tracers
and their galaxy counts from one call (box or light cone). The reference
populates the catalog itself, paints each tracer's galaxies with TSC, takes
the rfft and bins every pair."""

import numpy as np

from benchmark.reference import hod as ref_hod
from benchmark.reference import mesh as ref_mesh
from benchmark.stats import common

# the AbacusHOD method whose return value is the answer (the tests' answer fault)
PRODUCES = 'run_hod_pk_fused'

# the CPU tests' small size: a 32^3 mesh of 16 k bins on the shared small box
SMALL = {'call': {'nmesh': 32, 'nbins_k': 16}}


def evaluate(hod, tracers, call):
    """The program's answer: ({'pk', 'modes', 'n_gal'}, None)."""
    clustering, n_gal = hod.run_hod_pk_fused(tracers=tracers, **call)
    ts = common.want(tracers)
    pk = {(a, b): clustering[f'{a}_{b}'] for a, b in common.pairs(ts)}
    modes = {(a, b): clustering[f'{a}_{b}_modes'] for a, b in common.pairs(ts)}
    return {'pk': pk, 'modes': modes, 'n_gal': dict(n_gal)}, None


def reference(cat, cfg, tracers, call, P):
    """The same answer from the plain reference in precision `P`."""
    lbox = float(cfg['Lbox'])
    nmesh = int(call.get('nmesh', 256))
    nbins = int(call.get('nbins_k') or nmesh // 2)
    gals = ref_hod.galaxies(cat, cfg, tracers, P, rsd=call.get('want_rsd', True))
    ts = common.want(tracers)
    fields = [ref_mesh.fourier_field(gals[t]['pos'], nmesh, lbox, P) for t in ts]
    n_gal = {t: float(gals[t]['pos'].shape[0]) for t in ts}
    del gals
    window = ref_mesh.tsc_compensation(nmesh, lbox) if call.get('compensated', True) else None
    spectra, counts, _ = ref_mesh.binned_spectra(
        fields, lbox, ref_mesh.dk_edges_pk(nmesh, lbox, nbins), np.array([0.0, 1.0]), (),
        window, P)
    del fields
    names = {i: t for i, t in enumerate(ts)}
    pk = {(names[i], names[j]): v[0][:, 0] for (i, j), v in spectra.items()}
    modes = {k: counts[:, 0] for k in pk}
    return {'pk': pk, 'modes': modes, 'n_gal': n_gal}, None


def compare(got, _got_keep, ref, _ref_keep, cfg):
    autos = {a: ref['pk'][(a, a)] for a in ref['n_gal']}
    modes = next(iter(ref['modes'].values()))
    return {
        'ngal_gap': common.ngal_gap(got['n_gal'], ref['n_gal']),
        'pk_gap': common.spectrum_gap(got['pk'], ref['pk'], autos, modes),
        'modes_gap': common.modes_gap(got['modes'], ref['modes']),
    }


def work(answer, _keep, call, cfg):
    """Galaxies deposited into each tracer's mesh, and one binning of the
    tracers' fields."""
    nmesh = int(call.get('nmesh', 256))
    lbox = float(cfg['Lbox'])
    return {
        'grids': [(float(n), nmesh) for n in answer['n_gal'].values()],
        'binnings': [{'nmesh': nmesh, 'kmax': float(np.pi * nmesh / lbox), 'lbox': lbox,
                      'nfields': len(answer['n_gal'])}],
    }

