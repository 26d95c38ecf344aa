"""Port parity for the two-step HOD route: gen_cent / gen_sats / gen_gals,
AbacusHOD.run_hod and compute_ngal of abacusutils_tpu_torch against the JAX
package (a JAX AbacusHOD made with object.__new__ on a synthetic staged
state, as tests/test_torch_abacus_hod.py does), and the port's
compute_power(run_hod(...)) against its own run_hod_pk_fused.

Tolerances: per-tracer counts, Ncent, mass and id exact (the keep codes
are compared through the catalogs, and the number of galaxies that differ,
the keep-code flips, is reported and must be 0); positions within atol
1e-5 + 2 f32 ulps of the value, velocities within 2 f32 ulps of the
column's largest value (the port populates in f32; JAX, with x64 on as in
the full suite, in f64, and fuses z + vz * inv into an FMA);
compute_ngal within rtol 1e-12 (the same host numpy); the two routes
within rtol 2e-3 on bins with modes (tests/test_hod.py:126)."""

import logging

import numpy as np
import numpy.testing as npt
import pytest

from abacusutils_tpu.models.hod import population as jpop
from abacusutils_tpu.models.hod.abacus_hod import AbacusHOD as JaxAbacusHOD
from abacusutils_tpu_torch.convert import staged_state_from_numpy
from abacusutils_tpu_torch.models.hod import population as tpop
from torch_helpers import TRACERS, staged_state

LBOX = 500.0
ORIGIN = np.array([-260.0, -260.0, -260.0])  # outside the box corner
EPS32 = float(np.finfo(np.float32).eps)


def _tracers():
    tr = {k: dict(v) for k, v in TRACERS.items()}
    for p in tr.values():
        p.update(Acent=0.05, Asat=-0.1, Bcent=0.03, Bsat=0.05, s=0.4, s_v=-0.3, s_p=0.2, s_r=-0.1)
    tr['ELG'].update(Ccent=0.1, Csat=-0.1, logM1_EE=13.1, logM1_EL=13.8)
    return tr


def _params(lc):
    return {'z': 0.5, 'Lbox': LBOX, 'velz2kms': 100.0, 'origin': ORIGIN if lc else None,
            'chunk': -1}


def _pair(state, lc, want_ranks, want_shear=True):
    """(JAX AbacusHOD, port AbacusHOD) on copies of one staged state; the
    JAX object gets the mass-function bins its __init__ would set."""
    halo, part = state
    flags = dict(want_ranks=want_ranks, want_shear=want_shear, want_expvel=False, halo_lc=lc,
                 z_type='lightcone' if lc else 'primary')
    jax_hod = object.__new__(JaxAbacusHOD)
    hmass = halo['hmass']
    jax_hod.__dict__.update(
        halo_data=dict(halo), particle_data=dict(part), params=_params(lc), tracers=_tracers(),
        lbox=LBOX, z_mock=0.5, want_AB=True, logger=logging.getLogger('AbacusHOD'),
        _fused_stage=None, mock_dir='.',
        logMbins=np.linspace(np.log10(hmass.min()), np.log10(hmass.max()), 101),
        deltacbins=np.linspace(-0.5, 0.5, 101), fenvbins=np.linspace(-0.5, 0.5, 101),
        shearbins=np.linspace(-0.5, 0.5, 101), **flags,
    )
    port = staged_state_from_numpy(halo, part, _params(lc), _tracers(), flags, 'cpu')
    return jax_hod, port


def _flips(got, ref):
    """Galaxies in one catalog and not the other, counted over (id, central)
    multisets: the keep-code flips of one tracer."""
    def rows(td):
        cen = np.zeros(len(td['id']), np.int64)
        cen[: td['Ncent']] = 1
        return np.stack([td['id'], cen], 1)

    a, b = rows(got), rows(ref)
    ua, ca = np.unique(a, axis=0, return_counts=True)
    ub, cb = np.unique(b, axis=0, return_counts=True)
    both = {tuple(r): c for r, c in zip(ua, ca)}
    for r, c in zip(ub, cb):
        both[tuple(r)] = both.get(tuple(r), 0) - c
    return int(sum(abs(v) for v in both.values()))


def _assert_mock(got, ref, record=None):
    assert list(got) == list(ref)
    for tracer, r in ref.items():
        g = got[tracer]
        assert set(g) == set(r)
        flips = _flips(g, r)
        if record is not None:
            record(f'keep_code_flips_{tracer}', flips)
        assert flips == 0, f'{tracer}: {flips} keep-code flips'
        assert g['Ncent'] == r['Ncent'] and len(g['x']) == len(r['x']) > 0, tracer
        assert g['id'].dtype == np.int64
        npt.assert_array_equal(g['id'], r['id'])
        npt.assert_array_equal(g['mass'], r['mass'])
        for k in ('x', 'y', 'z'):
            npt.assert_allclose(g[k], r[k], rtol=2 * EPS32, atol=1e-5, err_msg=f'{tracer} {k}')
        for k in ('vx', 'vy', 'vz'):
            atol = 2 * EPS32 * np.abs(r[k]).max()
            npt.assert_allclose(g[k], r[k], rtol=0, atol=atol, err_msg=f'{tracer} {k}')


CASES = [
    # lc, want_ranks, reseed, rsd
    (False, False, None, True),
    (False, True, 7, True),
    (False, False, None, False),
    (True, False, None, True),
    (True, True, 11, True),
    (True, False, 5, False),
]


@pytest.mark.parametrize(
    'lc,want_ranks,reseed,rsd', CASES,
    ids=['-'.join(['lc' if c[0] else 'box', *(['ranks'] if c[1] else []),
                   *([f'reseed{c[2]}'] if c[2] else []), 'rsd' if c[3] else 'real'])
         for c in CASES],
)
def test_run_hod_matches_jax(lc, want_ranks, reseed, rsd, record_property):
    state = staged_state(30_000, 120_000, LBOX, seed=41)
    jax_hod, port = _pair(state, lc, want_ranks)
    ref = jax_hod.run_hod(want_rsd=rsd, reseed=reseed)
    got = port.run_hod(want_rsd=rsd, reseed=reseed)
    _assert_mock(got, ref, record_property)
    if reseed:
        npt.assert_array_equal(port.halo_data['hrandoms'], jax_hod.halo_data['hrandoms'])


def test_gen_functions_match_jax():
    """gen_gals on the staged dicts, and gen_cent / gen_sats called as the
    JAX gen_gals calls them, against the JAX functions."""
    halo, part = staged_state(20_000, 80_000, LBOX, seed=43)
    tracers = _tracers()
    params = _params(False)
    ref = jpop.gen_gals(halo, part, tracers, params, enable_ranks=True)
    got = tpop.gen_gals(halo, part, tracers, params, enable_ranks=True, device='cpu')
    _assert_mock(got, ref)

    want = ('LRG', 'ELG', 'QSO')
    tp = jpop.prepare_tracer_params(tracers, 0.5)
    inv = 1.0 / params['velz2kms']
    cargs = (halo['hpos'], halo['hvel'], halo['hmass'], halo['hid'], halo['hmultis'],
             halo['hrandoms'], halo['hveldev'], halo['hdeltac'], halo['hfenv'], halo['hshear'],
             tp, True, inv, LBOX, want, ORIGIN)
    cent_j, keep_j = jpop.gen_cent(*cargs)
    cent_t, keep_t = tpop.gen_cent(*cargs, device='cpu')
    npt.assert_array_equal(keep_t, keep_j)
    sargs = (part['ppos'], part['pvel'], part['phvel'], part['phmass'], part['phid'],
             part['pweights'], part['prandoms'], part['pdeltac'], part['pfenv'], part['pshear'],
             False, part['pranks'], part['pranksv'], part['pranksp'], part['pranksr'],
             tp, True, inv, LBOX, want, ORIGIN, keep_j[part['pinds']])
    sats_j = jpop.gen_sats(*sargs)
    sats_t = tpop.gen_sats(*sargs, device='cpu')
    for got, ref in ((cent_t, cent_j), (sats_t, sats_j)):
        for tracer in want:
            _assert_mock({tracer: dict(got[tracer], Ncent=0)}, {tracer: dict(ref[tracer], Ncent=0)})
    assert tpop.wrap(260.0, LBOX) == jpop.wrap(260.0, LBOX) == -240.0
    assert tpop.wrap(-251.0, LBOX) == 249.0 and tpop.wrap(3.0, LBOX) == 3.0
    a, b = np.arange(3), np.arange(2)
    npt.assert_array_equal(tpop.fast_concatenate(a, b), jpop.fast_concatenate(a, b))
    assert tpop.fast_concatenate(a[:0], b) is b and tpop.fast_concatenate(a, b[:0]) is a


def test_compute_ngal_matches_jax():
    jax_hod, port = _pair(staged_state(20_000, 1_000, LBOX, seed=47), False, False)
    ng_j, fs_j = jax_hod.compute_ngal()
    ng_t, fs_t = port.compute_ngal()
    assert list(ng_t) == list(ng_j)
    for tracer in ng_j:
        npt.assert_allclose(ng_t[tracer], ng_j[tracer], rtol=1e-12)
        npt.assert_allclose(fs_t[tracer], fs_j[tracer], rtol=1e-12)
    npt.assert_array_equal(port.hmf_centers_wshear[0], jax_hod.hmf_centers_wshear[0])
    npt.assert_array_equal(port.halo_mass_func, jax_hod.halo_mass_func)


@pytest.mark.parametrize('lc', [False, True])
def test_two_routes_agree(lc):
    """The port's compute_power(run_hod(...)) against its run_hod_pk_fused on
    the same object and randoms: each tracer's galaxy count equal to the
    fused n_gal, spectra within rtol 2e-3 on bins with modes, equal mode
    counts (the check of tests/test_hod.py:102-130). As in the JAX
    package, run_hod uses the shear columns the state holds and the fused
    route those of want_shear; staging() holds them only with want_shear."""
    nmesh, nbins_k = 32, 16
    _, port = _pair(staged_state(30_000, 120_000, LBOX, seed=53), lc, False, want_shear=True)
    mock = port.run_hod(want_rsd=True)
    ref = port.compute_power(mock, nbins_k, 1, np.pi * nmesh / LBOX, False, num_cells=nmesh,
                             compensated=True, interlaced=False)
    fused, n_gal = port.run_hod_pk_fused(nmesh=nmesh, nbins_k=nbins_k)
    for tracer in mock:
        assert n_gal[tracer] == len(mock[tracer]['x']) > 0, tracer
    npt.assert_array_equal(fused['k_binc'], ref['k_binc'])
    for pair in ('LRG_LRG', 'LRG_ELG', 'ELG_QSO', 'QSO_QSO'):
        good = ref[pair + '_modes'] > 0
        npt.assert_allclose(fused[pair][good], ref[pair][good], rtol=2e-3, err_msg=pair)
        npt.assert_array_equal(fused[pair + '_modes'][good], ref[pair + '_modes'][good])


def test_run_hod_stage_and_unported_options():
    """run_hod reuses the flat device stage and builds none on a second
    call, and the light-cone leg leaves it alone; NFW satellites without a
    sample to draw from raise as in the JAX package (and take the halos of
    the cached stage), write_to_disk without the catalog directory raises;
    a secondary redshift without NFW raises as in the JAX package. (NFW and
    write_to_disk themselves: tests/test_torch_nfw_table.py.)"""
    _, port = _pair(staged_state(2_000, 8_000, LBOX, seed=3), True, False)
    port.run_hod()
    stage = port._flat_stage_cache
    assert stage is not None
    port.run_hod(tracers={'LRG': _tracers()['LRG']})
    port.run_hod_pk_fused(nmesh=16, nbins_k=8)
    assert port._flat_stage_cache is stage
    with pytest.raises(ValueError, match='NFW_draw'):
        port.run_hod(want_nfw=True)
    assert port._flat_stage_cache is stage
    with pytest.raises(ValueError, match='mock_dir'):
        port.run_hod(write_to_disk=True)
    with pytest.raises(ValueError, match='NFW_draw'):
        tpop.gen_gals(port.halo_data, port.particle_data, _tracers(), _params(True), nfw=True,
                      device='cpu')
    port.z_type = 'secondary'
    with pytest.raises(RuntimeError, match='Secondary'):
        port.run_hod()
