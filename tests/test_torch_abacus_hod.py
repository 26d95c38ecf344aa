"""Port parity for AbacusHOD.run_hod_pk_fused, box and light cone.

The JAX AbacusHOD is made with object.__new__ and given a synthetic staged
state (the column dicts its staging() returns, drawn from a seed with
numpy), so no fixture files and no change to the JAX package are needed.
The port's AbacusHOD is built on the same state through
convert.staged_state_from_numpy. Both return (clustering, n_gal): the keys,
k_binc and the _modes columns must be equal, n_gal exact, auto spectra
within rtol 2e-4 and cross spectra within 2e-4 sqrt(P_ii P_jj) (two deposit
layouts summing in other orders; tests/test_torch_multi.py)."""

import logging

import numpy as np
import numpy.testing as npt
import pytest

from abacusutils_tpu.models.hod.abacus_hod import AbacusHOD as JaxAbacusHOD
from abacusutils_tpu_torch.convert import staged_state_from_numpy
from abacusutils_tpu_torch.models import pipeline as tpipe
from abacusutils_tpu_torch.models.hod.abacus_hod import AbacusHOD
from torch_helpers import TRACERS, gloo_mesh, staged_state  # noqa: F401

LBOX = 500.0
NMESH = 32
NBINS_K = 16
PK_RTOL = 2e-4
ORIGIN = np.array([-260.0, -260.0, -260.0])  # outside the box corner


def _state(n_halo=30_000, n_part=120_000, seed=21):
    return staged_state(n_halo, n_part, LBOX, seed)


def _tracers():
    """The test tracers with live assembly bias, shear terms, ELG
    conformity and rank decorations (each only acts where its flag is on)."""
    tr = {k: dict(v) for k, v in TRACERS.items()}
    for p in tr.values():
        p.update(Acent=0.05, Asat=-0.1, Bcent=0.03, Bsat=0.05, s=0.4, s_v=-0.3, s_p=0.2, s_r=-0.1)
    tr['ELG'].update(Ccent=0.1, Csat=-0.1, logM1_EE=13.1, logM1_EL=13.8)
    return tr


def _pair(state, lc, want_shear, want_ranks, device='cpu'):
    """(JAX AbacusHOD, port AbacusHOD) on copies of one staged state."""
    halo, part = state
    params = {'z': 0.5, 'Lbox': LBOX, 'velz2kms': 100.0, 'origin': ORIGIN if lc else None}
    flags = dict(want_ranks=want_ranks, want_shear=want_shear, want_expvel=False, halo_lc=lc,
                 z_type='lightcone' if lc else 'primary')
    jax_hod = object.__new__(JaxAbacusHOD)
    jax_hod.__dict__.update(
        halo_data=dict(halo), particle_data=dict(part), params=dict(params), tracers=_tracers(),
        lbox=LBOX, want_AB=True, logger=logging.getLogger('AbacusHOD'), _fused_stage=None,
        **flags,
    )
    port = staged_state_from_numpy(halo, part, params, _tracers(), flags, device)
    return jax_hod, port


def _assert_clustering(got, ref):
    (cl, ng), (cl_j, ng_j) = got, ref
    assert set(cl) == set(cl_j)
    assert ng == ng_j and all(v > 0 for v in ng.values())
    npt.assert_array_equal(cl['k_binc'], cl_j['k_binc'])
    tracers = list(ng)
    for t1 in tracers:
        for t2 in tracers:
            key = f'{t1}_{t2}'
            npt.assert_array_equal(cl[key + '_modes'], cl_j[key + '_modes'])
            if t1 == t2:
                npt.assert_allclose(cl[key], cl_j[key], rtol=PK_RTOL, err_msg=key)
            else:
                scale = np.sqrt(np.abs(cl_j[f'{t1}_{t1}'] * cl_j[f'{t2}_{t2}']))
                assert (np.abs(cl[key] - cl_j[key]) <= PK_RTOL * scale).all(), key


# every flag takes both values in each leg
CASES = [
    # lc, want_shear, want_ranks, compensated, reseed
    (False, False, False, True, None),
    (False, True, False, False, None),
    (False, False, True, True, 7),
    (False, True, True, False, 11),
    (True, False, False, True, None),
    (True, True, False, False, 7),
    (True, False, True, False, None),
    (True, True, True, True, 11),
]


@pytest.mark.parametrize(
    'lc,want_shear,want_ranks,compensated,reseed', CASES,
    ids=['-'.join(['lc' if c[0] else 'box', *(k for k, v in zip(
        ('shear', 'ranks', 'comp', 'reseed'), c[1:]) if v)]) for c in CASES],
)
def test_run_hod_pk_fused_matches_jax(lc, want_shear, want_ranks, compensated, reseed):
    jax_hod, port = _pair(_state(), lc, want_shear, want_ranks)
    kw = dict(nmesh=NMESH, nbins_k=NBINS_K, compensated=compensated, reseed=reseed)
    ref = jax_hod.run_hod_pk_fused(**kw)
    got = port.run_hod_pk_fused(**kw)
    _assert_clustering(got, ref)
    # no galaxy moved further than its brick's margin at these widths
    assert int(port.deposit_overflow) == 0
    if reseed:
        npt.assert_array_equal(port.halo_data['hrandoms'], jax_hod.halo_data['hrandoms'])
        npt.assert_array_equal(port.particle_data['prandoms'], jax_hod.particle_data['prandoms'])


def test_stage_cache_restages_when_flags_toggle():
    """A second call with new HOD parameters reuses the stage; toggling
    want_ranks restages (the rank columns join the stage) and matches JAX."""
    state = _state(seed=23)
    jax_hod, port = _pair(state, False, False, False)
    kw = dict(nmesh=NMESH, nbins_k=NBINS_K)
    port.run_hod_pk_fused(**kw)
    stage = port._fused_stage
    tweaked = _tracers()
    tweaked['LRG']['logM_cut'] += 0.1
    cl, ng = port.run_hod_pk_fused(tracers=tweaked, **kw)
    assert port._fused_stage is stage
    _, ng0 = port.run_hod_pk_fused(**kw)
    assert ng['LRG'] < ng0['LRG']  # higher cut -> fewer LRGs

    jax_hod.want_ranks = port.want_ranks = True
    got = port.run_hod_pk_fused(**kw)
    assert port._fused_stage is not stage and 'ranks' in port._fused_stage[1][1]
    _assert_clustering(got, jax_hod.run_hod_pk_fused(**kw))
    assert got[1] != ng0  # the rank decorations act


def test_lc_reseed_restages():
    """Reseeding invalidates the light-cone stage too: after a call on the
    old randoms, a reseeded call matches a fresh JAX object reseeded the
    same way."""
    state = _state(seed=29)
    _, port = _pair(state, True, False, False)
    kw = dict(nmesh=NMESH, nbins_k=NBINS_K)
    before = port.run_hod_pk_fused(**kw)
    got = port.run_hod_pk_fused(reseed=5, **kw)
    jax_hod, _ = _pair(state, True, False, False)
    _assert_clustering(got, jax_hod.run_hod_pk_fused(reseed=5, **kw))
    assert got[1] != before[1]


def test_staged_state_and_unported_options(gloo_mesh):
    """The conversion keeps the columns on the host until the first call,
    the bin plan is built once for repeated calls, and the sharded options
    route through parallel.mesh: on a world of one gloo rank, mesh= gives
    the unsharded spectra in both modes (slab alone, without a mesh, is the
    unsharded call, as in JAX); the light cone refuses mesh= as JAX's does."""
    halo, part = _state(2_000, 8_000, seed=3)
    _, port = _pair((halo, part), False, True, False)
    assert isinstance(port, AbacusHOD) and port._fused_stage is None
    assert port.want_shear and not port.halo_lc and port.lbox == LBOX
    assert all(isinstance(v, np.ndarray) for v in port.halo_data.values())
    builds = tpipe.make_bin_plan_arrays.builds
    want = port.run_hod_pk_fused(nmesh=24, nbins_k=9)
    port.run_hod_pk_fused(nmesh=24, nbins_k=9)
    assert tpipe.make_bin_plan_arrays.builds - builds <= 1
    _assert_clustering(port.run_hod_pk_fused(nmesh=24, nbins_k=9, slab=True), want)
    for slab in (False, True):
        _assert_clustering(port.run_hod_pk_fused(nmesh=24, nbins_k=9, mesh=gloo_mesh, slab=slab),
                           want)
        assert port._fused_stage[0][-2:] == (gloo_mesh, slab)
    _, lc = _pair((halo, part), True, False, False)
    with pytest.raises(NotImplementedError, match='single-device'):
        lc.run_hod_pk_fused(nmesh=24, mesh=gloo_mesh)
