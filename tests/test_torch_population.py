"""Port parity: HOD shape functions, LRG population markers and the populate
pass of abacusutils_tpu_torch against abacusutils_tpu (JAX on CPU).

Markers go through log10, erfc and 10**x, which torch and XLA round
differently: XLA's log10 is log(x)/ln(10) and often one ULP (~1e-6 at
log10 M ~ 13) from torch's, and the erfc argument (logM_cut - log10 M) /
(sqrt2 sigma) carries that into a relative marker change of up to
~2 |x| * 1e-6 / (sqrt2 sigma); XLA's f32 erfc itself is ~2e-6 from the f64
value. Measured over M in [1e11, 1e15]: up to 2.6e-5 relative. The satellite
power law (x / M1)**alpha, x = M_h - kappa * 10**logM_cut, has an unbounded
slope for alpha < 1 where x -> 0, so there one ULP of 10**logM_cut moves the
marker by up to ~1e-7 absolute. Markers are held at rtol 5e-5 plus atol 1e-6,
and a keep code may differ only where the random number and the marker tie
to that precision."""

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from abacusutils_tpu.models import pipeline as jpipe
from abacusutils_tpu.models.hod import population as jpop
from abacusutils_tpu.models.hod import shapes as jshapes
from abacusutils_tpu_torch.convert import params_to_tensors
from abacusutils_tpu_torch.models import pipeline as tpipe
from abacusutils_tpu_torch.models.hod import population as tpop
from abacusutils_tpu_torch.models.hod import shapes as tshapes
from torch_helpers import t

MARKER_RTOL = 5e-5
MARKER_ATOL = 1e-6


def _masses(n, seed):
    rng = np.random.default_rng(seed)
    return (10 ** (11 + 4 * rng.random(n))).astype(np.float32)


SHAPE_CASES = [
    ('n_cen_LRG', (12.8, 0.3)),
    ('n_sat_LRG_modified', (12.8, 10**12.8, 10**14.0, 0.3, 1.1, 0.4)),
    ('N_sat_generic', (10**12.5, 0.6, 10**13.8, 0.9, 1.2)),
    ('N_sat_elg', (10**11.6, 1.0, 10**13.5, 0.8)),
    ('Gaussian_fun', (12.0, 0.4)),
    ('N_cen_ELG_v1', (0.1, 100.0, 11.6, 0.3, 1.2)),
    ('N_cen_ELG_v2', (0.1, 11.6, 0.3, 1.2)),
    ('N_cen_QSO', (12.2, 0.5)),
]


@pytest.mark.parametrize('name,args', SHAPE_CASES, ids=[c[0] for c in SHAPE_CASES])
def test_shape_functions_match(name, args):
    """All eight shape functions at float32 on the same masses (log10 masses
    for Gaussian_fun), with the scalar parameters as float32 0-d values, as
    jax.jit traces them."""
    M = _masses(20_000, seed=len(name))
    if name == 'Gaussian_fun':
        M = np.log10(M).astype(np.float32)
    jargs = [jnp.float32(a) for a in args]
    targs = [torch.tensor(float(np.float32(a))) for a in args]
    ref = np.asarray(jax.jit(getattr(jshapes, name))(jnp.asarray(M), *jargs))
    got = getattr(tshapes, name)(t(M), *targs).numpy()
    assert got.dtype == np.float32
    npt.assert_allclose(got, ref, rtol=MARKER_RTOL, atol=MARKER_ATOL)


def _params():
    return {
        'logM_cut': 12.6, 'logM1': 13.7, 'sigma': 0.35, 'alpha': 0.9,
        'kappa': 0.5, 'alpha_c': 0.3, 'alpha_s': 1.0, 'ic': 0.9,
        'Acent': 0.1, 'Asat': -0.2, 'Bcent': 0.05, 'Bsat': 0.1,
    }


def _env(n, seed):
    rng = np.random.default_rng(seed)
    return (
        rng.normal(0, 1, n).astype(np.float32),
        rng.normal(0, 1, n).astype(np.float32),
        rng.random(n, dtype=np.float32),
    )


def _flips(keep_t, keep_j, randoms, marker):
    """Indices where the keep codes differ, after checking each is a near tie."""
    diff = np.flatnonzero(keep_t != keep_j)
    tie = MARKER_RTOL * np.abs(marker[diff]) + MARKER_ATOL
    assert (np.abs(randoms[diff] - marker[diff]) <= tie).all()
    return diff.size


def test_lrg_markers_match():
    """LRG central and satellite markers (with assembly bias) at MARKER_RTOL;
    keep codes equal apart from near ties, whose count is reported."""
    n = 100_000
    mass = _masses(n, seed=1)
    deltac, fenv, randoms = _env(n, seed=2)
    p = _params()
    pj = {k: jnp.float32(v) for k, v in p.items()}
    pt = params_to_tensors(p, 'cpu')

    cent = jax.jit(lambda *a: jpop._cent_marker('LRG', pj, *a, None))
    sat = jax.jit(lambda *a: jpop._sat_base('LRG', pj, *a, None, None))
    m_cj = np.asarray(cent(mass, deltac, fenv))
    m_sj = np.asarray(sat(mass, deltac, fenv))
    m_ct = tpop._cent_marker('LRG', pt, t(mass), t(deltac), t(fenv), None).numpy()
    m_st = tpop._sat_base('LRG', pt, t(mass), t(deltac), t(fenv), None, None).numpy()
    npt.assert_allclose(m_ct, m_cj, rtol=MARKER_RTOL, atol=MARKER_ATOL)
    npt.assert_allclose(m_st, m_sj, rtol=MARKER_RTOL, atol=MARKER_ATOL)

    # randoms drawn within 5e-6 of the markers provoke near-tie flips
    near = (m_cj * (1 + (randoms - 0.5) * 1e-5)).astype(np.float32)
    flips = _flips(randoms <= m_ct, randoms <= m_cj, randoms, m_cj)
    flips += _flips(near <= m_ct, near <= m_cj, near, m_cj)
    print(f'LRG keep-code flips (all near ties): {flips} of {2 * n}')


def test_other_tracers_not_ported():
    pt = params_to_tensors(_params(), 'cpu')
    x = torch.ones(3)
    for tracer in ('ELG', 'QSO'):
        with pytest.raises(NotImplementedError):
            tpop._cent_marker(tracer, pt, x, x, x, x)
        with pytest.raises(NotImplementedError):
            tpop._sat_base(tracer, pt, x, x, x, x, x)
    with pytest.raises(ValueError):
        tpop._cent_marker('BGS', pt, x, x, x, x)


def test_wrap_centered_matches():
    L = 500.0
    x = np.array([-250.0, -250.0001, 249.9999, 250.0, 0.0, 400.0, -400.0], np.float32)
    npt.assert_array_equal(
        tpop._wrap_centered(t(x), L).numpy(), np.asarray(jpop._wrap_centered(jnp.asarray(x), L))
    )


@pytest.mark.parametrize('rsd', [True, False])
def test_populate_weights_matches(rsd):
    halo, part, params = jpipe.make_example_inputs(20_000, 60_000, 500.0, seed=4)
    inv = np.float32(1.0) / np.float32(100.0)
    ref = jax.jit(jpipe.populate_weights, static_argnums=3)(halo, part, params, rsd, inv)
    th = {k: t(v) for k, v in halo.items()}
    tp = {k: t(v) for k, v in part.items()}
    got = tpipe.populate_weights(th, tp, params_to_tensors(params, 'cpu'), rsd, float(inv))
    z_c, keep_c, z_s, keep_s = (g.numpy() for g in got)
    # XLA may fuse z + vz * inv into one FMA: round-off of |z| <= 250 only
    npt.assert_allclose(z_c, np.asarray(ref[0]), rtol=1e-6, atol=1e-5)
    npt.assert_allclose(z_s, np.asarray(ref[2]), rtol=1e-6, atol=1e-5)
    m_c = np.asarray(
        jpipe._cent_weight(params, halo['mass'], halo['deltac'], halo['fenv'], halo['multis'])
    )
    m_s = np.asarray(
        jpipe._sat_weight(params, part['hmass'], part['deltac'], part['fenv'], part['weights'])
    )
    flips = _flips(keep_c, np.asarray(ref[1]), halo['randoms'], m_c)
    flips += _flips(keep_s, np.asarray(ref[3]), part['randoms'], m_s)
    print(f'populate keep-code flips (all near ties): {flips}')
