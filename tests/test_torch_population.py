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

import re

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from abacusutils_tpu.models import pipeline as jpipe
from abacusutils_tpu.models.hod import population as jpop
from abacusutils_tpu.models.hod import shapes as jshapes
from abacusutils_tpu_torch import _build
from abacusutils_tpu_torch.convert import params_to_tensors
from abacusutils_tpu_torch.models import pipeline as tpipe
from abacusutils_tpu_torch.models.hod import population as tpop
from abacusutils_tpu_torch.models.hod import shapes as tshapes
from torch_helpers import CODE_WANTS, code_catalogs, t

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
    """ELG and QSO markers are ported now (their parity is in
    tests/test_torch_multi.py): with prepared parameters they give float32
    markers; a tracer the package does not know still raises."""
    x = torch.full((3,), 1e12)
    for tracer in ('ELG', 'QSO'):
        p = jpop.prepare_tracer_params({tracer: dict(_params(), p_max=0.1, Q=100.0,
                                                     gamma=1.2, A_s=1.0)}, z=0.5)[tracer]
        pt = params_to_tensors(p, 'cpu')
        keep = torch.zeros(3, dtype=torch.int8)
        for m in (tpop._cent_marker(tracer, pt, x, x * 0, x * 0, 0.0),
                  tpop._sat_base(tracer, pt, x, x * 0, x * 0, 0.0, keep)):
            assert m.dtype == torch.float32 and torch.isfinite(m).all()
    pt = params_to_tensors(_params(), 'cpu')
    with pytest.raises(ValueError):
        tpop._cent_marker('BGS', pt, x, x, x, x)
    with pytest.raises(ValueError):
        tpop._sat_base('BGS', pt, x, x, x, x, x)


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


def _no_kernel_launched():
    assert tpop.keep_codes_kernel.launches == 0
    assert tpop.keep_codes_kernel.launches_by_form == {'centrals': 0, 'satellites': 0}


@pytest.mark.parametrize('want', CODE_WANTS, ids='+'.join)
def test_keep_code_dispatch_on_cpu_is_the_plain_chain(want):
    """_cent_codes / _sat_codes on CPU tensors return exactly the plain
    versions' codes; with host_at= the satellites' equal the plain version
    on the gathered host codes, and on a per-particle column; no launch is
    counted."""
    halo, part, hidx, tp = code_catalogs(3_001, 12_003, seed=5, ranks=True)
    keep_c = tpop._cent_codes(halo, tp, want)
    assert keep_c.dtype == torch.int8
    assert torch.equal(keep_c, tpop.cent_codes_plain(halo, tp, want))
    keep_s = tpop._sat_codes(part, tp, want, keep_c, host_at=hidx)
    assert torch.equal(keep_s, tpop.sat_codes_plain(part, tp, want, keep_c[hidx.long()]))
    assert torch.equal(tpop._sat_codes(part, tp, want, keep_c[hidx.long()]), keep_s)
    codes = {TRACER_CODE[w] for w in want}
    assert codes <= set(keep_c.unique().tolist()) and codes <= set(keep_s.unique().tolist())
    _no_kernel_launched()


TRACER_CODE = {tracer: code for code, tracer in enumerate(tpop.TRACER_ORDER, 1)}


class _Reads(dict):
    """A parameter dict that records the keys read from it."""

    def __init__(self, d):
        super().__init__(d)
        self.read = set()

    def __getitem__(self, k):
        self.read.add(k)
        return super().__getitem__(k)


@pytest.mark.parametrize('ranks', [False, True], ids=['no ranks', 'ranks'])
@pytest.mark.parametrize('form', tpop.CODE_FORMS)
def test_code_params_are_what_the_plain_markers_read(form, ranks):
    """code_params gives each tracer's CODE_PARAMS slots in the kernel's
    order: the plain version's own 0-d float32 tensors for exactly the keys
    its marker reads (run on a dict that records them), None for every
    other key and every tracer not wanted."""
    halo, part, hidx, tp = code_catalogs(500, 2_000, seed=6, ranks=ranks)
    for tracer in tpop.TRACER_ORDER:
        rec = {k: _Reads(v) for k, v in tp.items()}
        if form == 'centrals':
            tpop.cent_codes_plain(halo, rec, (tracer,))
        else:
            tpop.sat_codes_plain(part, rec, (tracer,), torch.zeros(2_000, dtype=torch.int8))
        slots = tpop.code_params(tp, (tracer,), form, ranks)
        assert len(slots) == len(tpop.TRACER_ORDER) * len(tpop.CODE_PARAMS)
        for i, other in enumerate(tpop.TRACER_ORDER):
            mine = slots[i * len(tpop.CODE_PARAMS):(i + 1) * len(tpop.CODE_PARAMS)]
            picked = {k for k, v in zip(tpop.CODE_PARAMS, mine) if v is not None}
            assert picked == (rec[tracer].read if other == tracer else set()), other
            for k, v in zip(tpop.CODE_PARAMS, mine):
                if v is not None:
                    assert v is tp[tracer][k] and v.dtype == torch.float32 and v.shape == ()
    # every tracer at once: each tracer's slots where they were alone
    full = tpop.code_params(tp, tpop.TRACER_ORDER, form, ranks)
    for i, tracer in enumerate(tpop.TRACER_ORDER):
        alone = tpop.code_params(tp, (tracer,), form, ranks)
        n = len(tpop.CODE_PARAMS)
        assert full[i * n:(i + 1) * n] == alone[i * n:(i + 1) * n]


def test_code_tables_match_the_kernel_source():
    """CODE_PARAMS is the parameter enum of csrc/hod_codes.cu, in order, and
    the kernel's tracer, parameter and column counts are the wrapper's."""
    src = (_build.CSRC / 'hod_codes.cu').read_text()
    enum = re.search(r'enum \{\s*(LOGM_CUT[^}]*)\}', src).group(1)
    assert [w.strip() for w in enum.split(',') if w.strip()] == [
        k.upper() for k in tpop.CODE_PARAMS]
    for name, n in (('kTracers', len(tpop.TRACER_ORDER)), ('kParams', len(tpop.CODE_PARAMS)),
                    ('kCols', len(tpop.CODE_COLUMNS))):
        assert int(re.search(rf'{name} = (\d+);', src).group(1)) == n
    assert len(_build.SIGNATURES['hod_keep_codes']) == 10


@pytest.mark.parametrize('shear', [False, True], ids=['no shear', 'shear'])
@pytest.mark.parametrize('form', tpop.CODE_FORMS)
def test_code_columns_in_kernel_order(form, shear):
    """code_columns hands the kernel the catalog's own tensors in
    CODE_COLUMNS order, None where the catalog has no shear or the form no
    rank columns."""
    halo, part, _, _ = code_catalogs(400, 1_600, seed=7, shear=shear, ranks=True)
    cat = halo if form == 'centrals' else part
    want = {
        'centrals': ('mass', 'multis', 'randoms', 'deltac', 'fenv', 'shear', None, None, None,
                     None),
        'satellites': ('hmass', 'weights', 'randoms', 'deltac', 'fenv', 'shear', 'ranks',
                       'ranksv', 'ranksp', 'ranksr'),
    }[form]
    cols = tpop.code_columns(cat, form)
    assert len(cols) == len(want)
    for key, col in zip(want, cols):
        if key is None or (key == 'shear' and not shear):
            assert col is None
        else:
            assert col is cat[key]


def test_keep_code_kernel_refuses_cpu_tensors():
    """The kernel's wrapper takes CUDA tensors only: on CPU tensors it
    raises before any launch (the dispatchers never call it there)."""
    halo, part, hidx, tp = code_catalogs(100, 400, seed=8)
    with pytest.raises(ValueError, match='CUDA'):
        tpop.keep_codes_kernel(halo, tp, tpop.TRACER_ORDER, 'centrals')
    with pytest.raises(ValueError, match='CUDA'):
        tpop.keep_codes_kernel(part, tp, tpop.TRACER_ORDER, 'satellites',
                               torch.zeros(100, dtype=torch.int8), hidx)
    _no_kernel_launched()
