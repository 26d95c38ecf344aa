"""Every CompaSO halo field of the port's CompaSOHaloCatalog
(abacusutils_tpu_torch/io/compaso.py) against the JAX package's, on a
synthetic simulation (abacusutils_tpu_torch.testing.synthetic_compaso, two
slabs, every halo statistic in its AbacusSummit encoding) and light cone
written with the JAX package's write_asdf.

Every column of ``fields='all'`` and ``'DEFAULT_FIELDS'``, cleaned and
uncleaned, with and without ``convert_units``, is bit-equal to JAX's
(dtype, shape and bytes, in the same column order), and equal to the
stored columns decoded field by field (testing.decoded_fields). A derived
field (sigmavMid) or one eigenvector set alone gives one column, no
dependency column leaks out; unpack_euler16 is bit-equal to JAX's on all
45 x 121 x 12 valid codes.
"""

import numpy as np
import pytest

from abacusutils_tpu.io.asdf_file import write_asdf as jax_write_asdf
from abacusutils_tpu.io.compaso import CompaSOHaloCatalog as JaxCatalog
from abacusutils_tpu.io.compaso import unpack_euler16 as jax_unpack_euler16
from abacusutils_tpu_torch.io.compaso import CompaSOHaloCatalog, unpack_euler16
from abacusutils_tpu_torch.testing import (
    EULER16_CODES,
    decoded_fields,
    synthetic_compaso,
    synthetic_compaso_lc,
    write_compaso_lc,
    write_compaso_sim,
)

SIM = dict(n_slabs=2, n_halo=3000, n_part=6000, n_field=500, seed=8)


@pytest.fixture(scope='module')
def sims(tmp_path_factory):
    root = tmp_path_factory.mktemp('compaso_fields')
    sim = synthetic_compaso(**SIM)
    box = write_compaso_sim(root / 'box', sim, writer=jax_write_asdf)['groupdir']
    lc = synthetic_compaso_lc(1500, seed=3)
    lc_dir = write_compaso_lc(root / 'lc', lc, writer=jax_write_asdf)['groupdir']
    return sim, box, lc, lc_dir


def _assert_same(ref, got):
    assert list(ref.halos.colnames) == list(got.halos.colnames)
    for c in ref.halos.colnames:
        a, b = np.asarray(ref.halos[c]), np.asarray(got.halos[c])
        assert a.dtype == b.dtype and a.shape == b.shape, c
        assert a.tobytes() == b.tobytes(), c
    assert ref.header == got.header


def _decoded(sim, cat, cleaned, convert_units=True):
    """The catalog's columns decoded from the drawn slabs (the zipper's
    npstart / npout and the renamed N aside)."""
    names = [c if c != 'N' or not cleaned else 'N_total' for c in cat.halos.colnames]
    per_slab = [decoded_fields(sl['halo_info'], sl['clean'] if cleaned else None, cat.header,
                               names, convert_units) for sl in sim['slabs']]
    return {c: np.concatenate([p[n] for p in per_slab]) for c, n in zip(cat.halos.colnames, names)}


@pytest.mark.parametrize('convert_units', [True, False], ids=['units', 'stored'])
@pytest.mark.parametrize('preset', ['all', 'DEFAULT_FIELDS'])
@pytest.mark.parametrize('cleaned', [True, False], ids=['cleaned', 'uncleaned'])
def test_presets_match_jax(sims, cleaned, preset, convert_units):
    sim, box, _, _ = sims
    kw = dict(fields=preset, cleaned=cleaned, convert_units=convert_units)
    ref, got = JaxCatalog(box, **kw), CompaSOHaloCatalog(box, **kw)
    _assert_same(ref, got)
    assert len(got.halos) == SIM['n_halo']
    nprev = got.header.get('NumTimeSliceRedshiftsPrev')
    if cleaned and preset == 'all':
        assert got.halos['N_mainprog'].shape == (SIM['n_halo'], nprev)
        assert 'sigmav3d_L2com_mainprog' in got.halos.colnames
    elif cleaned:
        assert 'N_mainprog' not in got.halos.colnames
    assert len(got.halos.colnames) > 80
    want = _decoded(sim, got, cleaned, convert_units)
    for c in got.halos.colnames:
        assert want[c].dtype == got.halos[c].dtype, c
        assert want[c].tobytes() == got.halos[c].tobytes(), c
    assert np.isfinite(got.halos['sigmavMid_com']).all()


def test_derived_and_eigenvector_fields_alone(sims):
    _, box, _, _ = sims
    for fields in (['sigmavMid_L2com'], ['sigmar_eigenvecsMid_com'], 'sigmavMid_com',
                   ['sigmavMid_L2com', 'sigmav3d_L2com', 'sigman_eigenvecsMaj_L2com']):
        for cleaned in (True, False):
            kw = dict(fields=fields, cleaned=cleaned)
            ref, got = JaxCatalog(box, **kw), CompaSOHaloCatalog(box, **kw)
            _assert_same(ref, got)
            asked = [fields] if isinstance(fields, str) else fields
            assert got.halos.colnames == asked + (['N'] if cleaned else [])


def test_integer_so_and_progenitor_fields(sims):
    sim, box, _, _ = sims
    fields = ['L2_N', 'L0_N', 'ntaggedA', 'ntaggedB', 'SO_radius', 'SO_L2max_central_particle',
              'SO_central_density', 'N_merge', 'is_merged_to', 'haloindex', 'N_mainprog',
              'vcirc_max_L2com_mainprog', 'v_L2com_mainprog', 'rvcirc_max_com', 'r33_com']
    ref, got = JaxCatalog(box, fields=fields), CompaSOHaloCatalog(box, fields=fields)
    _assert_same(ref, got)
    # the L0L1 counts have no dtype in the data model's tables: the JAX
    # package refuses them, the port loads them as stored
    with pytest.raises(KeyError):
        JaxCatalog(box, fields=['npoutA_L0L1'], cleaned=False)
    got = CompaSOHaloCatalog(box, fields=['npoutA_L0L1', 'npoutB_L0L1'], cleaned=False)
    for c in ('npoutA_L0L1', 'npoutB_L0L1'):
        stored = np.concatenate([sl['halo_info'][c] for sl in sim['slabs']])
        assert got.halos[c].dtype == stored.dtype
        np.testing.assert_array_equal(got.halos[c], stored)


def _big_and_elongated(h):
    return (h['N'] > 60) & (h['sigmavMid_L2com'] > 0.5 * h['sigmav3d_L2com'])


@pytest.mark.parametrize('cleaned', [True, False], ids=['cleaned', 'uncleaned'])
def test_filter_func_on_new_columns(sims, cleaned):
    _, box, _, _ = sims
    # a read without cleaning needs the A set's indices among the fields
    kw = dict(fields=['sigmavMid_L2com', 'sigmav3d_L2com', 'N', 'sigmar_eigenvecsMin_L2com',
                      'r10_com', 'npstartA', 'npoutA'], cleaned=cleaned,
              filter_func=_big_and_elongated,
              subsamples=dict(A=True, rv=True))
    ref, got = JaxCatalog(box, **kw), CompaSOHaloCatalog(box, **kw)
    _assert_same(ref, got)
    assert 100 < len(got.halos) < SIM['n_halo']
    assert got.nbytes() == ref.nbytes()
    assert got.nbytes(halos=True, subsamples=False) == ref.nbytes(halos=True, subsamples=False)
    assert got.nbytes(halos=False) == sum(v.nbytes for v in got.subsamples.columns.values()) > 0


def test_light_cone_all(sims):
    _, _, lc, lc_dir = sims
    for fields in ('all', 'DEFAULT_FIELDS', ['sigmavMid_L2com', 'pos_interp']):
        kw = dict(fields=fields, subsamples=dict(A=True, pos=True))
        ref, got = JaxCatalog(lc_dir, **kw), CompaSOHaloCatalog(lc_dir, **kw)
        _assert_same(ref, got)
        assert got.nbytes() == ref.nbytes()
    cols = got.halos.colnames
    assert all('L2' in c or c in ('N', 'pos_interp') for c in cols)
    all_cols = CompaSOHaloCatalog(lc_dir, fields='all').halos.colnames
    assert 'sigma_v_eigenvecsMaj_L2com' not in all_cols
    assert {'sigmav_eigenvecsMaj_L2com', 'L2_N', 'origin', 'SO_L2max_radius'} <= set(all_cols)
    assert not any(c.endswith('_com') and 'L2' not in c for c in all_cols)


def test_unpack_euler16_every_code():
    codes = np.arange(EULER16_CODES, dtype=np.uint16)
    for a, b in zip(jax_unpack_euler16(codes), unpack_euler16(codes)):
        assert a.dtype == b.dtype == np.float64
        assert a.tobytes() == b.tobytes()
    minor, middle, major = unpack_euler16(codes)
    for v in (minor, middle, major):
        np.testing.assert_allclose(np.linalg.norm(v, axis=1), 1.0, rtol=1e-12)
    np.testing.assert_allclose(np.einsum('ij,ij->i', minor, major), 0.0, atol=1e-12)


def test_what_is_refused(sims):
    """A field outside the data model raises KeyError in both packages; a missing
    cleaning directory raises FileNotFoundError."""
    _, box, _, _ = sims
    for fields in (['no_such_field'], ['sigmavMid'], 'r100'):
        with pytest.raises(KeyError):
            JaxCatalog(box, fields=fields)
        with pytest.raises(KeyError, match='No loader pattern'):
            CompaSOHaloCatalog(box, fields=fields)
    with pytest.raises(FileNotFoundError, match='cleaning'):
        CompaSOHaloCatalog(box, fields='all', cleandir=box / 'nowhere')
