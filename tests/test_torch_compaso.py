"""The port's CompaSOHaloCatalog and read_asdf (abacusutils_tpu_torch/io/
compaso.py, read_abacus.py) against the JAX package's, on the synthetic
simulation of tests/torch_disk.py (three slabs written with the JAX
package's write_asdf).

Every halo column (values and dtypes, in the same column order), the A
subsample's positions and velocities and the header are bit-equal, cleaned
and uncleaned, with and without filter_func. The same simulation written
by the port's own writer (abacusutils_tpu_torch.testing, the writer of the
card's run) reads identically through both readers, and both equal the
arrays it was written from: the halo columns by the encodings' decode
formulas exactly, the particles to the RVint quantum (1e-6 of the box in
position, half of 6000/2048 km/s in velocity, each plus float32's rounding
of the decoded value).
"""

import numpy as np
import pytest

from abacusutils_tpu.io.compaso import CompaSOHaloCatalog as JaxCatalog
from abacusutils_tpu.io.read_abacus import read_asdf as jax_read_asdf
from abacusutils_tpu_torch.io.compaso import CompaSOHaloCatalog
from abacusutils_tpu_torch.io.read_abacus import read_asdf
from abacusutils_tpu_torch.testing import (
    RV_POS_QUANTUM,
    RV_VEL_QUANTUM,
    decoded_catalog,
    write_compaso_sim,
)
from torch_disk import FIELDS, jax_written_sim


@pytest.fixture(scope='module')
def sims(tmp_path_factory):
    root = tmp_path_factory.mktemp('compaso')
    sim, jax_info = jax_written_sim(root / 'jax')
    port_info = write_compaso_sim(root / 'port', sim)
    return sim, jax_info['groupdir'], port_info['groupdir']


def _assert_catalogs_equal(ref, got):
    assert list(ref.halos.colnames) == list(got.halos.colnames)
    for c in ref.halos.colnames:
        a, b = np.asarray(ref.halos[c]), np.asarray(got.halos[c])
        assert a.dtype == b.dtype, c
        np.testing.assert_array_equal(a, b, err_msg=c)
    assert list(ref.subsamples.colnames) == list(got.subsamples.colnames)
    for c in ref.subsamples.colnames:
        np.testing.assert_array_equal(np.asarray(ref.subsamples[c]), got.subsamples[c])
    assert ref.header == got.header


def _far_from_centre(h):
    return (np.abs(h['x_L2com'][:, 1]) > 300) & (h['N'] > 60)


@pytest.mark.parametrize('filtered', [False, True], ids=['all', 'filter_func'])
@pytest.mark.parametrize('cleaned', [True, False], ids=['cleaned', 'uncleaned'])
def test_catalog_matches_jax(sims, cleaned, filtered):
    _, groupdir, _ = sims
    kw = dict(fields=FIELDS, subsamples=dict(A=True, rv=True), cleaned=cleaned,
              filter_func=_far_from_centre if filtered else None)
    ref, got = JaxCatalog(groupdir, **kw), CompaSOHaloCatalog(groupdir, **kw)
    _assert_catalogs_equal(ref, got)
    assert 1000 < len(got.halos) < 6000 if filtered else len(got.halos) == 6000
    assert len(got.subsamples) > 10_000
    if cleaned and not filtered:
        assert (got.halos['N'] == 0).sum() > 100  # halos merged away stay, with N = 0
    # one slab by its file, and the fields load_env_halos asks for
    one = dict(kw, fields=['N', 'x_L2com', 'r98_L2com', 'id'], subsamples=False)
    fn = groupdir / 'halo_info' / 'halo_info_001.asdf'
    _assert_catalogs_equal(JaxCatalog(fn, **one), CompaSOHaloCatalog(fn, **one))


@pytest.mark.parametrize('cleaned', [True, False], ids=['cleaned', 'uncleaned'])
def test_both_writers_read_identically(sims, cleaned):
    sim, jax_dir, port_dir = sims
    kw = dict(fields=FIELDS, subsamples=dict(A=True, rv=True), cleaned=cleaned)
    cats = [cls(d, **kw) for d in (jax_dir, port_dir) for cls in (JaxCatalog,
                                                                  CompaSOHaloCatalog)]
    for other in cats[1:]:
        _assert_catalogs_equal(cats[0], other)
    halos, parts = decoded_catalog(sim, range(3), cleaned)
    got = cats[-1]
    for c in FIELDS:
        assert got.halos[c].dtype == halos[c].dtype, c
        np.testing.assert_array_equal(got.halos[c], halos[c], err_msg=c)
    box = sim['header']['BoxSize']
    dpos = np.abs(got.subsamples['pos'] - parts['pos_true']).max()
    dvel = np.abs(got.subsamples['vel'] - parts['vel_true']).max()
    # the quantum, plus float32's rounding of the decoded value
    eps = np.finfo(np.float32).eps
    assert dpos <= RV_POS_QUANTUM * box + box / 2 * eps
    assert dvel <= RV_VEL_QUANTUM / 2 + 6000 * eps


def test_read_asdf_matches_jax(sims):
    _, groupdir, _ = sims
    for kind in ('field_rv_A', 'halo_rv_A'):
        for fn in sorted((groupdir / kind).glob('*.asdf')):
            for load in (None, ['pos']):
                ref = jax_read_asdf(fn, load=load, verbose=False)
                got = read_asdf(fn, load=load)
                assert ref.colnames == got.colnames
                for c in ref.colnames:
                    a = np.asarray(ref[c])
                    assert a.dtype == got[c].dtype and a.shape == got[c].shape
                    np.testing.assert_array_equal(a, got[c])
                assert ref.meta == got.meta


def test_what_was_refused_matches_jax(sims):
    """The presets, SO_radius, r10_L2com, vcirc_max_L2com and
    convert_units=False, which the port refused before the rest of the halo
    fields were ported, load bit-equal to JAX's; a missing cleaning
    directory raises."""
    _, groupdir, _ = sims
    for kw in (dict(fields='DEFAULT_FIELDS'), dict(fields='all'), dict(fields=['SO_radius']),
               dict(fields=['r10_L2com']), dict(fields=['vcirc_max_L2com']),
               dict(fields=FIELDS, convert_units=False)):
        _assert_catalogs_equal(JaxCatalog(groupdir, **kw), CompaSOHaloCatalog(groupdir, **kw))
    with pytest.raises(FileNotFoundError, match='cleaning'):
        CompaSOHaloCatalog(groupdir, fields=FIELDS, cleandir=groupdir / 'nowhere')
