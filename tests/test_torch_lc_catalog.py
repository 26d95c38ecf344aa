"""The port's CompaSOHaloCatalog (abacusutils_tpu_torch/io/compaso.py)
against the JAX package's on halo light cones and on a box's A and B
subsamples with their PIDs, from files written with the JAX package's
write_asdf (testing.synthetic_compaso_lc, testing.synthetic_compaso).

Bit-equal, column for column with dtypes and order, and the header: the
light cone's halos (pos_interp / vel_interp where pos_avg is zero, origin
modulo 3, the L2 stats) and its A particles with their PIDs packed; its
detection by path, and the warning on cleaned=False; the box's A + B
particles with pid, unpack_bits (True, a name, a list) and passthrough,
cleaned and not. Both also equal the arrays the files were written from
(testing.decoded_catalog_lc, decoded_catalog)."""

import shutil
import warnings

import numpy as np
import pytest

from abacusutils_tpu.io.asdf_file import write_asdf as jax_write_asdf
from abacusutils_tpu.io.compaso import CompaSOHaloCatalog as JaxCatalog
from abacusutils_tpu_torch.io import bitpacked
from abacusutils_tpu_torch.io.compaso import CompaSOHaloCatalog
from abacusutils_tpu_torch.models.hod.prepare_sim import SLAB_FIELDS_LC
from abacusutils_tpu_torch.testing import (
    decoded_catalog,
    decoded_catalog_lc,
    synthetic_compaso,
    synthetic_compaso_lc,
    write_compaso_lc,
    write_compaso_sim,
)

LC_FIELDS = SLAB_FIELDS_LC + ['N', 'origin', 'pos_avg', 'vel_avg', 'redshift_interp', 'x_L2com',
                              'v_L2com']
BOX_FIELDS = ['N', 'x_L2com', 'r98_L2com', 'npstartA', 'npoutA', 'npstartB', 'npoutB', 'id']


@pytest.fixture(scope='module')
def cats(tmp_path_factory):
    root = tmp_path_factory.mktemp('lc_catalog')
    lc = synthetic_compaso_lc(4000, seed=2)
    lc_info = write_compaso_lc(root, lc, writer=jax_write_asdf)
    box = synthetic_compaso(2, 3000, 20_000, 2000, seed=8)
    box_info = write_compaso_sim(root, box, writer=jax_write_asdf)
    return root, lc, lc_info['groupdir'], box, box_info['groupdir']


def _assert_same(ref, got):
    assert list(ref.halos.colnames) == list(got.halos.colnames)
    for c in ref.halos.colnames:
        a, b = np.asarray(ref.halos[c]), got.halos[c]
        assert a.dtype == b.dtype and a.shape == b.shape, c
        np.testing.assert_array_equal(a, b, err_msg=c)
    assert list(ref.subsamples.colnames) == list(got.subsamples.colnames)
    for c in ref.subsamples.colnames:
        a, b = np.asarray(ref.subsamples[c]), got.subsamples[c]
        assert a.dtype == b.dtype and a.shape == b.shape, c
        np.testing.assert_array_equal(a, b, err_msg=c)
    assert ref.header == got.header
    assert ref.halo_lc == got.halo_lc and ref.cleaned == got.cleaned


LC_REQUESTS = {
    'prepare_sim': dict(fields=SLAB_FIELDS_LC, subsamples=dict(A=True, rv=True)),
    'all sets': dict(fields=LC_FIELDS, subsamples=True),
    'pid only': dict(fields=LC_FIELDS + ['id', 'SO_radius'], subsamples=dict(pid=True)),
    'no particles': dict(fields=['pos_interp', 'vel_interp', 'origin'], subsamples=False),
    'unpack_bits ignored': dict(fields=LC_FIELDS, subsamples=True, unpack_bits=True),
}


@pytest.mark.parametrize('request_', list(LC_REQUESTS), ids=list(LC_REQUESTS))
def test_lc_catalog_matches_jax(cats, request_):
    _, lc, groupdir, _, _ = cats
    kw = LC_REQUESTS[request_]
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')  # pid requested without a set: both default to A
        ref, got = JaxCatalog(groupdir, **kw), CompaSOHaloCatalog(groupdir, **kw)
    _assert_same(ref, got)
    assert got.halo_lc and got.cleaned and got.header['cleaned_halos']
    assert list(got.superslab_inds) == [0] and len(got.halos) == 4000
    # the arrays the files were written from: 'id' and the SO field are
    # not light-cone columns, and are dropped as the JAX package drops them
    halos, parts = decoded_catalog_lc(lc)
    for c in got.halos.colnames:
        assert got.halos[c].dtype == halos[c].dtype, c
        np.testing.assert_array_equal(got.halos[c], halos[c], err_msg=c)
    for c in got.subsamples.colnames:
        np.testing.assert_array_equal(got.subsamples[c], parts[c], err_msg=c)
    if 'pid' in got.subsamples.colnames:
        assert got.subsamples['pid'].dtype == np.uint64  # packed, as stored


def test_lc_columns_exercise_their_loaders(cats):
    _, lc, groupdir, _, _ = cats
    got = CompaSOHaloCatalog(groupdir, fields=LC_FIELDS)
    h = lc['halos']
    no_avg = ~np.any(h['pos_avg'], axis=1)
    assert 0.25 < no_avg.mean() < 0.42
    np.testing.assert_array_equal(got.halos['pos_interp'][no_avg], h['pos_interp'][no_avg])
    np.testing.assert_array_equal(got.halos['pos_interp'][~no_avg], h['pos_avg'][~no_avg])
    np.testing.assert_array_equal(got.halos['vel_interp'][~no_avg], h['vel_avg'][~no_avg])
    assert not np.array_equal(h['pos_interp'][~no_avg], h['pos_avg'][~no_avg])
    assert set(np.unique(h['origin'])) == set(range(6))
    assert set(np.unique(got.halos['origin'])) == {0, 1, 2}
    assert got.halos['index_halo'].dtype == np.int64
    assert not np.all(np.diff(got.halos['index_halo']) > 0)  # in no order


def test_lc_detection_and_cleaning_warning(cats, tmp_path):
    _, _, groupdir, _, boxdir = cats
    for cls in (JaxCatalog, CompaSOHaloCatalog):
        assert cls._is_path_halo_lc(groupdir)
        assert cls._is_path_halo_lc(groupdir / 'lc_halo_info.asdf')
        assert not cls._is_path_halo_lc(boxdir)
    # a light cone outside a halo_light_cones tree: found by its lc_*.asdf
    elsewhere = tmp_path / 'z0.500'
    shutil.copytree(groupdir, elsewhere)
    assert CompaSOHaloCatalog._is_path_halo_lc(elsewhere)
    kw = dict(fields=SLAB_FIELDS_LC, subsamples=dict(A=True, rv=True))
    _assert_same(JaxCatalog(elsewhere, **kw), CompaSOHaloCatalog(elsewhere, **kw))
    _assert_same(JaxCatalog(elsewhere / 'lc_halo_info.asdf', halo_lc=True, **kw),
                 CompaSOHaloCatalog(elsewhere / 'lc_halo_info.asdf', halo_lc=True, **kw))
    caught = []
    for cls in (JaxCatalog, CompaSOHaloCatalog):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter('always')
            cat = cls(groupdir, cleaned=False, **kw)
        caught.append([str(x.message) for x in w])
        assert cat.cleaned and cat.header['cleaned_halos']
    assert caught[0] == caught[1] and 'ignoring `cleaned=False`' in caught[1][0]


BOX_REQUESTS = {
    'A+B rv pid': dict(subsamples=True),
    'unpack_bits True': dict(subsamples=True, unpack_bits=True),
    'unpack_bits name': dict(subsamples=dict(A=True, B=True, pid=True), unpack_bits='lagr_pos'),
    'unpack_bits list': dict(subsamples=dict(B=True, rv=True, pid=True),
                             unpack_bits=['tagged', 'density', 'packedpid']),
    'B packedpid': dict(subsamples=dict(B=True, pos=True, packedpid=True)),
    'passthrough all': dict(subsamples=True, passthrough=True, fields='all'),
    'passthrough listed': dict(passthrough=True, fields=['N', 'x_L2com', 'N_total']),
}


@pytest.mark.parametrize('cleaned', [True, False], ids=['cleaned', 'uncleaned'])
@pytest.mark.parametrize('request_', list(BOX_REQUESTS), ids=list(BOX_REQUESTS))
def test_box_subsamples_match_jax(cats, request_, cleaned):
    _, _, _, _, boxdir = cats
    kw = dict(dict(fields=BOX_FIELDS), cleaned=cleaned, **BOX_REQUESTS[request_])
    ref, got = JaxCatalog(boxdir, **kw), CompaSOHaloCatalog(boxdir, **kw)
    _assert_same(ref, got)
    if got.load_AB:
        assert len(got.subsamples) > 20_000


@pytest.mark.parametrize('cleaned', [True, False], ids=['cleaned', 'uncleaned'])
def test_box_pids_are_the_drawn_words(cats, cleaned):
    _, _, _, box, boxdir = cats
    got = CompaSOHaloCatalog(boxdir, fields=BOX_FIELDS, cleaned=cleaned, subsamples=True,
                             unpack_bits=True)
    halos, parts = decoded_catalog(box, range(2), cleaned, sets='AB')
    for c in ('npstartA', 'npoutA', 'npstartB', 'npoutB', 'N'):
        np.testing.assert_array_equal(got.halos[c], halos[c], err_msg=c)
    np.testing.assert_array_equal(got.subsamples['packedpid'], parts['packedpid'])
    ref = bitpacked.unpack_pids(parts['packedpid'], box=box['header']['BoxSize'],
                                ppd=box['header']['ppd'], pid=True, lagr_pos=True, tagged=True,
                                density=True, lagr_idx=True)
    for k, v in ref.items():
        np.testing.assert_array_equal(got.subsamples[k], v, err_msg=k)
    n_b = int(halos['npoutB'].sum())
    assert 2 * int(halos['npoutA'].sum()) < n_b < 3 * int(halos['npoutA'].sum())  # B / A = 7 / 3
    assert got.subsamples['tagged'].any() and got.subsamples['density'].max() > 1e5


def test_subsample_refusals(cats):
    _, _, _, _, boxdir = cats
    for kw, err in ((dict(unpack_bits='nope'), ValueError),
                    (dict(unpack_bits=['pid', 3]), ValueError), (dict(subsamples='A'), TypeError),
                    (dict(subsamples=dict(field=True)), ValueError),
                    (dict(subsamples=dict(A=True, rv=True, pos=True)), ValueError),
                    (dict(subsamples=dict(A=True, bogus=True)), ValueError)):
        for cls in (JaxCatalog, CompaSOHaloCatalog):
            with pytest.raises(err):
                cls(boxdir, fields=BOX_FIELDS, **kw)
