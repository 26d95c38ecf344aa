"""The port's packed-PID and pack9 decoders and its read_asdf
(abacusutils_tpu_torch/io/bitpacked.py, pack9.py, read_abacus.py) against
the JAX package's, bit for bit: unpack_pids on random uint64 words (every
bit set somewhere) and on drawn PID words, every field in float32 and
float64; empty_bitpacked_arrays and unpack_pids_into; unpack_pack9 on the
rows of the port's encoder (testing.pack9_rows), cell headers included,
with preallocated and skipped outputs; and read_asdf of rvint, pack9,
packedpid and pid files written by the JAX package's write_asdf, as a
box's files and as a light cone's (header OutputType 'LightCone'), for
every field set, both float types, colname, aux and the deprecated
load_pos / load_vel switches. The encoder itself is held to the values it
encoded, to its quanta."""

import warnings

import numpy as np
import pytest

from abacusutils_tpu.io import bitpacked as jbp
from abacusutils_tpu.io.asdf_file import write_asdf as jax_write_asdf
from abacusutils_tpu.io.pack9 import unpack_pack9 as jax_unpack_pack9
from abacusutils_tpu.io.read_abacus import read_asdf as jax_read_asdf
from abacusutils_tpu_torch.io import bitpacked as tbp
from abacusutils_tpu_torch.io.pack9 import unpack_pack9
from abacusutils_tpu_torch.io.read_abacus import read_asdf
from abacusutils_tpu_torch.testing import pack9_rows, pid_words, rvint_words, summit_header

PID_KW = ('pid', 'lagr_pos', 'tagged', 'density', 'lagr_idx')
CPD = 1701  # AbacusSummit base boxes' cells per dimension
N = 20_000


def _same(a, b, what=''):
    a = np.asarray(a)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    np.testing.assert_array_equal(a, b, err_msg=what)


def _words(seed):
    """Random uint64 words (every bit pattern), drawn PID words, and the
    extremes."""
    rng = np.random.default_rng(seed)
    rand = rng.integers(0, 2**63, N, dtype=np.uint64) * np.uint64(2) + rng.integers(
        0, 2, N, dtype=np.uint64)
    edge = np.array([0, 2**64 - 1, 2**63, 0x7FFF7FFF7FFF, 1 << 48, 0x07FE000000000000],
                    dtype=np.uint64)
    return np.concatenate([rand, pid_words(rng, N, 6912), edge])


def _truth(n, seed, box):
    rng = np.random.default_rng(seed)
    pos = (rng.random((n, 3)) - 0.5) * box
    vel = rng.normal(0, 400.0, (n, 3))
    return pos, vel


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
@pytest.mark.parametrize('box,ppd', [(2000.0, 6912.0), (2000.0, 6912), (500.0, 1728), (None, None)])
def test_unpack_pids_matches_jax(box, ppd, dtype):
    words = _words(1)
    kw = {k: True for k in PID_KW if box is not None or k != 'lagr_pos'}
    ref = jbp.unpack_pids(words, box=box, ppd=ppd, float_dtype=dtype, **kw)
    got = tbp.unpack_pids(words, box=box, ppd=ppd, float_dtype=dtype, **kw)
    assert list(got) == list(ref)
    for k in ref:
        _same(ref[k], got[k], k)
    # one field at a time, and each field's bits: the Lagrangian triple
    idx = np.stack([(words >> np.uint64(s)) & np.uint64(0x7FFF) for s in (0, 16, 32)], 1)
    np.testing.assert_array_equal(got['lagr_idx'], idx.astype(np.int16))
    np.testing.assert_array_equal(got['tagged'], (words >> np.uint64(48)) & np.uint64(1))
    for k in kw:
        one = tbp.unpack_pids(words, box=box, ppd=ppd, float_dtype=dtype, **{k: True})
        assert list(one) == [k]
        _same(got[k], one[k], k)


def test_unpack_pids_refusals():
    words = _words(2)[:10]
    for kw, err in ((dict(lagr_pos=True, ppd=10), 'box'), (dict(lagr_pos=True, box=1.0), 'ppd'),
                    (dict(pid=True, ppd=10.5), 'ppd')):
        with pytest.raises(ValueError, match=err):
            jbp.unpack_pids(words, **kw)
        with pytest.raises(ValueError, match=err):
            tbp.unpack_pids(words, **kw)


@pytest.mark.parametrize('fields', [True, False, 'lagr_pos', ['tagged', 'packedpid'],
                                    ['density', 'pid', 'lagr_idx']])
def test_bitpacked_arrays_and_unpack_into_match_jax(fields):
    words = _words(3)
    ref = jbp.empty_bitpacked_arrays(len(words) + 5, fields)
    got = tbp.empty_bitpacked_arrays(len(words) + 5, fields)
    assert list(got) == list(ref) and tbp.PID_FIELDS == jbp.PID_FIELDS
    for k in ref:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
        ref[k][...] = 0
        got[k][...] = 0
    assert jbp.unpack_pids_into(words, 2000.0, 6912, ref) == tbp.unpack_pids_into(
        words, 2000.0, 6912, got) == len(words)
    for k in ref:
        _same(ref[k], got[k], k)


@pytest.fixture(scope='module')
def pack9():
    """pack9 rows of 30,000 particles in a 2000 Mpc/h box at cpd 1701,
    some cells crowded, with the header's velocity scale."""
    header = summit_header()
    box, velz = header['BoxSize'], header['VelZSpace_to_kms']
    pos, vel = _truth(30_000, 4, box)
    pos[:3000] = pos[0] + (pos[:3000] - pos[0]) * 1e-4  # a few cells of many particles
    pos[-2:] = [[-box / 2, -box / 2, -box / 2], np.nextafter(box / 2, 0) * np.ones(3)]
    rows, order = pack9_rows(pos, vel, box, CPD, velz)
    return header, rows, pos[order], vel[order]


def test_pack9_encoder_round_trip(pack9):
    header, rows, pos, vel = pack9
    box, velz = header['BoxSize'], header['VelZSpace_to_kms']
    n_hdr = int((rows[:, 0] == 0xFF).sum())
    assert len(rows) == len(pos) + n_hdr and 1000 < n_hdr < len(pos)
    p, v = unpack_pack9(rows, box, velz, float_dtype=np.float64)
    step = 0.0005 * box / CPD
    assert np.abs(p - pos).max() <= step / 2 * (1 + 1e-9) + 1e-12 * box
    c3, c4 = int(rows[0, 3]), int(rows[0, 4])
    vscale = ((c3 << 4) | (c4 & 0x0F)) - 48  # the first header's third field
    assert 1 <= vscale < 100
    assert np.abs(v - vel).max() <= vscale * 0.0005 / CPD * velz / 2 * (1 + 1e-9)


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
def test_unpack_pack9_matches_jax(pack9, dtype):
    header, rows, _, _ = pack9
    box, velz = header['BoxSize'], header['VelZSpace_to_kms']
    ref = jax_unpack_pack9(rows, box, velz, float_dtype=dtype)
    got = unpack_pack9(rows, box, velz, float_dtype=dtype)
    for a, b in zip(ref, got):
        _same(a, b)
    n = len(ref[0])
    for posout, velout in ((False, None), (None, False)):
        r = jax_unpack_pack9(rows, box, velz, float_dtype=dtype, posout=posout, velout=velout)
        g = unpack_pack9(rows, box, velz, float_dtype=dtype, posout=posout, velout=velout)
        assert [np.shape(x) for x in r] == [np.shape(x) for x in g]
        for a, b in zip(r, g):
            np.testing.assert_array_equal(a, b)
    bufs = [[np.zeros((n + 7, 3), dtype) for _ in range(2)] for _ in range(2)]
    assert jax_unpack_pack9(rows, box, velz, dtype, *bufs[0]) == unpack_pack9(
        rows, box, velz, dtype, *bufs[1]) == (n, n)
    for a, b in zip(*bufs):
        _same(a, b)
    # a header alone decodes to no particle
    assert [len(x) for x in unpack_pack9(rows[:1], box, velz)] == [0, 0]


@pytest.fixture(scope='module')
def particle_files(tmp_path_factory, pack9):
    """rvint, pack9, packedpid and pid files of a box and of a light cone,
    written with the JAX package's write_asdf."""
    root = tmp_path_factory.mktemp('particles')
    header, rows, _, _ = pack9
    pos, vel = _truth(N, 5, header['BoxSize'])
    rng = np.random.default_rng(6)
    data = {'rvint': rvint_words(pos / header['BoxSize'], vel), 'pack9': rows,
            'packedpid': pid_words(rng, N, header['ppd']), 'pid': pid_words(rng, N, header['ppd'])}
    files = {}
    for form, hdr in (('box', header), ('lc', dict(header, OutputType='LightCone'))):
        for col, arr in data.items():
            fn = root / f'{form}_{col}.asdf'
            jax_write_asdf(fn, {'header': hdr, 'data': {col: arr}}, compression='blsc')
            files[form, col] = fn
    both = root / 'two_columns.asdf'
    jax_write_asdf(both, {'header': header, 'data': {'rvint': data['rvint'],
                                                     'packedpid': data['packedpid']}})
    return files, both


LOADS = [None, ('pos',), ('vel', 'aux'), ('pid',), PID_KW + ('aux',), ('lagr_pos', 'density')]


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
@pytest.mark.parametrize('col', ['rvint', 'pack9', 'packedpid', 'pid'])
@pytest.mark.parametrize('form', ['box', 'lc'])
def test_read_asdf_matches_jax(particle_files, form, col, dtype, capsys):
    files, _ = particle_files
    fn = files[form, col]
    for load in LOADS:
        ref = jax_read_asdf(fn, load=load, dtype=dtype, verbose=False)
        got = read_asdf(fn, load=load, dtype=dtype, verbose=False)
        assert ref.colnames == got.colnames, load
        for c in ref.colnames:
            _same(ref[c], got[c], f'{load} {c}')
        assert ref.meta == got.meta
        assert ('SubsampleFraction' in got.meta) == (form == 'lc')
    read_asdf(fn, load=('aux',))
    printed = capsys.readouterr().out
    assert ('light cone: A+B subsamples, 10% of particles' in printed) == (form == 'lc')


def test_read_asdf_columns_and_switches(particle_files):
    files, both = particle_files
    for colname in ('rvint', 'packedpid'):
        ref = jax_read_asdf(both, colname=colname, verbose=False)
        got = read_asdf(both, colname=colname, verbose=False)
        assert ref.colnames == got.colnames
        for c in ref.colnames:
            _same(ref[c], got[c], c)
    for reader in (jax_read_asdf, read_asdf):
        with pytest.raises(ValueError, match='multiple candidate'):
            reader(both, verbose=False)
    for kw in (dict(load_pos=False), dict(load_vel=False), dict(load_pos=True),
               dict(load_pos=True, load_vel=True)):
        with warnings.catch_warnings(record=True) as wj:
            warnings.simplefilter('always')
            ref = jax_read_asdf(files['box', 'rvint'], verbose=False, **kw)
        with warnings.catch_warnings(record=True) as wp:
            warnings.simplefilter('always')
            got = read_asdf(files['box', 'rvint'], verbose=False, **kw)
        assert ref.colnames == got.colnames and len(wj) == len(wp) == 1, kw
        assert wj[0].category is wp[0].category
