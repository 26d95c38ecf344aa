"""The port's metadata registry (abacusutils_tpu_torch/metadata) against the
JAX package's get_meta, and its msgpack decoder against the msgpack
package (used here only as the yardstick: the port never imports it).

get_meta of all eight bundled simulations, with and without a redshift,
equals JAX's key for key (the growth table's float keys included) with
the CLASS arrays bit-equal; a synthesized box too, and an unknown
cosmology is refused with JAX's message. The decoder equals
``msgpack.loads(..., strict_map_key=False)`` on every bundle's param and
state bytes and on hypothesis round trips over every type code, lengths
across the fix / 8 / 16 / 32 boundaries; it raises on extension types and
on truncated or trailing bytes.
"""

import struct
import subprocess
import sys
from pathlib import Path

import msgpack
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import abacusutils_tpu.metadata as jmeta
import abacusutils_tpu_torch.metadata as tmeta
from abacusutils_tpu_torch.io.asdf_file import open_asdf
from abacusutils_tpu_torch.metadata._msgpack import loads

SUMMIT = ['AbacusSummit_base_c000_ph000', 'AbacusSummit_base_c000_ph006',
          'AbacusSummit_highbase_c000_ph100', 'AbacusSummit_hugebase_c000_ph000',
          'AbacusSummit_huge_c000_ph201', 'AbacusSummit_high_c000_ph100',
          'AbacusSummit_small_c000_ph3000']
DESI2 = 'Abacus_DESI2_c000_ph300'


def _assert_meta_equal(got, ref):
    assert set(got) == set(ref)
    for k, r in ref.items():
        g = got[k]
        if k == 'CLASS_power_spectrum':
            for c in ('k (h/Mpc)', 'P (Mpc/h)^3'):
                a, b = np.asarray(r[c]), np.asarray(g[c])
                assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), c
        else:
            assert type(g) is type(r) and g == r, k
    if 'GrowthTable' in ref:
        assert all(type(z) is float for z in got['GrowthTable'])


@pytest.mark.parametrize('redshift', [None, 0.5, 0.8], ids=['param', 'z0.5', 'z0.8'])
@pytest.mark.parametrize('sim', SUMMIT + ['AbacusSummit_base_c000_ph001'])
def test_summit_matches_jax(sim, redshift):
    ref, got = jmeta.get_meta(sim, redshift), tmeta.get_meta(sim, redshift)
    _assert_meta_equal(got, ref)
    assert 'CLASS_power_spectrum' in got
    if redshift is not None:
        # the AbacusSummit entries carry no states: they are synthesized
        assert '_synthesized_from' in got and got['Redshift'] == redshift


@pytest.mark.parametrize('redshift', [None, 'z2.000', 2.5, 1.1])
def test_desi2_matches_jax(redshift):
    try:
        ref = jmeta.get_meta(DESI2, redshift)
    except ValueError as e:
        with pytest.raises(ValueError, match='metadata not present'):
            tmeta.get_meta(DESI2, redshift)
        assert 'metadata not present' in str(e)
        return
    _assert_meta_equal(tmeta.get_meta(DESI2, redshift), ref)


def test_refusals_and_cache(monkeypatch):
    for sim, match in (('AbacusSummit_base_c001_ph000', 'is not in metadata files'),
                       ('Quijote_fiducial', 'unknown what simulation set')):
        for mod in (jmeta, tmeta):
            with pytest.raises(ValueError, match=match):
                mod.get_meta(sim)
    tmeta.get_meta('AbacusSummit_small_c000_ph3001')
    assert 'AbacusSummit_small_c000_ph3001' in tmeta.metadata
    # a second call is served from the cache
    monkeypatch.setattr(tmeta, '_load_all', lambda: pytest.fail('reloaded'))
    assert tmeta.get_meta(SUMMIT[0])['SimName'] == SUMMIT[0]
    # the search order: $ABACUS_METADATA_DIR, then the package's directory
    monkeypatch.setenv('ABACUS_METADATA_DIR', '/nonexistent')
    assert tmeta._search_dirs()[0] == '/nonexistent'
    assert tmeta._search_dirs()[1].endswith('abacusutils_tpu_torch/metadata')


def _bundle_tables():
    d = tmeta._search_dirs()[1]
    for fn in tmeta.metadata_fns:
        tree = dict(open_asdf(f'{d}/{fn}').tree)
        for sim, rec in tree.items():
            if sim in ('asdf_library', 'history'):
                continue
            for part in ('param', 'state'):
                yield f'{sim}:{part}', np.asarray(rec[part]).tobytes()


@pytest.mark.parametrize('name,data', list(_bundle_tables()))
def test_decoder_on_the_bundles(name, data):
    assert loads(data) == msgpack.loads(data, strict_map_key=False)


_scalars = (st.none() | st.booleans() | st.integers(-2**63, 2**64 - 1)
            | st.floats(allow_nan=False) | st.text(max_size=40) | st.binary(max_size=40))
_values = st.recursive(
    _scalars,
    lambda inner: (st.lists(inner, max_size=6)
                   | st.dictionaries(st.text(max_size=8) | st.floats(allow_nan=False)
                                     | st.integers(-2**63, 2**64 - 1), inner, max_size=6)),
    max_leaves=30)


@settings(max_examples=300, deadline=None, database=None)
@given(_values, st.booleans())
def test_decoder_round_trip(value, single):
    data = msgpack.packb(value, use_single_float=single)
    assert loads(data) == msgpack.loads(data, strict_map_key=False)


@pytest.mark.parametrize('n', [0, 15, 16, 31, 32, 255, 256, 65535, 65536])
def test_decoder_length_boundaries(n):
    """str, bin, array and map lengths at each side of the fix / 8 / 16 /
    32 boundaries, and every integer width at its limits."""
    for value in ('x' * n, b'\x01' * n, list(range(min(n, 70000))),
                  {i: i % 3 for i in range(n)}, {f'k{i}': None for i in range(min(n, 300))}):
        data = msgpack.packb(value, use_bin_type=True)
        assert loads(data) == msgpack.loads(data, strict_map_key=False)
    for v in (127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1, -32, -33, -128,
              -129, -32768, -32769, -2**31, -2**31 - 1, -2**63):
        assert loads(msgpack.packb(v)) == v


def test_decoder_refusals():
    for ext in (msgpack.packb(msgpack.ExtType(5, b'abcd')),
                msgpack.packb(msgpack.ExtType(1, b'x' * 300))):
        with pytest.raises(ValueError, match='extension type'):
            loads(ext)
    good = msgpack.packb({'a': [1.5, 'text', None, True]})
    for cut in range(len(good)):
        with pytest.raises(ValueError, match='truncated'):
            loads(good[:cut])
    with pytest.raises(ValueError, match='trailing'):
        loads(good + b'\x00')
    with pytest.raises(ValueError, match='invalid msgpack type'):
        loads(b'\xc1')
    assert loads(b'\xca' + struct.pack('>f', 0.1)) == np.float32(0.1).item()


def test_registry_runs_without_msgpack():
    """In a process where importing msgpack fails, get_meta still serves a
    bundled and a synthesized simulation."""
    code = ('import sys; sys.modules["msgpack"] = None\n'
            'import abacusutils_tpu_torch.metadata as m\n'
            'assert m.get_meta("AbacusSummit_base_c000_ph001", 0.5)["f_growth"] > 0\n'
            'assert "msgpack" not in [k for k, v in sys.modules.items() if v is not None]\n'
            'print("ok")')
    root = Path(__file__).resolve().parents[1]  # the package's checkout
    out = subprocess.run([sys.executable, '-c', code], capture_output=True, text=True,
                         check=True, cwd=root)
    assert out.stdout.strip() == 'ok'
