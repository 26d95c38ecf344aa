"""The port's sharded path on gloo ranks against the JAX package's sharded
functions and the port's single-device functions.

A module fixture spawns 2 and then 4 CPU ranks once each
(tests/torch_dist.py: a gloo world over a file store under the test's tmp
directory, each rank on its share of the worker's cores); every rank runs
the port's sharded functions on the seeded inputs of tests/test_parallel.py
and writes an npz. Each test compares them, one case a function and world
size: the ranks' replicated results bit-equal, against the JAX function on
the 8-device CPU mesh (tests/conftest.py) and against the port's
single-device function, at tests/test_parallel.py's budgets (P(k) rtol
3e-4, poles atol 1e-5 of the largest, N_mode equal; the slab FFT rtol 1e-4,
atol 1e-3 of the largest, its round trip rtol 1e-5, atol 1e-4; the ZCV
fields atol 2e-5 of the scale, rtol 1e-4; field_fft_slab rtol 2e-4; pair
counts exactly equal).
"""

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

import torch_dist as td
from abacusutils_tpu.parallel import fft as jfft
from abacusutils_tpu.parallel import mesh as jmesh
from abacusutils_tpu_torch.ops import power as tpow
from abacusutils_tpu_torch.ops import tpcf as ttpcf

CASES = ('calc_power', 'calc_power_slab', 'slab_fft', 'pairs', 'zcv_fields', 'field_fft')
# results each rank computes for its own shard; every other result is replicated
LOCAL = ('local.', 'shard.')


@pytest.fixture(scope='module', params=[2, 4], ids=['2ranks', '4ranks'])
def ranks(request, tmp_path_factory):
    world = request.param
    return world, td.spawn(world, tmp_path_factory.mktemp(f'gloo{world}'), CASES)


_JAX = {}


def jax_ref(name, fn):
    """The JAX result `name`, computed once a module."""
    if name not in _JAX:
        _JAX[name] = fn()
    return _JAX[name]


def _slice(res, tag):
    return {k[len(tag) + 1:]: v for k, v in res.items() if k.startswith(tag + '.')}


def _assert_power(got, ref, kavg=False):
    npt.assert_allclose(np.ravel(got['power']), np.ravel(ref['power']), rtol=3e-4)
    pl = np.asarray(ref['poles'])
    npt.assert_allclose(np.asarray(got['poles']), pl, rtol=3e-4, atol=1e-5 * np.abs(pl).max())
    npt.assert_array_equal(np.ravel(got['N_mode']), np.ravel(ref['N_mode']))
    if kavg:
        npt.assert_allclose(np.ravel(got['k_avg']), np.ravel(ref['k_avg']), rtol=1e-6)


def test_ranks_agree_bit_for_bit(ranks):
    """What JAX returns replicated is the same on every rank, bit for bit."""
    world, res = ranks
    keys = [k for k in res[0] if not k.startswith(LOCAL)]
    assert len(keys) > 30
    for r in range(1, world):
        assert set(res[r]) == set(res[0])
        for k in keys:
            npt.assert_array_equal(res[r][k], res[0][k], err_msg=f'rank {r}: {k}')


def _port_calc_power(pos, w):
    return tpow.calc_power(pos, td.LBOX_PK, kbins=16, mubins=1,
                           k_max=np.pi * td.NMESH_PK / td.LBOX_PK, nmesh=td.NMESH_PK,
                           compensated=False, interlaced=False, w=w, poles=[0, 2, 4],
                           device='cpu')


@pytest.mark.parametrize('slab', [False, True], ids=['replicated', 'slab'])
def test_calc_power_sharded(ranks, slab):
    """calc_power_sharded (the replicated grid, or the slab path) against
    JAX's on 8 devices and the port's calc_power."""
    _, res = ranks
    got = _slice(res[0], 'pk_slab' if slab else 'pk')
    pos, w = (td.clustered_inputs if slab else td.pk_inputs)()
    ref = jax_ref(f'pk{slab}', lambda: jmesh.calc_power_sharded(
        pos, td.LBOX_PK, mesh=jmesh.make_mesh(), nmesh=td.NMESH_PK, kbins=16, w=w,
        poles=(0, 2, 4), slab=slab))
    _assert_power(got, ref, kavg=slab)
    single = _port_calc_power(pos, w)
    _assert_power(got, {k: np.asarray(single[k]) for k in ('power', 'poles', 'N_mode', 'k_avg')},
                  kavg=slab)


def test_slab_memory_is_sharded(ranks):
    """The slab path's local pieces: xl + 4 deposit planes folded to xl,
    Y / n ky rows after the transpose FFT, x-slabs of the ZCV fields, ky rows
    of field_fft_slab."""
    world, res = ranks
    n = td.NMESH_PK
    for r in range(world):
        npt.assert_array_equal(res[r]['local.paint_core'], [n // world, n, n])
        npt.assert_array_equal(res[r]['local.slab_fft'], [n, n // world, n // 2 + 1])
        nz = td.NMESH_ZCV
        npt.assert_array_equal(res[r]['local.zcv_field'], [nz // world, nz, nz])
        nf = td.NMESH_FIELD
        npt.assert_array_equal(res[r]['local.field_fft'], [nf, nf // world, nf // 2 + 1])


def test_slab_fft_roundtrip(ranks):
    """slab_rfftn gathered equals numpy's f64 rfftn and JAX's slab_rfftn on
    8 devices; slab_irfftn inverts it."""
    from functools import partial

    from jax.sharding import PartitionSpec as P

    _, res = ranks
    grid = td.fft_grid()
    want = np.fft.rfftn(grid.astype(np.float64))
    got = res[0]['fft.rfftn']
    npt.assert_allclose(got, want, rtol=1e-4, atol=1e-3 * np.abs(want).max())
    npt.assert_allclose(res[0]['fft.back'], grid, rtol=1e-5, atol=1e-4)

    def run():
        @jax.jit
        @partial(jax.shard_map, mesh=jmesh.make_mesh(), in_specs=P('data'),
                 out_specs=P('data', None, None))
        def fwd(g):
            return jnp.moveaxis(jfft.slab_rfftn(g, 'data'), 1, 0)

        return np.moveaxis(np.asarray(fwd(jnp.asarray(grid))), 0, 1)

    jref = jax_ref('fft', run)
    npt.assert_allclose(got, jref, rtol=1e-4, atol=1e-3 * np.abs(want).max())
    single = torch.fft.rfftn(torch.from_numpy(grid)).numpy()
    npt.assert_allclose(got, single, rtol=1e-4, atol=1e-3 * np.abs(want).max())


@pytest.mark.parametrize('kind', ['rppi_auto', 'rppi_cross', 'smu_auto'])
def test_pair_counts_sharded(ranks, kind):
    """The sharded pair counts, K5 with a global row offset, exactly equal
    to JAX's sharded counts (x64, its tiled engine in float64) and to the
    port's single-device all-pairs counts in float64 and float32."""
    _, res = ranks
    pos, pos2 = td.pair_inputs()
    mode, side = kind.split('_')
    other = pos2 if side == 'cross' else None
    if mode == 'smu':
        pos = td.smu_inputs()

    def run():
        with jax.enable_x64(True):
            if mode == 'rppi':
                return jmesh.pair_counts_rppi_sharded(pos, td.RPBINS, td.PIMAX, td.LBOX_PAIRS,
                                                      mesh=jmesh.make_mesh(), pos2=other)
            return jmesh.pair_counts_smu_sharded(pos, td.SBINS, td.NMU, td.LBOX_PAIRS,
                                                 mesh=jmesh.make_mesh())

    npt.assert_array_equal(res[0][f'pairs.{kind}.float64'], jax_ref(f'pairs.{kind}', run))
    for dt in (torch.float64, torch.float32):
        tag = str(dt).split('.')[-1]
        if mode == 'rppi':
            single = ttpcf.pair_counts_rppi(pos, td.RPBINS, td.PIMAX, td.LBOX_PAIRS, pos2=other,
                                            method='tile', device='cpu', dtype=dt)
        else:
            single = ttpcf.pair_counts_smu(pos, td.SBINS, td.NMU, td.LBOX_PAIRS, method='tile',
                                           device='cpu', dtype=dt)
        npt.assert_array_equal(res[0][f'pairs.{kind}.{tag}'], single, err_msg=tag)
    assert res[0][f'pairs.{kind}.float32'].sum() > 0


def test_zcv_fields_sharded(ranks):
    """get_fields_sharded against JAX's on 8 devices and the port's
    get_fields; get_fields(mesh=) gathers the same pieces bit for bit."""
    from abacusutils_tpu.models.zcv.ic_fields import get_fields_sharded as jax_fields
    from abacusutils_tpu_torch.models.zcv.ic_fields import get_fields

    _, res = ranks
    dens = td.zcv_density()
    jref = jax_ref('zcv', lambda: [np.asarray(f) for f in jax_fields(
        dens, td.LBOX_ZCV, td.NMESH_ZCV, jmesh.make_mesh())])
    single = [f.numpy() for f in get_fields(dens, td.LBOX_ZCV, td.NMESH_ZCV, device='cpu')]
    for name, j, s in zip(('d', 'd2', 's2', 'n2'), jref, single):
        got = res[0][f'zcv.{name}']
        for ref in (j, s):
            npt.assert_allclose(got, ref, atol=2e-5 * np.abs(ref).max(), rtol=1e-4, err_msg=name)
        npt.assert_array_equal(res[0][f'zcv_kwarg.{name}'], got)


@pytest.mark.parametrize('comp', [False, True], ids=['plain', 'compensated-interlaced'])
def test_field_fft_slab(ranks, comp):
    """field_fft_slab (interlacing and compensation on the rank's ky rows)
    against JAX's on 8 devices and the port's get_field_fft."""
    _, res = ranks
    pos, w, _ = td.field_inputs()
    lbox, n = td.LBOX_FIELD, td.NMESH_FIELD
    got = res[0][f'field.{int(comp)}{int(comp)}']
    jref = jax_ref(f'field{comp}', lambda: np.asarray(jfft.field_fft_slab(
        pos, lbox, n, jmesh.make_mesh(), w=w, compensated=comp, interlaced=comp)))
    W = tpow.get_W_compensated(lbox, n, 'TSC', comp) if comp else None
    single = tpow.get_field_fft(pos, lbox, n, 'TSC', w, W, comp, comp, device='cpu').numpy()
    for ref in (jref, single):
        npt.assert_allclose(got, ref, rtol=2e-4, atol=2e-6 * np.abs(ref).max())


def test_calc_pk_from_deltak_slab(ranks):
    """The cross spectrum of two ky-sharded fields with poles 0 and 2
    against JAX's calc_pk_from_deltak_slab and the port's
    calc_pk_from_deltak, both on the port's fields (as JAX's own test holds
    its binning on one set of fields: the k = 0 bin of this cross is the
    f32 round-off of field - 1, which differs with the order of the FFT's
    sums)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    _, res = ranks
    lbox = td.LBOX_FIELD
    kedges, muedges = td.field_edges()
    got = _slice(res[0], 'field_pk')
    f1, f2 = res[0]['field.f1'], res[0]['field.f2']

    def run():
        m = jmesh.make_mesh()
        put = [jax.device_put(f, NamedSharding(m, P(None, 'data', None))) for f in (f1, f2)]
        return jfft.calc_pk_from_deltak_slab(put[0], lbox, kedges, muedges, m,
                                             field2_fft=put[1], poles=[0, 2])

    single = tpow.calc_pk_from_deltak(torch.from_numpy(f1), lbox, kedges, muedges,
                                      field2_fft=torch.from_numpy(f2), poles=np.array([0, 2]))
    for ref in (run(), single):
        pw = np.asarray(ref['power'])
        npt.assert_allclose(got['power'], pw, rtol=3e-4, atol=1e-6 * np.abs(pw).max())
        pl = np.asarray(ref['binned_poles'])
        npt.assert_allclose(got['binned_poles'], pl, rtol=3e-4, atol=1e-5 * np.abs(pl).max())
        npt.assert_array_equal(got['N_mode'], np.asarray(ref['N_mode']))
