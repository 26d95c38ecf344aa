"""The port's sharded fused HOD -> P(k) step on gloo ranks against the JAX
package's sharded AbacusHOD.run_hod_pk_fused and the port's single-device
call (tests/torch_dist.py spawns 2 and then 4 CPU ranks once each, as in
tests/test_torch_parallel.py).

The staged state is tests/test_torch_abacus_hod.py's (LRG + ELG + QSO with
assembly bias and ELG conformity); the spectra are held at that file's
budget (auto rtol 2e-4, crosses 2e-4 sqrt(P_ii P_jj)), the _modes columns
and n_gal exactly, in the replicated-grid mode and in slab mode.
"""

import logging

import numpy as np
import numpy.testing as npt
import pytest

import torch_dist as td
from abacusutils_tpu.models.hod.abacus_hod import AbacusHOD as JaxAbacusHOD
from abacusutils_tpu.parallel import mesh as jmesh
from abacusutils_tpu_torch.ops.grid import _cells

CASES = ('fused', 'sharded_hod_pk', 'staging')
PK_RTOL = 2e-4


@pytest.fixture(scope='module', params=[2, 4], ids=['2ranks', '4ranks'])
def ranks(request, tmp_path_factory):
    world = request.param
    return world, td.spawn(world, tmp_path_factory.mktemp(f'gloo{world}'), CASES)


def _clustering(res, tag):
    cl = {k[len(tag) + 1:]: v for k, v in res.items()
          if k.startswith(tag + '.') and '.ngal.' not in k}
    ng = {k.rsplit('.', 1)[1]: float(v) for k, v in res.items() if k.startswith(tag + '.ngal.')}
    return cl, ng


def _assert_clustering(got, ref):
    (cl, ng), (cl_j, ng_j) = got, ref
    assert set(cl) == set(cl_j)
    assert ng == {t: float(n) for t, n in ng_j.items()} and all(v > 0 for v in ng.values())
    npt.assert_array_equal(cl['k_binc'], cl_j['k_binc'])
    for t1 in ng:
        for t2 in ng:
            key = f'{t1}_{t2}'
            npt.assert_array_equal(cl[key + '_modes'], cl_j[key + '_modes'])
            if t1 == t2:
                npt.assert_allclose(cl[key], cl_j[key], rtol=PK_RTOL, err_msg=key)
            else:
                scale = np.sqrt(np.abs(cl_j[f'{t1}_{t1}'] * cl_j[f'{t2}_{t2}']))
                assert (np.abs(cl[key] - cl_j[key]) <= PK_RTOL * scale).all(), key


_JAX = {}


def _jax_fused(slab):
    if slab not in _JAX:
        halo, part = td.fused_state()
        hod = object.__new__(JaxAbacusHOD)
        hod.__dict__.update(
            halo_data=dict(halo), particle_data=dict(part),
            params={'z': 0.5, 'Lbox': td.LBOX_FUSED, 'velz2kms': 100.0, 'origin': None},
            tracers=td.fused_tracers(), lbox=td.LBOX_FUSED, want_AB=True,
            logger=logging.getLogger('AbacusHOD'), _fused_stage=None, want_ranks=False,
            want_shear=False, want_expvel=False, halo_lc=False, z_type='primary')
        _JAX[slab] = hod.run_hod_pk_fused(nmesh=td.NMESH_FUSED, nbins_k=td.NBINS_FUSED,
                                          mesh=jmesh.make_mesh(), slab=slab)
    return _JAX[slab]


@pytest.mark.parametrize('slab', [False, True], ids=['replicated', 'slab'])
def test_hod_pk_fused_sharded(ranks, slab):
    """run_hod_pk_fused(mesh=) in both modes: every rank's clustering is the
    same bit for bit, and held to JAX's sharded call on 8 devices and to the
    port's single-device call."""
    world, res = ranks
    tag = f'fused{int(slab)}'
    got = _clustering(res[0], tag)
    for r in range(1, world):
        other = _clustering(res[r], tag)
        assert other[1] == got[1]
        for k in got[0]:
            npt.assert_array_equal(other[0][k], got[0][k], err_msg=f'rank {r}: {k}')
    _assert_clustering(got, _jax_fused(slab))
    single = td.fused_port().run_hod_pk_fused(nmesh=td.NMESH_FUSED, nbins_k=td.NBINS_FUSED)
    _assert_clustering(got, single)


def test_fused_slab_memory_is_sharded(ranks):
    """Each rank stages its x-slab of cells alone: its deposit planes are
    xl + 2 in slab mode (the whole grid otherwise), and the ranks' halos
    together are the catalog's (the counterpart of JAX's memory test)."""
    world, res = ranks
    n = td.NMESH_FUSED
    for r in range(world):
        npt.assert_array_equal(res[r]['local.fused1_grid'], [n // world + 2, n, n])
        npt.assert_array_equal(res[r]['local.fused0_grid'], [n, n, n])
    for slab in (0, 1):
        assert sum(int(res[r][f'local.fused{slab}_halos']) for r in range(world)) == td.N_HALO
        assert max(int(res[r][f'local.fused{slab}_halos']) for r in range(world)) < td.N_HALO


@pytest.mark.parametrize('slab', [False, True], ids=['replicated', 'slab'])
def test_stage_sharded_buckets_and_link(ranks, slab):
    """The shard-local stage: each rank holds exactly the halos and
    particles whose cell (K1's, of x + lbox / 2) lies in its x-slab, and each
    particle's hkeep_at names its host's slot in the ranks' concatenated
    staged halos (each padded to nhalo_max)."""
    import torch

    world, res = ranks
    tag = f'local.stage{int(slab)}'
    halo, part = td.fused_state()
    n = td.NMESH_FUSED
    xl = n // world

    def stripes(x):
        c = _cells(torch.from_numpy(np.ascontiguousarray(x, np.float32)), n, td.LBOX_FUSED, 0.0,
                   td.LBOX_FUSED / 2, True)
        return c.numpy() // xl

    hs, ps = stripes(halo['hpos'][:, 0]), stripes(part['ppos'][:, 0])
    nmax = int(res[0][f'{tag}.nhalo_max'])
    assert nmax == np.bincount(hs, minlength=world).max()
    slot_of = np.full(td.N_HALO, -1)
    for r in range(world):
        hid, pid = res[r][f'{tag}.halo_id'], res[r][f'{tag}.part_id']
        npt.assert_array_equal(np.sort(hid), np.flatnonzero(hs == r))
        npt.assert_array_equal(np.sort(pid), np.flatnonzero(ps == r))
        slot_of[hid] = r * nmax + np.arange(len(hid))
    for r in range(world):
        pid = res[r][f'{tag}.part_id']
        npt.assert_array_equal(res[r][f'{tag}.hkeep_at'], slot_of[part['pinds'][pid]])


def test_sharded_hod_pk(ranks):
    """sharded_hod_pk on row blocks (shard_particles pads as JAX pads)
    against JAX's on 8 devices: n_gal equal, the bin sums at rtol 2e-4, the
    mode counts equal."""
    world, res = ranks
    halo, part, params = td.hod_inputs()
    per = -(-len(part['x']) // world)
    for r in range(world):
        pad = res[r]['shard.part_randoms']
        assert len(pad) == per
        rows = part['randoms'][r * per:(r + 1) * per]
        npt.assert_array_equal(pad[:len(rows)], rows)
        assert (pad[len(rows):] == 2.0).all()
    if 'hod' not in _JAX:
        m = jmesh.make_mesh()
        _JAX['hod'] = jmesh.sharded_hod_pk(
            m, jmesh.shard_particles(m, halo), jmesh.shard_particles(m, part), params,
            *td.hod_edges(), td.LBOX_HOD, 100.0, td.NMESH_HOD, td.NBINS_HOD)
    wsum, counts, n_gal = (np.asarray(a) for a in _JAX['hod'])
    assert float(res[0]['hod.n_gal']) == float(n_gal) > 0
    npt.assert_array_equal(res[0]['hod.counts'], counts)
    npt.assert_allclose(res[0]['hod.wsum'], wsum, rtol=PK_RTOL)
