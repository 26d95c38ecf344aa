"""Port parity for prepare_sim's Menv engines: abacusutils_tpu_torch's
do_menv_device (K7's plain version on the CPU, after the port's host
preparation and device sort) and do_Menv_from_tree (the 'host' engine)
against the JAX package's do_Menv_from_tree and do_menv_device in its 'x64'
mode, on the same seeded catalogs: a periodic box, a box under three cells
a side (wrapped neighbour cells alias and are deduplicated), and a light
cone. rtol 1e-12 (the sums differ only in their order) and the same zeros
(the classification is the tree's)."""

import numpy as np
import numpy.testing as npt
import pytest
import torch

from abacusutils_tpu.models.hod.menv import do_Menv_from_tree as j_tree
from abacusutils_tpu.models.hod.menv_device import do_menv_device as j_device
from abacusutils_tpu_torch.models.hod import menv_device as tmd
from abacusutils_tpu_torch.models.hod.menv import do_Menv_from_tree as t_tree


def _clustered(rng, n, L, nclump=40, sigma_frac=0.02):
    c = rng.random((nclump, 3)) * L
    p = c[rng.integers(0, nclump, n)] + rng.normal(0, L * sigma_frac, (n, 3))
    return np.mod(p, L).astype(np.float32)


def _case(name):
    rng = np.random.default_rng({'box': 2, 'small box': 3, 'light cone': 4}[name])
    if name == 'box':
        L, n = 200.0, 3000
        pos = _clustered(rng, n, L)
    elif name == 'small box':
        L, n = 25.0, 1500
        pos = _clustered(rng, n, L, sigma_frac=0.05)
    else:
        L, n = 300.0, 4000
        pos = _clustered(rng, n, L) + 50.0
    mass = np.exp(rng.normal(27, 1.5, n))
    rin = 0.5 if name == 'light cone' else (rng.random(n) * 0.5 + 0.1).astype(np.float32)
    return dict(pos=pos, mass=mass, r_inner=rin, r_outer=10.0, halo_lc=name == 'light cone',
                Lbox=L, mcut=float(np.median(mass)))


@pytest.mark.parametrize('name', ['box', 'small box', 'light cone'])
def test_menv_matches_jax(name):
    kw = _case(name)
    ref = j_tree(**kw)
    got = tmd.do_menv_device(**kw, device='cpu')
    assert np.count_nonzero(ref) > len(ref) // 4
    for other in (j_device(**kw, precision='x64'), t_tree(**kw)):
        npt.assert_allclose(other, ref, rtol=1e-12, atol=0.0)
        npt.assert_array_equal(other == 0, ref == 0)
    npt.assert_allclose(got, ref, rtol=1e-12, atol=0.0)
    npt.assert_array_equal(got == 0, ref == 0)


def test_stage_menv_is_the_jax_host_preparation(monkeypatch):
    """The cell sort, the starts and work items, the neighbour tables and the
    dense ids K7 reads: every halo lies in its cell's run, each item holds
    at most K7_CENTRES centres of one cell, and the dense ids (forced here)
    name the occupied cells in order."""
    kw = _case('light cone')
    for dense in (False, True):
        if dense:
            monkeypatch.setattr(tmd, '_DENSE_MIN_CELLS', 0)
        cols, starts, ukeys, nbrs, ncs, periodic, work, order = tmd.stage_menv(
            kw['pos'], kw['mass'], kw['r_inner'], kw['r_outer'], True, kw['Lbox'], 'cpu')
        assert not periodic and (ukeys is not None) == dense
        _, _, key, _, cod = tmd._cell_keys(kw['pos'], kw['r_outer'], True, kw['Lbox'])
        skey = torch.from_numpy(key)[order]
        st = starts.long()
        assert int(st[-1]) == len(key) and bool((torch.diff(skey) >= 0).all())
        owner = torch.repeat_interleave(torch.arange(st.numel() - 1), torch.diff(st))
        npt.assert_array_equal(owner.numpy(), skey.numpy())
        w = work.long()
        real = w[:, 2] > w[:, 1]
        assert int((w[real, 2] - w[real, 1]).max()) <= tmd.K7_CENTRES
        assert int((w[real, 2] - w[real, 1]).sum()) == len(key)
        npt.assert_array_equal(owner[w[real, 1]].numpy(), w[real, 0].numpy())
        if dense:
            npt.assert_array_equal(ukeys.numpy(), cod)
        for t_, n in zip(nbrs, ncs):
            assert t_.shape == (n, 3) and int(t_.min()) >= -1
    # periodic axes of fewer than three cells deduplicate
    npt.assert_array_equal(tmd._axis_neighbors(2, True), [[0, 1, -1], [0, 1, -1]])
    npt.assert_array_equal(tmd._axis_neighbors(3, False), [[-1, 0, 1], [0, 1, 2], [1, 2, -1]])
