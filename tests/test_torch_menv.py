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
from abacusutils_tpu_torch.testing import menv_walk


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
    """The cell sort, the starts, the cells, the centres and the work items
    K7 reads: every halo lies in its cell's run, the cells decode the raw
    ids, the centres are those above mcut, the items cut them in order into
    runs of at most K7_CENTRES centres of one row, and the dense ids (forced
    here) name the occupied cells in order."""
    kw = _case('light cone')
    for dense in (False, True):
        if dense:
            monkeypatch.setattr(tmd, '_DENSE_MIN_CELLS', 0)
        st = tmd.stage_menv(kw['pos'], kw['mass'], kw['r_inner'], kw['r_outer'], True,
                            kw['Lbox'], 'cpu', kw['mcut'])
        assert not st.periodic and (st.ukeys is not None) == dense
        _, ncs, key, _, cod = tmd._cell_keys(kw['pos'], kw['r_outer'], True, kw['Lbox'])
        assert st.ncs == tuple(int(c) for c in ncs)
        skey = torch.from_numpy(key)[st.order]
        starts = st.starts.long()
        assert int(starts[-1]) == len(key) and bool((torch.diff(skey) >= 0).all())
        owner = torch.repeat_interleave(torch.arange(starts.numel() - 1), torch.diff(starts))
        npt.assert_array_equal(owner.numpy(), skey.numpy())
        raw = torch.from_numpy(cod)[skey] if dense else skey
        cells = st.cells.long()
        npt.assert_array_equal(((cells[0] * ncs[1] + cells[1]) * ncs[2] + cells[2]).numpy(),
                               raw.numpy())
        q = st.query.long()
        npt.assert_array_equal(q.numpy(), torch.nonzero(st.cols[3] > kw['mcut']).flatten())
        w = st.work.long()
        assert int(w[0, 0]) == 0 and int(w[-1, 1]) == q.numel()
        assert torch.equal(w[1:, 0], w[:-1, 1])
        assert int((w[:, 1] - w[:, 0]).min()) >= 1
        assert int((w[:, 1] - w[:, 0]).max()) <= tmd.K7_CENTRES
        row = cells[0, q] * ncs[1] + cells[1, q]
        item = torch.repeat_interleave(torch.arange(len(w)), w[:, 1] - w[:, 0])
        assert bool((row == row[w[item, 0]]).all())
        if dense:
            npt.assert_array_equal(st.ukeys.numpy(), cod)
    # periodic axes of fewer than three cells deduplicate: every cell is a
    # neighbour; open axes stop at the faces
    for n, periodic, want in ((2, True, [[0, 1], [0, 1]]),
                              (3, False, [[0, 1], [0, 1, 2], [1, 2]])):
        c = torch.tensor([[i, 0, 0] for i in range(n)])
        near = tmd.neighbour_cells(c[:, None], c[None], (n, 1, 1), periodic)
        assert [torch.nonzero(r).flatten().tolist() for r in near] == want


def _walk_case(name):
    """Clumped catalogs for K7's walk: boxes of 1, 2, 3 and 5 cells a side
    (r_outer 10), a light cone, and a box whose r_inner (25) passes both
    r_outer and the cell edge (10)."""
    rng = np.random.default_rng(len(name))
    L = {'box nc 1': 15.0, 'box nc 2': 25.0, 'box nc 3': 35.0, 'box nc 5': 55.0,
         'light cone': 200.0, 'box r_inner > r_outer': 200.0}[name]
    n = 1500
    pos = _clustered(rng, n, L, nclump=20, sigma_frac=0.05)
    if name == 'light cone':
        pos = pos + 50.0
    mass = np.exp(rng.normal(27, 1.5, n))
    rin = (rng.random(n) * 0.5 + 0.1).astype(np.float32)
    if name == 'box r_inner > r_outer':
        rin = np.full(n, 25.0, np.float32)
    return dict(pos=pos, mass=mass, r_inner=rin, r_outer=10.0, halo_lc=name == 'light cone',
                Lbox=L, mcut=float(np.median(mass)))


WALK_CASES = ['box nc 1', 'box nc 2', 'box nc 3', 'box nc 5', 'light cone',
              'box r_inner > r_outer']


def _walk_stage(name, dense, monkeypatch):
    if dense:
        monkeypatch.setattr(tmd, '_DENSE_MIN_CELLS', 0)
    kw = _walk_case(name)
    st = tmd.stage_menv(kw['pos'], kw['mass'], kw['r_inner'], kw['r_outer'], kw['halo_lc'],
                        kw['Lbox'], 'cpu', kw['mcut'])
    return kw, st, kw['Lbox'] if st.periodic else 0.0


@pytest.mark.parametrize('name,dense', [(c, False) for c in WALK_CASES] + [('light cone', True)])
def test_row_runs_visit_each_centres_27_cells_once(name, dense, monkeypatch):
    """The ranges of K7's items, after its z-cell test, hold for every
    centre exactly the halos of its 27 cells (the JAX package's neighbour
    cells), each once."""
    kw, st, lbox = _walk_stage(name, dense, monkeypatch)
    pairs = menv_walk(st, lbox, kw['r_outer'] ** 2, pairs=True)
    cell = st.cells.long().T
    q = st.query.long()
    want = torch.nonzero(tmd.neighbour_cells(cell[q][:, None], cell[None], st.ncs, st.periodic))
    want = torch.stack([q[want[:, 0]], want[:, 1]], 1)

    def ordered(p):
        return p[torch.argsort(p[:, 0] * len(cell) + p[:, 1])]

    assert torch.equal(ordered(pairs), ordered(want))


@pytest.mark.parametrize('name,dense', [(c, False) for c in WALK_CASES] + [('light cone', True)])
def test_row_walk_matches_plain_and_jax(name, dense, monkeypatch):
    """K7's walk on the CPU equals menv_annulus_plain and JAX's device
    engine ('x64') at rtol 1e-12 with the same zeros, r_inner > r_outer
    included (both sum the 27 cells only)."""
    kw, st, lbox = _walk_stage(name, dense, monkeypatch)
    walk = menv_walk(st, lbox, kw['r_outer'] ** 2)
    plain = tmd.menv_annulus(st, lbox, kw['r_outer'] ** 2)
    assert np.count_nonzero(plain.numpy()) > len(plain) // 4
    npt.assert_allclose(walk.numpy(), plain.numpy(), rtol=1e-12, atol=0.0)
    npt.assert_array_equal(walk.numpy() == 0, plain.numpy() == 0)
    got = np.empty(len(walk))
    got[st.order.numpy()] = walk.numpy()
    ref = j_device(**kw, precision='x64')
    npt.assert_allclose(got, ref, rtol=1e-12, atol=0.0)
    npt.assert_array_equal(got == 0, ref == 0)


def test_menv_wrapper_never_falls_back(monkeypatch):
    """Off the CPU, K7's wrapper launches or raises: a stage it does not take
    is refused, and a missing kernel library is not replaced by the plain
    version."""
    from abacusutils_tpu_torch import _build

    class NoKernel(RuntimeError):
        pass

    def no_lib():
        raise NoKernel

    meta = dict(device='meta')
    n = 10
    i32 = dict(dtype=torch.int32, **meta)
    st = tmd.MenvStage([torch.empty(n, dtype=torch.float64, **meta) for _ in range(5)],
                       torch.empty((3, n), **i32), torch.empty(9, **i32), None, (2, 2, 2), True,
                       0.0, torch.empty(n, **i32), torch.empty((1, 2), **i32),
                       torch.empty(n, dtype=torch.int64, **meta))
    with pytest.raises(ValueError, match='work must be'):
        tmd.menv_annulus(st._replace(work=torch.empty((1, 3), **i32)), 10.0, 1.0)
    with pytest.raises(ValueError, match='cells must be'):
        tmd.menv_annulus(st._replace(cells=torch.empty((2, n), **i32)), 10.0, 1.0)
    monkeypatch.setattr(_build, 'lib', no_lib)
    with pytest.raises(NoKernel):
        tmd.menv_annulus(st, 10.0, 1.0)
