"""Port parity for prepare_sim's rank fields: abacusutils_tpu_torch's
rank_fields_device (K6's plain version and the stable-sort ranks, on the CPU)
against the JAX package's rank_fields_device in its 'x64' mode and against
its per-halo cKDTree loop (_rank_fields), on the same seeded slabs.

Against the loop every rank field is exact; the nearest-neighbour rank
(ranksc) is tie-aware, since mutual nearest neighbours tie exactly and
numpy's argsort orders ties as it likes. Against JAX's device engine the
four elementwise ranks are exact; its NN keys come from XLA's pairwise
kernel, whose float64 arithmetic may differ in the last bit, so ranksc is
held exact wherever the keys are bit-equal and untied, and the keys that are
not bit-equal are counted and bounded.
"""

import numpy as np
import numpy.testing as npt
import pytest

from abacusutils_tpu.models.hod import ranks_device as jrd
from abacusutils_tpu.models.hod.prepare_sim import _rank_fields as j_rank_fields
from abacusutils_tpu_torch.models.hod import ranks_device as trd
from abacusutils_tpu_torch.models.hod.prepare_sim import _rank_fields as t_rank_fields
from torch_helpers import t

MPART, H = 2.1e9, 0.6736


def _slab(seed=11, n_halo=80, max_pn=50, big=None):
    """The slab of tests/test_ranks_device.py:_synthetic_slab, with `big`
    extra particles in one more halo, a particle placed at its halo's centre
    (a NaN radial velocity) and a duplicated position (a zero NN distance)."""
    rng = np.random.default_rng(seed)
    pn = rng.integers(2, max_pn, n_halo)
    if big:
        pn = np.append(pn, big)
        n_halo += 1
    ps = np.concatenate([[0], np.cumsum(pn)])[:-1]
    n = int(pn.sum())
    hpos = (rng.random((n_halo, 3)) * 100).astype(np.float32)
    hvel = rng.normal(0, 300, (n_halo, 3)).astype(np.float32)
    N = rng.integers(50, 5000, n_halo)
    r25 = (rng.random(n_halo) * 0.2 + 0.05).astype(np.float32)
    r98 = (r25 * (rng.random(n_halo) * 4 + 1.5)).astype(np.float32)
    ppos = np.zeros((n, 3), np.float32)
    pvel = np.zeros((n, 3), np.float32)
    submask = np.zeros(n, bool)
    for j in range(n_halo):
        sl = slice(ps[j], ps[j] + pn[j])
        ppos[sl] = hpos[j] + rng.normal(0, 0.3, (pn[j], 3)).astype(np.float32)
        pvel[sl] = hvel[j] + rng.normal(0, 100, (pn[j], 3)).astype(np.float32)
        m = rng.random(pn[j]) < 0.6
        while m.sum() < 2:
            m[rng.integers(0, pn[j])] = True
        submask[sl] = m
    # a selected particle at its halo's centre, and a duplicated position
    j = 3
    first = ps[j] + np.flatnonzero(submask[ps[j]:ps[j] + pn[j]])[0]
    ppos[first] = hpos[j]
    ppos[ps[5] + 1] = ppos[ps[5]]
    submask[ps[5]:ps[5] + 2] = True
    return ps, pn, n, hpos, hvel, N, r25, r98, ppos, pvel, submask


def _per_particle(ps, pn, n, hpos, hvel, N, r25, r98, submask):
    seg = np.full(n, -1, np.int32)
    nsub_p = np.zeros(n)
    hpos_p = np.zeros((n, 3), np.float32)
    hvel_p = np.zeros((n, 3), np.float32)
    mass_p = np.zeros(n)
    r25_p = np.zeros(n, np.float32)
    r98_p = np.zeros(n, np.float32)
    for j in range(len(ps)):
        sl = slice(ps[j], ps[j] + pn[j])
        seg[sl] = j
        nsub_p[sl] = submask[sl].sum()
        hpos_p[sl] = hpos[j]
        hvel_p[sl] = hvel[j]
        mass_p[sl] = N[j] * MPART
        r25_p[sl] = r25[j]
        r98_p[sl] = r98[j]
    return seg, nsub_p, hpos_p, hvel_p, mass_p, r25_p, r98_p


def _host_loop(fn, ps, pn, n, hpos, hvel, N, r25, r98, ppos, pvel, submask):
    out = [np.full(n, -1.0) for _ in range(5)]
    for j in range(len(ps)):
        sl = slice(ps[j], ps[j] + pn[j])
        idx = np.arange(ps[j], ps[j] + pn[j])[submask[sl]]
        fn(idx, ppos[sl][submask[sl]], pvel[sl][submask[sl]], ppos[sl], hpos[j], hvel[j],
           N[j] * MPART, r25[j], r98[j], H, *out)
    return out


def _untied(ps, pn, ppos, submask, j):
    """The selected particles of halo j whose NN distance no other selected
    particle of the halo shares."""
    from scipy.spatial import cKDTree

    sl = slice(ps[j], ps[j] + pn[j])
    nn = cKDTree(ppos[sl]).query(ppos[sl][submask[sl]], k=2)[0][:, 1]
    _, inv, cnt = np.unique(nn, return_inverse=True, return_counts=True)
    return cnt[inv] == 1


@pytest.mark.parametrize('big', [None, 320], ids=['80 halos', 'and a halo of 320'])
def test_rank_fields_match_jax_and_the_host_loop(big):
    slab = _slab(big=big)
    ps, pn, n, hpos, hvel, N, r25, r98, ppos, pvel, submask = slab
    cols = _per_particle(ps, pn, n, hpos, hvel, N, r25, r98, submask)
    seg, nsub_p, hpos_p, hvel_p, mass_p, r25_p, r98_p = cols
    args = (ppos, pvel, submask, seg, nsub_p, ps, pn, hpos_p, hvel_p, mass_p, r25_p, r98_p, H)
    port = trd.rank_fields_device(*args, device='cpu')
    ref = jrd.rank_fields_device(*args, precision='x64')
    with np.errstate(invalid='ignore', divide='ignore'):
        host = _host_loop(j_rank_fields, *slab)
        host_port = _host_loop(t_rank_fields, *slab)
    for a, b in zip(host, host_port):
        npt.assert_array_equal(b, a)  # the port's 'host' engine is the loop
    vrad = trd._host_rank_keys(ppos, pvel, hpos_p, hvel_p, mass_p, r25_p, r98_p, H)[2]
    assert np.isnan(vrad).sum() == 1
    dup = np.zeros(n, bool)
    dup[ps[5]:ps[5] + 2] = True
    names = ('ranks', 'ranksv', 'ranksp', 'ranksr')
    for name, p, r, hl in zip(names, port[:4], ref[:4], host[:4]):
        npt.assert_array_equal(p, r, err_msg=f'{name} against JAX')
        # the NaN radial velocity ranks after the unselected slots on the
        # device (as lax.sort orders it) but last among the selected on the
        # host, and the duplicated pair ties in dist^2, which numpy's argsort
        # orders as it likes: hold the host loop on the other particles
        fine = np.isfinite(vrad) | (name != 'ranksr')
        fine[dup] = name != 'ranks'
        npt.assert_array_equal(p[fine], hl[fine], err_msg=f'{name} against the host loop')
    # ranksc: the NN keys of both engines, and the ranks where keys are
    # bit-equal and untied
    x, y, z = (t(ppos[:, a].copy()) for a in range(3))
    seg_t, sel_t = t(seg), t(submask & (seg >= 0))
    query, work = trd.nn_work(seg_t, sel_t, len(ps))
    key_p = np.sqrt(trd.nn_within_halo(x, y, z, query, work, t(ps.astype(np.int32)),
                                       t(pn.astype(np.int32)), seg_t).numpy())
    with jrd.jax.enable_x64(True):
        key_j = np.asarray(jrd._nn_keys(ppos, ps, pn, np.float64, False)[0])
    q = query.numpy()
    differ = key_p[q] != key_j[q]
    assert differ.sum() <= len(q) // 200, f'{differ.sum()} of {len(q)} NN keys differ'
    n_tied = 0
    for j in range(len(ps)):
        sl = slice(ps[j], ps[j] + pn[j])
        m = submask[sl]
        untied = _untied(ps, pn, ppos, submask, j)
        n_tied += int((~untied).sum())
        same = untied & (key_p[sl][m] == key_j[sl][m])
        npt.assert_array_equal(port[4][sl][m][same], ref[4][sl][m][same], err_msg=f'halo {j}')
        npt.assert_array_equal(port[4][sl][m][untied], host[4][sl][m][untied])
        npt.assert_array_equal(np.sort(port[4][sl][m]), np.sort(host[4][sl][m]))
    assert n_tied > 0  # the duplicated position ties


def test_seg_rank_ties_and_nan_as_lax_sort():
    """seg_rank against JAX's _seg_rank3 with ties, -0.0 beside 0.0, NaN of
    either sign, unselected slots and unsegmented particles."""
    rng = np.random.default_rng(3)
    n = 400
    seg = np.sort(rng.integers(-1, 12, n)).astype(np.int32)
    sel = rng.random(n) < 0.7
    for dt in (np.float32, np.float64):
        key = rng.integers(0, 6, n).astype(dt)  # many ties
        key[rng.random(n) < 0.05] = np.nan
        key[rng.random(n) < 0.05] = -np.array(np.nan, dt)
        key[rng.random(n) < 0.05] = -0.0
        got = trd.seg_rank(t(seg), t(sel), t(key)).numpy()
        zeros = np.zeros(n, dt)
        with jrd.jax.enable_x64(True):
            want = np.asarray(jrd._seg_rank3(seg, sel, key, zeros, zeros))
        ok = sel & (seg >= 0)
        npt.assert_array_equal(got[ok], want[ok].astype(np.int64), err_msg=str(dt))
