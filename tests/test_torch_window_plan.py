"""K8's row plan (models/zcv/zenbu_window.py:window_plan) and its sums on the
CPU: ``window_mode_sums_rows_plain`` (each distinct f32 kx^2 + ky^2 row once,
times its multiplicity, cut to its run of in-bin kz) and a torch mirror of
the kernel's walk over each bin's prefix of rows, against the JAX package's
``_window_mode_sums_host`` and the port's full-mesh plain version
``window_mode_sums_plain``.

Tolerances: the counts row exactly (integer sums); against the full-mesh
plain version the other rows within 1e-12 of the bin's count (the same f32
weights summed in f64 in another order); against JAX's host sums within
1e-6 of (2 l + 1) x the bin's count (numpy forms 3 mu^2 and 35 mu^4 in
another association, an f32 ulp of each weight).
"""

import numpy as np
import numpy.testing as npt
import pytest
import torch

from abacusutils_tpu.models.zcv import zenbu_window as jzw
from abacusutils_tpu_torch.models.zcv import zenbu_window as tzw

PREF = np.array([1, 5, 9])


def _kout(nmesh, lbox, log):
    kmax = np.pi * nmesh / lbox
    if log:
        return np.concatenate([[0.0], np.geomspace(2 * np.pi / lbox, kmax, 16)])
    return np.linspace(0, kmax, nmesh // 2 + 1)


@pytest.mark.parametrize('lbox', [2000.0, 750.0])
@pytest.mark.parametrize('log', [False, True], ids=['linear', 'log'])
@pytest.mark.parametrize('nmesh', [24, 31, 32])
def test_row_walk_matches_jax_host_and_plain(nmesh, log, lbox):
    kout = _kout(nmesh, lbox, log)
    plan = tzw.get_window_plan(nmesh, lbox, kout, 'cpu')
    got = tzw.window_mode_sums_rows_plain(plan)
    ref = tzw.window_mode_sums_plain(plan.kv, plan.kzv, plan.edges, plan.nkout)
    npt.assert_array_equal(got[0].numpy(), ref[0].numpy())
    assert bool(((got - ref).abs() <= 1e-12 * ref[0].clamp_min(1.0)).all())
    # every distinct value's multiplicity, the cut ones included, counts
    # each (ix, iy) row once
    assert int(plan.mult.sum() + plan.cut_mult.sum()) == nmesh * nmesh
    assert plan.modes == int((plan.izhi - plan.izlo + 1).sum())
    S0, n0, k0 = jzw._window_mode_sums_host(nmesh, lbox, kout)
    S, n, k = tzw._window_mode_sums_device(nmesh, lbox, kout, 'cpu')
    npt.assert_array_equal(n, n0)
    assert (np.abs(S - S0) <= 1e-6 * PREF[:, None, None] * n0[None, None, :]).all()
    npt.assert_allclose(k, k0, rtol=1e-6)
    r = got.numpy()
    npt.assert_array_equal(r[0], n0)
    assert (np.abs(r[4] - S0[1, 1] / 5) <= 1e-6 * n0).all()


@pytest.mark.parametrize('nmesh', [31, 32])
def test_plan_rows_and_cuts(nmesh):
    """The plan's rows are the distinct values of the mesh's own kx^2 + ky^2
    table (an odd mesh's unpaired -(n + 1) / 2 dk included), ascending, each
    with the number of (ix, iy) that share its bits; a value is cut exactly
    when none of its modes lies in a bin, and izlo..izhi are a kept row's
    in-bin kz."""
    lbox = 500.0
    kout = np.linspace(2.5 * 2 * np.pi / lbox, 0.8 * np.pi * nmesh / lbox, 9)  # above 0
    plan = tzw.get_window_plan(nmesh, lbox, kout, 'cpu')
    kv, kzv = tzw._mode_kgrids(nmesh, lbox)
    kxy2 = (kv[:, None] * kv[:, None] + kv[None, :] * kv[None, :]).reshape(-1)
    vals, counts = np.unique(kxy2, return_counts=True)
    kept = np.isin(vals, plan.kxy2.numpy())
    npt.assert_array_equal(plan.kxy2.numpy(), vals[kept])
    npt.assert_array_equal(plan.mult.numpy(), counts[kept])
    npt.assert_array_equal(np.sort(plan.cut_mult.numpy()), np.sort(counts[~kept]))
    assert (~kept).any() and kept.any()
    e = tzw._f32_ge_edges(kout)
    knorm = np.sqrt(vals[:, None] + kzv[None, :] * kzv[None, :])  # numpy's f32 root is exact
    inbin = (knorm >= e[0]) & (knorm < e[-1])
    npt.assert_array_equal(inbin.any(1), kept)
    iz = np.arange(len(kzv))
    lo, hi = plan.izlo.numpy()[:, None], plan.izhi.numpy()[:, None]
    npt.assert_array_equal(inbin[kept], (iz >= lo) & (iz <= hi))


def _walk_chunks(plan):
    """K8's kernel walk in torch: for each bin its prefix of `reach` rows in
    chunks of K8_ITEM_ROWS; for each row its first kz at or above the bin's
    lower threshold (a search of its run), then its kz while the squared
    norm stays below the upper one, the weights times the row's
    multiplicity summed; a bin's chunks added in order."""
    out = torch.zeros((7, plan.nkout), dtype=torch.float64)
    for b in range(plan.nkout):
        for r0 in range(0, int(plan.reach[b]), tzw.K8_ITEM_ROWS):
            part = torch.zeros(7, dtype=torch.float64)
            for r in range(r0, min(r0 + tzw.K8_ITEM_ROWS, int(plan.reach[b]))):
                lo, end = int(plan.izlo[r]), int(plan.izhi[r]) + 1
                ksq = plan.kxy2[r] + plan.kz2[lo:end]
                z0 = lo + int(torch.searchsorted(ksq, plan.thresholds[b:b + 1]))
                z1 = lo + int(torch.searchsorted(ksq, plan.thresholds[b + 1:b + 2]))
                _, rows = tzw._mode_weights(plan.kxy2[r] + plan.kz2[z0:z1], plan.kzv[z0:z1])
                part += torch.stack([w.double() for w in rows]).sum(1) * plan.mult[r]
            out[:, b] += part
    return out


@pytest.mark.parametrize('nmesh,log', [(31, False), (32, True), (24, False)])
def test_plan_reach(nmesh, log):
    """Each bin's reach is the prefix of the rows with kxy2 below its upper
    threshold, and every in-bin mode's row lies in its bin's prefix; the
    kernel's walk over the prefixes gives the rows mirror's sums (counts
    exactly)."""
    lbox = 640.0
    kout = _kout(nmesh, lbox, log)
    plan = tzw.get_window_plan(nmesh, lbox, kout, 'cpu')
    n = (plan.izhi - plan.izlo + 1).long()
    row = torch.repeat_interleave(torch.arange(n.numel()), n)
    iz = plan.izlo.long()[row] + torch.arange(plan.modes) - torch.repeat_interleave(
        torch.cumsum(n, 0) - n, n)
    bins = torch.searchsorted(plan.thresholds, plan.kxy2[row] + plan.kz2[iz], right=True) - 1
    assert bool((bins >= 0).all() and (bins < plan.nkout).all())
    reach = plan.reach.long()
    assert plan.reach.dtype == torch.int32 and reach.shape == (plan.nkout,)
    npt.assert_array_equal(reach.numpy(), [int((plan.kxy2 < t).sum())
                                           for t in plan.thresholds[1:]])
    assert bool((row < reach[bins]).all())
    walk = _walk_chunks(plan)
    ref = tzw.window_mode_sums_rows_plain(plan)
    npt.assert_array_equal(walk[0].numpy(), ref[0].numpy())
    assert bool(((walk - ref).abs() <= 1e-12 * ref[0].clamp_min(1.0)).all())


def test_plan_walk_in_short_chunks(monkeypatch):
    """With chunks shorter than a bin's prefix (several blocks a bin) the
    walk still gives the rows mirror's sums."""
    monkeypatch.setattr(tzw, 'K8_ITEM_ROWS', 7)
    nmesh, lbox = 32, 900.0
    plan = tzw.get_window_plan(nmesh, lbox, _kout(nmesh, lbox, False), 'cpu')
    assert int(plan.reach.max()) > 3 * 7
    walk = _walk_chunks(plan)
    ref = tzw.window_mode_sums_rows_plain(plan)
    npt.assert_array_equal(walk[0].numpy(), ref[0].numpy())
    assert bool(((walk - ref).abs() <= 1e-12 * ref[0].clamp_min(1.0)).all())


def test_thresholds_order_roots_as_edges():
    """s >= the squared-norm threshold of an edge exactly when the correctly
    rounded f32 root of s is at least the edge, for f32 s around each
    threshold and at random; 0 for edges at or below 0, inf past every
    root."""
    rng = np.random.default_rng(5)
    e = np.concatenate([[-1.0, 0.0, 1e-30, 3.1e-3, 0.5, 1.0, 7.77, 1e19, np.inf],
                        rng.random(200) * 2]).astype(np.float32)
    t = tzw._k2_thresholds(e)
    assert t[0] == 0 and t[1] == 0 and t[-201] == np.inf
    near = np.stack([np.nextafter(t, np.float32(-np.inf)), t, np.nextafter(t, np.float32(np.inf))])
    s = np.concatenate([near.reshape(-1), (rng.random(5000) * 4).astype(np.float32)])
    s = np.maximum(s, np.float32(0))
    root = np.sqrt(s.astype(np.float64)).astype(np.float32)
    npt.assert_array_equal(s[:, None] >= t[None, :], root[:, None] >= e[None, :])


def test_cpu_wrapper_runs_the_plain_version():
    """window_mode_sums on a plan of CPU tensors is the full-mesh plain
    version of the plan's tensors; window_plan refuses tensors of other
    shapes or types."""
    nmesh, lbox = 20, 300.0
    kout = _kout(nmesh, lbox, False)
    plan = tzw.get_window_plan(nmesh, lbox, kout, 'cpu')
    ref = tzw.window_mode_sums_plain(plan.kv, plan.kzv, plan.edges, plan.nkout)
    assert torch.equal(tzw.window_mode_sums(plan), ref)
    with pytest.raises(ValueError, match='edges must be'):
        tzw.window_plan(plan.kv, plan.kzv, plan.edges[1:], plan.nkout)
    with pytest.raises(ValueError, match='kzv must be'):
        tzw.window_plan(plan.kv, plan.kzv.double(), plan.edges, plan.nkout)
