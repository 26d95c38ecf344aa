"""Row spans of the mode-bin plans (ops/power.py:row_spans, mode_spans): the
kz interval of each (ix, iy) row that holds its in-bin modes, which the
binning kernel walks instead of every mode. Checked against numpy brute force
and, through the plain binning restricted to the spans, against JAX's
_segsum_matmul / _segsum_matmul_pairs on the CPU."""

import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from abacusutils_tpu.ops import power as jpow
from abacusutils_tpu_torch.ops import power as tpow
from abacusutils_tpu_torch.ops.power import (
    bin_pair_modes_plain,
    bin_power_modes_plain,
    field_pairs,
    get_mode_bin_plan,
    get_W_compensated,
    mode_spans,
    row_spans,
)
from torch_helpers import t

LBOX = 500.0


def _plan(n1d, nk, nmu, kmin_frac, kmax_frac, poles=()):
    """A plan on the CPU with nk linear k-bins from kmin_frac to kmax_frac of
    the Nyquist frequency and nmu mu-bins."""
    kny = np.pi * n1d / LBOX
    kedges = np.linspace(kmin_frac * kny, kmax_frac * kny, nk + 1)
    muedges = np.linspace(0.0, 1.0, nmu + 1)
    dk = 2 * np.pi / LBOX
    return get_mode_bin_plan(n1d, ((kedges / dk) ** 2).astype(np.float32),
                             (muedges**2).astype(np.float32), poles, 'cpu')


def _brute_spans(seg, nbins, n1d):
    """[lo, hi) of the in-bin modes of every row, from numpy, and whether
    each row's in-bin modes are one interval."""
    s = seg.reshape(n1d * n1d, n1d // 2 + 1)
    bounds = np.zeros((n1d * n1d, 2), np.int32)
    for r in range(n1d * n1d):
        idx = np.nonzero((s[r] >= 0) & (s[r] < nbins))[0]
        if len(idx):
            bounds[r] = idx[0], idx[-1] + 1
            assert len(idx) == idx[-1] + 1 - idx[0], r
    return bounds


@pytest.mark.parametrize('nmu', [1, 4])
@pytest.mark.parametrize('kmin_frac,kmax_frac', [(0.0, 1.0), (0.2, 1.0), (0.0, 0.6), (0.3, 0.7)])
@pytest.mark.parametrize('n1d', [32, 33])
def test_spans_match_brute_force(n1d, kmin_frac, kmax_frac, nmu):
    """The plan's spans are each row's interval of seg < nbins (even and odd
    meshes, k_min > 0, k_max below Nyquist, 1 and 4 mu-bins); every mode
    outside them has seg == nbins, seg does not decrease along kz inside
    them, and the work list holds the groups of four rows with any."""
    plan = _plan(n1d, 10, nmu, kmin_frac, kmax_frac)
    nbins = plan.nk * plan.nmu
    seg = plan.seg.numpy()
    bounds = plan.spans.bounds.numpy()
    npt.assert_array_equal(bounds, _brute_spans(seg, nbins, n1d))
    s = seg.reshape(n1d * n1d, n1d // 2 + 1)
    kz = np.arange(n1d // 2 + 1)
    inside = (kz[None, :] >= bounds[:, :1]) & (kz[None, :] < bounds[:, 1:])
    assert (s[~inside] == nbins).all()
    assert ((s >= 0) & (s < nbins))[inside].all()
    for r in np.nonzero(bounds[:, 1] > bounds[:, 0])[0]:
        assert (np.diff(s[r, bounds[r, 0]:bounds[r, 1]]) >= 0).all(), r
    assert 0 < inside.sum() < s.size or (kmin_frac == 0.0 and kmax_frac == 1.0)
    rows = (bounds[:, 1] > 0).reshape(n1d, n1d)
    gpx = -(-n1d // 4)
    padded = np.zeros((n1d, 4 * gpx), bool)
    padded[:, :n1d] = rows
    want = np.nonzero(padded.reshape(n1d * gpx, 4).any(1))[0]
    npt.assert_array_equal(plan.spans.groups.numpy(), want)
    assert plan.spans.bounds.dtype == plan.spans.groups.dtype == torch.int32


def test_spans_of_any_seg_hold_every_in_bin_mode():
    """row_spans of a seg that is no plan's (bins in random order, modes out
    of range on both sides) still run from each row's first in-bin mode to
    its last."""
    n1d, nbins = 20, 7
    rng = np.random.default_rng(4)
    seg = rng.integers(-2, nbins + 3, n1d * n1d * (n1d // 2 + 1)).astype(np.int32)
    seg[: 11 * 3] = nbins  # three empty rows
    spans = row_spans(torch.from_numpy(seg), nbins)
    s = seg.reshape(n1d * n1d, -1)
    for r, (lo, hi) in enumerate(spans.bounds.numpy()):
        idx = np.nonzero((s[r] >= 0) & (s[r] < nbins))[0]
        assert (lo, hi) == ((idx[0], idx[-1] + 1) if len(idx) else (0, 0)), r
    assert tuple(spans.bounds[:3].reshape(-1).tolist()) == (0,) * 6


def test_mode_spans_reads_the_cache_by_identity():
    """mode_spans on a cached plan's seg builds nothing and returns the
    plan's spans; on an equal tensor that is not the plan's, or with another
    bin count, it builds once a call."""
    plan = _plan(24, 8, 2, 0.1, 0.8)
    nbins = plan.nk * plan.nmu
    before = mode_spans.builds
    assert mode_spans(plan.seg, nbins) is plan.spans
    assert mode_spans.builds == before
    copy = plan.seg.clone()
    got = mode_spans(copy, nbins)
    assert mode_spans.builds == before + 1
    npt.assert_array_equal(got.bounds.numpy(), plan.spans.bounds.numpy())
    npt.assert_array_equal(got.groups.numpy(), plan.spans.groups.numpy())
    mode_spans(plan.seg, nbins - 1)
    assert mode_spans.builds == before + 2


def test_mesh_side_of_mode_counts():
    for n1d in (1, 2, 7, 32, 33, 550):
        assert tpow._mesh_side(n1d * n1d * (n1d // 2 + 1)) == n1d
    with pytest.raises(ValueError, match='rfft mesh'):
        tpow._mesh_side(1000)


def _restricted(seg, spans, nbins, n1d):
    """seg with every mode outside the spans moved out of every bin."""
    bounds = spans.bounds
    kz = torch.arange(n1d // 2 + 1, dtype=torch.int32)
    inside = (kz[None, :] >= bounds[:, :1]) & (kz[None, :] < bounds[:, 1:])
    return torch.where(inside.reshape(-1), seg, nbins)


def _meshes(n1d, nf, seed):
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(n1d,) * 3).astype(np.float32)
    return [torch.fft.rfftn(t(base + 0.5 * rng.normal(size=base.shape).astype(np.float32)))
            for _ in range(nf)]


def _jax_fields(dks, scale, W, n1d):
    out = []
    for dk in dks:
        d = jnp.asarray(dk.numpy()) * jnp.float32(scale)
        if W is not None:
            Wj = jnp.asarray(W.numpy())
            d = d / (Wj[:, None, None] * Wj[None, :, None] * Wj[None, None, : n1d // 2 + 1])
        out.append(d)
    return out


@pytest.mark.parametrize('kmin_frac,kmax_frac', [(0.0, 1.0), (0.15, 0.7)])
@pytest.mark.parametrize('n1d', [32, 33])
def test_power_over_spans_matches_segsum_matmul(n1d, kmin_frac, kmax_frac):
    """The single-field binning over the span modes only (the plain version
    on seg with every mode outside the spans moved out) against JAX's
    _segsum_matmul over all modes, rtol 1e-5 (the bf16 hi/lo MXU split)."""
    plan = _plan(n1d, 12, 1, kmin_frac, kmax_frac)
    nbins = plan.nk
    seg_r = _restricted(plan.seg, plan.spans, nbins, n1d)
    (dk,) = _meshes(n1d, 1, seed=n1d)
    W = t(get_W_compensated(LBOX, n1d, 'TSC', False).astype(np.float32))
    scale = 1.0 / n1d**3
    got = bin_power_modes_plain(dk, seg_r, W, scale, nbins)
    (dj,) = _jax_fields([dk], scale, W, n1d)
    ref = jpow._segsum_matmul((jnp.abs(dj) ** 2).reshape(-1), jnp.asarray(plan.seg.numpy()),
                              nbins, n1d // 2 + 1, even=n1d % 2 == 0)
    npt.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)


@pytest.mark.parametrize('nmu', [1, 4])
@pytest.mark.parametrize('n1d', [32, 33])
def test_pairs_over_spans_match_segsum_matmul_pairs(n1d, nmu):
    """Every pair's binning over the span modes only against JAX's
    _segsum_matmul_pairs over all modes (k below Nyquist, so the spans leave
    modes out): autos at rtol 1e-5, crosses within 1e-5 sqrt(P_ii P_jj)."""
    plan = _plan(n1d, 8, nmu, 0.1, 0.8)
    nbins = plan.nk * plan.nmu
    seg_r = _restricted(plan.seg, plan.spans, nbins, n1d)
    assert int((seg_r != plan.seg).sum()) == 0  # the spans hold every in-bin mode
    dks = _meshes(n1d, 3, seed=n1d + nmu)
    scale = 1.0 / n1d**3
    got = bin_pair_modes_plain(dks, seg_r, None, scale, nbins).numpy()
    dj = _jax_fields(dks, scale, None, n1d)
    pairs = field_pairs(3)
    ref = np.asarray(jpow._segsum_matmul_pairs(
        tuple(d.reshape(-1) for d in dj), jnp.asarray(plan.seg.numpy()), nbins, n1d // 2 + 1,
        even=n1d % 2 == 0, pairs=tuple(pairs),
    ))[:, 0]
    auto = {i: ref[p] for p, (i, j) in enumerate(pairs) if i == j}
    for p, (i, j) in enumerate(pairs):
        scale_ij = np.sqrt(np.abs(auto[i] * auto[j]))
        assert (np.abs(got[p] - ref[p]) <= 1e-5 * scale_ij).all(), (i, j)
