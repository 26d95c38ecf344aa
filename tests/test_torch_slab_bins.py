"""The binning kernel's work list along x (ops/power.py:row_spans' `xgroups`,
span_groups): the groups of four rows neighbouring along x that the kernel
walks on parallel/fft.py:slab_rfftn's x-fastest ky slabs, checked on the CPU
for whole meshes and the ky slabs of 3- and 4-way splits (n1d 45 and 48: a
ragged last group along x, and along y for 45 in four), and the binning
over the modes those groups visit against JAX's _segsum_matmul_pairs."""

import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from abacusutils_tpu.ops import power as jpow
from abacusutils_tpu_torch.ops import power as tpow
from torch_helpers import t

LBOX = 700.0
NMU = 2


def _edges(n1d):
    """Squared k edges (units of the fundamental mode) from 0.1 to 0.8 of
    Nyquist in n1d // 2 bins, so that some rows hold no in-bin mode, and
    NMU mu edges."""
    kny = np.pi * n1d / LBOX
    kedges = np.linspace(0.1 * kny, 0.8 * kny, n1d // 2 + 1)
    dk = 2 * np.pi / LBOX
    return (((kedges / dk) ** 2).astype(np.float32),
            (np.linspace(0.0, 1.0, NMU + 1) ** 2).astype(np.float32))


def _slabs(n1d, split):
    """The ky rows (y0, y1) of each rank of a `split`-way split (ceil(n1d /
    split) rows a rank, the last one ragged)."""
    yl = -(-n1d // split)
    return [(y0, min(y0 + yl, n1d)) for y0 in range(0, n1d, yl)]


def _plan(n1d, ys, poles=()):
    return tpow.get_mode_bin_plan(n1d, *_edges(n1d), poles, 'cpu', yslab=ys)


def _group_rows(ids, n1d, ny, along_x):
    """The (ix, local iy) rows of each group id of a work list, the ragged
    last group's rows past the mesh left out (as the kernel leaves them)."""
    out = []
    for gid in ids.tolist():
        if along_x:
            ly, g = divmod(gid, -(-n1d // 4))
            out.append([(ix, ly) for ix in range(4 * g, 4 * g + 4) if ix < n1d])
        else:
            ix, g = divmod(gid, -(-ny // 4))
            out.append([(ix, ly) for ly in range(4 * g, 4 * g + 4) if ly < ny])
    return out


def _x_fastest(rows):
    """`rows` (n1d, ny, n1d/2+1) copied into slab_rfftn's layout on the card:
    x fastest, then y, kz slowest."""
    n1d, ny, kzlen = rows.shape
    return torch.empty((kzlen, ny, n1d), dtype=rows.dtype).permute(2, 1, 0).copy_(rows)


SPLITS = [(n1d, split) for n1d in (45, 48) for split in (1, 3, 4)]


@pytest.mark.parametrize('n1d,split', SPLITS)
def test_x_groups_hold_each_row_once(n1d, split):
    """The x list of every ky slab holds each non-empty (ix, iy) row exactly
    once (the ragged last group along x included), no group without one,
    in ascending order; its rows are the y list's rows."""
    for ys in _slabs(n1d, split):
        ny = ys[1] - ys[0]
        spans = _plan(n1d, None if split == 1 else ys).spans
        bounds = spans.bounds.numpy().reshape(n1d, ny, 2)
        nonempty = {(ix, ly) for ix, ly in zip(*np.nonzero(bounds[..., 1] > 0))}
        assert 0 < len(nonempty) < n1d * ny
        assert spans.xgroups.dtype == torch.int32
        ids = spans.xgroups.numpy()
        assert (np.diff(ids) > 0).all()
        xrows = _group_rows(spans.xgroups, n1d, ny, True)
        assert all(any(r in nonempty for r in g) for g in xrows)
        got = [r for g in xrows for r in g if r in nonempty]
        assert len(got) == len(set(got)) and set(got) == nonempty
        if n1d % 4:
            assert any(g[-1][0] == n1d - 1 and len(g) == n1d % 4 for g in xrows)
        yrows = {r for g in _group_rows(spans.groups, n1d, ny, False) for r in g}
        assert {r for g in xrows for r in g} & nonempty == yrows & nonempty


@pytest.mark.parametrize('n1d', [45, 48])
def test_layout_picks_the_list(n1d):
    """span_groups gives the x list for slab_rfftn's layout (x fastest, then
    y or kz), and the y list for rfftn's (iy fastest, then ix, kz slowest)
    and for a kz-contiguous slab or mesh."""
    kzlen = n1d // 2 + 1
    for ys in [(0, n1d)] + _slabs(n1d, 3):
        ny = ys[1] - ys[0]
        spans = _plan(n1d, ys).spans
        c64 = dict(dtype=torch.complex64)
        slab_rfftn = torch.empty((kzlen, ny, n1d), **c64).permute(2, 1, 0)
        x_then_kz = torch.empty(n1d * ny * kzlen, **c64).as_strided(
            (n1d, ny, kzlen), (1, n1d * kzlen, n1d))
        rfftn = torch.empty((kzlen, n1d, ny), **c64).permute(1, 2, 0)
        contiguous = torch.empty((n1d, ny, kzlen), **c64)
        for d, along_x in ((slab_rfftn, True), (x_then_kz, True), (rfftn, False),
                           (contiguous, False)):
            groups, got = tpow.span_groups(spans, d.stride())
            assert got is along_x, d.stride()
            assert groups is (spans.xgroups if along_x else spans.groups)


@pytest.mark.parametrize('n1d,split', SPLITS)
def test_plain_binning_on_x_fastest_slabs_is_exact(n1d, split):
    """bin_pair_modes_plain (and the CPU route of bin_pair_modes and
    bin_power_modes) on x-fastest copies of the ky slabs equals it on the
    contiguous slabs bit for bit, poles included."""
    nk = n1d // 2
    rng = np.random.default_rng(n1d + split)
    dks = [torch.fft.rfftn(t(rng.standard_normal((n1d,) * 3).astype(np.float32)))
           for _ in range(3)]
    W = t(tpow.get_W_compensated(LBOX, n1d, 'TSC', False).astype(np.float32))
    for ys in _slabs(n1d, split):
        plan = _plan(n1d, ys, (2, 4))
        rows = [d[:, ys[0]:ys[1]].contiguous() for d in dks]
        xf = [_x_fastest(r) for r in rows]
        assert xf[0].stride()[0] == 1
        want = tpow.bin_pair_modes_plain(rows, plan.seg, W, 1e-3, nk * NMU, plan.pole_w, NMU, ys)
        got = tpow.bin_pair_modes_plain(xf, plan.seg, W, 1e-3, nk * NMU, plan.pole_w, NMU, ys)
        again = tpow.bin_pair_modes(xf, plan.seg, W, 1e-3, nk * NMU, plan.pole_w, NMU, ys)
        for w, g, a in zip(want, got, again):
            assert torch.equal(g, w) and torch.equal(a, w)
        assert torch.equal(tpow.bin_power_modes(xf[0], plan.seg, W, 1e-3, nk * NMU, ys),
                           tpow.bin_power_modes_plain(rows[0], plan.seg, W, 1e-3, nk * NMU, ys))


@pytest.mark.parametrize('split', [3, 4])
@pytest.mark.parametrize('n1d', [45, 48])
def test_x_grouped_walk_matches_segsum_matmul_pairs(n1d, split):
    """The ky slabs' binning over the modes the x list's tiles visit (each
    group's rows, each row's kz span), on x-fastest slabs, summed over the
    slabs, against JAX's _segsum_matmul_pairs of the whole mesh over all
    modes: autos at rtol 1e-5, crosses within 1e-5 sqrt(P_ii P_jj)."""
    kzlen = n1d // 2 + 1
    nbins = n1d // 2 * NMU
    rng = np.random.default_rng(7 * n1d + split)
    base = rng.standard_normal((n1d,) * 3).astype(np.float32)
    dks = [torch.fft.rfftn(t(base + 0.5 * rng.standard_normal(base.shape).astype(np.float32)))
           for _ in range(3)]
    scale = 1.0 / n1d**3
    total = 0.0
    for ys in _slabs(n1d, split):
        ny = ys[1] - ys[0]
        plan = _plan(n1d, ys)
        bounds = plan.spans.bounds.numpy().reshape(n1d, ny, 2)
        visited = np.zeros((n1d, ny, kzlen), bool)
        for g in _group_rows(plan.spans.xgroups, n1d, ny, True):
            for ix, ly in g:
                visited[ix, ly, bounds[ix, ly, 0]:bounds[ix, ly, 1]] = True
        seg = torch.where(t(visited.reshape(-1)), plan.seg, nbins)
        xf = [_x_fastest(d[:, ys[0]:ys[1]]) for d in dks]
        total = total + tpow.bin_pair_modes_plain(xf, seg, None, scale, nbins, yslab=ys).numpy()
    full = _plan(n1d, None)
    pairs = tpow.field_pairs(3)
    ref = np.asarray(jpow._segsum_matmul_pairs(
        tuple(jnp.asarray(d.numpy()).reshape(-1) * jnp.float32(scale) for d in dks),
        jnp.asarray(full.seg.numpy()), nbins, kzlen, even=n1d % 2 == 0, pairs=tuple(pairs),
    ))[:, 0]
    auto = {i: ref[p] for p, (i, j) in enumerate(pairs) if i == j}
    for p, (i, j) in enumerate(pairs):
        tol = 1e-5 * np.sqrt(np.abs(auto[i] * auto[j]))
        assert (np.abs(total[p] - ref[p]) <= tol).all(), (i, j)
    npt.assert_array_equal(full.spans.xgroups.numpy(),
                           _plan(n1d, (0, n1d)).spans.xgroups.numpy())
