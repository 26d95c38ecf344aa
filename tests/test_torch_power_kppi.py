"""Port parity for bin_kppi and its plan: abacusutils_tpu_torch's (k_perp, pi)
binning (the plain version of K9 on the CPU) against a float64 brute force
over every mode and against abacusutils_tpu (JAX on the CPU) on the same
numpy inputs.

Tolerances: counts exact (the plan's int64 products; JAX's f32 products are
exact below 2^24, far above these meshes); means within rtol 2e-6 of the
brute force (both sum f32 weights in float64, then divide) and of JAX (its
HIGHEST-precision f32 matmuls keep ~1e-7 of the sum)."""

import numpy as np
import numpy.testing as npt
import pytest
import torch

from abacusutils_tpu.ops import power as jpow
from abacusutils_tpu_torch.ops import power as tpow
from torch_helpers import t

MEAN_RTOL = 2e-6
L = 100.0


def _brute_kppi(n1d, kedges2, piedges2, w):
    """(wsum, counts) in float64 by visiting every mode: its k_perp^2 and
    kz^2 as integers, its bins by searchsorted(side='left') - 1 on the f32
    squared edges, dup 1 on kz = 0 and on the Nyquist plane of an even mesh
    (the rfft mesh's self-conjugate planes), 2 elsewhere."""
    nk, npi = len(kedges2) - 1, len(piedges2) - 1
    kzlen = n1d // 2 + 1
    i = np.arange(n1d)
    f = np.where(i < n1d // 2, i, i - n1d)
    ix, iy, iz = np.meshgrid(f, f, np.arange(kzlen), indexing='ij')
    kp2 = (ix**2 + iy**2).astype(np.float32).reshape(-1)
    kz2 = (iz**2).astype(np.float32).reshape(-1)
    izf = iz.reshape(-1)
    dup = np.where((izf == 0) | ((n1d % 2 == 0) & (izf == n1d // 2)), 1.0, 2.0)
    ok = (kp2 >= kedges2[0]) & (kp2 < kedges2[-1]) & (kz2 < piedges2[-1])
    bk = np.clip(np.searchsorted(kedges2, kp2, side='left') - 1, 0, nk - 1)
    bp = np.clip(np.searchsorted(piedges2, kz2, side='left') - 1, 0, npi - 1)
    wsum = np.zeros((nk, npi))
    counts = np.zeros((nk, npi))
    np.add.at(wsum, (bk[ok], bp[ok]), dup[ok] * w[:, :, :kzlen].astype(np.float64).reshape(-1)[ok])
    np.add.at(counts, (bk[ok], bp[ok]), dup[ok])
    return wsum, counts


def _edges(n1d, fourier, case):
    """(kedges, pimax, Npi) in the mesh's units dk. 'squares': edges at
    whole multiples of dk, so k_perp^2 and kz^2 land on them; 'past nyquist':
    pi bins past the Nyquist plane (its dup of 1 inside a bin) and k_perp
    edges past the mesh's corner; 'uneven': edges between the squares."""
    dk = 2 * np.pi / L if fourier else L / n1d
    if case == 'squares':
        return np.arange(0, 9) * 2 * dk, (n1d // 2) * dk, 4
    if case == 'past nyquist':
        return np.linspace(0.0, 1.5 * n1d * dk, 7), (n1d // 2 + 3) * dk, 5
    return np.sqrt(np.linspace(0.3, 0.55 * n1d**2, 6)) * dk, 0.37 * n1d * dk, 3


CASES = ['squares', 'past nyquist', 'uneven']


@pytest.mark.parametrize('case', CASES)
@pytest.mark.parametrize('fourier', [True, False])
@pytest.mark.parametrize('n1d', [16, 31, 32])
def test_bin_kppi_matches_brute_force_and_jax(n1d, fourier, case):
    rng = np.random.default_rng(n1d + 7 * fourier)
    w = rng.random((n1d, n1d, n1d // 2 + 1)).astype(np.float32) + 0.5
    kedges, pimax, npi = _edges(n1d, fourier, case)
    mean, counts = tpow.bin_kppi(n1d, L, kedges, pimax, npi, w, fourier=fourier, device='cpu')
    assert counts.dtype == np.int64 and mean.dtype == np.float32
    assert mean.shape == counts.shape == (len(kedges) - 1, npi)

    dk = 2 * np.pi / L if fourier else L / n1d
    kedges2 = ((kedges / dk) ** 2).astype(np.float32)
    piedges2 = ((np.linspace(0.0, pimax, npi + 1) / dk) ** 2).astype(np.float32)
    wsum, bcounts = _brute_kppi(n1d, kedges2, piedges2, w)
    npt.assert_array_equal(counts, bcounts.astype(np.int64))
    assert counts.sum() > 0
    want = np.where(bcounts != 0, wsum / np.maximum(bcounts, 1), 0.0)
    npt.assert_allclose(mean, want, rtol=MEAN_RTOL, atol=0)

    jmean, jcounts = jpow.bin_kppi(n1d, L, kedges, pimax, npi, w, fourier=fourier)
    npt.assert_array_equal(counts, jcounts)
    npt.assert_allclose(mean, jmean, rtol=MEAN_RTOL, atol=0)


@pytest.mark.parametrize('n1d', [16, 31])
def test_kppi_plan_partitions_rows_and_kz(n1d, monkeypatch):
    """The plan's items cover each k_perp bin's rows once, in runs of at
    most KPPI_ITEM_ROWS within one bin; the pi bins' kz ranges tile the
    kz in a bin; the plan is cached by (n1d, edges, device)."""
    monkeypatch.setattr(tpow, '_KPPI_PLANS', {})
    ke2 = np.array([0.0, 3.0, 10.0, 40.0, 80.0], np.float32)
    pe2 = np.array([0.0, 1.0, 9.0, 30.0], np.float32)
    before = tpow.get_kppi_plan.builds
    plan = tpow.get_kppi_plan(n1d, ke2, pe2, 'cpu')
    assert tpow.get_kppi_plan(n1d, ke2, pe2, 'cpu') is plan
    assert tpow.get_kppi_plan.builds == before + 1
    rows, items = plan.rows.numpy(), plan.items.numpy()
    row_bin, istart = plan.row_bin.numpy(), plan.item_start.numpy()
    assert sorted(rows.tolist()) == np.nonzero(row_bin >= 0)[0].tolist()
    assert (np.diff(row_bin[rows]) >= 0).all()
    assert (items[1:, 0] == items[:-1, 1]).all() and items[0, 0] == 0
    assert items[-1, 1] == len(rows)
    assert ((items[:, 1] - items[:, 0] >= 1) & (items[:, 1] - items[:, 0] <= tpow.KPPI_ITEM_ROWS)).all()
    for b in range(plan.nk):
        for it in range(istart[b], istart[b + 1]):
            assert (row_bin[rows[items[it, 0]:items[it, 1]]] == b).all()
    zstart, z_bin = plan.zstart.numpy(), plan.z_bin.numpy()
    assert zstart[0] == 0 and zstart[-1] == plan.kzv == (z_bin >= 0).sum()
    for p in range(plan.npi):
        assert (z_bin[zstart[p]:zstart[p + 1]] == p).all()
    assert not plan.counts.flags.writeable


def test_bin_kppi_reads_a_full_mesh_through_its_strides():
    """A full real mesh (n1d, n1d, n1d) and its [:, :, :kzlen] half give the
    same sums: the half is read through the full mesh's strides. A tensor
    input stays on its device; numpy input without a device goes to the card,
    which this machine may not have."""
    n1d = 16
    rng = np.random.default_rng(3)
    full = rng.random((n1d, n1d, n1d)).astype(np.float32)
    kedges, pimax, npi = _edges(n1d, True, 'past nyquist')
    a = tpow.bin_kppi(n1d, L, kedges, pimax, npi, t(full))
    b = tpow.bin_kppi(n1d, L, kedges, pimax, npi, full[:, :, : n1d // 2 + 1], device='cpu')
    for x, y in zip(a, b):
        npt.assert_array_equal(x, y)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no CUDA device'):
            tpow.bin_kppi(n1d, L, kedges, pimax, npi, full)


def test_kppi_wrapper_checks_its_input():
    """The K9 wrapper runs the plain version on a CPU tensor, counts no
    launch there, and refuses what the kernel does not take: another dtype,
    a mesh of another size, weights not contiguous along kz."""
    n1d = 16
    plan = tpow.get_kppi_plan(n1d, np.array([0.0, 50.0], np.float32),
                              np.array([0.0, 20.0, 64.0], np.float32), 'cpu')
    w = torch.rand(n1d, n1d, n1d // 2 + 1)
    before = tpow.bin_kppi_sums.launches
    out = tpow.bin_kppi_sums(w, plan)
    assert out.dtype == torch.float64 and out.shape == (1, 2)
    assert tpow.bin_kppi_sums.launches == before
    npt.assert_array_equal(out.numpy(), tpow.bin_kppi_sums_plain(w, plan).numpy())
    for bad, match in ((w.double(), 'float32'), (w[:8], 'float32'),
                       (w[:, :, :4], 'float32'),
                       (torch.rand(n1d, n1d // 2 + 1, n1d).transpose(1, 2), 'contiguous along kz')):
        with pytest.raises(ValueError, match=match):
            tpow.bin_kppi_sums(bad, plan)
