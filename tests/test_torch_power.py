"""Port parity: the P(k) mode-binning helpers and the binned power of
abacusutils_tpu_torch against abacusutils_tpu (JAX on CPU)."""

import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from abacusutils_tpu.models.pipeline import make_bin_plan_arrays as jax_make_bin_plan_arrays
from abacusutils_tpu.ops import power as jpow
from abacusutils_tpu_torch import _build
from abacusutils_tpu_torch.models.pipeline import make_bin_plan_arrays
from abacusutils_tpu_torch.ops.power import (
    MAX_BINS,
    bin_power_modes,
    get_k_mu_edges,
    get_W_compensated,
    mode_bin_plan,
)
from torch_helpers import t


@pytest.mark.parametrize('paste', ['TSC', 'CIC'])
@pytest.mark.parametrize('interlaced', [False, True])
def test_window_and_edges_match(paste, interlaced):
    npt.assert_array_equal(
        get_W_compensated(500.0, 64, paste, interlaced),
        jpow.get_W_compensated(500.0, 64, paste, interlaced),
    )
    for logk in (False, True):
        for a, b in zip(
            get_k_mu_edges(500.0, 0.3, 20, 4, logk), jpow.get_k_mu_edges(500.0, 0.3, 20, 4, logk)
        ):
            npt.assert_array_equal(a, b)


@pytest.mark.parametrize('n1d,lbox,nbins', [(32, 500.0, 16), (33, 500.0, 16), (64, 2000.0, 32)])
def test_bin_plan_matches_jax(n1d, lbox, nbins):
    """seg and counts equal the JAX plan exactly (odd meshes included: no
    self-conjugate Nyquist plane there)."""
    seg, counts = make_bin_plan_arrays(n1d, lbox, nbins, 'cpu')
    (seg_j,), counts_j = jax_make_bin_plan_arrays(n1d, lbox, nbins)
    assert seg.dtype == torch.int32
    npt.assert_array_equal(seg.numpy(), np.asarray(seg_j))
    npt.assert_array_equal(counts, counts_j)

    kedges2 = np.array([0.0, 4.0, 30.0, 200.0], np.float32)
    muedges2 = np.array([0.0, 0.1, 0.5, 1.0], np.float32)
    seg2, counts2 = mode_bin_plan(n1d, kedges2, muedges2)
    plan = jpow._get_mode_bin_plan(n1d, kedges2, muedges2, ())
    npt.assert_array_equal(seg2, np.asarray(plan.seg))
    npt.assert_array_equal(counts2, plan.counts)


def _mesh(n1d, seed):
    rng = np.random.default_rng(seed)
    delta = rng.normal(size=(n1d,) * 3).astype(np.float32)
    return torch.fft.rfftn(t(delta))


@pytest.mark.parametrize('n1d,lbox,nbins', [(32, 500.0, 16), (33, 500.0, 16), (64, 2000.0, 32)])
@pytest.mark.parametrize('window', [True, False])
def test_binned_power_matches_segsum_matmul(n1d, lbox, nbins, window):
    """bin_power_modes (CPU dispatch: the plain float64 bincount) against
    the JAX step's |delta_k * s / W|^2 -> _segsum_matmul. rtol 1e-5: the
    bf16 hi/lo split of the MXU contraction keeps ~16 mantissa bits per
    mode, and f32 sums run in another order."""
    seg, _ = make_bin_plan_arrays(n1d, lbox, nbins, 'cpu')
    dk = _mesh(n1d, seed=n1d)
    W = t(get_W_compensated(lbox, n1d, 'TSC', False).astype(np.float32)) if window else None
    scale = 1.0 / n1d**3

    before = bin_power_modes.launches
    got = bin_power_modes(dk, seg, W, scale, nbins)
    assert bin_power_modes.launches == before  # the plain version is no launch
    assert got.dtype == torch.float32 and got.shape == (nbins,)

    kzlen = n1d // 2 + 1
    dkj = jnp.asarray(dk.numpy()) * jnp.float32(scale)
    if W is not None:
        Wj = jnp.asarray(W.numpy())
        dkj = dkj / (Wj[:, None, None] * Wj[None, :, None] * Wj[None, None, :kzlen])
    ref = jpow._segsum_matmul(
        (jnp.abs(dkj) ** 2).reshape(-1), jnp.asarray(seg.numpy()), nbins, kzlen,
        even=(n1d % 2 == 0),
    )
    npt.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)


def test_binning_wrapper_never_falls_back(monkeypatch):
    meta = dict(device='meta')
    dk = torch.empty((32, 32, 17), dtype=torch.complex64, **meta)
    seg = torch.empty(32 * 32 * 17, dtype=torch.int32, **meta)
    with pytest.raises(ValueError, match='nbins'):
        bin_power_modes(dk, seg, None, 1.0, MAX_BINS + 1)

    class NoKernel(RuntimeError):
        pass

    def no_lib():
        raise NoKernel

    monkeypatch.setattr(_build, 'lib', no_lib)
    with pytest.raises(NoKernel):
        bin_power_modes(dk, seg, None, 1.0, 16)
    with pytest.raises(ValueError, match='int32'):
        bin_power_modes(dk, seg.long(), None, 1.0, 16)
