"""Port parity for prepare_sim's shear field: abacusutils_tpu_torch's
ops/shear.py and the reference-compatible paints of ops/grid.py
(tsc_parallel, cic_serial, rightwrap) against the JAX package's, on the same
seeded inputs at N_dim 32 to 48.

Tolerances: the FFTs are torch.fft's and XLA's, so the shear and the tidal
components agree to float32 round-off of transforms of the size (rtol 2e-4
with an absolute floor of 1e-5 of the field's scale); the host Gaussian
filter is the same scipy call (exact); the paints scatter float32 weights
in another order (rtol 1e-5 of the grid's largest cell)."""

import numpy as np
import numpy.testing as npt
import pytest
import torch

from abacusutils_tpu.ops import grid as jgrid
from abacusutils_tpu.ops import shear as jshear
from abacusutils_tpu_torch.ops import grid as tgrid
from abacusutils_tpu_torch.ops import shear as tshear


def _close(got, ref, rtol=2e-4, floor=1e-5):
    ref = np.asarray(ref)
    npt.assert_allclose(got, ref, rtol=rtol, atol=floor * float(np.abs(ref).max()))


def _density(n, seed=7):
    rng = np.random.default_rng(seed)
    return rng.lognormal(0.0, 0.8, (n, n, n)).astype(np.float32)


@pytest.mark.parametrize('n,L,R', [(32, 100.0, None), (48, 150.0, 3.0)])
def test_get_shear_matches_jax(n, L, R):
    dens = _density(n)
    got = tshear.get_shear(dens, n, L, R=R, device='cpu')
    assert got.dtype == np.float32 and got.shape == (n,) * 3
    _close(got, jshear.get_shear(dens, n, L, R=R))


def test_tidal_components_and_composition():
    """get_tidal against JAX's, and get_tidal -> irfftn -> get_shear_nb
    against get_shear (the one-component-at-a-time accumulation)."""
    n, L = 32, 50.0
    dens = _density(n, 3)
    karr = np.fft.fftfreq(n, d=L / (2 * np.pi * n)).astype(np.float32)
    dfour = np.fft.rfftn(dens)
    for R in (None, 3.0):
        tid = tshear.get_tidal(dfour, karr, n, R=R, device='cpu')
        assert tid.dtype == np.complex64 and tid.shape == (n, n, n // 2 + 1, 6)
        _close(tid, jshear.get_tidal(dfour, karr, n, R=R), rtol=1e-5)
        tidr = np.stack([np.fft.irfftn(tid[..., c]).real for c in range(6)], axis=-1)
        q = tshear.get_shear_nb(tidr, n)
        npt.assert_array_equal(q, jshear.get_shear_nb(tidr, n))
        _close(q, tshear.get_shear(dens, n, L, R=R, device='cpu'))


def test_smoothing_matches_jax():
    n, L, R = 40, 80.0, 2.0
    dens = _density(n, 5)
    npt.assert_array_equal(tshear.smooth_density(dens, R, n, L),
                           jshear.smooth_density(dens, R, n, L))
    _close(tshear.smooth_density_periodic(dens, R, n, L, device='cpu'),
           jshear.smooth_density_periodic(dens, R, n, L), rtol=1e-5)
    for k in (np.array([0.0, 1.0, 7.0]),):
        npt.assert_array_equal(tshear.Wg(k, R), jshear.Wg(k, R))
        npt.assert_array_equal(tshear.Wth(k + 1e-3, R), jshear.Wth(k + 1e-3, R))


@pytest.mark.parametrize('wrap', [True, False])
def test_tsc_parallel_matches_jax(wrap):
    """An int, a tuple and an ndarray densgrid; positions past the faces
    (the single wrap, or none)."""
    rng = np.random.default_rng(9)
    n, L = 36, 90.0
    pos = (rng.random((20000, 3)) * 1.1 * L - 0.05 * L).astype(np.float32)
    w = rng.random(20000).astype(np.float32)
    ref = jgrid.tsc_parallel(pos, n, L, weights=w, wrap=wrap)
    got = tgrid.tsc_parallel(pos, n, L, weights=w, wrap=wrap, device='cpu')
    _close(got, ref, rtol=1e-5)
    _close(tgrid.tsc_parallel(pos, (n, n, n), L, wrap=wrap, device='cpu'),
           jgrid.tsc_parallel(pos, (n, n, n), L, wrap=wrap), rtol=1e-5)
    acc_j = np.ones((n, n, n), np.float32)
    acc_t = acc_j.copy()
    assert jgrid.tsc_parallel(pos, acc_j, L, wrap=wrap) is None
    assert tgrid.tsc_parallel(pos, acc_t, L, wrap=wrap, device='cpu') is None
    _close(acc_t, acc_j, rtol=1e-5)


@pytest.mark.parametrize('shape', [(32, 32, 32), (24, 40, 1), (16, 20, 28)])
def test_cic_serial_matches_jax(shape):
    """Cubic (K1's CIC), the 2-D gz == 1 projected mode and a non-cubic grid
    (both on the host), accumulated into the array given."""
    rng = np.random.default_rng(11)
    L = 64.0
    pos = (rng.random((8000, 3)) * L).astype(np.float32)
    w = rng.random(8000)
    dj = np.zeros(shape, np.float64)
    dt = np.zeros(shape, np.float64)
    jgrid.cic_serial(pos, dj, L, weights=w)
    tgrid.cic_serial(pos, dt, L, weights=w, device='cpu')
    _close(dt, dj, rtol=1e-5)
    assert tgrid.rightwrap(5.0, 4.0) == jgrid.rightwrap(5.0, 4.0) == 1.0
    npt.assert_array_equal(tgrid.rightwrap(np.array([1.0, 4.0, 6.0]), 4.0),
                           jgrid.rightwrap(np.array([1.0, 4.0, 6.0]), 4.0))


def test_paint_tensor_stays_where_it_lies():
    pos = torch.rand(500, 3, dtype=torch.float64) * 10
    grid = tgrid.tsc_parallel(pos, 8, 10.0)
    assert isinstance(grid, np.ndarray) and grid.shape == (8, 8, 8)
    npt.assert_allclose(grid.sum(), 500.0, rtol=1e-5)
