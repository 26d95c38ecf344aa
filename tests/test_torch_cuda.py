"""The port's CUDA kernels against their plain PyTorch versions on a card.

JAX-free, so it runs where the card is (that machine has no JAX); the repo's
conftest imports JAX, so run it there with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Every test skips where torch.cuda.is_available() is false.
"""

import numpy as np
import numpy.testing as npt
import pytest
import torch

from abacusutils_tpu_torch.convert import inputs_from_numpy
from abacusutils_tpu_torch.models import pipeline as tpipe
from abacusutils_tpu_torch.ops.grid import (
    check_deposit_err,
    paint_3d_plain,
    stage_grouped2d,
    tsc_deposit_cells,
)
from abacusutils_tpu_torch.ops.power import (
    bin_power_modes,
    bin_power_modes_plain,
    get_W_compensated,
)
from abacusutils_tpu_torch.testing import edge_points
from torch_helpers import cuda_device, t  # noqa: F401

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize('nmesh,yb,box,offset', [(64, 32, 2000.0, 0.0), (128, 16, 77.0, 0.3)])
def test_deposit_kernel_matches_plain(cuda_device, nmesh, yb, box, offset):
    rng = np.random.default_rng(nmesh)
    n = 300_000
    pos = edge_points(n, nmesh, yb, box, rng)
    w = rng.random(n).astype(np.float32)
    w[::9] = 0.0
    cols = [t(pos[:, i]).to(cuda_device) for i in range(3)]
    wt = t(w).to(cuda_device)
    (x, y, z, ws), starts = stage_grouped2d(cols + [wt], nmesh, box, yb, offset)
    before = tsc_deposit_cells.launches
    grid = torch.zeros((nmesh,) * 3, device=cuda_device)
    got = tsc_deposit_cells(grid, x, y, z, ws, starts, nmesh, yb, box, offset)
    assert got is grid and tsc_deposit_cells.launches == before + 1
    ref = paint_3d_plain(torch.zeros_like(grid), *cols, wt, nmesh, box, offset)
    # float atomics sum in a run-dependent order: f32 round-off of the cell sums
    scale = float(ref.abs().max())
    npt.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), rtol=1e-5, atol=1e-6 * scale)


def test_binning_kernel_matches_plain(cuda_device):
    n1d, lbox, nbins = 64, 2000.0, 32
    seg, _ = tpipe.make_bin_plan_arrays(n1d, lbox, nbins, cuda_device)
    rng = np.random.default_rng(5)
    dk = torch.fft.rfftn(t(rng.normal(size=(n1d,) * 3).astype(np.float32)).to(cuda_device))
    W = t(get_W_compensated(lbox, n1d, 'TSC', False).astype(np.float32)).to(cuda_device)
    for Wc in (W, None):
        before = bin_power_modes.launches
        got = bin_power_modes(dk, seg, Wc, 1.0 / n1d**3, nbins)
        assert bin_power_modes.launches == before + 1
        ref = bin_power_modes_plain(dk, seg, Wc, 1.0 / n1d**3, nbins)
        # per-block f32 histograms, summed with f64 atomics in any order
        npt.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), rtol=1e-5)


def test_step_on_card_matches_cpu(cuda_device):
    """The kernel step on the card against the plain step on the CPU: the
    same n_gal, wsum at rtol 1e-4 (float atomics sum in a run-dependent
    order; the two devices' erfc may differ in the last bit, which could
    only flip a galaxy at an exact tie)."""
    lbox, nmesh, yb, nbins = 500.0, 32, 8, 16
    halo, part, params = tpipe.make_example_inputs(30_000, 120_000, lbox, seed=7)
    seg, _ = tpipe.make_bin_plan_arrays(nmesh, lbox, nbins, 'cpu')
    Wc = get_W_compensated(lbox, nmesh, 'TSC', False)

    def step(device, err=None):
        h, p, prm, sg, W = inputs_from_numpy(halo, part, params, seg.numpy(), Wc, device)
        h_g, s_h = tpipe.group_inputs2d_device(h, nmesh, lbox, yb)
        p_g, s_p = tpipe.group_inputs2d_device(p, nmesh, lbox, yb)
        return tpipe.hod_pk_fused_yb(
            h_g, p_g, prm, sg, W, lbox, 100.0, nmesh, yb, nbins, s_h, s_p, err=err
        )

    err = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    k1, k2 = tsc_deposit_cells.launches, bin_power_modes.launches
    wsum_g, n_gal_g = step(cuda_device, err)
    torch.cuda.synchronize()
    check_deposit_err(err)
    assert (tsc_deposit_cells.launches - k1, bin_power_modes.launches - k2) == (2, 1)
    wsum_c, n_gal_c = step('cpu')
    assert float(n_gal_g) == float(n_gal_c)
    npt.assert_allclose(wsum_g.cpu().numpy(), wsum_c.numpy(), rtol=1e-4)


def test_deposit_kernel_counts_misstaged_points(cuda_device):
    """Points staged with another offset than the deposit uses land outside
    their cell's tile: the kernel counts them instead of writing them, and
    the wrapper raises."""
    nmesh, yb, box = 64, 16, 100.0
    rng = np.random.default_rng(3)
    pos = (rng.random((50_000, 3)) * box).astype(np.float32)
    cols = [t(pos[:, i]).to(cuda_device) for i in range(3)]
    w = torch.ones(50_000, device=cuda_device)
    (x, y, z, ws), starts = stage_grouped2d(cols + [w], nmesh, box, yb, offset=0.0)
    grid = torch.zeros((nmesh,) * 3, device=cuda_device)
    with pytest.raises(RuntimeError, match='outside their staged cell'):
        tsc_deposit_cells(grid, x, y, z, ws, starts, nmesh, yb, box, offset=box / nmesh / 2)
