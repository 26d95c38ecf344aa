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
    axis_cloud,
    blocks_per_sm,
    brick_shape,
    overflow_count_plain,
    paint_3d_plain,
    paint_slab_plain,
    stage_bricks,
    tsc_deposit_cells,
)
from abacusutils_tpu_torch.convert import params_to_tensors, staged_state_from_numpy
from abacusutils_tpu_torch.models.hod import population as tpop
from abacusutils_tpu_torch.models.hod.population import prepare_tracer_params
from abacusutils_tpu_torch.ops.power import (
    bin_pair_modes,
    bin_pair_modes_plain,
    bin_power_modes,
    bin_power_modes_plain,
    field_pairs,
    get_W_compensated,
)
from abacusutils_tpu_torch.ops import power as tpow
from abacusutils_tpu_torch.ops import tpcf as ttpcf
from abacusutils_tpu_torch.testing import edge_points, edge_points_centred
from torch_helpers import (  # noqa: F401
    CODE_WANTS,
    K6_CATALOGS,
    gloo_mesh,
    TRACERS,
    catalog_tensors,
    code_catalogs,
    cuda_device,
    k6_catalog,
    k6_tensors,
    linked_inputs,
    staged_state,
    t,
)

pytestmark = pytest.mark.cuda


# the f32 machine epsilon, and the multiple of eps sqrt(n_c) S_c a cell of
# n_c summed terms may differ by (see _assert_grid)
F32_EPS = float(np.finfo(np.float32).eps)
LOAD_EPS = 4.0


def _cloud_load(x, y, z, w, nmesh, box):
    """Per cell, the number n_c of points whose 27-point cloud reaches it and
    the plain scatter S_c of |w|: the load of _assert_grid's bound."""
    ix, _ = axis_cloud(x, box, 0.0, nmesh)
    iy, _ = axis_cloud(y, box, 0.0, nmesh)
    iz, _ = axis_cloud(z, box, 0.0, nmesh)
    count = torch.zeros(nmesh**3, dtype=torch.float64, device=x.device)
    one = torch.ones_like(ix, dtype=torch.float64)
    for a in (-1, 0, 1):
        for b in (-1, 0, 1):
            for c in (-1, 0, 1):
                cell = ((ix + a) % nmesh * nmesh + (iy + b) % nmesh) * nmesh + (iz + c) % nmesh
                count.index_add_(0, cell, one)
    S = paint_3d_plain(torch.zeros((nmesh,) * 3, device=x.device), x, y, z, w.abs(), nmesh, box)
    return count.reshape((nmesh,) * 3), S


def _assert_grid(got, ref, load=None):
    """The deposit `got` against the plain scatter `ref`: K1's float atomics
    sum each cell in a run-dependent order, so each cell may differ by
    rtol 1e-5 of itself plus 1e-6 of the grid's largest cell, and where
    `load` = (n_c, S_c) is given (:func:`_cloud_load`) by a further
    LOAD_EPS x eps_f32 x sqrt(n_c) x S_c: the round-off of a sum of n_c
    terms of magnitude up to S_c taken in any order grows like sqrt(n_c)
    eps S_c. A cell of a few points gains next to nothing; a cell of 10^5
    points (test_deposit_kernel_splits_heavy_brick) gains ~1.5e-4 of
    itself."""
    scale = float(ref.abs().max())
    g, r = got.cpu().double().numpy(), ref.cpu().double().numpy()
    bound = 1e-5 * np.abs(r) + 1e-6 * scale
    if load is not None:
        n_c, S_c = (a.cpu().double().numpy() for a in load)
        bound = bound + LOAD_EPS * F32_EPS * np.sqrt(n_c) * S_c
    bad = np.abs(g - r) > bound
    assert not bad.any(), (f'{int(bad.sum())} cells off, worst excess '
                           f'{float((np.abs(g - r) - bound).max()):.3g}')


@pytest.mark.parametrize(
    'nmesh,box,offset', [(64, 2000.0, 0.0), (96, 77.0, 0.3), (550, 2000.0, 0.0), (45, 90.0, 0.0)]
)
def test_deposit_kernel_matches_plain(cuda_device, nmesh, box, offset):
    """K1 against the plain scatter on points placed on cell and brick
    edges and across the periodic wrap, at meshes of 16^3 bricks with and
    without a ragged last brick (96 = 6 x 16; 550 = 34 x 16 + 6; 45 =
    2 x 16 + 13), which the float4 (64, 96), float2 (550) and float (45)
    flush take; no point leaves its tile."""
    rng = np.random.default_rng(nmesh)
    n = 300_000
    pos = edge_points(n, nmesh, 16, box, rng)
    w = rng.random(n).astype(np.float32)
    w[::9] = 0.0
    cols = [t(pos[:, i]).to(cuda_device) for i in range(3)]
    wt = t(w).to(cuda_device)
    (x, y, z, ws), plan = stage_bricks(cols + [wt], nmesh, box, offset=offset)
    before = tsc_deposit_cells.launches
    grid = torch.zeros((nmesh,) * 3, device=cuda_device)
    overflow = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    got = tsc_deposit_cells(grid, x, y, z, ws, plan, box, offset, overflow)
    assert got is grid and tsc_deposit_cells.launches == before + 1
    assert int(overflow) == 0
    _assert_grid(got, paint_3d_plain(torch.zeros_like(grid), *cols, wt, nmesh, box, offset))


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

    def step(device, overflow):
        h, p, prm, sg, W = inputs_from_numpy(halo, part, params, seg.numpy(), Wc, device)
        h_g, plan_h = tpipe.group_inputs2d_device(h, nmesh, lbox, yb)
        p_g, plan_p = tpipe.group_inputs2d_device(p, nmesh, lbox, yb)
        return tpipe.hod_pk_fused_yb(
            h_g, p_g, prm, sg, W, lbox, 100.0, nmesh, yb, nbins, plan_h, plan_p,
            overflow=overflow,
        )

    over = [torch.zeros(1, dtype=torch.int32, device=d) for d in (cuda_device, 'cpu')]
    k1, k2 = tsc_deposit_cells.launches, bin_power_modes.launches
    wsum_g, n_gal_g = step(cuda_device, over[0])
    torch.cuda.synchronize()
    assert (tsc_deposit_cells.launches - k1, bin_power_modes.launches - k2) == (2, 1)
    wsum_c, n_gal_c = step('cpu', over[1])
    assert int(over[0]) == int(over[1])  # the kernel's count is the plain count
    assert float(n_gal_g) == float(n_gal_c)
    npt.assert_allclose(wsum_g.cpu().numpy(), wsum_c.numpy(), rtol=1e-4)


def test_deposit_kernel_counts_misstaged_points(cuda_device):
    """Points staged with another offset than the deposit uses may leave
    their brick's tile: the kernel deposits them straight into the grid and
    counts them in its overflow word, the plain count exactly."""
    nmesh, box = 64, 100.0
    rng = np.random.default_rng(3)
    pos = (rng.random((50_000, 3)) * box).astype(np.float32)
    cols = [t(pos[:, i]).to(cuda_device) for i in range(3)]
    w = torch.ones(50_000, device=cuda_device)
    (x, y, z, ws), plan = stage_bricks(cols + [w], nmesh, box, offset=0.0)
    grid = torch.zeros((nmesh,) * 3, device=cuda_device)
    overflow = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    off = box / nmesh / 2
    tsc_deposit_cells(grid, x, y, z, ws, plan, box, off, overflow)
    want = int(overflow_count_plain(x, y, z, ws, plan, box, off))
    assert int(overflow) == want > 0
    _assert_grid(grid, paint_3d_plain(torch.zeros_like(grid), x, y, z, ws, nmesh, box, off))


@pytest.mark.parametrize('kind', ['tsc', 'cic'])
def test_deposit_kernel_overflow_paths(cuda_device, kind):
    """Points displaced past their brick's margin after staging (up to 4
    cells on every axis, a margin of (1, 0, 2)), CIC points at negative
    coordinates and points on cell and brick edges: the grid is the plain
    scatter's and the overflow word the plain count."""
    nmesh, box = 96, 77.0
    rng = np.random.default_rng(21)
    n = 200_000
    pos = edge_points_centred(n, nmesh, 16, box, rng)
    if kind == 'tsc':
        pos = pos + np.float32(box / 2)
    w = rng.random(n).astype(np.float32)
    cols = [t(pos[:, i]).to(cuda_device) for i in range(3)] + [t(w).to(cuda_device)]
    margin = (1, 0, 2)
    (x, y, z, ws), plan = stage_bricks(cols, nmesh, box, brick_shape(nmesh, margin=margin),
                                       margin, kind=kind)
    h = box / nmesh
    move = torch.from_numpy((rng.uniform(-4, 4, (n, 3)) * h).astype(np.float32)).to(cuda_device)
    move[n // 2:] = 0.0
    x, y, z = x + move[:, 0], y + move[:, 1], z + move[:, 2]
    grid = torch.zeros((nmesh,) * 3, device=cuda_device)
    overflow = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    tsc_deposit_cells(grid, x, y, z, ws, plan, box, 0.0, overflow, kind)
    want = int(overflow_count_plain(x, y, z, ws, plan, box, 0.0, kind))
    assert int(overflow) == want > n // 10
    _assert_grid(grid, paint_3d_plain(torch.zeros_like(grid), x, y, z, ws, nmesh, box, 0.0, kind))


def test_deposit_kernel_splits_heavy_brick(cuda_device):
    """10^5 points in one cell, over a background of 10^5: the heavy brick
    is cut into several work items (several blocks add into the same grid
    cells) and the grid is the plain scatter's; the default brick's tile
    leaves room for at least four blocks an SM."""
    nmesh, box = 64, 100.0
    rng = np.random.default_rng(8)
    pos = (rng.random((200_000, 3)) * box).astype(np.float32)
    pos[:100_000] = np.float32([30.1, 55.2, 70.3]) + (
        rng.random((100_000, 3)) * 0.3 * box / nmesh).astype(np.float32)
    w = rng.random(200_000).astype(np.float32)
    cols = [t(pos[:, i]).to(cuda_device) for i in range(3)] + [t(w).to(cuda_device)]
    (x, y, z, ws), plan = stage_bricks(cols, nmesh, box)
    work = plan.work.cpu().numpy()
    heavy = work[(work[:, 2] > work[:, 1])][:, 0]
    assert np.bincount(heavy).max() >= 10
    grid = torch.zeros((nmesh,) * 3, device=cuda_device)
    tsc_deposit_cells(grid, x, y, z, ws, plan, box)
    _assert_grid(grid, paint_3d_plain(torch.zeros_like(grid), x, y, z, ws, nmesh, box),
                 _cloud_load(x, y, z, ws, nmesh, box))
    assert blocks_per_sm(plan) >= 4


@pytest.mark.parametrize('nfields', [1, 2, 3, 5])
@pytest.mark.parametrize('n1d', [48, 45])
def test_pair_binning_kernel_matches_plain(cuda_device, nfields, n1d):
    """K3 against its plain version, odd and even meshes, with and without
    the window: autos at rtol 1e-5, crosses at 1e-5 sqrt(P_ii P_jj) (per-block
    f32 histograms, summed with f64 atomics in any order)."""
    lbox, nbins = 700.0, n1d // 2
    seg, _ = tpipe.make_bin_plan_arrays(n1d, lbox, nbins, cuda_device)
    rng = np.random.default_rng(n1d + nfields)
    base = rng.normal(size=(n1d,) * 3).astype(np.float32)
    dks = [
        torch.fft.rfftn(t(base + 0.5 * rng.normal(size=base.shape).astype(np.float32))
                        .to(cuda_device))
        for _ in range(nfields)
    ]
    W = t(get_W_compensated(lbox, n1d, 'TSC', False).astype(np.float32)).to(cuda_device)
    npairs = nfields * (nfields + 1) // 2
    for Wc in (W, None):
        before = bin_pair_modes.launches
        got = bin_pair_modes(dks, seg, Wc, 1.0 / n1d**3, nbins)
        assert bin_pair_modes.launches == before + 1
        assert got.shape == (npairs, nbins) and got.dtype == torch.float64
        ref = bin_pair_modes_plain(dks, seg, Wc, 1.0 / n1d**3, nbins).cpu().numpy()
        got = got.cpu().numpy()
        pairs = field_pairs(nfields)
        auto = {i: ref[p] for p, (i, j) in enumerate(pairs) if i == j}
        for p, (i, j) in enumerate(pairs):
            if i == j:
                npt.assert_allclose(got[p], ref[p], rtol=1e-5)
            else:
                assert (np.abs(got[p] - ref[p]) <= 1e-5 * np.sqrt(auto[i] * auto[j])).all(), (i, j)


def _multi_inputs(device, seed=7):
    halo, part, _ = linked_inputs(30_000, 120_000, 500.0, seed=seed)
    tp = prepare_tracer_params(TRACERS, z=0.5)
    return catalog_tensors(halo, device), catalog_tensors(part, device), {
        k: params_to_tensors(v, device) for k, v in tp.items()
    }


def test_multi_step_on_card_matches_cpu(cuda_device):
    """hod_pk_fused_multi through K1 (two launches a tracer) and K3 (one)
    on the card against the same step from the plain versions on the CPU:
    equal n_gal, autos at rtol 1e-4, crosses at 1e-4 sqrt(P_ii P_jj)."""
    lbox, nmesh, yb, nbins = 500.0, 32, 8, 16
    want = ('LRG', 'ELG', 'QSO')
    out = {}
    for device in (cuda_device, torch.device('cpu')):
        halo, part, prm = _multi_inputs(device)
        h_g, p_g, s_h, s_p = tpipe.group_inputs2d_linked_device(halo, part, nmesh, lbox, yb)
        seg, _ = tpipe.make_bin_plan_arrays(nmesh, lbox, nbins, device)
        W = t(get_W_compensated(lbox, nmesh, 'TSC', False).astype(np.float32)).to(device)
        k1, k3 = tsc_deposit_cells.launches, bin_pair_modes.launches
        out[device.type] = tpipe.hod_pk_fused_multi(
            h_g, p_g, prm, seg, W, lbox, 100.0, want, nmesh, yb, nbins, s_h, s_p
        )
        if device.type == 'cuda':
            torch.cuda.synchronize()
            assert (tsc_deposit_cells.launches - k1, bin_pair_modes.launches - k3) == (6, 1)
    _assert_card_spectra(out['cuda'], out['cpu'], want)


def _assert_card_spectra(card, cpu, want):
    (sg, ng), (sc, nc) = card, cpu
    for tr in want:
        assert float(ng[tr]) == float(nc[tr]) > 0, tr
    for (t1, t2), v in sg.items():
        g, r = v.cpu().numpy(), sc[(t1, t2)].numpy()
        if t1 == t2:
            npt.assert_allclose(g, r, rtol=1e-4)
        else:
            scale = np.sqrt(np.abs(sc[(t1, t1)].numpy() * sc[(t2, t2)].numpy()))
            assert (np.abs(g - r) <= 1e-4 * scale).all(), (t1, t2)


@pytest.mark.parametrize('lc', [False, True])
def test_abacus_hod_on_card_matches_cpu(cuda_device, lc):
    """AbacusHOD.run_hod_pk_fused on the card against the same object on
    the CPU (plain versions), box leg and light-cone leg (galaxies displaced
    past the box edge, so K1 and the staging key each wrap them once):
    equal keys, modes and n_gal, spectra within 1e-4 as above."""
    state = staged_state(30_000, 120_000, 500.0, seed=31)
    params = {'z': 0.5, 'Lbox': 500.0, 'velz2kms': 100.0,
              'origin': np.array([-260.0, -260.0, -260.0]) if lc else None}
    flags = dict(want_shear=True, want_ranks=True, halo_lc=lc)
    tracers = {k: dict(v, Acent=0.05, s=0.3) for k, v in TRACERS.items()}
    res = {}
    for device in (cuda_device, 'cpu'):
        hod = staged_state_from_numpy(*state, params, tracers, flags, device)
        k1, k3 = tsc_deposit_cells.launches, bin_pair_modes.launches
        res[str(device)] = hod.run_hod_pk_fused(nmesh=32, nbins_k=16)
        if device != 'cpu':
            assert tsc_deposit_cells.launches - k1 == 6
            assert bin_pair_modes.launches - k3 == 1
            assert int(hod.deposit_overflow) == 0
    (cg, ng), (cc, nc) = res[str(cuda_device)], res['cpu']
    assert set(cg) == set(cc) and ng == nc
    for key in cc:
        if key.endswith('_modes') or key == 'k_binc':
            npt.assert_array_equal(cg[key], cc[key])
    want = list(ng)
    spectra = {}
    for i, t1 in enumerate(want):
        for t2 in want[i:]:
            spectra[(t1, t2)] = (cg[f'{t1}_{t2}'], cc[f'{t1}_{t2}'])
    for (t1, t2), (g, r) in spectra.items():
        if t1 == t2:
            npt.assert_allclose(g, r, rtol=1e-4)
        else:
            scale = np.sqrt(np.abs(cc[f'{t1}_{t1}'] * cc[f'{t2}_{t2}']))
            assert (np.abs(g - r) <= 1e-4 * scale).all(), (t1, t2)


def _pole_case(device, n1d, nmu, poles, nf, seed):
    lbox, nk = 700.0, n1d // 4
    ke, me = tpow.get_k_mu_edges(lbox, np.pi * n1d / lbox, nk, nmu, False)
    dk = 2 * np.pi / lbox
    plan = tpow.get_mode_bin_plan(
        n1d, ((ke / dk) ** 2).astype(np.float32), (me**2).astype(np.float32), poles, device
    )
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(n1d,) * 3).astype(np.float32)
    dks = [
        torch.fft.rfftn(t(base + 0.5 * rng.normal(size=base.shape).astype(np.float32)).to(device))
        for _ in range(nf)
    ]
    W = t(get_W_compensated(lbox, n1d, 'TSC', False).astype(np.float32)).to(device)
    pole_w = {p: plan.pole_w[p] for p in poles if p}
    return plan, dks, W, pole_w


@pytest.mark.parametrize('nmu', [1, 4])
@pytest.mark.parametrize('nfields', [1, 2, 3])
def test_pair_binning_pole_rows_match_plain(cuda_device, nfields, nmu):
    """K3 with pole rows, poles (0, 1, 2, 4), against its plain version (which
    reads the plan's pole weights where the kernel evaluates them in
    registers): the (k, mu) rows at rtol 1e-5 (autos) or 1e-5 sqrt(P_ii
    P_jj) (crosses), each pole row within 1e-5 (2l+1) sqrt(A_i A_j), A the
    auto sums of the k bin."""
    n1d = 48
    plan, dks, W, pole_w = _pole_case(cuda_device, n1d, nmu, (0, 1, 2, 4), nfields, nfields + nmu)
    nbins = plan.nk * nmu
    before = bin_pair_modes.launches
    got, gotp = bin_pair_modes(dks, plan.seg, W, 1.0 / n1d**3, nbins, pole_w, nmu)
    assert bin_pair_modes.launches == before + 1
    ref, refp = bin_pair_modes_plain(dks, plan.seg, W, 1.0 / n1d**3, nbins, pole_w, nmu)
    got, gotp, ref, refp = (a.cpu().numpy() for a in (got, gotp, ref, refp))
    pairs = field_pairs(nfields)
    auto = {i: ref[p] for p, (i, j) in enumerate(pairs) if i == j}
    for p, (i, j) in enumerate(pairs):
        scale = np.sqrt(auto[i] * auto[j])
        assert (np.abs(got[p] - ref[p]) <= 1e-5 * scale).all(), (i, j)
        kscale = np.sqrt(auto[i].reshape(-1, nmu).sum(1) * auto[j].reshape(-1, nmu).sum(1))
        for q, ell in enumerate(pole_w):
            err = np.abs(gotp[p, q] - refp[p, q])
            assert (err <= 1e-5 * (2 * ell + 1) * kscale).all(), (i, j, ell)


def test_pair_binning_no_pole_form_unchanged(cuda_device):
    """The no-pole K3 (the form run_hod_pk_fused launches) gives what the
    pole form gives in its (k, mu) rows, and its plain version's sums at
    the tolerance it always had."""
    n1d = 64
    plan, dks, W, pole_w = _pole_case(cuda_device, n1d, 1, (0, 2, 4), 3, 9)
    nbins = plan.nk
    plain = bin_pair_modes(dks, plan.seg, W, 1.0 / n1d**3, nbins)
    with_poles, _ = bin_pair_modes(dks, plan.seg, W, 1.0 / n1d**3, nbins, pole_w, 1)
    ref = bin_pair_modes_plain(dks, plan.seg, W, 1.0 / n1d**3, nbins).cpu().numpy()
    plain, with_poles = plain.cpu().numpy(), with_poles.cpu().numpy()
    pairs = field_pairs(3)
    auto = {i: ref[p] for p, (i, j) in enumerate(pairs) if i == j}
    for p, (i, j) in enumerate(pairs):
        scale = np.sqrt(auto[i] * auto[j])
        assert (np.abs(plain[p] - ref[p]) <= 1e-5 * scale).all(), (i, j)
        assert (np.abs(plain[p] - with_poles[p]) <= 1e-6 * scale).all(), (i, j)


@pytest.mark.parametrize('layout', ['strided', 'mixed'])
def test_pair_binning_reads_field_strides(cuda_device, layout):
    """K3 reads its fields through their strides: fields that all share a
    non-C layout (read in place) and fields of mixed layouts (copied) give
    the sums of the C-contiguous fields."""
    n1d = 32
    plan, dks, W, pole_w = _pole_case(cuda_device, n1d, 4, (0, 2), 3, 5)
    dks = [d.contiguous() for d in dks]
    # the same values with the x axis fastest in memory
    strided = [d.permute(2, 1, 0).contiguous().permute(2, 1, 0) for d in dks]
    if layout == 'mixed':
        strided[0] = dks[0]
    assert not strided[1].is_contiguous()
    args = (plan.seg, W, 1.0 / n1d**3, plan.nk * 4, pole_w, 4)
    ref, refp = bin_pair_modes_plain(dks, *args)
    got, gotp = bin_pair_modes(strided, *args)
    for a, b in ((got, ref), (gotp, refp)):
        a, b = a.cpu().numpy(), b.cpu().numpy()
        assert (np.abs(a - b) <= 1e-5 * np.abs(b).max(axis=-1, keepdims=True)).all()


@pytest.mark.parametrize('offset', [0.0, 0.5 * 77.0 / 128])
def test_cic_deposit_kernel_matches_plain(cuda_device, offset):
    """K1 with the CIC kind against paint_3d_plain(kind='cic') on box-centred
    points placed on cell and brick edges at negative and positive
    coordinates and past the box edge, with overflow word 0."""
    nmesh, box = 128, 77.0
    rng = np.random.default_rng(11)
    n = 300_000
    pos = edge_points_centred(n, nmesh, 16, box, rng)
    w = rng.random(n).astype(np.float32)
    w[::7] = 0.0
    cols = [t(pos[:, i]).to(cuda_device) for i in range(3)]
    wt = t(w).to(cuda_device)
    (x, y, z, ws), plan = stage_bricks(cols + [wt], nmesh, box, offset=offset, kind='cic')
    overflow = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    grid = torch.zeros((nmesh,) * 3, device=cuda_device)
    tsc_deposit_cells(grid, x, y, z, ws, plan, box, offset, overflow, kind='cic')
    torch.cuda.synchronize()
    assert int(overflow.item()) == 0
    _assert_grid(grid, paint_3d_plain(torch.zeros_like(grid), *cols, wt, nmesh, box, offset,
                                      'cic'))


def test_device_plan_at_550_matches_numpy(cuda_device):
    """The plan built on the card at compute_power's default mesh (550^3,
    83.5 million modes, 128 k-bins to k = 0.5 h/Mpc in a 2000 Mpc/h box)
    is bit-equal to the numpy host build: seg and counts."""
    n1d, lbox = 550, 2000.0
    ke, me = tpow.get_k_mu_edges(lbox, 0.5, 128, 1, False)
    dk = 2 * np.pi / lbox
    ke2, me2 = ((ke / dk) ** 2).astype(np.float32), (me**2).astype(np.float32)
    seg, counts, ksum, pole_w = tpow.mode_bin_plan_device(n1d, ke2, me2, (0, 2, 4), cuda_device)
    assert seg.device.type == 'cuda' and set(pole_w) == {2, 4}
    seg_np, counts_np = tpow.mode_bin_plan(n1d, ke2, me2)
    npt.assert_array_equal(seg.cpu().numpy(), seg_np)
    npt.assert_array_equal(counts.cpu().numpy(), counts_np)


# ---- the binning kernel's row spans, runs, flush and forms ------------------


def _span_plan(device, n1d, nk, nmu, poles, kmin_frac=0.1, kmax_frac=0.8, lbox=700.0):
    """A plan whose k-bins run from kmin_frac to kmax_frac of the Nyquist
    frequency, so rows and parts of rows hold no in-bin mode."""
    kny = np.pi * n1d / lbox
    ke = np.linspace(kmin_frac * kny, kmax_frac * kny, nk + 1)
    me = np.linspace(0.0, 1.0, nmu + 1)
    dk = 2 * np.pi / lbox
    return tpow.get_mode_bin_plan(n1d, ((ke / dk) ** 2).astype(np.float32),
                                  (me**2).astype(np.float32), poles, device)


def _card_fields(device, n1d, nf, seed):
    """nf correlated rfft meshes made on the card (cuFFT's strided layout)."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(n1d,) * 3).astype(np.float32)
    return [torch.fft.rfftn(t(base + 0.5 * rng.normal(size=base.shape).astype(np.float32))
                            .to(device)) for _ in range(nf)]


def _outside_spans(spans, n1d):
    """A flat bool mask of the modes outside the row spans."""
    kz = torch.arange(n1d // 2 + 1, dtype=torch.int32, device=spans.bounds.device)
    b = spans.bounds
    return ~((kz[None, :] >= b[:, :1]) & (kz[None, :] < b[:, 1:])).reshape(-1)


def _assert_pair_sums(got, ref, nfields, nmu=1, pole_degrees=(), tol=1e-5):
    """Autos at rtol tol, crosses within tol sqrt(P_ii P_jj); pole rows
    within tol (2l+1) sqrt(A_i A_j), A the auto sums of the k bin."""
    if pole_degrees:
        (got, gotp), (ref, refp) = got, ref
        gotp, refp = gotp.cpu().numpy(), refp.cpu().numpy()
    got, ref = got.cpu().numpy().reshape(-1, ref.shape[-1]), ref.cpu().numpy().reshape(
        -1, ref.shape[-1])
    pairs = field_pairs(nfields)
    auto = {i: ref[p] for p, (i, j) in enumerate(pairs) if i == j}
    for p, (i, j) in enumerate(pairs):
        scale = np.sqrt(np.abs(auto[i] * auto[j]))
        assert (np.abs(got[p] - ref[p]) <= tol * scale).all(), (i, j)
        kscale = np.sqrt(np.abs(auto[i].reshape(-1, nmu).sum(1) * auto[j].reshape(-1, nmu).sum(1)))
        for q, ell in enumerate(pole_degrees):
            err = np.abs(gotp[p, q] - refp[p, q])
            assert (err <= tol * (2 * ell + 1) * kscale).all(), (i, j, ell)


@pytest.mark.parametrize('form', ['power', 'pairs with poles'])
def test_binning_kernel_skips_modes_outside_spans(cuda_device, form):
    """Poison: every mode outside the plan's row spans is moved into bin 0 in
    the plan's own seg. The kernel reads only in-span modes, so its sums do
    not change by a bit, while the plain version over the poisoned seg does
    change; no span is built for the plan's seg."""
    n1d, poles = 40, ((0, 2, 4) if form != 'power' else ())
    plan = _span_plan(cuda_device, n1d, 10, 1, poles, kmin_frac=0.25, kmax_frac=0.75)
    nbins = plan.nk
    dks = _card_fields(cuda_device, n1d, 1 if form == 'power' else 3, seed=17)
    W = t(get_W_compensated(700.0, n1d, 'TSC', False).astype(np.float32)).to(cuda_device)
    pole_w = {p: plan.pole_w[p] for p in poles if p} or None

    def kernel():
        if form == 'power':
            return bin_power_modes(dks[0], plan.seg, W, 1.0 / n1d**3, nbins)
        out = bin_pair_modes(dks, plan.seg, W, 1.0 / n1d**3, nbins, pole_w, 1)
        return torch.cat([a.reshape(6, -1) for a in out], 1)

    def plain():
        if form == 'power':
            return bin_power_modes_plain(dks[0], plan.seg, W, 1.0 / n1d**3, nbins)
        out = bin_pair_modes_plain(dks, plan.seg, W, 1.0 / n1d**3, nbins, pole_w, 1)
        return torch.cat([a.reshape(6, -1) for a in out], 1)

    builds = tpow.mode_spans.builds
    clean, clean_plain = kernel(), plain()
    outside = _outside_spans(plan.spans, n1d)
    assert 0 < int(outside.sum()) < outside.numel()
    keep = plan.seg.clone()
    try:
        plan.seg[outside] = 0
        poisoned, poisoned_plain = kernel(), plain()
        torch.cuda.synchronize()
    finally:
        plan.seg.copy_(keep)
    assert torch.equal(poisoned, clean)
    assert not torch.allclose(poisoned_plain, clean_plain, rtol=1e-3)
    assert tpow.mode_spans.builds == builds


@pytest.mark.parametrize('nfields', [1, 3])
@pytest.mark.parametrize('runs', ['longest', 'shortest'])
def test_binning_kernel_longest_and_shortest_runs(cuda_device, runs, nfields):
    """The longest runs (every in-span mode in bin 0: one run a row) and the
    shortest (a bin per integer |k|^2 shell: a new bin at every kz) against
    the plain version."""
    n1d = 32
    kzlen = n1d // 2 + 1
    i = np.arange(n1d)
    i2 = np.where(i < n1d // 2, i, i - n1d) ** 2
    k2 = (i2[:, None, None] + i2[None, :, None] + np.arange(kzlen)[None, None, :] ** 2).reshape(-1)
    nbins = (n1d // 2) ** 2
    if runs == 'longest':
        seg = np.where(k2 < nbins, 0, nbins)
    else:
        seg = np.where(k2 < nbins, k2, nbins)
    seg = t(seg.astype(np.int32)).to(cuda_device)
    dks = _card_fields(cuda_device, n1d, nfields, seed=nfields)
    if nfields == 1:
        got = bin_power_modes(dks[0], seg, None, 1.0 / n1d**3, nbins)
        ref = bin_power_modes_plain(dks[0], seg, None, 1.0 / n1d**3, nbins)
        npt.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), rtol=1e-5)
    else:
        got = bin_pair_modes(dks, seg, None, 1.0 / n1d**3, nbins)
        ref = bin_pair_modes_plain(dks, seg, None, 1.0 / n1d**3, nbins)
        _assert_pair_sums(got, ref, nfields)


def test_power_binning_reads_strided_rfftn_without_copy(cuda_device):
    """K2 on cuFFT's rfftn output, which is not C-contiguous: the result is
    the plain version's, and the call allocates nothing near the size of the
    mesh (it reads the field through its strides)."""
    n1d, lbox, nbins = 128, 2000.0, 64
    seg, _ = tpipe.make_bin_plan_arrays(n1d, lbox, nbins, cuda_device)
    (dk,) = _card_fields(cuda_device, n1d, 1, seed=3)
    assert not dk.is_contiguous()
    W = t(get_W_compensated(lbox, n1d, 'TSC', False).astype(np.float32)).to(cuda_device)
    bin_power_modes(dk, seg, W, 1.0 / n1d**3, nbins)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got = bin_power_modes(dk, seg, W, 1.0 / n1d**3, nbins)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    assert extra < dk.numel() * dk.element_size() // 8, extra
    ref = bin_power_modes_plain(dk, seg, W, 1.0 / n1d**3, nbins)
    npt.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), rtol=1e-5)


@pytest.mark.parametrize('form', ['power', 'pairs', 'pairs with poles, nmu 4'])
def test_binning_launches_are_bit_identical(cuda_device, form):
    """Two launches on the same inputs give the same bits: per-warp
    histograms, no atomics, partials summed in a fixed order."""
    n1d = 64
    nmu, poles = (4, (0, 2, 4)) if 'poles' in form else (1, ())
    plan = _span_plan(cuda_device, n1d, 16, nmu, poles, kmin_frac=0.0, kmax_frac=1.0)
    nbins = plan.nk * plan.nmu
    dks = _card_fields(cuda_device, n1d, 1 if form == 'power' else 3, seed=5)
    pole_w = {p: plan.pole_w[p] for p in poles if p} or None
    if form == 'power':
        a, b = (bin_power_modes(dks[0], plan.seg, None, 1.0, nbins) for _ in range(2))
        assert torch.equal(a, b)
    else:
        a, b = (bin_pair_modes(dks, plan.seg, None, 1.0, nbins, pole_w, nmu) for _ in range(2))
        for x, y in zip(a if pole_w else [a], b if pole_w else [b]):
            assert torch.equal(x, y)


@pytest.mark.parametrize('npoles', [0, 1, 2, 3, 4])
@pytest.mark.parametrize('nfields', [1, 2, 3, 4, 5, 6, 7, 8])
def test_binning_kernel_forms(cuda_device, nfields, npoles):
    """Every instance, T = 1..8 fields and NP = 0..4 pole rows, against the
    plain version, on odd and even meshes, with and without the window, on a
    plan with empty rows (k-bins from 0.2 to 0.7 of Nyquist)."""
    n1d = 21 if (nfields + npoles) % 2 else 24
    degrees = (2, 4, 1, 8)[:npoles]
    nmu = 2 if npoles else 1
    plan = _span_plan(cuda_device, n1d, 6, nmu, (0,) + degrees, kmin_frac=0.2, kmax_frac=0.7)
    assert int((plan.spans.bounds[:, 1] == 0).sum()) > 0
    nbins = plan.nk * plan.nmu
    dks = _card_fields(cuda_device, n1d, nfields, seed=10 * nfields + npoles)
    W = None
    if nfields % 2:
        W = t(get_W_compensated(700.0, n1d, 'TSC', False).astype(np.float32)).to(cuda_device)
    pole_w = {p: plan.pole_w[p] for p in degrees} or None
    before = bin_pair_modes.launches
    got = bin_pair_modes(dks, plan.seg, W, 1.0 / n1d**3, nbins, pole_w, nmu)
    assert bin_pair_modes.launches == before + 1
    ref = bin_pair_modes_plain(dks, plan.seg, W, 1.0 / n1d**3, nbins, pole_w, nmu)
    _assert_pair_sums(got, ref, nfields, nmu, degrees)


# ---- the pair-count kernels -------------------------------------------------

PAIR_EDGES = np.logspace(-1, np.log10(30.0), 9)
PAIR_EDGES0 = np.concatenate([[0.0], PAIR_EDGES[1:]])


def _clustered(n, lbox, seed, device):
    """Half the points in 40 Gaussian clumps (sigma 5), half uniform, with
    coincident distinct points and points on the box faces."""
    rng = np.random.default_rng(seed)
    cen = rng.random((40, 3)) * lbox
    half = n // 2
    pos = np.concatenate([
        (cen[rng.integers(0, 40, half)] + rng.normal(0, 5, (half, 3))) % lbox,
        rng.random((n - half, 3)) * lbox,
    ]).astype(np.float32)
    pos[:40] = pos[40:80]
    pos[80:120, 0] = 0.0
    pos[120:160, 2] = np.nextafter(np.float32(lbox), np.float32(0))
    return [t(np.mod(pos[:, i], np.float32(lbox))).to(device) for i in range(3)]


def _pair_modes():
    return [('rppi', 30, 30.0), ('smu', 20, 20.0)]


@pytest.mark.parametrize('cross', [False, True], ids=['auto', 'cross'])
@pytest.mark.parametrize('lbox,nc', [(95.0, 3), (125.0, 4), (160.0, 5), (400.0, 13)])
def test_cell_pair_kernel_equals_plain(cuda_device, lbox, nc, cross):
    """K4 against its plain version, every bin equal, in both modes: grids
    of 3 and 4 cells a side (the per-pair round) and of 5 and 13 (the
    item-constant wrap), edges that start at 0 (the pair i == j is skipped
    by index), cells cut into several work items; two launches agree."""
    cols = _clustered(60_000, lbox, nc, cuda_device)
    s1 = ttpcf.stage_cells(*cols, lbox, nc)
    s2 = ttpcf.stage_cells(*_clustered(25_000, lbox, nc + 50, cuda_device), lbox, nc) if cross \
        else None
    assert s1.nc == int(lbox // 30) == nc and s1.max_occ > ttpcf.CHUNK
    _check_k4(s1, s2, PAIR_EDGES0)


def _check_k4(s1, s2, edges):
    thr = ttpcf.edges_f32(edges**2)
    for mode, nb2, aux in _pair_modes():
        before = ttpcf.count_pairs_cells.launches, ttpcf.count_pairs_cells.launches_by_form[mode]
        got = ttpcf.count_pairs_cells(s1, s2, thr, nb2, mode, aux)
        assert ttpcf.count_pairs_cells.launches == before[0] + 1
        assert ttpcf.count_pairs_cells.launches_by_form[mode] == before[1] + 1
        assert got.dtype == torch.int64 and got.shape == ((len(edges) - 1) * nb2,)
        assert int(got.sum()) > 0
        ref = ttpcf.count_pairs_cells_plain(s1, s2, thr, nb2, mode, aux, max_pairs=1 << 24)
        assert torch.equal(got, ref), (mode, int((got != ref).sum()))
        assert torch.equal(got, ttpcf.count_pairs_cells(s1, s2, thr, nb2, mode, aux))


@pytest.mark.parametrize('cross', [False, True], ids=['auto', 'cross'])
@pytest.mark.parametrize('shape', ['cells of rmax/2', 'reach of 3 cells along z, items of 3 cells',
                                   '2 reach + 1 cells a side', 'full cells beside empty ones',
                                   'items at the box faces', 'points on cell edges and on lbox',
                                   'edges too fine for the bin table'])
def test_cell_pair_kernel_on_fine_grids(cuda_device, shape, cross):
    """K4 against its plain version at the shapes a grid finer than rmax
    brings: a reach of 2 cells with pruned rows, 3 x 3 rows that reach 3
    cells along z (a walk of over 25 rows is refused), a grid of exactly
    2 reach + 1 cells (the per-pair round; one cell less is refused), a
    clump far over 64 points a cell in an almost empty box, items whose reach
    wraps around a face, positions on cell edges and on lbox itself, and 20
    linear bins, which the one general instance a mode bins by comparing
    against every edge (auto: the index test; cross: no pair skipped)."""
    lbox, edges = 400.0, PAIR_EDGES0
    nc, span, seed = 26, 2, 31
    cols = None
    if shape == 'reach of 3 cells along z, items of 3 cells':
        nc, span = 39, 3
        st = ttpcf.stage_cells(*_clustered(5_000, lbox, 1, cuda_device), lbox, nc, span)
        with pytest.raises(ValueError, match="exceeds the kernel's 25"):
            ttpcf.count_pairs_cells(st, st, ttpcf.edges_f32(edges**2), 20, 'smu', 20.0)
        edges = np.concatenate([[0.0], np.logspace(-1, 1, 9)[1:]])  # rp, s < 10 = one cell
        walk = ttpcf.walk_rows(nc, lbox, float(ttpcf.edges_f32(edges**2)[-1]), 30, 'rppi', False)
        assert walk.reach_z == 3 and len(walk.rows) == 9
    elif shape == '2 reach + 1 cells a side':
        lbox, nc, span = 125.0, 5, 1
        st = ttpcf.stage_cells(*_clustered(5_000, lbox, 1, cuda_device), lbox, 4, 1)
        with pytest.raises(ValueError, match='visited twice'):
            ttpcf.count_pairs_cells(st, None, ttpcf.edges_f32([0.0, 40.0**2]), 30, 'rppi')
    elif shape == 'full cells beside empty ones':
        rng = np.random.default_rng(5)
        pos = np.concatenate([rng.normal(200.0, 3.0, (6_000, 3)), rng.random((500, 3)) * lbox])
        cols = [t(np.mod(pos[:, i], lbox).astype(np.float32)).to(cuda_device) for i in range(3)]
    elif shape == 'items at the box faces':
        cols = _clustered(30_000, lbox, 32, cuda_device)
        cols[2] = torch.where(cols[2] < 200.0, cols[2] * 0.1, 400.0 - (400.0 - cols[2]) * 0.1)
        span = 3
    elif shape == 'points on cell edges and on lbox':
        cell = lbox / nc
        cols = [torch.remainder(torch.round(c / cell) * cell, np.float32(lbox))
                for c in _clustered(30_000, lbox, 33, cuda_device)]
    elif shape == 'edges too fine for the bin table':
        edges = np.concatenate([[0.0, 1e-3, 1.001e-3], np.linspace(1.0, 30.0, 18)])
        assert ttpcf.bin_lut(ttpcf.edges_f32(edges**2)) is None
    if cols is None:
        cols = _clustered(30_000, lbox, seed, cuda_device)
    s1 = ttpcf.stage_cells(*cols, lbox, nc, span)
    s2 = ttpcf.stage_cells(*_clustered(12_000, lbox, seed + 50, cuda_device), lbox, nc, span) \
        if cross else None
    if shape == 'full cells beside empty ones':
        assert s1.max_occ > 4 * ttpcf.CHUNK
    _check_k4(s1, s2, edges)


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64], ids=['f32', 'f64'])
@pytest.mark.parametrize('cross', [False, True], ids=['auto', 'cross'])
def test_all_pairs_kernel_equals_plain(cuda_device, dtype, cross):
    """K5 against its plain version, every bin equal, in both modes and both
    types, on positions that are not wrapped into the box (the per-pair
    minimum image takes them as they are); two launches agree."""
    lbox = 400.0
    cols = [c.to(dtype) - 0.5 * lbox for c in _clustered(12_000, lbox, 3, cuda_device)]
    cols2 = [c.to(dtype) for c in _clustered(5_000, lbox, 4, cuda_device)] if cross else None
    e2 = PAIR_EDGES0**2
    thr = ttpcf.edges_f32(e2) if dtype == torch.float32 else e2
    for mode, nb2, aux in _pair_modes():
        before = ttpcf.count_pairs_all.launches
        got = ttpcf.count_pairs_all(cols, cols2, thr, nb2, mode, lbox, aux)
        assert ttpcf.count_pairs_all.launches == before + 1
        ref = ttpcf.count_pairs_all_plain(cols, cols2, thr, nb2, mode, lbox, aux,
                                          max_pairs=1 << 24)
        assert int(got.sum()) > 0 and torch.equal(got, ref), (mode, int((got != ref).sum()))
        assert torch.equal(got, ttpcf.count_pairs_all(cols, cols2, thr, nb2, mode, lbox, aux))


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64], ids=['f32', 'f64'])
@pytest.mark.parametrize('periods', ['one', 'several'])
def test_all_pairs_kernel_round_forms(cuda_device, dtype, periods):
    """K5 takes the round of d / lbox from two compares where both sets lie
    within one period, and from the division where they do not; both equal
    the plain version, which always divides."""
    lbox = 400.0
    cols = [c.to(dtype) for c in _clustered(9_000, lbox, 6, cuda_device)]
    cols2 = [c.to(dtype) - 100.0 for c in _clustered(4_000, lbox, 7, cuda_device)]
    if periods == 'several':
        gen = torch.Generator(device=cuda_device).manual_seed(3)
        cols = [c + lbox * torch.randint(-3, 4, c.shape, generator=gen, device=cuda_device)
                for c in cols]
    e2 = PAIR_EDGES0**2
    thr = ttpcf.edges_f32(e2) if dtype == torch.float32 else e2
    for other in (None, cols2):
        for mode, nb2, aux in _pair_modes():
            before = ttpcf.count_pairs_all.launches, ttpcf.count_pairs_all.launches_one_period
            got = ttpcf.count_pairs_all(cols, other, thr, nb2, mode, lbox, aux)
            assert ttpcf.count_pairs_all.launches == before[0] + 1
            assert ttpcf.count_pairs_all.launches_one_period - before[1] == (periods == 'one')
            ref = ttpcf.count_pairs_all_plain(cols, other, thr, nb2, mode, lbox, aux,
                                              max_pairs=1 << 24)
            assert int(got.sum()) > 0 and torch.equal(got, ref), (mode, int((got != ref).sum()))
    ttpcf._span_cache.clear()


def test_pair_engines_agree_and_self_pairs_are_skipped(cuda_device):
    """On one wrapped catalog K4 and K5 count alike, and both equal the
    plain counts on the CPU; with a first edge of 0 the n pairs i == j stay
    out while the coincident distinct points count (both orders)."""
    lbox = 400.0
    cols = _clustered(20_000, lbox, 9, cuda_device)
    stage = ttpcf.stage_cells(*cols, lbox, 13)
    cpu = [c.cpu() for c in cols]
    thr = ttpcf.edges_f32(PAIR_EDGES0**2)
    for mode, nb2, aux in _pair_modes():
        k4 = ttpcf.count_pairs_cells(stage, None, thr, nb2, mode, aux)
        k5 = ttpcf.count_pairs_all(cols, None, thr, nb2, mode, lbox, aux)
        assert torch.equal(k4, k5), mode
        assert torch.equal(k5.cpu(), ttpcf.count_pairs_all_plain(cpu, None, thr, nb2, mode, lbox,
                                                                 aux))
        assert 80 <= int(k4[0]) < 20_000


def test_pair_counts_entry_points_on_card(cuda_device):
    """pair_counts_rppi / pair_counts_smu from host data with no device named
    run on the card: the cell engine from _CELL_MIN_N points on (one K4
    launch a call, the stage of a tensor input cached, on the finer grid its
    density allows), the all-pairs engine below, the two equal, and the
    half walk of an autocorrelation equal to the full walk on a clone."""
    lbox = 700.0
    cols = _clustered(250_000, lbox, 21, cuda_device)
    host = np.stack([c.cpu().numpy() for c in cols], 1)
    assert ttpcf.cell_grid(lbox, 30.0, 250_000) == (46, 2)
    ttpcf._stage_cache.clear()
    k4, k5, builds = (ttpcf.count_pairs_cells.launches, ttpcf.count_pairs_all.launches,
                      ttpcf.stage_cells.builds)
    by_form = dict(ttpcf.count_pairs_cells.launches_by_form)
    auto = ttpcf.pair_counts_rppi(tuple(cols), PAIR_EDGES, 30, lbox)
    smu = ttpcf.pair_counts_smu(tuple(cols), PAIR_EDGES, 20, lbox)
    assert (ttpcf.count_pairs_cells.launches - k4, ttpcf.count_pairs_all.launches - k5,
            ttpcf.stage_cells.builds - builds) == (2, 0, 1)
    assert {m: n - by_form[m] for m, n in ttpcf.count_pairs_cells.launches_by_form.items()} == {
        'rppi': 1, 'smu': 1}
    assert ttpcf._stage_cache[0][1] == (lbox, 46, 4)
    npt.assert_array_equal(auto, ttpcf.pair_counts_rppi(host, PAIR_EDGES, 30, lbox))
    clone = tuple(c.clone() for c in cols)
    npt.assert_array_equal(auto, ttpcf.pair_counts_rppi(tuple(cols), PAIR_EDGES, 30, lbox,
                                                        pos2=clone))
    assert auto.dtype == np.int64 and auto.shape == (8, 30) and smu.shape == (8, 20)
    few = host[: ttpcf._CELL_MIN_N - 1]
    k4, k5 = ttpcf.count_pairs_cells.launches, ttpcf.count_pairs_all.launches
    small = ttpcf.pair_counts_smu(few, PAIR_EDGES, 20, lbox)
    assert (ttpcf.count_pairs_cells.launches - k4, ttpcf.count_pairs_all.launches - k5) == (0, 1)
    npt.assert_array_equal(small, ttpcf.pair_counts_smu(few, PAIR_EDGES, 20, lbox, method='cell'))
    more = host[: ttpcf._CELL_MIN_N]
    k4, k5 = ttpcf.count_pairs_cells.launches, ttpcf.count_pairs_all.launches
    cells = ttpcf.pair_counts_smu(more, PAIR_EDGES, 20, lbox)
    assert (ttpcf.count_pairs_cells.launches - k4, ttpcf.count_pairs_all.launches - k5) == (1, 0)
    npt.assert_array_equal(cells, ttpcf.pair_counts_smu(more, PAIR_EDGES, 20, lbox, method='tile'))
    ttpcf._stage_cache.clear()


# ---------------------------------------------------------------------------
# prepare_sim: K6, K7 and the engines around them
# ---------------------------------------------------------------------------


def _rank_slab(sizes, seed):
    """Halos of the given particle counts, each a Gaussian clump, with a
    duplicated position in the first (a zero NN distance) and 70 % of the
    particles selected; returns the per-particle arguments of
    rank_fields_device."""
    rng = np.random.default_rng(seed)
    pn = np.asarray(sizes, np.int64)
    ps = np.concatenate([[0], np.cumsum(pn)[:-1]])
    n = int(pn.sum())
    owner = np.repeat(np.arange(len(pn)), pn)
    hpos = (rng.random((len(pn), 3)) * 500).astype(np.float32)
    hvel = rng.normal(0, 300, (len(pn), 3)).astype(np.float32)
    ppos = (hpos[owner] + rng.normal(0, 0.4, (n, 3))).astype(np.float32)
    pvel = (hvel[owner] + rng.normal(0, 120, (n, 3))).astype(np.float32)
    ppos[1] = ppos[0]
    submask = rng.random(n) < 0.7
    submask[ps] = submask[ps + 1] = True
    nsub = np.bincount(owner, weights=submask, minlength=len(pn))
    r25 = (rng.random(len(pn)) * 0.2 + 0.05).astype(np.float32)
    r98 = (r25 * rng.uniform(1.5, 5.5, len(pn))).astype(np.float32)
    mass = pn * rng.uniform(5, 20, len(pn)) * 2.1e9
    return (ppos, pvel, submask, owner.astype(np.int32), nsub[owner], ps, pn, hpos[owner],
            hvel[owner], mass[owner], r25[owner], r98[owner], 0.6736)


def test_nn_kernel_matches_plain(cuda_device):
    """K6 against its plain version bit for bit: small halos, a halo of
    several shared tiles (K6_TILE = 256) and of several work items
    (K6_QUERIES = 128 queries), a duplicated position."""
    from abacusutils_tpu_torch.models.hod import ranks_device as trd

    args = _rank_slab([2, 3, 20, 64, 129, 700, 2500, 40], 5)
    ppos, _, submask, seg, _, ps, pn = args[:7]
    x, y, z = (torch.from_numpy(ppos[:, a].copy()).to(cuda_device) for a in range(3))
    seg_d = torch.from_numpy(seg).to(cuda_device)
    sel_d = torch.from_numpy(submask).to(cuda_device)
    query, work = trd.nn_work(seg_d, sel_d, len(ps))
    ps_d = torch.from_numpy(ps.astype(np.int32)).to(cuda_device)
    pn_d = torch.from_numpy(pn.astype(np.int32)).to(cuda_device)
    before = trd.nn_within_halo.launches
    got = trd.nn_within_halo(x, y, z, query, work, ps_d, pn_d, seg_d)
    assert trd.nn_within_halo.launches == before + 1
    ref = trd.nn_within_halo_plain(x, y, z, query, ps_d, pn_d, seg_d)
    q = query.long()
    assert torch.equal(got[q], ref[q]) and float(got[0]) == 0.0
    assert bool(torch.isfinite(got[q]).all())
    cpu = trd.rank_fields_device(*args, device='cpu')
    card = trd.rank_fields_device(*args)
    for a, b in zip(card, cpu):
        npt.assert_array_equal(a, b)


@pytest.mark.parametrize('kind', K6_CATALOGS)
def test_nn_kernel_on_adversarial_catalogs(cuda_device, kind):
    """K6's float32 filter on the catalogs that press its bound
    (torch_helpers.k6_catalog: duplicated positions, neighbours whose keys
    lie one float64 ulp apart, coordinates near 0 of both signs and near
    2000 and +-1000, differences whose float32 squares underflow, a halo
    over two shared tiles, a halo all at one point): bit-equal to the plain
    version and to the filtered plain mirror."""
    from abacusutils_tpu_torch.models.hod import ranks_device as trd

    args = k6_tensors(*k6_catalog(kind), device=cuda_device)
    x, y, z, query, work, ps_d, pn_d, seg_d = args
    before = trd.nn_within_halo.launches
    got = trd.nn_within_halo(*args)
    assert trd.nn_within_halo.launches == before + 1
    ref = trd.nn_within_halo_plain(x, y, z, query, ps_d, pn_d, seg_d)
    mirror, _ = trd.nn_within_halo_filtered_plain(x, y, z, query, ps_d, pn_d, seg_d)
    q = query.long()
    assert torch.equal(got[q], ref[q]) and torch.equal(mirror[q], ref[q])
    assert bool(torch.isfinite(got[q]).all())


def _menv_case(name, n, seed):
    rng = np.random.default_rng(seed)
    L = {'box': 300.0, 'small box': 25.0, 'light cone': 800.0, 'box nc 1': 15.0,
         'box nc 3': 35.0, 'box nc 5': 55.0, 'box r_inner > r_outer': 300.0}[name]
    c = rng.random((n // 50, 3)) * L
    pos = c[rng.integers(0, len(c), n)] + rng.normal(0, 4.0, (n, 3))
    if name == 'light cone':
        # an octant shell: open faces on every side of the grid
        u = np.abs(rng.normal(size=(n, 3)))
        pos = u / np.linalg.norm(u, axis=1)[:, None] * rng.uniform(300, 700, n)[:, None]
        pos[: n // 2] = pos[n // 2:][: n // 2] + rng.normal(0, 3.0, (n // 2, 3))
    else:
        pos = np.mod(pos, L) - L / 2
    mass = np.exp(rng.normal(27, 1.5, n))
    rin = (rng.random(n) * 0.8 + 0.1).astype(np.float32)
    if name == 'box r_inner > r_outer':
        rin = np.full(n, 25.0, np.float32)
    return dict(pos=pos.astype(np.float32), mass=mass, r_inner=rin, r_outer=10.0,
                halo_lc=name == 'light cone', Lbox=L, mcut=float(np.median(mass)))


MENV_CASES = ['box', 'small box', 'light cone', 'box nc 1', 'box nc 3', 'box nc 5',
              'box r_inner > r_outer']


@pytest.mark.parametrize('dense', [False, True], ids=['cell starts', 'dense ids'])
@pytest.mark.parametrize('name', MENV_CASES)
def test_menv_kernel_matches_plain(cuda_device, name, dense, monkeypatch):
    """K7 against its plain version (the 27-cell sum by all pairs; rtol
    1e-12, the same zeros) in boxes of 1 to 15 cells a side (the minimum
    image by division below 5 cells, by each range's wrap from 5), an octant
    light cone and a box whose r_inner passes the cell edge, through the
    cell starts and through the dense ids; bit-equal to its CPU walk and to
    a second launch; and against the host tree where r_inner <= r_outer."""
    from abacusutils_tpu_torch.models.hod import menv_device as tmd
    from abacusutils_tpu_torch.models.hod.menv import do_Menv_from_tree
    from abacusutils_tpu_torch.testing import menv_walk

    if dense:
        monkeypatch.setattr(tmd, '_DENSE_MIN_CELLS', 0)
    kw = _menv_case(name, 20_000 if name in ('box', 'light cone') else 3000, 8)
    before = tmd.menv_annulus.launches
    got = tmd.do_menv_device(**kw)
    assert tmd.menv_annulus.launches == before + 1
    ref = tmd.do_menv_device(**kw, device='cpu')
    assert np.count_nonzero(ref) > len(ref) // 4
    npt.assert_allclose(got, ref, rtol=1e-12, atol=0.0)
    npt.assert_array_equal(got == 0, ref == 0)
    st = tmd.stage_menv(kw['pos'], kw['mass'], kw['r_inner'], kw['r_outer'], kw['halo_lc'],
                        kw['Lbox'], cuda_device, kw['mcut'])
    lbox = kw['Lbox'] if st.periodic else 0.0
    card = tmd.menv_annulus(st, lbox, kw['r_outer'] ** 2)
    assert torch.equal(card, tmd.menv_annulus(st, lbox, kw['r_outer'] ** 2))
    cpu = st._replace(cols=[c.cpu() for c in st.cols], cells=st.cells.cpu(),
                      starts=st.starts.cpu(), ukeys=None if st.ukeys is None else st.ukeys.cpu(),
                      query=st.query.cpu(), work=st.work.cpu())
    assert torch.equal(card.cpu(), menv_walk(cpu, lbox, kw['r_outer'] ** 2))
    if name != 'box r_inner > r_outer':
        tree = do_Menv_from_tree(**kw)
        npt.assert_allclose(got, tree, rtol=1e-12, atol=0.0)
        npt.assert_array_equal(got == 0, tree == 0)


def test_out_of_box_catalog_goes_to_all_pairs(cuda_device):
    """30,000 points in [-lbox/2, lbox/2), between the port's threshold and
    JAX's: the default dispatch counts them with K5 (JAX's default engine),
    and the same catalog inside the box with K4."""
    lbox = 700.0
    host = np.stack([c.cpu().numpy() for c in _clustered(30_000, lbox, 23, cuda_device)], 1)
    for shift, want in ((-lbox / 2, (0, 1)), (0.0, (1, 0))):
        pos = host + np.float32(shift)
        k4, k5 = ttpcf.count_pairs_cells.launches, ttpcf.count_pairs_all.launches
        got = ttpcf.pair_counts_rppi(pos, PAIR_EDGES, 30, lbox)
        assert (ttpcf.count_pairs_cells.launches - k4, ttpcf.count_pairs_all.launches - k5) == want
        npt.assert_array_equal(got, ttpcf.pair_counts_rppi(pos, PAIR_EDGES, 30, lbox,
                                                           method='tile'))
    ttpcf._stage_cache.clear()
    ttpcf._span_cache.clear()


@pytest.mark.parametrize('wrap', [True, False])
def test_tsc_parallel_on_card(cuda_device, wrap):
    """tsc_parallel at a mesh that is not a power of two, with positions
    past the faces, wrapped once or not, against the plain scatter."""
    from abacusutils_tpu_torch.ops.grid import tsc_parallel

    rng = np.random.default_rng(4)
    n, L = 100, 250.0
    pos = (rng.random((400_000, 3)) * 1.2 * L - 0.1 * L).astype(np.float32)
    got = tsc_parallel(pos, n, L, wrap=wrap)
    ref = tsc_parallel(pos, n, L, wrap=wrap, device='cpu')
    _assert_grid(torch.from_numpy(got), torch.from_numpy(ref))


def test_shear_on_card(cuda_device):
    from abacusutils_tpu_torch.ops.shear import get_shear

    dens = np.random.default_rng(2).lognormal(0, 0.8, (64, 64, 64)).astype(np.float32)
    got = get_shear(dens, 64, 100.0, R=2.0)
    ref = get_shear(dens, 64, 100.0, R=2.0, device='cpu')
    npt.assert_allclose(got, ref, rtol=2e-4, atol=1e-5 * float(np.abs(ref).max()))


# ---------------------------------------------------------------------------
# the ZCV kernels: K1's multi-weight form and K8
# ---------------------------------------------------------------------------


def _lattice(nmesh, box, jitter, rng, dev):
    """The points of an nmesh^3 lattice, each moved by up to `jitter`
    cells on every axis, wrapped into [0, box)."""
    h = box / nmesh
    c = (np.arange(nmesh, dtype=np.float32) * np.float32(h))
    pos = np.stack(np.meshgrid(c, c, c, indexing='ij'), -1).reshape(-1, 3)
    pos = pos + (rng.uniform(-jitter, jitter, pos.shape) * h).astype(np.float32)
    return [t(np.mod(pos[:, i], np.float32(box)).astype(np.float32)).to(dev) for i in range(3)]


def _check_gather(cols, ws, nmesh, box, dev):
    """K1's multi-weight gather against the plain scatter once a column
    (1e-5 of max|grid|: f32 sums in another order), bit-equal to its plain
    walk and to a second launch, one launch counted; and paint_3d_multi,
    which stages and launches it, in the columns' order."""
    from abacusutils_tpu_torch.ops.grid import (
        gather_deposit_plain,
        paint_3d_multi,
        stage_gather,
        tsc_deposit_cells_multi,
    )

    nf = len(ws)
    assert all(w is not None for w in ws[1:])
    plan = stage_gather(cols + [w for w in ws if w is not None], nmesh, box)
    grids = torch.full((nf,) + (nmesh,) * 3, 7.0, device=dev)
    before = tsc_deposit_cells_multi.launches
    assert tsc_deposit_cells_multi(grids, plan) is grids
    assert tsc_deposit_cells_multi.launches == before + 1
    again = torch.empty_like(grids)
    tsc_deposit_cells_multi(again, plan)
    assert torch.equal(grids, again)
    assert torch.equal(grids, gather_deposit_plain(again, plan))
    ones = torch.ones_like(cols[0])
    for f, w in enumerate(ws):
        ref = paint_3d_plain(torch.zeros((nmesh,) * 3, device=dev), *cols,
                             ones if w is None else w, nmesh, box)
        scale = float(ref.abs().max())
        npt.assert_allclose(grids[f].cpu().numpy(), ref.cpu().numpy(), rtol=0, atol=1e-5 * scale)
    # the unit column last: the same grids in that order
    turned = ws[1:] + ws[:1]
    painted = paint_3d_multi(*cols, nmesh, box, turned)
    assert torch.equal(painted, grids[list(range(1, nf)) + [0]] if ws[0] is None else grids)


@pytest.mark.parametrize('nf', [1, 2, 3, 4, 5])
@pytest.mark.parametrize('nmesh', [7, 16, 33, 64])
def test_multiweight_deposit_matches_plain(cuda_device, nf, nmesh):
    """K1's multi-weight gather (a unit column first, then nf - 1 weight
    columns with zeros in them) on a lattice moved by up to half a cell and
    on clumped points on cell and brick edges, at even and odd meshes with
    ragged last bricks."""
    box = 2000.0
    rng = np.random.default_rng(nf * nmesh)
    for cols in (_lattice(nmesh, box, 0.5, rng, cuda_device),
                 [t(c).to(cuda_device) for c in edge_points(100_000, nmesh, 8, box, rng).T]):
        n = cols[0].numel()
        ws = [None] + [t(rng.normal(size=n).astype(np.float32)).to(cuda_device)
                       for _ in range(nf - 1)]
        if nf > 1:
            ws[1][::7] = 0.0
        _check_gather(cols, ws, nmesh, box, cuda_device)


@pytest.mark.parametrize('nmesh', [16, 33])
def test_multiweight_deposit_far_points(cuda_device, nmesh):
    """Lattice points moved up to 4 cells from their sites: cells hold from
    none to many points, and the gather still equals the scatter."""
    rng = np.random.default_rng(23)
    cols = _lattice(nmesh, 77.0, 4.0, rng, cuda_device)
    n = cols[0].numel()
    ws = [None] + [t(rng.random(n).astype(np.float32)).to(cuda_device) for _ in range(3)]
    _check_gather(cols, ws, nmesh, 77.0, cuda_device)


def test_field_ffts_on_card_match_cpu(cuda_device):
    """get_field_ffts (two stages, one multi-weight launch each) on the card
    against the same call on the CPU (the plain deposit)."""
    n, nmesh, lbox = 50_000, 48, 500.0
    rng = np.random.default_rng(2)
    pos = (rng.random((n, 3)) * lbox).astype(np.float32)
    ws = [None] + [rng.normal(size=n).astype(np.float32) for _ in range(4)]
    W = get_W_compensated(lbox, nmesh, 'TSC', True)
    got = tpow.get_field_ffts(pos, lbox, nmesh, 'TSC', ws, W, True, True, device=cuda_device)
    ref = tpow.get_field_ffts(pos, lbox, nmesh, 'TSC', ws, W, True, True, device='cpu')
    for g, r in zip(got, ref):
        r = r.numpy()
        npt.assert_allclose(g.cpu().numpy(), r, rtol=0, atol=1e-5 * np.abs(r).max())


@pytest.mark.parametrize('nmesh,nkout', [(64, 32), (63, 20), (128, 64), (256, 128)])
def test_window_kernel_matches_plain(cuda_device, nmesh, nkout):
    """K8 against its plain version (a torch bincount a kx plane) on the
    card, at even and odd meshes: the counts row exact, the other rows
    within 1e-12 of the bin's count (f64 sums of the same f32 weights in
    another order), bins past the last mode empty; two launches give the
    same bits."""
    from abacusutils_tpu_torch.models.zcv import zenbu_window as tzw

    lbox = 1000.0
    kout = np.linspace(0.0, np.sqrt(3) * np.pi * nmesh / lbox * 0.8, nkout + 1)
    kv, kz = (torch.from_numpy(a).to(cuda_device) for a in tzw._mode_kgrids(nmesh, lbox))
    edges = torch.from_numpy(tzw._f32_ge_edges(kout)).to(cuda_device)
    plan = tzw.window_plan(kv, kz, edges, nkout)
    before = tzw.window_mode_sums.launches
    got = tzw.window_mode_sums(plan)
    again = tzw.window_mode_sums(plan)
    assert tzw.window_mode_sums.launches == before + 2
    ref = tzw.window_mode_sums_plain(kv, kz, edges, nkout)
    got, again, ref = (a.cpu().numpy() for a in (got, again, ref))
    npt.assert_array_equal(got, again)
    npt.assert_array_equal(got[0], ref[0])
    assert (np.abs(got - ref) <= 1e-12 * np.maximum(ref[0], 1.0)).all()
    assert ref[0].sum() > 0


@pytest.mark.parametrize('nmesh', [63, 127])
def test_window_kernel_odd_mesh_log_bins(cuda_device, nmesh):
    """K8 over the row plan of an odd mesh (an unpaired -(n + 1) / 2 dk on
    the mesh axes) with log bins from the fundamental mode: the counts row
    equal to the full-mesh plain version's, the other rows within 1e-12 of
    the bin's count, two launches bit-equal."""
    from abacusutils_tpu_torch.models.zcv import zenbu_window as tzw

    lbox = 1500.0
    kout = np.concatenate([[0.0], np.geomspace(2 * np.pi / lbox, np.pi * nmesh / lbox, 24)])
    plan = tzw.get_window_plan(nmesh, lbox, kout, cuda_device)
    args = (plan.kv, plan.kzv, plan.edges, plan.nkout)
    before = tzw.window_mode_sums.launches
    got = tzw.window_mode_sums(plan)
    again = tzw.window_mode_sums(plan)
    assert tzw.window_mode_sums.launches == before + 2
    ref = tzw.window_mode_sums_plain(*args)
    rows = tzw.window_mode_sums_rows_plain(plan)
    got, again, ref, rows = (a.cpu().numpy() for a in (got, again, ref, rows))
    npt.assert_array_equal(got, again)
    npt.assert_array_equal(got[0], ref[0])
    npt.assert_array_equal(rows[0], ref[0])
    assert (np.abs(got - ref) <= 1e-12 * np.maximum(ref[0], 1.0)).all()


def _kppi_edges(n1d, case):
    """(kedges, pimax, npi) in units of the fundamental mode (L = 2 pi):
    bins within the mesh, or k_perp edges past its corner and pi bins past
    its Nyquist plane."""
    if case == 'within':
        return np.linspace(0.0, 0.5 * n1d, 9), 0.4 * n1d, 6
    return np.linspace(0.0, 1.6 * n1d, 11), n1d // 2 + 2.5, 7


@pytest.mark.parametrize('case', ['within', 'past the mesh'])
@pytest.mark.parametrize('n1d', [7, 16, 31, 64])
def test_kppi_kernel_matches_plain(cuda_device, n1d, case):
    """K9 against its plain version (a torch bincount a kx plane) on the
    card: counts equal to a bincount of dup over the modes, sums within 1e-12
    of the bin's largest (f64 sums of the same f32 weights in another
    order), two launches bit-equal, and a full real mesh read through its
    [:, :, :kzlen] view's strides equal to the contiguous half."""
    rng = np.random.default_rng(n1d)
    kzlen = n1d // 2 + 1
    full = t(rng.random((n1d, n1d, n1d)).astype(np.float32) + 0.5).to(cuda_device)
    half = full[:, :, :kzlen].contiguous()
    kedges, pimax, npi = _kppi_edges(n1d, case)
    kedges2 = (kedges**2).astype(np.float32)
    piedges2 = (np.linspace(0.0, pimax, npi + 1) ** 2).astype(np.float32)
    plan = tpow.get_kppi_plan(n1d, kedges2, piedges2, cuda_device)
    before = tpow.bin_kppi_sums.launches
    got = tpow.bin_kppi_sums(half, plan)
    again = tpow.bin_kppi_sums(half, plan)
    strided = tpow.bin_kppi_sums(full[:, :, :kzlen], plan)
    assert tpow.bin_kppi_sums.launches == before + 3
    ref = tpow.bin_kppi_sums_plain(half, plan)
    ones = tpow.bin_kppi_sums_plain(torch.ones_like(half), plan).cpu().numpy()
    got, again, strided, ref = (a.cpu().numpy() for a in (got, again, strided, ref))
    npt.assert_array_equal(got, again)
    npt.assert_array_equal(got, strided)
    npt.assert_array_equal(plan.counts, ones.astype(np.int64))
    assert plan.counts.sum() > 0
    assert (np.abs(got - ref) <= 1e-12 * np.abs(ref).max()).all()


def test_kppi_wrapper_refuses_what_k9_does_not_take(cuda_device):
    """The K9 wrapper raises on a CUDA tensor of another dtype, a mesh not
    contiguous along kz, another shape or another device than its plan's;
    it never falls back to the plain version."""
    n1d = 16
    plan = tpow.get_kppi_plan(n1d, np.array([0.0, 40.0], np.float32),
                              np.array([0.0, 9.0, 30.0], np.float32), cuda_device)
    w = torch.rand(n1d, n1d, n1d // 2 + 1, device=cuda_device)
    before = tpow.bin_kppi_sums.launches
    for bad, match in ((w.double(), 'float32'), (w[:, :8], 'float32'),
                       (torch.rand(n1d, 9, n1d, device=cuda_device).transpose(1, 2),
                        'contiguous along kz')):
        with pytest.raises(ValueError, match=match):
            tpow.bin_kppi_sums(bad, plan)
    cpu_plan = tpow.get_kppi_plan(n1d, np.array([0.0, 40.0], np.float32),
                                  np.array([0.0, 9.0, 30.0], np.float32), 'cpu')
    with pytest.raises(ValueError, match='plan on cpu'):
        tpow.bin_kppi_sums(w, cpu_plan)
    assert tpow.bin_kppi_sums.launches == before


@pytest.mark.parametrize('interlaced', [False, True])
def test_staged_power_on_card_matches_cpu(cuda_device, interlaced):
    """StagedPower on the card (K1 on the cached brick stage, a pz override
    gathered into it, K3) against the same stage on the CPU: counts equal,
    power within 1e-4 |P| + 1e-6 max|P| (f32 atomics and cuFFT against the
    plain scatter and pocketfft); the overflow word counts the same points."""
    n, nmesh, lbox = 60_000, 64, 500.0
    rng = np.random.default_rng(4)
    pos = (rng.random((n, 3)) * lbox).astype(np.float32)
    w = rng.random(n).astype(np.float32) + 0.5
    pz = (pos[:, 2] + rng.normal(0, 15.0, n).astype(np.float32)) % np.float32(lbox)
    kw = dict(kbins=24, mubins=2, poles=[0, 2, 4])
    for extra in ({}, {'pz': pz}):
        tabs, over = [], []
        for dev in (cuda_device, 'cpu'):
            st = tpow.StagedPower(pos, lbox, nmesh=nmesh, w=w, interlaced=interlaced, device=dev)
            tabs.append(st.power(**kw, **extra))
            over.append(int(st.overflow))
        got, ref = tabs
        npt.assert_array_equal(got['N_mode'], ref['N_mode'])
        P = ref['power']
        assert (np.abs(got['power'] - P) <= 1e-4 * np.abs(P) + 1e-6 * np.abs(P).max()).all()
        pw = ref['poles']
        npt.assert_allclose(got['poles'], pw, rtol=1e-4, atol=1e-5 * np.abs(pw).max())
        assert over[0] == over[1]
        if extra:
            assert over[0] > 0


def _cv_ic(nmesh, lbox, seed):
    """A seeded Gaussian IC (sigma 0.3) and its Zel'dovich displacement in
    units of the box, numpy f32."""
    rng = np.random.default_rng(seed)
    dens = rng.normal(0, 0.3, (nmesh,) * 3).astype(np.float32)
    kf = np.fft.fftfreq(nmesh) * nmesh * (2 * np.pi / lbox)
    kx, ky, kz = np.meshgrid(kf, kf, kf[: nmesh // 2 + 1], indexing='ij')
    k2 = kx**2 + ky**2 + kz**2
    k2[0, 0, 0] = 1.0
    dk = np.fft.rfftn(dens)
    disp = tuple((np.fft.irfftn(1j * kv / k2 * dk, s=dens.shape) / lbox * 0.02).astype(np.float32)
                 for kv in (kx, ky, kz))
    return dens, disp


def _cv_config(nmesh, lbox, kind):
    # a Savitzky-Golay window shorter than the nmesh / 2 bins, so beta is smoothed
    cv = {'nmesh': nmesh, 'kcut': np.pi * nmesh / lbox / 2, 'sg_window': 7}
    if kind == 'zcv':
        cv['fields'] = ['1cb', 'delta']
    return {
        'sim_params': {'sim_name': 'AbacusSummit_base_c000_ph000', 'z_mock': 0.5},
        'HOD_params': {'want_rsd': True, 'rec_algo': 'recsym', 'smoothing': 10.0},
        f'{kind}_params': cv,
        'power_params': {'nbins_k': nmesh // 2, 'nbins_mu': 1, 'poles': [0, 2, 4],
                         'k_hMpc_max': np.pi * nmesh / lbox, 'logk': False,
                         'paste': 'TSC' if kind == 'zcv' else 'CIC', 'compensated': True,
                         'interlaced': True, 'nmesh': nmesh},
    }


def _assert_flow(got, ref, rho_key):
    """A field flow on the card against the same flow on the CPU: mode counts
    equal, bias within 1e-3, every pole stack and xi within 1e-3 |x| + 1e-4
    max|x| (f32 atomics and cuFFT against the plain scatter and pocketfft,
    through a least-squares bias fit), rho within 1e-3."""
    assert set(got) == set(ref)
    npt.assert_array_equal(got['Nk_tr_tr_ell'], ref['Nk_tr_tr_ell'])
    npt.assert_allclose(np.asarray(got['bias']), np.asarray(ref['bias']), rtol=1e-3)
    npt.assert_allclose(got[rho_key], ref[rho_key], rtol=0, atol=1e-3)
    for key, r in ref.items():
        if key.startswith(('Pk_', 'Xi_')):
            r = np.asarray(r)
            npt.assert_allclose(np.asarray(got[key]), r, rtol=1e-3, atol=1e-4 * np.abs(r).max(),
                                err_msg=key)
            assert np.isfinite(got[key]).all(), key


class _Ball:
    """What apply_zcv_xi re-populates from: run_hod(want_rsd=False) gives the
    tracer at its real-space positions."""

    tracers = {'LRG': {}}

    def __init__(self, lbox, real):
        self.lbox, self.real = lbox, real

    def run_hod(self, tracers, want_rsd=True, reseed=None, write_to_disk=False):
        assert not want_rsd
        return {'LRG': dict(self.real)}


def test_apply_zcv_xi_on_card_matches_cpu(cuda_device):
    """apply_zcv_xi on the card (K1 for the tracer fields, K3 for every
    projection and for pk_to_xi) against the same call on the CPU, on
    products built on each device from one IC."""
    from abacusutils_tpu_torch.models.zcv import cosmo
    from abacusutils_tpu_torch.models.zcv.advect_fields import advected_field_ffts
    from abacusutils_tpu_torch.models.zcv.apply import apply_zcv_xi
    from abacusutils_tpu_torch.models.zcv.ic_fields import get_fields
    from abacusutils_tpu_torch.models.zcv.precompute import ZCVProducts

    nmesh, lbox = 32, 2000.0
    config = _cv_config(nmesh, lbox, 'zcv')
    meta = cosmo.get_meta('AbacusSummit_base_c000_ph000', redshift=0.5)
    dens, disp = _cv_ic(nmesh, lbox, 3)
    rng = np.random.default_rng(4)
    real = {c: (rng.random(40_000) * lbox - lbox / 2).astype(np.float32) for c in 'xyz'}
    rsd = dict(real, z=((real['z'] + rng.normal(0, 5.0, 40_000) + lbox / 2) % lbox
                        - lbox / 2).astype(np.float32))
    nk = nmesh // 2
    k_binc = (np.arange(nk) + 0.5) * np.pi * nmesh / lbox / nk
    outs = []
    for dev in (cuda_device, torch.device('cpu')):
        fields = get_fields(dens, lbox, nmesh, dev)
        ffts = {}
        for want_rsd in (True, False):
            D, f = cosmo.growth_from_meta(meta, 0.5, want_rsd)
            ffts[want_rsd] = advected_field_ffts(disp, fields, lbox, nmesh, D, f,
                                                 config['power_params'], dev)
        templates = {True: np.ones((15, 3, nk)) * np.linspace(1.0, 0.1, nk)}
        zcv = ZCVProducts(ffts, {}, None, None, k_binc, config['zcv_params']['kcut'],
                          templates, meta)
        before = tpow.bin_pair_modes.launches
        outs.append(apply_zcv_xi(_Ball(lbox, real), {'LRG': rsd}, config, zcv))
        if dev.type == 'cuda':
            assert tpow.bin_pair_modes.launches > before
            assert zcv.tracer_ffts[True].device.type == 'cuda'
    _assert_flow(*outs, 'rho_tr_ZD')
    assert set(outs[0]) >= {'Xi_tr_tr_ell_zcv', 'Xi_tr_tr_ell', 'Np_tr_tr_ell', 'r_binc'}
    npt.assert_array_equal(outs[0]['Np_tr_tr_ell'], outs[1]['Np_tr_tr_ell'])


def test_run_lcv_field_on_card_matches_cpu(cuda_device):
    """lcv_products (the linear fields, their spectra in one K3 launch, the
    window on K8 over its row plan), get_recon_power with randoms (K1, CIC)
    and run_lcv_field on the card against the same calls on the CPU."""
    from abacusutils_tpu_torch.models.zcv import cosmo
    from abacusutils_tpu_torch.models.zcv import zenbu_window as tzw
    from abacusutils_tpu_torch.models.zcv.precompute import lcv_products
    from abacusutils_tpu_torch.models.zcv.tools_cv import run_lcv, run_lcv_field
    from abacusutils_tpu_torch.models.zcv.tracer_power import get_recon_power

    nmesh, lbox = 32, 2000.0
    config = _cv_config(nmesh, lbox, 'lcv')
    meta = cosmo.get_meta('AbacusSummit_base_c000_ph000', redshift=0.5)
    dens, _ = _cv_ic(nmesh, lbox, 5)
    rng = np.random.default_rng(6)
    tracer = (rng.random((30_000, 3)) * lbox).astype(np.float32)
    randoms = (rng.random((90_000, 3)) * lbox).astype(np.float32)
    field, k_level = [], []
    for dev in (cuda_device, torch.device('cpu')):
        before = tzw.window_mode_sums.launches
        lcv = lcv_products(dens, lbox, nmesh, config, meta, engine='device', device=dev)
        if dev.type == 'cuda':
            assert tzw.window_mode_sums.launches == before + 1
        tr = get_recon_power(tracer, randoms, True, config, meta=meta, device=dev,
                             save_3D_power=True)
        assert tr.device.type == dev.type
        field.append(run_lcv_field(tr, lcv.field_ffts, config, meta=meta))
        spectra = get_recon_power(None, None, True, config, lcv.field_ffts, meta,
                                  tr_field_fft=tr)
        k_level.append(run_lcv(spectra, lcv.pk_lin, config, window=lcv.window, keff=lcv.keff,
                               meta=meta))
    _assert_flow(*field, 'rho_tr_lf')
    _assert_flow(*k_level, 'rho_tr_lf')


def test_prepare_sim_main_on_card_matches_cpu(cuda_device, tmp_path):
    """prepare_sim.main on the card (K6, K7 and K1 through the device
    engines) on a two-slab synthetic simulation written by the port's own
    writer: the CPU run's tables (ranksc tie-aware, Menv at rtol 1e-12 with
    the same zeros, every other column exact). Both runs rank halos on the
    CPU's shear field; the card's field agrees with it at the shear's
    tolerance (rtol 2e-4, atol 1e-5 of its largest value)."""
    import glob
    import os
    import shutil

    from abacusutils_tpu_torch.models.hod import prepare_sim as tps
    from abacusutils_tpu_torch.testing import synthetic_compaso, write_compaso_sim
    from torch_disk import assert_tables_equal, config

    sim = synthetic_compaso(2, 4000, 30_000, 20_000, seed=9)
    write_compaso_sim(tmp_path, sim)
    name = sim['header']['SimName']
    np.random.seed(3)
    cpu_field = tps.calc_shearmark(str(tmp_path), name, 0.5, 32, 2, str(tmp_path / 'cpu'), 1,
                                   device='cpu')
    np.random.seed(3)
    card_field = tps.calc_shearmark(str(tmp_path), name, 0.5, 32, 2, str(tmp_path / 'card'), 1,
                                    device=cuda_device)
    npt.assert_allclose(card_field, cpu_field, rtol=2e-4, atol=1e-5 * np.abs(cpu_field).max())
    saved = {}
    for where, device in (('cpu', 'cpu'), ('card', cuda_device)):
        cfg = config(tmp_path, name, where)
        saved[where] = f'{tmp_path}/{where}/{name}/z0.500'
        os.makedirs(saved[where])
        shutil.copy(tmp_path / 'cpu.npy', f'{saved[where]}/shear_N32_R2_down1.npy')
        tps.main(cfg, device=device)
    files = sorted(os.path.basename(f) for f in glob.glob(f'{saved["cpu"]}/*.npz'))
    assert len(files) == 6
    for fn in files:
        with np.load(f'{saved["card"]}/{fn}') as got, np.load(f'{saved["cpu"]}/{fn}') as ref:
            if fn.startswith('env'):
                assert_tables_equal({k: got[k] for k in got}, {k: ref[k] for k in ref},
                                    exact_menv=False)
            else:
                (key,) = ref.files
                assert_tables_equal(got[key], ref[key])


def test_particle_readers_on_card_host(cuda_device, tmp_path):
    """The readers of this slice on the card's machine (its numpy, libzstd
    and file system), files written by the port's own writer: the light
    cone's catalog equal to the arrays it was written from (pos_interp /
    vel_interp where pos_avg is zero, origin modulo 3, packed PIDs), its
    particle pair through read_asdf (RVint and every PID field of the
    drawn words, SubsampleFraction A + B), a box's A + B particles with
    unpack_bits=True and passthrough equal to the drawn words, and pack9
    rows decoded to the values they encode, to the quanta."""
    from abacusutils_tpu_torch.io import bitpacked
    from abacusutils_tpu_torch.io.compaso import CompaSOHaloCatalog
    from abacusutils_tpu_torch.io.pack9 import unpack_pack9
    from abacusutils_tpu_torch.io.read_abacus import read_asdf
    from abacusutils_tpu_torch.testing import (
        decoded_catalog,
        decoded_catalog_lc,
        pack9_rows,
        synthetic_compaso,
        synthetic_compaso_lc,
        write_compaso_lc,
        write_compaso_sim,
    )

    lc = synthetic_compaso_lc(5000, n_particles=40_000, seed=3)
    info = write_compaso_lc(tmp_path, lc)
    halos, parts = decoded_catalog_lc(lc)
    cat = CompaSOHaloCatalog(info['groupdir'], fields=list(halos), subsamples=True)
    assert cat.halo_lc and cat.subsamples.colnames == ['pid', 'pos', 'vel']
    for k in halos:
        assert cat.halos[k].dtype == halos[k].dtype, k
        npt.assert_array_equal(cat.halos[k], halos[k], err_msg=k)
    for k in parts:
        npt.assert_array_equal(cat.subsamples[k], parts[k], err_msg=k)
    header = lc['header']
    box, ppd = header['BoxSize'], header['ppd']
    words = lc['particles']['packedpid']
    rv = read_asdf(info['particle_files']['rv'], verbose=False)
    p, v = bitpacked.unpack_rvint(lc['particles']['rvint'], box)
    npt.assert_array_equal(rv['pos'], p)
    npt.assert_array_equal(rv['vel'], v)
    frac = header['ParticleSubsampleA'] + header['ParticleSubsampleB']
    assert rv.meta['SubsampleFraction'] == frac
    fields = ('pid', 'lagr_pos', 'tagged', 'density', 'lagr_idx')
    pid = read_asdf(info['particle_files']['pid'], load=fields + ('aux',), verbose=False)
    want = bitpacked.unpack_pids(words, box=box, ppd=ppd, **dict.fromkeys(fields, True))
    for k in fields:
        npt.assert_array_equal(pid[k], want[k], err_msg=k)
    npt.assert_array_equal(pid['aux'], words)

    sim = synthetic_compaso(2, 3000, 20_000, 2000, seed=4)
    groupdir = write_compaso_sim(tmp_path / 'box', sim)['groupdir']
    for cleaned in (True, False):
        hal, par = decoded_catalog(sim, range(2), cleaned, sets='AB')
        got = CompaSOHaloCatalog(groupdir, fields=['N', 'npstartA', 'npoutA', 'npstartB',
                                                   'npoutB'], cleaned=cleaned,
                                 subsamples=True, unpack_bits=True)
        npt.assert_array_equal(got.subsamples['packedpid'], par['packedpid'])
        want = bitpacked.unpack_pids(par['packedpid'], box=box, ppd=ppd,
                                     **dict.fromkeys(fields, True))
        for k in fields:
            npt.assert_array_equal(got.subsamples[k], want[k], err_msg=k)
        raw = CompaSOHaloCatalog(groupdir, fields='all', cleaned=cleaned, subsamples=True,
                                 passthrough=True)
        npt.assert_array_equal(raw.subsamples['rvint'], par['rvint'])
        npt.assert_array_equal(raw.subsamples['packedpid'], par['packedpid'])

    rng = np.random.default_rng(5)
    pos = (rng.random((20_000, 3)) - 0.5) * box
    vel = rng.normal(0, 400.0, (20_000, 3))
    rows, order = pack9_rows(pos, vel, box, 1701, header['VelZSpace_to_kms'])
    dp, dv = unpack_pack9(rows, box, header['VelZSpace_to_kms'], float_dtype=np.float64)
    assert np.abs(dp - pos[order]).max() <= 0.0005 * box / 1701 / 2 * (1 + 1e-9)
    assert np.abs(dv - vel[order]).max() < 5.0


def test_prepare_sim_lc_on_card_matches_cpu(cuda_device, tmp_path):
    """prepare_sim.main of a synthetic halo light cone (port-written) on the
    card (K6 and K7 through the device engines) and on the CPU (their plain
    versions): the same files, every column equal but fenv_rank, which is
    tie-aware (Menv at rtol 1e-12 can swap halos of equal Menv); then
    AbacusHOD.from_config's run_hod_pk_fused on each, within 1e-4 of the
    spectra's scale, n_gal equal."""
    import glob
    import os

    from abacusutils_tpu_torch.models.hod import prepare_sim as tps
    from abacusutils_tpu_torch.models.hod.abacus_hod import AbacusHOD
    from abacusutils_tpu_torch.testing import synthetic_compaso_lc, write_compaso_lc
    from torch_disk import assert_fenv_tie_aware, config

    sim = synthetic_compaso_lc(20_000, seed=7)
    write_compaso_lc(tmp_path, sim)
    name = sim['header']['SimName']
    saved, spectra = {}, {}
    for where, device in (('cpu', 'cpu'), ('card', cuda_device)):
        cfg = config(tmp_path, name, where)
        cfg['sim_params'].update(sim_dir=f'{tmp_path}/halo_light_cones/', halo_lc=True)
        cfg['HOD_params']['want_shear'] = False
        saved[where] = f'{tmp_path}/{where}/{name}/z0.500'
        tps.main(cfg, device=device)
        hod = AbacusHOD.from_config(cfg['sim_params'], cfg['HOD_params'], device=device)
        spectra[where] = hod.run_hod_pk_fused(nmesh=64, nbins_k=32)
    files = sorted(os.path.basename(f) for f in glob.glob(f'{saved["cpu"]}/*.npz'))
    assert len(files) == 2
    tables = {}
    for fn in files:
        with np.load(f'{saved["card"]}/{fn}') as got, np.load(f'{saved["cpu"]}/{fn}') as ref:
            (key,) = ref.files
            tables[key] = got[key], ref[key]
    assert_fenv_tie_aware(tables, sim['halos']['N_interp'], sim['header']['ParticleMassHMsun'])
    (cl, ng), (cl_c, ng_c) = spectra['card'], spectra['cpu']
    assert ng == ng_c
    for t1 in ng:
        for t2 in ng:
            scale = np.sqrt(np.abs(cl_c[f'{t1}_{t1}'] * cl_c[f'{t2}_{t2}']))
            assert (np.abs(cl[f'{t1}_{t2}'] - cl_c[f'{t1}_{t2}']) <= 1e-4 * scale).all()


def test_all_fields_read_on_card_host(cuda_device, tmp_path):
    """CompaSOHaloCatalog(fields='all'), cleaned and not, on the card
    machine (host numpy and its zstd): every column equal to the drawn
    columns decoded field by field."""
    from abacusutils_tpu_torch.io.compaso import CompaSOHaloCatalog
    from abacusutils_tpu_torch.testing import decoded_fields, synthetic_compaso, write_compaso_sim

    sim = synthetic_compaso(2, 4000, 8000, 500, seed=21)
    groupdir = write_compaso_sim(tmp_path, sim)['groupdir']
    for cleaned in (True, False):
        for convert_units in (True, False):
            cat = CompaSOHaloCatalog(groupdir, fields='all', cleaned=cleaned,
                                     convert_units=convert_units)
            names = [c if c != 'N' or not cleaned else 'N_total' for c in cat.halos.colnames]
            per = [decoded_fields(s['halo_info'], s['clean'] if cleaned else None, cat.header,
                                  names, convert_units) for s in sim['slabs']]
            for c, n in zip(cat.halos.colnames, names):
                want = np.concatenate([p[n] for p in per])
                assert want.dtype == cat.halos[c].dtype and want.tobytes() == cat.halos[c].tobytes(), c
            assert cat.nbytes() == sum(v.nbytes for v in cat.halos.columns.values())


def test_get_meta_without_msgpack(cuda_device):
    """The metadata registry with the msgpack package blocked: bundled,
    synthesized and per-redshift entries."""
    import subprocess
    import sys
    from pathlib import Path

    code = ('import sys; sys.modules["msgpack"] = None\n'
            'import abacusutils_tpu_torch.metadata as m\n'
            'a = m.get_meta("AbacusSummit_base_c000_ph000", 0.5)\n'
            'b = m.get_meta("AbacusSummit_base_c000_ph002", 0.8)\n'
            'c = m.get_meta("Abacus_DESI2_c000_ph300", "z2.000")\n'
            'assert a["BoxSize"] == b["BoxSize"] == 2000.0 and 0 < a["f_growth"] < b["f_growth"]\n'
            'assert len(c["CLASS_power_spectrum"]["k (h/Mpc)"]) > 100\n'
            'print("ok")')
    root = Path(__file__).resolve().parents[1]  # the package's checkout
    out = subprocess.run([sys.executable, '-c', code], capture_output=True, text=True,
                         check=True, cwd=root)
    assert out.stdout.strip() == 'ok'


class _DeviceBall(_Ball):
    def __init__(self, lbox, real, device):
        super().__init__(lbox, real)
        self.device = device


def test_zcv_chain_from_disk_on_card_matches_cpu(cuda_device, tmp_path, monkeypatch):
    """The ZCV chain on files at nmesh 32 on the card and on the CPU:
    ic_fields.main from ic_dens / ic_disp files, advect_fields.main in RSD
    and real space (K1's multi-weight form, K3), zenbu_window.main (K8 and
    the templates on a coarse q grid), then apply_zcv with zcv=None (K1,
    K3): the files' spectra and the reduced poles of both within the
    tolerance of a card flow against the CPU's; each kernel launched on
    the card."""
    import functools
    import json

    from abacusutils_tpu_torch.io.asdf_file import write_asdf
    from abacusutils_tpu_torch.models.zcv import advect_fields, ic_fields, zenbu_native, zenbu_window
    from abacusutils_tpu_torch.models.zcv.apply import apply_zcv
    from abacusutils_tpu_torch.models.zcv.files import read_data
    from abacusutils_tpu_torch.ops import grid as tgrid

    qgrid = np.concatenate([np.geomspace(1e-2, 20.0, 40, endpoint=False), np.arange(20.0, 600.0, 3.0)])
    monkeypatch.setattr(zenbu_native, 'ZAQFuncs',
                        functools.partial(zenbu_native.ZAQFuncs, qgrid=qgrid, nk=768))
    zenbu_native._QF_CACHE.clear()
    nmesh, lbox = 32, 2000.0
    dens, disp = _cv_ic(nmesh, lbox, 8)
    sim = 'AbacusSummit_base_c000_ph000'
    ic = tmp_path / 'ic' / sim
    ic.mkdir(parents=True)
    write_asdf(ic / f'ic_dens_N{nmesh}.asdf', {'data': {'density': dens}, 'header': {'BoxSize': lbox}})
    write_asdf(ic / f'ic_disp_N{nmesh}.asdf',
               {'data': {'displacements': np.stack(disp, -1) * np.float32(lbox)},
                'header': {'BoxSize': lbox}})
    rng = np.random.default_rng(5)
    real = {c: (rng.random(40_000) * lbox - lbox / 2).astype(np.float32) for c in 'xyz'}
    rsd = dict(real, z=((real['z'] + rng.normal(0, 5.0, 40_000) + lbox / 2) % lbox
                        - lbox / 2).astype(np.float32))
    out, tables = {}, {}
    try:
        for where, dev in (('card', cuda_device), ('cpu', torch.device('cpu'))):
            config = _cv_config(nmesh, lbox, 'zcv')
            config['zcv_params'].update(zcv_dir=str(tmp_path / where), ic_dir=str(tmp_path / 'ic'))
            cfg = tmp_path / f'{where}.json'
            cfg.write_text(json.dumps(config))
            k1m, k3 = tgrid.tsc_deposit_cells_multi.launches, tpow.bin_pair_modes.launches
            k8, k1 = zenbu_window.window_mode_sums.launches, tgrid.tsc_deposit_cells.launches
            ic_fields.main(str(cfg), device=dev)
            for want_rsd in (True, False):
                advect_fields.main(str(cfg), want_rsd=want_rsd, device=dev)
            zenbu_window.main(str(cfg), engine='device', device=dev)
            out[where] = apply_zcv(_DeviceBall(lbox, real, dev), {'LRG': rsd}, config)
            if where == 'card':
                assert tgrid.tsc_deposit_cells_multi.launches - k1m == 4
                assert zenbu_window.window_mode_sums.launches - k8 == 1
                assert tgrid.tsc_deposit_cells.launches - k1 == 4
                assert tpow.bin_pair_modes.launches - k3 == 4
            zz = tmp_path / where / sim / 'z0.500'
            tables[where] = {s: read_data(zz / f'power{s}_ij_nmesh{nmesh}.asdf') for s in ('_rsd', '')}
    finally:
        zenbu_native._QF_CACHE.clear()
    for s in ('_rsd', ''):
        for key, r in tables['cpu'][s].items():
            if key.startswith('N_'):
                npt.assert_array_equal(tables['card'][s][key], r)
            elif key.startswith('P_') and '_1cb_1cb' in key or key.endswith('delta_delta'):
                npt.assert_allclose(tables['card'][s][key], r, rtol=1e-3, atol=1e-4 * np.abs(r).max(),
                                    err_msg=key)
    for key in ('Pk_tr_tr_ell', 'Pk_tr_tr_ell_zcv'):
        r = np.asarray(out['cpu'][key])
        npt.assert_allclose(np.asarray(out['card'][key]), r, rtol=1e-3, atol=1e-4 * np.abs(r).max(),
                            err_msg=key)
        assert np.isfinite(out['card'][key]).all()


# ---------------------------------------------------------------------------
# the sharded path's kernel forms (parallel/): K1's slab mode, the binning
# over a ky slab, K5's row offset
# ---------------------------------------------------------------------------


def _rank_points(nmesh, ndev, rank, h, n, box, rng):
    """Points whose TSC centre (K1's f32 cell) lies in rank's x-slab of an
    ndev-way split, or within h - 1 cells past it on each side, a tenth of
    them drawn on cell edges."""
    xl = nmesh // ndev
    lo = rank * xl - (h - 1)
    cell = rng.integers(lo, (rank + 1) * xl + (h - 1), n)
    frac = rng.random(n) - 0.5
    frac[::10] = 0.5
    x = ((cell + frac) * box / nmesh) % box
    pos = np.stack([x, rng.random(n) * box, rng.random(n) * box], 1).astype(np.float32)
    pos[1::10, 1] = box * np.float32(0.999999)  # across the y wrap
    i0, _ = axis_cloud(t(pos[:, 0]), box, 0.0, nmesh)
    keep = ((i0.numpy() - lo) % nmesh) < xl + 2 * (h - 1)
    return pos[keep], rng.random(int(keep.sum())).astype(np.float32)


@pytest.mark.parametrize('h', [1, 2])
@pytest.mark.parametrize('nmesh', [64, 96])
def test_slab_deposit_kernel_matches_plain(cuda_device, nmesh, h):
    """K1's slab mode against its plain version at each rank's geometry of a
    4-way split (slab 0 and slab 3 across the periodic wrap), with the halo
    planes of the fused step (h = 1) and of paint_slab (h = 2): no fault,
    the slab form's launch counted."""
    box, ndev = 700.0, 4
    xl = nmesh // ndev
    rng = np.random.default_rng(nmesh + h)
    for rank in range(ndev):
        pos, w = _rank_points(nmesh, ndev, rank, h, 200_000, box, rng)
        cols = [t(pos[:, i]).to(cuda_device) for i in range(3)] + [t(w).to(cuda_device)]
        slab = (rank * xl, h, xl + 2 * h)
        (x, y, z, ws), plan = stage_bricks(cols, nmesh, box, slab=slab)
        grid = torch.zeros(plan.grid_shape, device=cuda_device)
        fault = torch.zeros(1, dtype=torch.int32, device=cuda_device)
        before = tsc_deposit_cells.launches_by_form['tsc slab']
        tsc_deposit_cells(grid, x, y, z, ws, plan, box, fault=fault)
        assert tsc_deposit_cells.launches_by_form['tsc slab'] == before + 1
        ref = torch.zeros_like(grid)
        assert int(paint_slab_plain(ref, x, y, z, ws, nmesh, box, slab)) == 0 == int(fault)
        _assert_grid(grid, ref)


def test_slab_deposit_kernel_faults_and_overflow(cuda_device):
    """Points whose cloud leaves the slab add nothing and are counted as
    faults, as the plain version counts them; points moved past their tile
    after staging go to the slab's planes directly (the overflow word)."""
    nmesh, box, ndev, h = 64, 700.0, 4, 1
    xl = nmesh // ndev
    rng = np.random.default_rng(3)
    pos, w = _rank_points(nmesh, ndev, 2, h, 100_000, box, rng)
    pos[:500, 0] = rng.random(500) * box  # most of these lie outside slab 2
    cols = [t(pos[:, i]).to(cuda_device) for i in range(3)] + [t(w).to(cuda_device)]
    slab = (2 * xl, h, xl + 2 * h)
    (x, y, z, ws), plan = stage_bricks(cols, nmesh, box, slab=slab)
    z = z + 3.0 * box / nmesh
    grid = torch.zeros(plan.grid_shape, device=cuda_device)
    fault = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    overflow = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    tsc_deposit_cells(grid, x, y, z, ws, plan, box, 0.0, overflow, fault=fault)
    ref = torch.zeros_like(grid)
    want_fault = int(paint_slab_plain(ref, x, y, z, ws, nmesh, box, slab))
    assert int(fault) == want_fault > 300
    assert int(overflow) == int(overflow_count_plain(x, y, z, ws, plan, box)) > 0
    _assert_grid(grid, ref)
    with pytest.raises(ValueError, match='outside the slab'):
        tsc_deposit_cells(torch.zeros_like(grid), x, y, z, ws, plan, box)


@pytest.mark.parametrize('npoles', [0, 2])
@pytest.mark.parametrize('n1d,ndev', [(48, 4), (45, 3)])
def test_slab_binning_kernel_matches_plain(cuda_device, n1d, ndev, npoles):
    """The binning kernel over each ky slab of an ndev-way split (the plan of
    yslab=, W read at y0 + iy, the pole rows' |k| from the global iy), on
    contiguous slabs (the groups along y) and on x-fastest copies (along
    x), against its plain version, and the slabs' sums add up to the whole
    mesh's binning."""
    lbox, nk, nmu = 700.0, n1d // 2, 2 if npoles else 1
    kedges, muedges = tpow.get_k_mu_edges(lbox, np.pi * n1d / lbox, nk, nmu, False)
    dk = 2 * np.pi / lbox
    k2, m2 = ((kedges / dk) ** 2).astype(np.float32), (muedges**2).astype(np.float32)
    poles = (2, 4)[:npoles]
    rng = np.random.default_rng(n1d + npoles)
    base = rng.normal(size=(n1d,) * 3).astype(np.float32)
    dks = [torch.fft.rfftn(t(base + 0.5 * rng.normal(size=base.shape).astype(np.float32))
                           .to(cuda_device)) for _ in range(3)]
    W = t(get_W_compensated(lbox, n1d, 'TSC', False).astype(np.float32)).to(cuda_device)
    full = tpow.get_mode_bin_plan(n1d, k2, m2, poles, cuda_device)
    want = bin_pair_modes(dks, full.seg, W, 1.0 / n1d**3, nk * nmu, full.pole_w or None, nmu)
    total = None
    yl = n1d // ndev
    for r in range(ndev):
        ys = (r * yl, (r + 1) * yl)
        sp = tpow.get_mode_bin_plan(n1d, k2, m2, poles, cuda_device, yslab=ys)
        local = [d[:, ys[0]:ys[1]].contiguous() for d in dks]
        before = bin_pair_modes.launches_by_form.get(f'{"poles nmu=2" if npoles else "no poles"} '
                                                     'ky slab', 0)
        got = bin_pair_modes(local, sp.seg, W, 1.0 / n1d**3, nk * nmu, sp.pole_w or None, nmu,
                             yslab=ys)
        key = f'{"poles nmu=2" if npoles else "no poles"} ky slab'
        assert bin_pair_modes.launches_by_form[key] == before + 1
        ref = bin_pair_modes_plain([d.cpu() for d in local], sp.seg.cpu(), W.cpu(), 1.0 / n1d**3,
                                   nk * nmu, {p: v.cpu() for p, v in sp.pole_w.items()} or None,
                                   nmu, yslab=ys)
        # the same rows laid out x fastest, as parallel/fft.py:slab_rfftn
        # leaves them: the work list along x
        xf = [_x_fastest(r) for r in local]
        before = bin_pair_modes.launches_by_form.get(f'{key} x-grouped', 0)
        got_x = bin_pair_modes(xf, sp.seg, W, 1.0 / n1d**3, nk * nmu, sp.pole_w or None, nmu,
                               yslab=ys)
        assert bin_pair_modes.launches_by_form[f'{key} x-grouped'] == before + 1
        got = got if npoles else (got,)
        got_x = got_x if npoles else (got_x,)
        ref = ref if npoles else (ref,)
        for g, gx, f in zip(got, got_x, ref):
            g, gx, f = g.cpu().numpy(), gx.cpu().numpy(), f.numpy()
            npt.assert_allclose(g, f, rtol=1e-5, atol=1e-5 * np.abs(f).max())
            npt.assert_allclose(gx, f, rtol=1e-5, atol=1e-5 * np.abs(f).max())
        total = [g.clone() for g in got] if total is None else [a + g for a, g in zip(total, got)]
    want = want if npoles else (want,)
    for a, f in zip(total, want):
        f = f.cpu().numpy()
        npt.assert_allclose(a.cpu().numpy(), f, rtol=1e-5, atol=1e-5 * np.abs(f).max())


def _x_fastest(rows):
    """A copy of the (n1d, ny, n1d/2+1) `rows` laid out x fastest, then y,
    kz slowest."""
    n1d, ny, kzlen = rows.shape
    out = torch.empty((kzlen, ny, n1d), dtype=rows.dtype, device=rows.device)
    return out.permute(2, 1, 0).copy_(rows)


def _rank_spectra(grids, split):
    """What parallel/fft.py:slab_rfftn leaves on each rank of a `split`-way
    split of the ky rows (ceil(n1d / split) a rank, the last one ragged):
    the rfft along z and fft along y of the whole grids, the rank's rows made
    contiguous (the transpose's all_to_all_single and cat), then the fft
    along x. Returns [((y0, y1), [field a grid])]."""
    n1d = grids[0].shape[0]
    cs = [torch.fft.fft(torch.fft.rfft(g, dim=2), dim=1) for g in grids]
    yl = -(-n1d // split)
    return [((y0, min(y0 + yl, n1d)),
             [torch.fft.fft(c[:, y0:y0 + yl].contiguous(), dim=0) for c in cs])
            for y0 in range(0, n1d, yl)]


@pytest.mark.parametrize('npoles', [0, 2])
@pytest.mark.parametrize('nfields', [1, 3])
@pytest.mark.parametrize('n1d', [45, 48])
def test_slab_binning_kernel_on_slab_rfftn_output(cuda_device, tmp_path, n1d, nfields, npoles):
    """The binning kernel on parallel/fft.py:slab_rfftn's own output at world
    size one, and on each rank's rows of a 3- and a 4-way split laid out as
    slab_rfftn lays them: the launch runs the groups along x (counted under
    its ' x-grouped' form), equals its plain version at the tolerances of
    test_slab_binning_kernel_matches_plain, gives the same bits twice, and
    the slabs' sums add up to the whole mesh's binning."""
    import torch.distributed as dist

    from abacusutils_tpu_torch.parallel.fft import slab_rfftn
    from abacusutils_tpu_torch.parallel.mesh import init_world, make_mesh

    lbox, nk, nmu = 700.0, n1d // 2, 2 if npoles else 1
    kedges, muedges = tpow.get_k_mu_edges(lbox, np.pi * n1d / lbox, nk, nmu, False)
    dk = 2 * np.pi / lbox
    k2, m2 = ((kedges / dk) ** 2).astype(np.float32), (muedges**2).astype(np.float32)
    poles = (2, 4)[:npoles]
    rng = np.random.default_rng(10 * n1d + nfields + npoles)
    base = rng.normal(size=(n1d,) * 3).astype(np.float32)
    grids = [t(base + 0.5 * rng.normal(size=base.shape).astype(np.float32)).to(cuda_device)
             for _ in range(nfields)]
    W = t(get_W_compensated(lbox, n1d, 'TSC', False).astype(np.float32)).to(cuda_device)
    scale = 1.0 / n1d**3
    full = tpow.get_mode_bin_plan(n1d, k2, m2, poles, cuda_device)
    want = bin_pair_modes([torch.fft.rfftn(g) for g in grids], full.seg, W, scale, nk * nmu,
                          full.pole_w or None, nmu)
    want = [w.cpu().numpy() for w in (want if npoles else (want,))]
    init_world(0, 1, f'file://{tmp_path / "store"}', 'cuda', 0)
    try:
        whole = [slab_rfftn(g, make_mesh()) for g in grids]
    finally:
        dist.destroy_process_group()
    assert whole[0].stride()[0] == 1, whole[0].stride()
    key = f'{"poles nmu=2" if npoles else "no poles"} ky slab x-grouped'
    for split, ranks in ((1, [((0, n1d), whole)]), (3, _rank_spectra(grids, 3)),
                         (4, _rank_spectra(grids, 4))):
        total = None
        for ys, fields in ranks:
            sp = tpow.get_mode_bin_plan(n1d, k2, m2, poles, cuda_device, yslab=ys)
            pole_w = sp.pole_w or None

            def run():
                return bin_pair_modes(fields, sp.seg, W, scale, nk * nmu, pole_w, nmu, yslab=ys)

            before = bin_pair_modes.launches_by_form.get(key, 0)
            got = run()
            assert bin_pair_modes.launches_by_form[key] == before + 1, (split, ys)
            again = run()
            got, again = (got, again) if npoles else ((got,), (again,))
            assert all(torch.equal(a, g) for a, g in zip(again, got)), (split, ys)
            ref = bin_pair_modes_plain([f.cpu() for f in fields], sp.seg.cpu(), W.cpu(), scale,
                                       nk * nmu, {p: v.cpu() for p, v in sp.pole_w.items()}
                                       or None, nmu, yslab=ys)
            ref = ref if npoles else (ref,)
            for g, f in zip(got, ref):
                f = f.numpy()
                npt.assert_allclose(g.cpu().numpy(), f, rtol=1e-5, atol=1e-5 * np.abs(f).max(),
                                    err_msg=f'{split}-way, rows {ys}')
            if nfields == 1 and not npoles:
                k2_got = bin_power_modes(fields[0], sp.seg, W, scale, nk, yslab=ys)
                f = ref[0][0].numpy()
                npt.assert_allclose(k2_got.cpu().numpy(), f, rtol=1e-5,
                                    atol=1e-5 * np.abs(f).max())
            total = [g.clone() for g in got] if total is None else [a + g for a, g in
                                                                   zip(total, got)]
        for a, f in zip(total, want):
            npt.assert_allclose(a.cpu().numpy(), f, rtol=1e-5, atol=1e-5 * np.abs(f).max(),
                                err_msg=f'{split}-way')


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64], ids=['f32', 'f64'])
def test_all_pairs_kernel_row_offset(cuda_device, dtype):
    """K5 with a global row offset: each row shard of an autocorrelation
    against the whole set equals its plain version bin for bin, and the
    shards add up to the autocorrelation."""
    lbox = 400.0
    cols = [c.to(dtype) for c in _clustered(12_000, lbox, 5, cuda_device)]
    e2 = PAIR_EDGES0**2
    thr = ttpcf.edges_f32(e2) if dtype == torch.float32 else e2
    for mode, nb2, aux in _pair_modes():
        whole = ttpcf.count_pairs_all(cols, None, thr, nb2, mode, lbox, aux)
        total = torch.zeros_like(whole)
        for a, b in ((0, 4000), (4000, 9001), (9001, 12_000)):
            part = [c[a:b].contiguous() for c in cols]
            got = ttpcf.count_pairs_all(part, cols, thr, nb2, mode, lbox, aux, row0=a)
            ref = ttpcf.count_pairs_all_plain(part, cols, thr, nb2, mode, lbox, aux,
                                              max_pairs=1 << 24, row0=a)
            assert torch.equal(got, ref), (mode, a)
            total += got
        assert int(whole.sum()) > 0 and torch.equal(total, whole), mode


def test_gloo_mesh_refuses_cuda_tensors(cuda_device, gloo_mesh):
    """A CUDA tensor on a gloo mesh raises: nothing is staged through the
    host."""
    from abacusutils_tpu_torch.parallel.mesh import all_reduce

    with pytest.raises(ValueError, match='cuda tensor on a cpu mesh'):
        all_reduce(torch.ones(3, device=cuda_device), gloo_mesh)


def test_abacus_hod_mesh_on_the_default_device(cuda_device):
    """run_hod_pk_fused(mesh=make_mesh()) on an object built with the
    package's default device, 'cuda' with no index (what from_config's
    device=None gives): the mesh's card is that device, and both modes equal
    the unsharded call (spectra at rtol 2e-4, crosses at 2e-4 of
    sqrt(P_ii P_jj), n_gal equal)."""
    import torch.distributed as dist

    from abacusutils_tpu_torch.parallel.mesh import make_mesh

    state = staged_state(30_000, 120_000, 500.0, seed=37)
    params = {'z': 0.5, 'Lbox': 500.0, 'velz2kms': 100.0, 'origin': None}
    flags = dict(want_shear=False, want_ranks=False, halo_lc=False)
    hod = staged_state_from_numpy(*state, params, TRACERS, flags, 'cuda')
    assert hod.device.index is None
    ref, ng = hod.run_hod_pk_fused(nmesh=32, nbins_k=16)
    try:
        mesh = make_mesh()
        for slab in (False, True):
            got, ng_s = hod.run_hod_pk_fused(nmesh=32, nbins_k=16, mesh=mesh, slab=slab)
            assert ng_s == ng and set(got) == set(ref)
            for key, r in ref.items():
                t1, _, t2 = key.partition('_')
                if key.endswith('_modes') or key == 'k_binc':
                    npt.assert_array_equal(got[key], r)
                elif t1 == t2:
                    npt.assert_allclose(got[key], r, rtol=2e-4)
                else:
                    scale = np.sqrt(np.abs(ref[f'{t1}_{t1}'] * ref[f'{t2}_{t2}']))
                    assert (np.abs(got[key] - r) <= 2e-4 * scale).all(), (slab, key)
    finally:
        dist.destroy_process_group()


def test_two_step_xirppi_counts_its_transfers(cuda_device):
    """run_hod -> compute_xirppi on the card, the flat stage cached: the
    transfer counters read 48 B a galaxy and the fixed bytes, exactly. Up:
    the prepared HOD parameters (4 B each) and the mock's x, y, z (12 B a
    galaxy); down: six float32 phase-space columns, the float32 mass and the
    int64 id (36 B a galaxy, each through a page-locked buffer of its own
    size) and the int64 (rp, unit pi) counts."""
    from abacusutils_tpu_torch.utils import profiling

    halo, part = staged_state(30_000, 120_000, 500.0, seed=43)
    halo['hmass'], part['phmass'] = (a.astype(np.float32) for a in (halo['hmass'], part['phmass']))
    params = {'z': 0.5, 'Lbox': 500.0, 'velz2kms': 100.0, 'origin': None}
    tracers = {'LRG': TRACERS['LRG']}
    hod = staged_state_from_numpy(halo, part, params, tracers, dict(halo_lc=False), cuda_device)
    rpbins = np.logspace(-1, np.log10(30), 9)
    hod.compute_xirppi(hod.run_hod(), rpbins, 30, 5)
    before = dict(profiling.counters)
    mock = hod.run_hod()
    hod.compute_xirppi(mock, rpbins, 30, 5)
    got = {k: profiling.counters[k] - before.get(k, 0)
           for k in ('h2d_bytes', 'd2h_bytes', 'pinned_bytes')}
    ngal = len(mock['LRG']['x'])
    assert ngal > 1000
    nparams = len(prepare_tracer_params(tracers, 0.5)['LRG'])
    counts = 8 * (len(rpbins) - 1) * 30
    assert got == {'h2d_bytes': 4 * nparams + 12 * ngal, 'd2h_bytes': 36 * ngal + counts,
                   'pinned_bytes': 36 * ngal}


def _code_levels(cat, tp, want, form, host_codes=None):
    """The running marker sums the plain keep codes compare each random
    with, one a wanted tracer, by the plain version's own ops."""
    levels, marker = [], torch.zeros_like(cat['mass' if form == 'centrals' else 'hmass'])
    for tracer in tpop.TRACER_ORDER:
        if tracer not in want:
            continue
        p = tp[tracer]
        if form == 'centrals':
            m = tpop._cent_marker(tracer, p, cat['mass'], cat['deltac'], cat['fenv'],
                                  cat.get('shear', 0.0)) * cat['multis']
        else:
            m = tpop._sat_base(tracer, p, cat['hmass'], cat['deltac'], cat['fenv'],
                               cat.get('shear', 0.0), host_codes) * cat['weights'] * p['ic']
            if 'ranks' in cat:
                m = m * tpop._rank_multiplier(p, cat)
        marker = marker + m
        levels.append(marker)
    return levels


def _tie_randoms(cat, levels, every=7):
    """Set every `every`-th object's random to one of its marker levels,
    exactly, the levels taken in turn: a tie that <= keeps."""
    idx = torch.arange(0, cat['randoms'].numel(), every, device=cat['randoms'].device)
    for j, level in enumerate(levels):
        sel = idx[j::len(levels)]
        cat['randoms'][sel] = level[sel]


def _kernel_and_plain_codes(halo, part, hidx, tp, want):
    """Both forms by the kernel (the satellites through host_at and through
    a per-particle column) and by the plain versions; checks one launch a
    form a call."""
    counts = tpop.keep_codes_kernel.launches_by_form
    before = dict(counts)
    keep_c = tpop._cent_codes(halo, tp, want)
    assert counts['centrals'] == before['centrals'] + 1
    keep_s = tpop._sat_codes(part, tp, want, keep_c, host_at=hidx)
    keep_s2 = tpop._sat_codes(part, tp, want, keep_c[hidx])
    assert counts['satellites'] == before['satellites'] + 2
    plain_c = tpop.cent_codes_plain(halo, tp, want)
    plain_s = tpop.sat_codes_plain(part, tp, want, plain_c[hidx])
    return (keep_c, keep_s, keep_s2), (plain_c, plain_s)


@pytest.mark.parametrize('ranks', [False, True], ids=['no ranks', 'ranks'])
@pytest.mark.parametrize('want', CODE_WANTS, ids='+'.join)
def test_keep_code_kernel_matches_plain(cuda_device, want, ranks):
    """csrc/hod_codes.cu against the plain ATen chain, bit for bit, on 1e6
    halos and 5e6 particles (neither a multiple of the kernel's 4 objects a
    thread) with deltac, fenv and shear, every tracer subset, with and
    without the rank columns; every 7th random set exactly to one of its
    marker levels (a tie); the satellites read their host codes through
    host_at and from a per-particle column."""
    halo, part, hidx, tp = code_catalogs(1_000_003, 5_000_001, seed=len(want) + 10 * ranks,
                                         device=cuda_device, ranks=ranks)
    _tie_randoms(halo, _code_levels(halo, tp, want, 'centrals'))
    host = tpop.cent_codes_plain(halo, tp, want)[hidx]
    _tie_randoms(part, _code_levels(part, tp, want, 'satellites', host))
    (keep_c, keep_s, keep_s2), (plain_c, plain_s) = _kernel_and_plain_codes(
        halo, part, hidx, tp, want)
    for got, ref, form in ((keep_c, plain_c, 'centrals'), (keep_s, plain_s, 'satellites'),
                           (keep_s2, plain_s, 'satellites, per-particle host codes')):
        assert got.dtype == torch.int8
        assert torch.equal(got, ref), f'{form}: {int((got != ref).sum())} codes differ'
    for got in (plain_c, plain_s):
        codes = set(got.unique().tolist())
        assert {tpop.TRACER_ORDER.index(w) + 1 for w in want} | {0} == codes


def test_keep_code_kernel_edges(cuda_device):
    """The kernel's edges, each against the plain version: no objects (no
    launch), 1 to 9 objects (the scalar tail of a thread), columns that
    start 4 B past a 16-B boundary (no float4 loads), halos at
    x = M - kappa Mcut < 0, = 0 and just above, no shear column, and
    every wrong argument refused before a launch."""
    halo, part, hidx, tp = code_catalogs(20_011, 80_013, seed=3, device=cuda_device, shear=False)
    want = tpop.TRACER_ORDER
    counts = tpop.keep_codes_kernel.launches_by_form
    before = dict(counts)
    empty_h = {k: v[:0] for k, v in halo.items()}
    empty_p = {k: v[:0] for k, v in part.items()}
    assert tpop._cent_codes(empty_h, tp, want).shape == (0,)
    assert tpop._sat_codes(empty_p, tp, want, torch.zeros(0, dtype=torch.int8,
                                                           device=cuda_device),
                           host_at=hidx[:0]).shape == (0,)
    assert counts == before
    # x < 0, x = 0 and x > 0 of each tracer's satellite power law at the
    # halo's own deltac and fenv: masses at kappa 10**logM_cut and one ulp
    # either side (the f32 sum of logM_cut is recomputed as the kernel does)
    for i, tracer in enumerate(tpop.TRACER_ORDER):
        p = tp[tracer]
        lc = p['logM_cut'] + p['Acent'] * part['deltac'] + p['Bcent'] * part['fenv']
        edge = p['kappa'] * 10**lc
        sl = slice(3 * i * 1000, (3 * i + 3) * 1000)
        part['hmass'][sl] = torch.cat([torch.nextafter(edge[sl][:1000], edge[sl][:1000] * 0),
                                       edge[sl][1000:2000],
                                       torch.nextafter(edge[sl][2000:], edge[sl][2000:] * 2)])
    for n in (1, 2, 3, 4, 5, 7, 9, 20_011):
        h = {k: v[:n] for k, v in halo.items()}
        m = min(4 * n, part['hmass'].numel())
        pt = {k: v[:m] for k, v in part.items()}
        (kc, ks, ks2), (pc, ps) = _kernel_and_plain_codes(h, pt, hidx[:m] % n, tp, want)
        assert torch.equal(kc, pc) and torch.equal(ks, ps) and torch.equal(ks2, ps), n
    # one float past a 16-B boundary: the scalar loads
    h = {k: v[1:] for k, v in halo.items()}
    pt = {k: v[1:] for k, v in part.items()}
    assert all(v.data_ptr() % 16 == 4 for v in (*h.values(), *pt.values()))
    (kc, ks, ks2), (pc, ps) = _kernel_and_plain_codes(h, pt, (hidx[1:] - 1).clamp(min=0), tp,
                                                      want)
    assert torch.equal(kc, pc) and torch.equal(ks, ps) and torch.equal(ks2, ps)
    before = dict(counts)
    bad = dict(halo, randoms=halo['randoms'].double())
    with pytest.raises(ValueError, match='randoms'):
        tpop._cent_codes(bad, tp, want)
    with pytest.raises(ValueError, match='mass'):
        tpop._cent_codes(dict(halo, mass=halo['mass'][::2]), tp, want)
    with pytest.raises(ValueError, match='host_at'):
        tpop._sat_codes(part, tp, want, torch.zeros(20_011, dtype=torch.int8,
                                                    device=cuda_device), host_at=hidx.long())
    with pytest.raises(ValueError, match='parameter'):
        tpop._cent_codes(halo, {k: {kk: vv.double() for kk, vv in v.items()}
                                for k, v in tp.items()}, want)
    with pytest.raises(ValueError, match='central codes'):
        tpop._sat_codes(part, tp, ('ELG',), None)
    assert counts == before
