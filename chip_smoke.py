#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's fused HOD step on one GPU and check its kernels.

    python3 chip_smoke.py

Phases, each printing what it measured:

1. device, torch and CUDA versions, the card's name and power limit; build
   the CUDA kernels from ``abacusutils_tpu_torch/csrc`` (nvcc, sm_90a);
2. K1, the TSC deposit, against its plain PyTorch version on ~4e6 points
   placed on cell and y-block edges and across the periodic wrap;
3. K2, the P(k) mode binning, against its plain version on a 256^3 rfft mesh;
4. the step at bench scale (1e7 halos + 5e7 particles, nmesh=256, yb=32,
   128 k-bins): staging, one warm and 3x5 timed steps through the kernels
   (both launch counters must rise by 2 and 1 per step), each kernel timed
   against its plain version at the step's shapes, and the whole step held
   against the same step built from the plain versions.

The line before the last is a JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``. Without CUDA, or when any phase
fails, the script exits non-zero before printing either.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

from abacusutils_tpu_torch import _build
from abacusutils_tpu_torch.models.pipeline import (
    group_inputs2d_device,
    hod_pk_fused_yb,
    make_bin_plan_arrays,
    make_example_inputs_device,
    populate_weights,
)
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

N_HALO = 10_000_000
N_PART = 50_000_000
LBOX = 2000.0
NMESH = 256
YB = 32
NBINS_K = NMESH // 2
VELZ2KMS = 100.0
SEED = 42
N_EDGE = 4_000_000


class PhaseError(RuntimeError):
    pass


def require(cond, msg):
    if not cond:
        raise PhaseError(msg)


def sync_seconds(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def event_ms(fn, reps=5):
    """Mean device time of `fn` over `reps` calls after one warm-up call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_build():
    print('torch', torch.__version__, 'cuda', torch.version.cuda, 'python', sys.version.split()[0])
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print('nvidia-smi:', smi)
    print('device:', torch.cuda.get_device_name(0), 'count', torch.cuda.device_count())
    path, secs, log = _build.build()
    for line in log.splitlines():
        if 'registers' in line or 'Compiling entry' in line:
            print('ptxas:', line.strip())
    _build.lib()
    print(f'phase 1 build: {path.name} in {secs:.2f} s')


def phase_k1(dev):
    rng = np.random.default_rng(SEED)
    pos = edge_points(N_EDGE, NMESH, YB, LBOX, rng)
    w = rng.random(N_EDGE).astype(np.float32)
    w[::5] = 0.0
    cols = [torch.from_numpy(pos[:, i].copy()).to(dev) for i in range(3)]
    wt = torch.from_numpy(w).to(dev)
    (x, y, z, ws), starts = stage_grouped2d(cols + [wt], NMESH, LBOX, YB)
    err = torch.zeros(1, dtype=torch.int32, device=dev)
    grid_k = torch.zeros((NMESH,) * 3, device=dev)
    tsc_deposit_cells(grid_k, x, y, z, ws, starts, NMESH, YB, LBOX, 0.0, err=err)
    grid_p = paint_3d_plain(torch.zeros_like(grid_k), *cols, wt, NMESH, LBOX)
    torch.cuda.synchronize()
    n_err = int(err.item())
    diff = float((grid_k - grid_p).abs().max())
    gmax = float(grid_p.abs().max())
    mass_k, mass_p = float(grid_k.double().sum()), float(grid_p.double().sum())
    print(
        f'phase 2 K1 vs plain: {N_EDGE} edge points, err word {n_err}, '
        f'max|d| {diff:.3e} (max|grid| {gmax:.4f}), mass {mass_k:.6f} vs {mass_p:.6f}'
    )
    require(n_err == 0, f'K1 error word {n_err}')
    require(diff <= 1e-5 * gmax, f'K1 max|d| {diff} > 1e-5 * {gmax}')
    require(abs(mass_k - mass_p) <= 1e-6 * abs(mass_p), 'K1 total mass differs')
    return grid_p


def phase_k2(grid, seg, W):
    delta = grid * (grid.numel() / grid.sum()) - 1.0
    dk = torch.fft.rfftn(delta)
    scale = 1.0 / grid.numel()
    got = bin_power_modes(dk, seg, W, scale, NBINS_K)
    ref = bin_power_modes_plain(dk, seg, W, scale, NBINS_K)
    torch.cuda.synchronize()
    rel = float(((got - ref).abs() / ref.abs().clamp_min(1e-30)).max())
    print(f'phase 3 K2 vs plain: {dk.numel()} modes, {NBINS_K} bins, max rel {rel:.3e}')
    require(bool(torch.isfinite(got).all()), 'K2 output not finite')
    require(bool(((got - ref).abs() <= 1e-5 * ref.abs()).all()), f'K2 max rel {rel} > 1e-5')


def deposit_inputs(halo_g, part_g, sh, sp, params):
    """The step's populate pass, as (x, y, z, weight, starts) per catalog,
    in the box frame the deposit takes."""
    inv_v = float(np.float32(1.0) / np.float32(VELZ2KMS))
    half = float(np.float32(LBOX) / 2)
    z_c, keep_c, z_s, keep_s = populate_weights(halo_g, part_g, params, True, inv_v)
    return [
        (halo_g['x'] + half, halo_g['y'] + half, z_c + half, keep_c, sh),
        (part_g['x'] + half, part_g['y'] + half, z_s + half, keep_s, sp),
    ]


def plain_step(dep, seg, W):
    """The step from the plain versions only (no kernel launches)."""
    n_gal = dep[0][3].sum() + dep[1][3].sum()
    grid = torch.zeros((NMESH,) * 3, device=n_gal.device)
    for x, y, z, w, _ in dep:
        paint_3d_plain(grid, x, y, z, w, NMESH, LBOX)
    delta = grid * (grid.numel() / n_gal) - 1.0
    wsum = bin_power_modes_plain(torch.fft.rfftn(delta), seg, W, 1.0 / grid.numel(), NBINS_K)
    return wsum, n_gal


def phase_step(dev, seg, W):
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    (halo, part, params), t_in = sync_seconds(
        lambda: make_example_inputs_device(N_HALO, N_PART, LBOX, gen, dev)
    )
    stage = lambda: (  # noqa: E731
        group_inputs2d_device(halo, NMESH, LBOX, YB), group_inputs2d_device(part, NMESH, LBOX, YB)
    )
    t_stage_cold = sync_seconds(stage)[1]  # frees the cold result before the warm run
    ((halo_g, sh), (part_g, sp)), t_stage = sync_seconds(stage)
    del halo, part
    print(f'phase 4 inputs {t_in:.3f} s, staging cold {t_stage_cold:.3f} s warm {t_stage:.3f} s')

    err = torch.zeros(1, dtype=torch.int32, device=dev)

    def step():
        return hod_pk_fused_yb(
            halo_g, part_g, params, seg, W, LBOX, VELZ2KMS, NMESH, YB, NBINS_K, sh, sp,
            rsd=True, err=err,
        )

    torch.cuda.reset_peak_memory_stats()
    tsc_deposit_cells.launches = 0
    bin_power_modes.launches = 0
    (wsum, n_gal), t_warm = sync_seconds(step)
    n_iter, best = 5, float('inf')
    for _ in range(3):
        _, dt = sync_seconds(lambda: [step() for _ in range(n_iter)])
        best = min(best, dt / n_iter)
    launches = {
        'tsc_deposit_cells': tsc_deposit_cells.launches,
        'bin_power_modes': bin_power_modes.launches,
    }
    n_steps = 1 + 3 * n_iter
    peak = torch.cuda.max_memory_allocated()
    check_deposit_err(err)
    n_gal_v = float(n_gal)
    print(
        f'phase 4 step: n_gal {n_gal_v:.0f}, step_seconds {best:.6f} (warm-up {t_warm:.3f} s), '
        f'galaxies/s {n_gal_v / best:.6e}, peak memory {peak / 2**30:.3f} GiB, launches {launches}'
    )
    require(launches['tsc_deposit_cells'] == 2 * n_steps, f'K1 launches {launches}')
    require(launches['bin_power_modes'] == n_steps, f'K2 launches {launches}')
    require(bool(torch.isfinite(wsum).all() & (wsum >= 0).all()), 'wsum not finite and >= 0')
    require(float(wsum.sum()) > 0 and n_gal_v > 0, 'empty step')

    # each kernel against its plain version at the step's shapes
    dep = deposit_inputs(halo_g, part_g, sh, sp, params)
    grid_k = torch.zeros((NMESH,) * 3, device=dev)
    grid_p = torch.zeros_like(grid_k)

    def k1():
        grid_k.zero_()
        for x, y, z, w, st in dep:
            tsc_deposit_cells(grid_k, x, y, z, w, st, NMESH, YB, LBOX, 0.0, err=err)

    def p1():
        grid_p.zero_()
        for x, y, z, w, _ in dep:
            paint_3d_plain(grid_p, x, y, z, w, NMESH, LBOX)

    k1_ms, p1_ms = event_ms(k1), event_ms(p1)
    check_deposit_err(err)
    k1_err = float((grid_k - grid_p).abs().max())
    print(f'phase 4 K1 at step shapes: {k1_ms:.4f} ms vs plain {p1_ms:.4f} ms, max|d| {k1_err:.3e}')
    require(k1_err <= 1e-5 * float(grid_p.abs().max()), 'K1 disagrees at step shapes')

    dk = torch.fft.rfftn(grid_k * (grid_k.numel() / n_gal) - 1.0)
    scale = 1.0 / grid_k.numel()
    k2_ms = event_ms(lambda: bin_power_modes(dk, seg, W, scale, NBINS_K))
    p2_ms = event_ms(lambda: bin_power_modes_plain(dk, seg, W, scale, NBINS_K))
    got = bin_power_modes(dk, seg, W, scale, NBINS_K)
    ref = bin_power_modes_plain(dk, seg, W, scale, NBINS_K)
    k2_err = float((got - ref).abs().max())
    print(f'phase 4 K2 at step shapes: {k2_ms:.4f} ms vs plain {p2_ms:.4f} ms, max|d| {k2_err:.3e}')
    require(bool(((got - ref).abs() <= 1e-5 * ref.abs()).all()), 'K2 disagrees at step shapes')

    # the whole step against the step built from the plain versions
    (wsum_p, n_gal_p), t_plain = sync_seconds(lambda: plain_step(dep, seg, W))
    rel = float(((wsum - wsum_p).abs() / wsum_p.abs().clamp_min(1e-30)).max())
    print(f'phase 4 plain step {t_plain:.3f} s: n_gal {float(n_gal_p):.0f}, wsum max rel {rel:.3e}')
    require(float(n_gal_p) == n_gal_v, 'n_gal differs from the plain step')
    require(bool(((wsum - wsum_p).abs() <= 1e-4 * wsum_p.abs()).all()), f'wsum rel {rel} > 1e-4')

    return [
        {
            'name': 'tsc_deposit_cells', 'route': 'cuda',
            'source': 'abacusutils_tpu_torch/csrc/tsc_deposit.cu',
            'replaces': 'abacusutils_tpu/ops/grid_pallas.py:92',
            'launches': launches['tsc_deposit_cells'], 'max_abs_err': k1_err,
            'ms': k1_ms, 'plain_ms': p1_ms,
        },
        {
            'name': 'bin_power_modes', 'route': 'cuda',
            'source': 'abacusutils_tpu_torch/csrc/mode_bin.cu',
            'replaces': 'abacusutils_tpu/ops/power.py:396',
            'launches': launches['bin_power_modes'], 'max_abs_err': k2_err,
            'ms': k2_ms, 'plain_ms': p2_ms,
        },
    ]


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    dev = torch.device('cuda', 0)
    torch.cuda.set_device(dev)
    try:
        phase_build()
        seg, _ = make_bin_plan_arrays(NMESH, LBOX, NBINS_K, dev)
        W = get_W_compensated(LBOX, NMESH, 'TSC', False).astype(np.float32)
        W = torch.from_numpy(W).to(dev)
        grid = phase_k1(dev)
        phase_k2(grid, seg, W)
        del grid
        kernels = phase_step(dev, seg, W)
    except PhaseError as e:
        print(f'chip_smoke: FAILED: {e}', file=sys.stderr)
        return 1
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({
        'ok': True,
        'device': {
            'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
            'count': torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == '__main__':
    sys.exit(main())
