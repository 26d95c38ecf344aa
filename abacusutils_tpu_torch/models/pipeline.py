r"""Fused HOD-populate -> paint -> P(k) step (PyTorch + CUDA kernels).

Counterpart of abacusutils_tpu/models/pipeline.py for the single-tracer
(LRG) step ``hod_pk_fused_yb``. The step is static-shape, as on the TPU:
population produces a keep weight and an RSD z for every halo and particle,
and the deposit consumes the weights, so no galaxy catalog is compacted and
nothing waits for the host.

The catalogs are staged once by :func:`group_inputs2d_device`: one stable
sort by (x-cell, y-block), both of which RSD along z never changes. The
deposit kernel reads the sorted columns and the per-cell starts as they
are; there is no padded (ncell, K) layout.
"""

import numpy as np
import torch

from ..convert import params_to_tensors
from ..ops.grid import _f32, stage_grouped2d, tsc_deposit_cells
from ..ops.power import bin_power_modes, get_k_mu_edges, mode_bin_plan
from .hod.population import _cent_marker, _sat_base

__all__ = [
    'make_bin_plan_arrays',
    'populate_weights',
    'group_inputs2d_device',
    'hod_pk_fused_yb',
    'make_example_inputs',
    'make_example_inputs_device',
]

def make_bin_plan_arrays(nmesh, lbox, nbins_k, device):
    """Mode-binning plan of a monopole P(k) with `nbins_k` linear k bins up
    to the Nyquist frequency: (seg, counts), seg an int32 tensor on `device`
    with one bin per rfft mode, counts the (nbins_k,) float64 numpy mode
    counts (models/pipeline.py:make_bin_plan_arrays)."""
    kedges, muedges = get_k_mu_edges(lbox, np.pi * nmesh / lbox, nbins_k, 1, False)
    dk = 2 * np.pi / lbox
    seg, counts = mode_bin_plan(
        int(nmesh),
        ((kedges / dk) ** 2).astype(np.float32),
        (muedges**2).astype(np.float32),
    )
    return torch.from_numpy(seg).to(device), counts.reshape(-1)


def _cent_weight(p, mass, deltac, fenv, multis):
    return _cent_marker('LRG', p, mass, deltac, fenv, None) * multis


def _sat_weight(p, mass, deltac, fenv, pweights):
    return _sat_base('LRG', p, mass, deltac, fenv, None, None) * pweights * p['ic']


def populate_weights(halo, part, p, rsd, inv_velz2kms):
    """LRG populate pass: keep weights (0/1 float32) and RSD z for centrals
    and satellites. z is not wrapped here; the deposit wraps it once."""
    marker_c = _cent_weight(p, halo['mass'], halo['deltac'], halo['fenv'], halo['multis'])
    keep_c = (halo['randoms'] <= marker_c).to(torch.float32)
    vz_c = halo['vz'] + p['alpha_c'] * halo['vdevz']
    z_c = halo['z'] + (vz_c * inv_velz2kms if rsd else 0.0)

    marker_s = _sat_weight(p, part['hmass'], part['deltac'], part['fenv'], part['weights'])
    keep_s = (part['randoms'] <= marker_s).to(torch.float32)
    vz_s = part['hvelz'] + p['alpha_s'] * (part['vz'] - part['hvelz'])
    z_s = part['z'] + (vz_s * inv_velz2kms if rsd else 0.0)
    return z_c, keep_c, z_s, keep_s


def group_inputs2d_device(cat, nmesh, lbox, yb=32):
    """Sort a catalog dict by (x-cell, y-block of `yb`) of its box-centred
    x and y (models/pipeline.py:group_inputs2d_device, without padding).
    Returns (sorted dict of float32 columns, int32 cell starts)."""
    keys = list(cat)
    cols = [cat[k].to(torch.float32) for k in keys]
    staged, starts = stage_grouped2d(
        cols, nmesh, lbox, yb, xi=keys.index('x'), yi=keys.index('y'), shift=lbox / 2
    )
    return dict(zip(keys, staged)), starts


def hod_pk_fused_yb(
    halo_g, part_g, params, seg, Wcomp, lbox, velz2kms, nmesh, yb, nbins_k,
    starts_h, starts_p, rsd=True, err=None,
):
    """Populate + TSC deposit + rfftn + binned P(k), one step
    (models/pipeline.py:hod_pk_fused_yb).

    halo_g/part_g and starts_h/starts_p come from
    :func:`group_inputs2d_device`; params from
    ``convert.params_to_tensors``; seg from :func:`make_bin_plan_arrays`;
    Wcomp is the (nmesh,) float32 window compensation or None.

    On CUDA the deposit and the binning are the port's kernels, and nothing
    waits for the host. The deposit counts points that fall outside their
    staged cell in the int32 (1,) error word `err` (allocated when None;
    read it with ``ops.grid.check_deposit_err`` after a sync); a non-zero
    word turns wsum into NaN on the device. On CPU every stage runs its
    plain version.

    Returns (wsum, n_gal): the (nbins_k,) float32 bin sums of |delta_k|^2
    (divide by the plan's counts for P(k)) and the galaxy count, both 0-d
    or 1-d tensors on the inputs' device."""
    inv_velz2kms = _f32(np.float32(1.0) / np.float32(velz2kms))
    z_c, keep_c, z_s, keep_s = populate_weights(halo_g, part_g, params, rsd, inv_velz2kms)
    n_gal = keep_c.sum() + keep_s.sum()

    half_l = _f32(np.float32(lbox) / 2)
    grid = torch.zeros((nmesh,) * 3, dtype=torch.float32, device=keep_c.device)
    if err is None:
        err = torch.zeros(1, dtype=torch.int32, device=grid.device)
    for cat, z, keep, starts in ((halo_g, z_c, keep_c, starts_h), (part_g, z_s, keep_s, starts_p)):
        tsc_deposit_cells(
            grid, cat['x'] + half_l, cat['y'] + half_l, z + half_l, keep, starts,
            nmesh, yb, lbox, 0.0, err=err,
        )

    delta = grid * (grid.numel() / n_gal) - 1.0
    delta_k = torch.fft.rfftn(delta)
    wsum = bin_power_modes(delta_k, seg, Wcomp, 1.0 / grid.numel(), nbins_k)
    return torch.where(err == 0, wsum, torch.nan), n_gal


_EXAMPLE_PARAMS = {
    'logM_cut': 12.8, 'logM1': 14.0, 'sigma': 0.3, 'alpha': 1.0,
    'kappa': 0.4, 'alpha_c': 0.3, 'alpha_s': 1.0, 'ic': 1.0,
    'Acent': 0.0, 'Asat': 0.0, 'Bcent': 0.0, 'Bsat': 0.0,
}


def make_example_inputs(n_halo, n_part, lbox, seed=0):
    """Synthetic AbacusSummit-like halo/particle arrays as numpy, identical
    to models/pipeline.py:make_example_inputs for the same seed."""
    rng = np.random.default_rng(seed)
    u = rng.random(n_halo)
    mass = (10 ** (11 + 4 * u**3)).astype(np.float32)
    hx, hy, hz = ((rng.random(n_halo, dtype=np.float32) * lbox - lbox / 2) for _ in range(3))
    halo = {
        'x': hx,
        'y': hy,
        'z': hz,
        'vz': rng.normal(0, 300, n_halo).astype(np.float32),
        'mass': mass,
        'multis': np.ones(n_halo, np.float32),
        'randoms': rng.random(n_halo, dtype=np.float32),
        'vdevz': rng.normal(0, 100, n_halo).astype(np.float32),
        'deltac': np.zeros(n_halo, np.float32),
        'fenv': np.zeros(n_halo, np.float32),
    }
    hidx = rng.integers(0, n_halo, n_part)
    part = {
        'x': (hx[hidx] + rng.normal(0, 0.5, n_part).astype(np.float32)),
        'y': (hy[hidx] + rng.normal(0, 0.5, n_part).astype(np.float32)),
        'z': (hz[hidx] + rng.normal(0, 0.5, n_part).astype(np.float32)),
        'vz': rng.normal(0, 300, n_part).astype(np.float32),
        'hvelz': halo['vz'][hidx],
        'hmass': mass[hidx],
        'weights': np.full(n_part, 20.0, np.float32),
        'randoms': rng.random(n_part, dtype=np.float32),
        'deltac': np.zeros(n_part, np.float32),
        'fenv': np.zeros(n_part, np.float32),
    }
    return halo, part, dict(_EXAMPLE_PARAMS)


def make_example_inputs_device(n_halo, n_part, lbox, generator, device):
    """The distributions of :func:`make_example_inputs`, drawn on `device`
    with `generator` (a torch.Generator on that device), so a bench-scale
    catalog never crosses PCIe (models/pipeline.py:make_example_inputs_device).
    Returns (halo, part, params), params as 0-d float32 tensors on `device`."""
    f32 = torch.float32

    def uniform(n):
        return torch.rand(n, generator=generator, device=device, dtype=f32)

    def normal(n, scale):
        return torch.randn(n, generator=generator, device=device, dtype=f32) * scale

    half = _f32(lbox / 2)
    mass = 10 ** (11 + 4 * uniform(n_halo) ** 3)
    hx, hy, hz = (uniform(n_halo) * lbox - half for _ in range(3))
    hvz = normal(n_halo, 300.0)
    halo = {
        'x': hx, 'y': hy, 'z': hz, 'vz': hvz, 'mass': mass,
        'multis': torch.ones(n_halo, dtype=f32, device=device),
        'randoms': uniform(n_halo),
        'vdevz': normal(n_halo, 100.0),
        'deltac': torch.zeros(n_halo, dtype=f32, device=device),
        'fenv': torch.zeros(n_halo, dtype=f32, device=device),
    }
    hidx = torch.randint(0, n_halo, (n_part,), generator=generator, device=device)
    part = {
        'x': hx[hidx] + normal(n_part, 0.5),
        'y': hy[hidx] + normal(n_part, 0.5),
        'z': hz[hidx] + normal(n_part, 0.5),
        'vz': normal(n_part, 300.0),
        'hvelz': hvz[hidx],
        'hmass': mass[hidx],
        'weights': torch.full((n_part,), 20.0, dtype=f32, device=device),
        'randoms': uniform(n_part),
        'deltac': torch.zeros(n_part, dtype=f32, device=device),
        'fenv': torch.zeros(n_part, dtype=f32, device=device),
    }
    return halo, part, params_to_tensors(_EXAMPLE_PARAMS, device)
