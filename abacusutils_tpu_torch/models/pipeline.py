r"""Fused HOD-populate -> paint -> P(k) steps (PyTorch + CUDA kernels).

Counterpart of abacusutils_tpu/models/pipeline.py for the fused route:

- the single-tracer (LRG) step :func:`hod_pk_fused_yb`;
- the multi-tracer step :func:`hod_pk_fused_multi` (LRG > ELG > QSO
  priority codes, ELG conformity through the staged satellite -> host link,
  every auto and cross spectrum), the box leg of
  ``AbacusHOD.run_hod_pk_fused``;
- the light-cone leg: :func:`populate_lc_multi` on brick-staged catalogs,
  then :func:`pk_grouped_multi` on the displaced galaxies in that order.

The steps are static-shape, as on the TPU: population produces a keep
weight and an RSD coordinate for every halo and particle, and the deposit
consumes the weights, so no galaxy catalog is compacted and nothing waits
for the host.

Catalogs are staged once by :func:`group_inputs2d_device`: one stable sort
by the 3-D brick of each object's cell before RSD. RSD moves galaxies on
every call (along z in the box, along the line of sight in the light cone,
so in all three coordinates), so the bricks carry a margin of
:data:`RSD_MARGIN` cells on the axes it moves; the deposit kernel (K1) adds
a galaxy that moved further straight into the grid and counts it in its
overflow word. K1 reads the sorted columns and the work list as they are;
there is no padded (ncell, K) layout. One all-pairs binning kernel (K3)
turns the tracers' rfft meshes into every spectrum; the single-tracer step
bins with the same kernel at one field (K2).
"""

import numpy as np
import torch

from ..convert import params_to_tensors
from ..ops.grid import RSD_MARGIN, _f32, brick_shape, stage_bricks, tsc_deposit_cells
from ..ops.power import (
    bin_pair_modes,
    bin_power_modes,
    field_pairs,
    get_k_mu_edges,
    get_mode_bin_plan,
)
from ..utils import profiling
from .hod.population import (
    TRACER_ORDER,
    _apply_rsd,
    _cent_codes,
    _cent_marker,
    _sat_base,
    _sat_codes,
)

__all__ = [
    'make_bin_plan_arrays',
    'populate_weights',
    'group_inputs2d_device',
    'group_inputs2d_linked_device',
    'hod_pk_fused_yb',
    'populate_weights_multi',
    'hod_pk_fused_multi',
    'populate_lc_multi',
    'pk_grouped_multi',
    'make_example_inputs',
    'make_example_inputs_device',
    'RSD_MARGIN',
]

def make_bin_plan_arrays(nmesh, lbox, nbins_k, device):
    """Mode-binning plan of a monopole P(k) with `nbins_k` linear k bins up
    to the Nyquist frequency: (seg, counts), seg an int32 tensor on `device`
    with one bin per rfft mode, counts the (nbins_k,) float64 numpy mode
    counts, read-only (models/pipeline.py:make_bin_plan_arrays).

    The plan is built on `device` by ``ops.power.mode_bin_plan_device`` and
    cached by ``ops.power.get_mode_bin_plan`` with its row spans, which the
    binning kernel reads for this very seg tensor: a second call with the
    same arguments builds nothing (``make_bin_plan_arrays.builds`` counts
    the builds made for it)."""
    kedges, muedges = get_k_mu_edges(lbox, np.pi * nmesh / lbox, nbins_k, 1, False)
    dk = 2 * np.pi / lbox
    kedges2 = ((kedges / dk) ** 2).astype(np.float32)
    muedges2 = (muedges**2).astype(np.float32)
    before = get_mode_bin_plan.builds
    plan = get_mode_bin_plan(int(nmesh), kedges2, muedges2, (), device)
    make_bin_plan_arrays.builds += get_mode_bin_plan.builds - before
    return plan.seg, plan.counts.reshape(-1)


make_bin_plan_arrays.builds = 0


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


def group_inputs2d_device(
    cat, nmesh, lbox, yb=None, return_order=False, margin=(0, 0, RSD_MARGIN), shift=None,
):
    """Sort a catalog dict by the brick of its x, y, z plus `shift` (None:
    lbox / 2, for box-centred catalogs) (ops.grid.stage_bricks; the
    counterpart of models/pipeline.py:group_inputs2d_device, which groups by
    (x-cell, y-block of `yb`) with padding). `yb` sets the y extent of the
    bricks (None: ops.grid.BRICK's), `margin` their room per axis, in cells,
    for moves after staging. Returns (sorted dict, BrickPlan); float columns
    become float32, integer columns keep their type. With return_order=True
    the int64 sort permutation comes third."""
    keys = list(cat)
    cols = [cat[k].to(torch.float32) if cat[k].is_floating_point() else cat[k] for k in keys]
    staged, plan, *order = stage_bricks(
        cols, nmesh, lbox, brick_shape(nmesh, yb, margin), margin,
        shift=lbox / 2 if shift is None else shift,
        xi=keys.index('x'), yi=keys.index('y'), zi=keys.index('z'), return_order=return_order,
    )
    return (dict(zip(keys, staged)), plan, *order)


def group_inputs2d_linked_device(halo, part, nmesh, lbox, yb=None, **stage):
    """Both catalogs staged by :func:`group_inputs2d_device`, plus
    part_g['hkeep_at'], the int32 position of each particle's host halo in
    the staged halo order (the ELG conformity link;
    models/pipeline.py:group_inputs2d_linked_device). `part['hidx']` holds
    the original host-halo indices. The link is integer arithmetic on the
    halo sort's permutation, inv[order] = arange, then inv[hidx], staged
    with the particles. `stage` (margin, shift) goes to
    :func:`group_inputs2d_device`. Returns (halo_g, part_g, plan_h,
    plan_p)."""
    halo_g, plan_h, order_h = group_inputs2d_device(
        halo, nmesh, lbox, yb, return_order=True, **stage
    )
    n_halo = order_h.numel()
    inv = torch.empty(n_halo, dtype=torch.int32, device=order_h.device)
    inv[order_h] = torch.arange(n_halo, dtype=torch.int32, device=order_h.device)
    part = dict(part)
    part['hkeep_at'] = inv[part.pop('hidx')]
    part_g, plan_p = group_inputs2d_device(part, nmesh, lbox, yb, **stage)
    return halo_g, part_g, plan_h, plan_p


def _delta_k(grid, n_gal):
    """rfft of the overdensity of a deposited grid."""
    return torch.fft.rfftn(grid * (grid.numel() / n_gal) - 1.0)


def hod_pk_fused_yb(
    halo_g, part_g, params, seg, Wcomp, lbox, velz2kms, nmesh, yb, nbins_k,
    plan_h, plan_p, rsd=True, overflow=None,
):
    """Populate + TSC deposit + rfftn + binned P(k), one step
    (models/pipeline.py:hod_pk_fused_yb).

    halo_g/part_g and plan_h/plan_p come from :func:`group_inputs2d_device`
    (the plans carry the deposit's bricks, so `yb`, kept from the JAX
    signature, has no effect here); params from
    ``convert.params_to_tensors``; seg from :func:`make_bin_plan_arrays`;
    Wcomp is the (nmesh,) float32 window compensation or None.

    On CUDA the deposit and the binning are the port's kernels, and nothing
    waits for the host: the binning reads the row spans cached with seg's
    plan (another seg tensor costs a span build with a host sync, counted
    in ``ops.power.mode_spans.builds``). The deposit adds the galaxies that RSD moved out of
    their brick's tile straight into the grid and counts them in the int32
    (1,) word `overflow`, when given. On CPU every stage runs its plain
    version.

    Returns (wsum, n_gal): the (nbins_k,) float32 bin sums of |delta_k|^2
    (divide by the plan's counts for P(k)) and the galaxy count, both 0-d
    or 1-d tensors on the inputs' device."""
    inv_velz2kms = _f32(np.float32(1.0) / np.float32(velz2kms))
    z_c, keep_c, z_s, keep_s = populate_weights(halo_g, part_g, params, rsd, inv_velz2kms)
    n_gal = keep_c.sum() + keep_s.sum()

    half_l = _f32(np.float32(lbox) / 2)
    grid = torch.zeros((nmesh,) * 3, dtype=torch.float32, device=keep_c.device)
    for cat, z, keep, plan in ((halo_g, z_c, keep_c, plan_h), (part_g, z_s, keep_s, plan_p)):
        tsc_deposit_cells(
            grid, cat['x'] + half_l, cat['y'] + half_l, z + half_l, keep, plan, lbox, 0.0,
            overflow,
        )

    wsum = bin_power_modes(_delta_k(grid, n_gal), seg, Wcomp, 1.0 / grid.numel(), nbins_k)
    return wsum, n_gal


def _tracer_zw(halo, part, params, want, rsd, inv_velz2kms, keep_c, keep_s):
    """Per-tracer RSD z + 0/1 keep weights from the priority codes."""
    out = {}
    for code, tracer in enumerate(TRACER_ORDER, 1):
        if tracer not in want:
            continue
        p = params[tracer]
        vz_c = halo['vz'] + p['alpha_c'] * halo['vdevz']
        z_c = halo['z'] + (vz_c * inv_velz2kms if rsd else 0.0)
        w_c = (keep_c == code).to(torch.float32)
        vz_s = part['hvelz'] + p['alpha_s'] * (part['vz'] - part['hvelz'])
        z_s = part['z'] + (vz_s * inv_velz2kms if rsd else 0.0)
        w_s = (keep_s == code).to(torch.float32)
        out[tracer] = (z_c, w_c, z_s, w_s)
    return out


def populate_weights_multi(halo, part, params, want, rsd, inv_velz2kms):
    """Multi-tracer populate pass: priority keep codes over stacked markers
    (one random per object) and per-tracer RSD z. `params` maps tracer ->
    0-d float32 parameter tensors (prepare_tracer_params, then
    params_to_tensors); satellites see their host's central keep code
    through part['hkeep_at'] (ELG conformity). Returns
    {tracer: (z_c, w_c, z_s, w_s)} and the central keep codes
    (models/pipeline.py:populate_weights_multi)."""
    with profiling.span('abacus.populate'):
        keep_c = _cent_codes(halo, params, want)
        keep_s = _sat_codes(part, params, want, keep_c, host_at=part['hkeep_at'])
        return _tracer_zw(halo, part, params, want, rsd, inv_velz2kms, keep_c, keep_s), keep_c


def _pair_spectra(deltas, want, seg, Wcomp, nmesh, nbins_k):
    """Every auto and cross bin sum of the tracers' meshes through one
    binning launch, as {(t1, t2): (nbins_k,) float64}."""
    wsum = bin_pair_modes(deltas, seg, Wcomp, 1.0 / nmesh**3, nbins_k)
    pairs = [(want[i], want[j]) for i, j in field_pairs(len(want))]
    return dict(zip(pairs, wsum.unbind(0)))


def hod_pk_fused_multi(
    halo_g, part_g, params, seg, Wcomp, lbox, velz2kms, want, nmesh, yb, nbins_k,
    plan_h, plan_p, rsd=True, overflow=None,
):
    """Multi-tracer populate + TSC deposit + rfftn + every auto and cross
    P(k) bin sum (models/pipeline.py:hod_pk_fused_multi).

    halo_g/part_g and plan_h/plan_p come from
    :func:`group_inputs2d_linked_device` (`yb` has no effect here, as in
    :func:`hod_pk_fused_yb`); `params` maps each tracer of `want` (in
    TRACER_ORDER order) to its 0-d float32 parameter tensors. Each tracer
    takes two deposit launches (halos, particles) and one rfftn; one
    binning launch gives all T(T+1)/2 spectra. Nothing waits for the host;
    `overflow` counts the galaxies RSD moved out of their brick's tile (see
    :func:`hod_pk_fused_yb`).

    Returns ({(t1, t2): wsum}, {tracer: n_gal}): (nbins_k,) float64 bin sums
    (divide by the plan's counts for P(k)) and 0-d galaxy counts."""
    # an f32 division, as under jax.jit
    inv_velz2kms = _f32(np.float32(1.0) / np.float32(velz2kms))
    tr, _ = populate_weights_multi(halo_g, part_g, params, want, rsd, inv_velz2kms)
    half_l = _f32(np.float32(lbox) / 2)
    device = halo_g['x'].device
    with profiling.span('abacus.deposit'):
        xy = [
            (halo_g['x'] + half_l, halo_g['y'] + half_l, plan_h),
            (part_g['x'] + half_l, part_g['y'] + half_l, plan_p),
        ]
    deltas, n_gal = [], {}
    for tracer in want:
        z_c, w_c, z_s, w_s = tr[tracer]
        with profiling.span('abacus.deposit'):
            grid = torch.zeros((nmesh,) * 3, dtype=torch.float32, device=device)
            for (x, y, plan), z, w in zip(xy, (z_c, z_s), (w_c, w_s)):
                tsc_deposit_cells(grid, x, y, z + half_l, w, plan, lbox, 0.0, overflow)
            n_gal[tracer] = w_c.sum() + w_s.sum()
        with profiling.span('abacus.transform'):
            deltas.append(_delta_k(grid, n_gal[tracer]))
    with profiling.span('abacus.bin'):
        return _pair_spectra(deltas, want, seg, Wcomp, nmesh, nbins_k), n_gal


def populate_lc_multi(halo, part, params, want, rsd, inv_velz2kms, origin):
    """Light-cone multi-tracer populate pass: priority keep codes (as
    :func:`populate_weights_multi`, the host link is part['hidx'], an index
    into `halo`) and per-galaxy line-of-sight RSD from `origin`, a (3,)
    float32 tensor (models/pipeline.py:populate_lc_multi). The displacement
    moves galaxies in all three coordinates.

    halo: x/y/z, vx/vy/vz, vdevx/vdevy/vdevz, mass, multis, randoms,
    deltac, fenv (+shear); part: x/y/z, vx/vy/vz, hvelx/hvely/hvelz, hmass,
    weights, randoms, deltac, fenv, hidx (+shear, +rank columns).
    Returns ({tracer: (xc, yc, zc, wc, xs, ys, zs, ws)}, {tracer: n_gal})."""
    with profiling.span('abacus.populate'):
        keep_c = _cent_codes(halo, params, want)
        keep_s = _sat_codes(part, params, want, keep_c, host_at=part['hidx'])
        out, n_gal = {}, {}
        for code, tracer in enumerate(TRACER_ORDER, 1):
            if tracer not in want:
                continue
            p = params[tracer]
            vc = [halo[f'v{a}'] + p['alpha_c'] * halo[f'vdev{a}'] for a in 'xyz']
            xc, yc, zc = _apply_rsd(
                halo['x'], halo['y'], halo['z'], *vc, rsd, inv_velz2kms, None, origin
            )
            wc = (keep_c == code).to(torch.float32)
            vs = [
                part[f'hvel{a}'] + p['alpha_s'] * (part[f'v{a}'] - part[f'hvel{a}'])
                for a in 'xyz'
            ]
            xs, ys, zs = _apply_rsd(
                part['x'], part['y'], part['z'], *vs, rsd, inv_velz2kms, None, origin
            )
            ws = (keep_s == code).to(torch.float32)
            out[tracer] = (xc, yc, zc, wc, xs, ys, zs, ws)
            n_gal[tracer] = wc.sum() + ws.sum()
        return out, n_gal


def pk_grouped_multi(groups, n_gal, seg, Wcomp, lbox, nmesh, yb, nbins_k, want, overflow=None):
    """Auto and cross P(k) bin sums of per-tracer staged galaxies:
    groups[tracer] is a list of (x, y, z, w, plan) deposits into the
    tracer's grid, each in the order of a ``ops.grid.stage_bricks`` plan (no
    shift; the galaxies may have moved since), painted at their raw
    coordinates (each wrapped once into [0, lbox)); `yb` has no effect, the
    plans carry the bricks. One deposit launch per deposit, one binning
    launch (models/pipeline.py:pk_grouped_multi). Returns ({(t1, t2): wsum},
    n_gal) as :func:`hod_pk_fused_multi` does."""
    device = groups[want[0]][0][0].device
    deltas = []
    for tracer in want:
        with profiling.span('abacus.deposit'):
            grid = torch.zeros((nmesh,) * 3, dtype=torch.float32, device=device)
            for x, y, z, w, plan in groups[tracer]:
                tsc_deposit_cells(grid, x, y, z, w, plan, lbox, 0.0, overflow)
        with profiling.span('abacus.transform'):
            deltas.append(_delta_k(grid, n_gal[tracer]))
    with profiling.span('abacus.bin'):
        return _pair_spectra(deltas, want, seg, Wcomp, nmesh, nbins_k), n_gal


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


def make_example_inputs_device(n_halo, n_part, lbox, generator, device, link=False):
    """The distributions of :func:`make_example_inputs`, drawn on `device`
    with `generator` (a torch.Generator on that device), so a bench-scale
    catalog never crosses PCIe (models/pipeline.py:make_example_inputs_device).
    link=True adds part['hidx'], each particle's int32 host-halo index (the
    multi-tracer conformity link). Returns (halo, part, params), params as
    0-d float32 tensors on `device`."""
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
    if link:
        part['hidx'] = hidx.to(torch.int32)
    return halo, part, params_to_tensors(_EXAMPLE_PARAMS, device)
