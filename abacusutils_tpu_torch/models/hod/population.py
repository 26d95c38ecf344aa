r"""Population markers and host-side tracer parameters (elementwise PyTorch).

Counterpart of the helpers of abacusutils_tpu/models/hod/population.py that
the fused route uses: ``_wrap_centered``, ``_cent_marker`` and ``_sat_base``
for LRG, ELG (with conformity and the shear terms) and QSO, ``_apply_rsd``
(plane-parallel z and the light-cone line of sight), ``_rank_multiplier``
and the host function ``prepare_tracer_params``.

Markers take 0-d float32 parameter tensors (``convert.params_to_tensors``),
so their scalar arithmetic runs in float32, as under jax.jit.
"""

import numpy as np
import torch

from . import shapes

__all__ = ['TRACER_ORDER', 'prepare_tracer_params']

TRACER_ORDER = ('LRG', 'ELG', 'QSO')


def _wrap_centered(x, L):
    """Wrap to [-L/2, L/2) with a single correction (reference wrap:128-136)."""
    L2 = L / 2
    x = torch.where(x >= L2, x - L, x)
    return torch.where(x < -L2, x + L, x)


def _cent_marker(tracer, p, mass, deltac, fenv, shear):
    """Expected central occupation for one tracer with assembly bias."""
    if tracer == 'LRG':
        logM_cut = p['logM_cut'] + p['Acent'] * deltac + p['Bcent'] * fenv
        return shapes.n_cen_LRG(mass, logM_cut, p['sigma']) * p['ic']
    if tracer == 'ELG':
        logM_cut = p['logM_cut'] + p['Acent'] * deltac + p['Bcent'] * fenv + p['Ccent'] * shear
        return (
            shapes.N_cen_ELG_v1(mass, p['p_max'], p['Q'], logM_cut, p['sigma'], p['gamma'])
            * p['ic']
        )
    if tracer == 'QSO':
        logM_cut = p['logM_cut'] + p['Acent'] * deltac + p['Bcent'] * fenv
        return shapes.N_cen_QSO(mass, logM_cut, p['sigma']) * p['ic']
    raise ValueError(tracer)


def _sat_base(tracer, p, mass, deltac, fenv, shear, keep_cent):
    """Expected satellite count per particle for one tracer (before weights);
    `keep_cent` is the host halo's central keep code (ELG conformity)."""
    if tracer == 'LRG':
        M1 = 10 ** (p['logM1'] + p['Asat'] * deltac + p['Bsat'] * fenv)
        logM_cut = p['logM_cut'] + p['Acent'] * deltac + p['Bcent'] * fenv
        return shapes.n_sat_LRG_modified(
            mass, logM_cut, 10**logM_cut, M1, p['sigma'], p['alpha'], p['kappa']
        )
    if tracer == 'ELG':
        logM_cut = p['logM_cut'] + p['Acent'] * deltac + p['Bcent'] * fenv + p['Ccent'] * shear
        Mcut = 10**logM_cut
        M1 = 10 ** (p['logM1'] + p['Asat'] * deltac + p['Bsat'] * fenv + p['Csat'] * shear)
        base = shapes.N_sat_elg(mass, Mcut, p['kappa'], M1, p['alpha'], p['A_s'])
        # conformity: host has an LRG (1) or ELG (2) central
        M1_EL = 10 ** (p['logM1_EL'] + p['Asat'] * deltac + p['Bsat'] * fenv)
        base_EL = shapes.N_sat_elg(mass, Mcut, p['kappa'], M1_EL, p['alpha_EL'], p['A_s'])
        M1_EE = 10 ** (p['logM1_EE'] + p['Asat'] * deltac + p['Bsat'] * fenv)
        base_EE = shapes.N_sat_elg(mass, Mcut, p['kappa'], M1_EE, p['alpha_EE'], p['A_s'])
        base = torch.where(keep_cent == 1, base_EL, base)
        return torch.where(keep_cent == 2, base_EE, base)
    if tracer == 'QSO':
        M1 = 10 ** (p['logM1'] + p['Asat'] * deltac + p['Bsat'] * fenv)
        logM_cut = p['logM_cut'] + p['Acent'] * deltac + p['Bcent'] * fenv
        return shapes.N_sat_generic(mass, 10**logM_cut, p['kappa'], M1, p['alpha'])
    raise ValueError(tracer)


def _apply_rsd(x, y, z, vx, vy, vz, rsd, inv_velz2kms, lbox, origin):
    """Redshift-space positions: along the line of sight from `origin` (a
    (3,) tensor) when given, else along z with a single periodic wrap."""
    if not rsd:
        return x, y, z
    if origin is not None:
        nx = x - origin[0]
        ny = y - origin[1]
        nz = z - origin[2]
        # a division, as XLA computes 1.0 / sqrt (not an rsqrt)
        inv_norm = 1.0 / torch.sqrt(nx * nx + ny * ny + nz * nz)
        nx = nx * inv_norm
        ny = ny * inv_norm
        nz = nz * inv_norm
        proj = inv_velz2kms * (vx * nx + vy * ny + vz * nz)
        return x + proj * nx, y + proj * ny, z + proj * nz
    return x, y, _wrap_centered(z + vz * inv_velz2kms, lbox)


def _rank_multiplier(p, part):
    """Velocity/distance rank decoration factor on the satellite rate
    (reference GRAND_HOD.py:1042-1050); `part` carries the staged
    ranks/ranksv/ranksp/ranksr columns."""
    return (
        1
        + p['s'] * part['ranks']
        + p['s_v'] * part['ranksv']
        + p['s_p'] * part['ranksp']
        + p['s_r'] * part['ranksr']
    )


def prepare_tracer_params(tracers, z):
    """Fill in defaults + z-evolution for each tracer's HOD parameters
    (reference gen_gals GRAND_HOD.py:1341-1468). Host Python floats."""
    out = {}
    for tracer, HOD in tracers.items():
        p = {k: float(v) for k, v in HOD.items() if np.isscalar(v)}
        Delta_a = 1.0 / (1 + z) - 1.0 / (1 + HOD.get('z_pivot', z))
        p['logM_cut'] = HOD['logM_cut'] + HOD.get('logM_cut_pr', 0.0) * Delta_a
        p['logM1'] = HOD['logM1'] + HOD.get('logM1_pr', 0.0) * Delta_a
        for k, default in [
            ('Acent', 0.0), ('Asat', 0.0), ('Bcent', 0.0), ('Bsat', 0.0),
            ('ic', 1.0), ('f_sigv', 0.0), ('alpha_c', 0.0), ('alpha_s', 1.0),
            ('s', 0.0), ('s_v', 0.0), ('s_p', 0.0), ('s_r', 0.0),
        ]:
            p.setdefault(k, default)
        if tracer == 'ELG':
            p.setdefault('Ccent', HOD.get('Ccent', 0.0))
            p.setdefault('Csat', HOD.get('Csat', 0.0))
            p['logM1_EE'] = HOD.get('logM1_EE', p['logM1'])
            p['alpha_EE'] = HOD.get('alpha_EE', p['alpha'])
            p['logM1_EL'] = HOD.get('logM1_EL', p['logM1'])
            p['alpha_EL'] = HOD.get('alpha_EL', p['alpha'])
            p.setdefault('exp_frac', 0.0)
            p.setdefault('exp_scale', 1.0)
            p.setdefault('nfw_rescale', 1.0)
        out[tracer] = p
    return out
