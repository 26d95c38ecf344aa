r"""Population markers (elementwise PyTorch).

Counterpart of the marker helpers of abacusutils_tpu/models/hod/population.py
(``_wrap_centered``, ``_cent_marker``, ``_sat_base``). Only the LRG branches
are ported; ELG and QSO come with the multi-tracer step.
"""

import torch

from . import shapes

__all__ = ['TRACER_ORDER']

TRACER_ORDER = ('LRG', 'ELG', 'QSO')


def _wrap_centered(x, L):
    """Wrap to [-L/2, L/2) with a single correction (reference wrap:128-136)."""
    L2 = L / 2
    x = torch.where(x >= L2, x - L, x)
    return torch.where(x < -L2, x + L, x)


def _not_ported(tracer):
    if tracer in TRACER_ORDER:
        return NotImplementedError(f'{tracer} markers are not ported yet (LRG only)')
    return ValueError(tracer)


def _cent_marker(tracer, p, mass, deltac, fenv, shear):
    """Expected central occupation for one tracer with assembly bias."""
    if tracer != 'LRG':
        raise _not_ported(tracer)
    logM_cut = p['logM_cut'] + p['Acent'] * deltac + p['Bcent'] * fenv
    return shapes.n_cen_LRG(mass, logM_cut, p['sigma']) * p['ic']


def _sat_base(tracer, p, mass, deltac, fenv, shear, keep_cent):
    """Expected satellite count per particle for one tracer (before weights)."""
    if tracer != 'LRG':
        raise _not_ported(tracer)
    M1 = 10 ** (p['logM1'] + p['Asat'] * deltac + p['Bsat'] * fenv)
    logM_cut = p['logM_cut'] + p['Acent'] * deltac + p['Bcent'] * fenv
    return shapes.n_sat_LRG_modified(
        mass, logM_cut, 10**logM_cut, M1, p['sigma'], p['alpha'], p['kappa']
    )
