r"""Zel'dovich advection of the IC bias fields and their 15 auto and cross
spectra (the compute of abacusutils_tpu/models/zcv/advect_fields.py:main,
arrays in and arrays out).

:func:`advected_positions` moves the lattice by the scaled displacement in
the f32 order of operations of ``main``; :func:`advected_field_ffts`
deposits the five fields (1cb, delta, delta^2, s^2, nabla^2 delta) on it
through K1's multi-weight form (``ops/power.py:get_field_ffts``: one launch
a stage); :func:`power_ij` bins every auto and cross spectrum with poles in
one K3 launch. No file is read or written.
"""

import numpy as np
import torch

from ...convert import resolve_device
from ...ops.grid import _f32
from ...ops.power import (
    calc_pk_pairs_from_deltak,
    get_field_ffts,
    get_k_mu_edges,
    get_W_compensated,
)
from .tools_cv import ZCV_FIELDS

__all__ = ['advected_positions', 'advected_field_ffts', 'field_growth', 'power_ij']


def field_growth(D):
    """The growth scaling of each of ZCV_FIELDS (advect_fields.py:field_D):
    1, D, D^2, D^2, D."""
    return [1, D, D**2, D**2, D]


def _column(a, device):
    if isinstance(a, torch.Tensor):
        return a.reshape(-1)
    return torch.from_numpy(np.ascontiguousarray(a, np.float32).reshape(-1)).to(
        resolve_device(device))


def advected_positions(disp, Lbox, nmesh, D, f_growth, device=None):
    """The advected lattice of advect_fields.py:97-109 as three (nmesh^3,)
    f32 columns (x, y, z): the displacement (in units of the box, as
    ``load_disp`` returns it) times D, z also times (1 + f_growth), plus the
    fractional lattice, times Lbox, modulo Lbox, each step rounded to f32 as
    numpy rounds it. disp: (disp_x, disp_y, disp_z), (nmesh,)*3 arrays
    (numpy goes to `device`, the card when None) or tensors."""
    nmesh = int(nmesh)
    out = []
    for ax in range(3):
        p = _column(disp[ax], device).to(torch.float32) * _f32(D)
        if ax == 2:
            p *= _f32(1 + f_growth)
        lattice = torch.arange(nmesh, dtype=torch.float32, device=p.device) / _f32(nmesh)
        shape = [1, 1, 1]
        shape[ax] = nmesh
        p = (p.view(nmesh, nmesh, nmesh) + lattice.view(shape)).reshape(-1)
        p *= _f32(Lbox)
        out.append(torch.remainder(p, _f32(Lbox)))
    return tuple(out)


def advected_field_ffts(disp, fields, Lbox, nmesh, D, f_growth, power_params, device=None):
    """The Fourier fields of advect_fields.py:main for the five ZCV_FIELDS:
    the lattice advected by :func:`advected_positions`, weighted by 1 and by
    each of `fields` = (delta, delta^2, s^2, nabla^2 delta) of
    ``ic_fields.get_fields``, painted with the power_params' paste (TSC),
    compensation and interlacing through one multi-weight K1 launch a
    stage. Returns {field name: complex64 rfft mesh} in ZCV_FIELDS order,
    not yet scaled by :func:`field_growth`."""
    pp = power_params
    pos = advected_positions(disp, Lbox, nmesh, D, f_growth, device)
    ws = [None] + [f.reshape(-1) if isinstance(f, torch.Tensor) else np.ravel(f) for f in fields]
    W = (get_W_compensated(Lbox, nmesh, pp['paste'], pp['interlaced'])
         if pp['compensated'] else None)
    ffts = get_field_ffts(pos, Lbox, nmesh, pp['paste'], ws, W, pp['compensated'],
                          pp['interlaced'], pos[0].device)
    return dict(zip(ZCV_FIELDS, ffts))


def power_ij(field_ffts, Lbox, power_params, D):
    """The pk_ij_dict of advect_fields.py:main: every auto and cross
    spectrum of the fields (a {name: rfft mesh} dict in ZCV_FIELDS order),
    binned with poles by one K3 launch and scaled by the fields' growth
    (:func:`field_growth` of D). Keys k_binc, mu_binc and, per pair
    '{ki}_{kj}' (i >= j), P_kmu_, N_kmu_, P_ell_, N_ell_."""
    pp = power_params
    k_bin_edges, mu_bin_edges = get_k_mu_edges(Lbox, pp['k_hMpc_max'], pp['nbins_k'],
                                               pp['nbins_mu'], pp['logk'])
    keynames = list(field_ffts)
    field_D = field_growth(D)
    res = calc_pk_pairs_from_deltak(
        [field_ffts[k] for k in keynames], Lbox, k_bin_edges, mu_bin_edges,
        poles=np.asarray(pp['poles']),
    )
    pk_ij_dict = {
        'k_binc': (k_bin_edges[1:] + k_bin_edges[:-1]) * 0.5,
        'mu_binc': (mu_bin_edges[1:] + mu_bin_edges[:-1]) * 0.5,
    }
    for i in range(len(keynames)):
        for j in range(i + 1):
            P = res[(i, j)]
            scale = field_D[i] * field_D[j]
            kn_ij = f'{keynames[i]}_{keynames[j]}'
            pk_ij_dict[f'P_kmu_{kn_ij}'] = np.asarray(P['power']) * scale
            pk_ij_dict[f'N_kmu_{kn_ij}'] = np.asarray(P['N_mode'])
            pk_ij_dict[f'P_ell_{kn_ij}'] = np.asarray(P['binned_poles']) * scale
            pk_ij_dict[f'N_ell_{kn_ij}'] = np.asarray(P['N_mode_poles'])
    return pk_ij_dict
