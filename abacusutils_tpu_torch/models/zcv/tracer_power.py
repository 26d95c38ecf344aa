r"""Tracer auto spectrum and its crosses with the advected ZCV fields
(the ZCV part of abacusutils_tpu/models/zcv/tracer_power.py, arrays in and
arrays out).

The tracer field is painted by K1 (``ops/power.py:get_field_fft``); its
auto spectrum and its cross with each advected field come from one K3
launch over the tracer and the fields held in memory. No ASDF memo file is
read or written. ``get_recon_power`` (LCV) is not ported.
"""

import numpy as np
import torch

from ...ops.grid import _f32
from ...ops.power import (
    _pos_columns,
    calc_pk_pairs_from_deltak,
    get_field_fft,
    get_k_mu_edges,
    get_W_compensated,
)
from .advect_fields import field_growth
from .cosmo import get_meta, growth_from_meta

__all__ = ['get_tracer_power']


def get_tracer_power(tracer_pos, want_rsd, config, field_ffts, meta=None, device=None):
    """Auto P_tr,tr and the crosses P_{field,tr} with the advected fields
    (tracer_power.py:get_tracer_power, ZCV).

    tracer_pos: (N, 3) positions in [-Lbox/2, Lbox/2) (numpy, going to
    `device`, the card when None, or a tensor); field_ffts: the
    {name: rfft mesh} of advect_fields.advected_field_ffts in the same
    space (RSD or real) as the tracer, holding config's zcv fields; meta:
    the cosmo.get_meta dict of the simulation at z_mock (None: the
    extract's, by config's sim_name). Returns pk_tr_dict with the keys the
    JAX package writes: k_binc, mu_binc and, for 'tr_tr' and each
    '{field}_tr', P_kmu_, N_kmu_, P_ell_, N_ell_."""
    keynames = list(config['zcv_params']['fields'])
    z_this = config['sim_params']['z_mock']
    pp = config['power_params']
    nmesh = config['zcv_params']['nmesh']
    if meta is None:
        meta = get_meta(config['sim_params']['sim_name'], redshift=z_this)
    Lbox = meta['BoxSize']
    paste, compensated, interlaced = pp['paste'], pp['compensated'], pp['interlaced']

    k_bin_edges, mu_bin_edges = get_k_mu_edges(Lbox, pp['k_hMpc_max'], pp['nbins_k'],
                                               pp['nbins_mu'], pp['logk'])
    pk_tr_dict = {
        'k_binc': (k_bin_edges[1:] + k_bin_edges[:-1]) * 0.5,
        'mu_binc': (mu_bin_edges[1:] + mu_bin_edges[:-1]) * 0.5,
    }
    W = get_W_compensated(Lbox, nmesh, paste, interlaced) if compensated else None
    D, _ = growth_from_meta(meta, z_this, want_rsd)
    field_D = field_growth(D)

    # the tracer field, shifted into [0, Lbox) as the JAX package shifts it
    if isinstance(tracer_pos, torch.Tensor):
        device = tracer_pos.device
    cols = [torch.remainder(c + _f32(Lbox / 2.0), _f32(Lbox))
            for c in _pos_columns(tracer_pos, device)]
    tr_field_fft = get_field_fft(cols, Lbox, nmesh, paste, None, W, compensated, interlaced,
                                 cols[0].device)
    del cols

    stack = [tr_field_fft] + [field_ffts[kn] for kn in keynames]
    res = calc_pk_pairs_from_deltak(
        stack, Lbox, k_bin_edges, mu_bin_edges, poles=np.asarray(pp['poles']),
        pairs=tuple([(0, 0)] + [(i + 1, 0) for i in range(len(keynames))]),
    )
    for tag_ij, scale, P in (
        [('tr_tr', 1.0, res[(0, 0)])]
        + [(f'{kn}_tr', field_D[i], res[(i + 1, 0)]) for i, kn in enumerate(keynames)]
    ):
        pk_tr_dict[f'P_kmu_{tag_ij}'] = np.asarray(P['power']) * scale
        pk_tr_dict[f'N_kmu_{tag_ij}'] = np.asarray(P['N_mode'])
        pk_tr_dict[f'P_ell_{tag_ij}'] = np.asarray(P['binned_poles']) * scale
        pk_tr_dict[f'N_ell_{tag_ij}'] = np.asarray(P['N_mode_poles'])
    return pk_tr_dict
