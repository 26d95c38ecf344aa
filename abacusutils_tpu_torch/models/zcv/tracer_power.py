r"""Tracer auto spectra and their crosses with the control-variate fields
(the counterpart of abacusutils_tpu/models/zcv/tracer_power.py, arrays in
and arrays out): ``get_tracer_power`` against the advected ZCV fields,
``get_recon_power`` against the linear LCV fields.

The tracer field is painted by K1 (``ops/power.py:get_field_fft``); its
auto spectrum and its crosses with the fields come from one K3 launch over
the tracer and the fields held in memory. With ``save_3D_power`` each
returns the tracer's Fourier field, from which the field-level flows
(``tools_cv.run_zcv_field``, ``run_lcv_field``) build their 3-D power. No
ASDF memo file is read or written.
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

__all__ = ['get_tracer_power', 'get_recon_power']


def _setup(config, cv, meta):
    """(pp, nmesh, meta, Lbox, k_bin_edges, mu_bin_edges, W, pk_tr_dict with
    k_binc and mu_binc) of a tracer-power call."""
    pp = config['power_params']
    nmesh = config[cv]['nmesh']
    if meta is None:
        meta = get_meta(config['sim_params']['sim_name'], redshift=config['sim_params']['z_mock'])
    Lbox = meta['BoxSize']
    k_bin_edges, mu_bin_edges = get_k_mu_edges(Lbox, pp['k_hMpc_max'], pp['nbins_k'],
                                               pp['nbins_mu'], pp['logk'])
    W = (get_W_compensated(Lbox, nmesh, pp['paste'], pp['interlaced'])
         if pp['compensated'] else None)
    pk_tr_dict = {
        'k_binc': (k_bin_edges[1:] + k_bin_edges[:-1]) * 0.5,
        'mu_binc': (mu_bin_edges[1:] + mu_bin_edges[:-1]) * 0.5,
    }
    return pp, nmesh, meta, Lbox, k_bin_edges, mu_bin_edges, W, pk_tr_dict


def _paint(cols, Lbox, nmesh, pp, W):
    return get_field_fft(cols, Lbox, nmesh, pp['paste'], None, W, pp['compensated'],
                         pp['interlaced'], cols[0].device)


def _spectra(pk_tr_dict, stack, keynames, scales, Lbox, k_bin_edges, mu_bin_edges, poles):
    """The tracer auto and its crosses with each field of `stack` after the
    tracer, from one K3 launch, scaled by `scales` (one a field)."""
    res = calc_pk_pairs_from_deltak(
        stack, Lbox, k_bin_edges, mu_bin_edges, poles=np.asarray(poles),
        pairs=tuple([(0, 0)] + [(i + 1, 0) for i in range(len(keynames))]),
    )
    for tag_ij, scale, P in (
        [('tr_tr', 1.0, res[(0, 0)])]
        + [(f'{kn}_tr', scales[i], res[(i + 1, 0)]) for i, kn in enumerate(keynames)]
    ):
        pk_tr_dict[f'P_kmu_{tag_ij}'] = np.asarray(P['power']) * scale
        pk_tr_dict[f'N_kmu_{tag_ij}'] = np.asarray(P['N_mode'])
        pk_tr_dict[f'P_ell_{tag_ij}'] = np.asarray(P['binned_poles']) * scale
        pk_tr_dict[f'N_ell_{tag_ij}'] = np.asarray(P['N_mode_poles'])
    return pk_tr_dict


def get_tracer_power(tracer_pos, want_rsd, config, field_ffts=None, meta=None, device=None,
                     save_3D_power=False):
    """Auto P_tr,tr and the crosses P_{field,tr} with the advected fields
    (tracer_power.py:get_tracer_power, ZCV).

    tracer_pos: (N, 3) positions in [-Lbox/2, Lbox/2) (numpy, going to
    `device`, the card when None, or a tensor); field_ffts: the
    {name: rfft mesh} of advect_fields.advected_field_ffts in the same
    space (RSD or real) as the tracer, holding config's zcv fields; meta:
    the cosmo.get_meta dict of the simulation at z_mock (None: the
    extract's, by config's sim_name). Returns pk_tr_dict with the keys the
    JAX package writes: k_binc, mu_binc and, for 'tr_tr' and each
    '{field}_tr', P_kmu_, N_kmu_, P_ell_, N_ell_. With save_3D_power,
    returns the tracer's Fourier field instead (the field-level flow's
    input; field_ffts is not read)."""
    keynames = list(config['zcv_params']['fields'])
    pp, nmesh, meta, Lbox, k_bin_edges, mu_bin_edges, W, pk_tr_dict = _setup(
        config, 'zcv_params', meta)

    # the tracer field, shifted into [0, Lbox) as the JAX package shifts it
    if isinstance(tracer_pos, torch.Tensor):
        device = tracer_pos.device
    cols = [torch.remainder(c + _f32(Lbox / 2.0), _f32(Lbox))
            for c in _pos_columns(tracer_pos, device)]
    tr_field_fft = _paint(cols, Lbox, nmesh, pp, W)
    del cols
    if save_3D_power:
        return tr_field_fft

    D, _ = growth_from_meta(meta, config['sim_params']['z_mock'], want_rsd)
    stack = [tr_field_fft] + [field_ffts[kn] for kn in keynames]
    return _spectra(pk_tr_dict, stack, keynames, field_growth(D), Lbox, k_bin_edges,
                    mu_bin_edges, pp['poles'])


def get_recon_power(tracer_pos, random_pos, want_rsd, config, lin_ffts=None, meta=None,
                    device=None, save_3D_power=False, tr_field_fft=None):
    """Auto P_tr,tr and the crosses with the linear fields delta and
    delta mu^2 (tracer_power.py:get_recon_power, LCV).

    tracer_pos, random_pos: (N, 3) reconstructed positions in [0, Lbox)
    (numpy, going to `device`, the card when None, or tensors), painted as
    they are (the JAX package does not shift them, unlike
    get_tracer_power's); the randoms' field, when given, is subtracted from
    the tracer's. lin_ffts: the {'delta', 'deltamu2'} meshes of
    linear_fields.linear_field_ffts (precompute.LCVProducts.field_ffts);
    meta: the cosmo.get_meta dict at z_mock (None: the extract's).
    tr_field_fft: the tracer's Fourier field of an earlier call, taken
    instead of painting (the JAX package's want_load_tr_fft). Returns
    pk_tr_dict (k_binc, mu_binc and, for 'tr_tr', 'delta_tr' and
    'deltamu2_tr', P_kmu_, N_kmu_, P_ell_, N_ell_), all from one K3 launch;
    with save_3D_power the tracer's Fourier field (the input of
    tools_cv.run_lcv_field; lin_ffts is not read)."""
    keynames = ['delta', 'deltamu2']
    pp, nmesh, meta, Lbox, k_bin_edges, mu_bin_edges, W, pk_tr_dict = _setup(
        config, 'lcv_params', meta)

    if tr_field_fft is None:
        if isinstance(tracer_pos, torch.Tensor):
            device = tracer_pos.device
        cols = _pos_columns(tracer_pos, device)
        tr_field_fft = _paint(cols, Lbox, nmesh, pp, W)
        if random_pos is not None:
            rn = _pos_columns(random_pos, cols[0].device)
            tr_field_fft = tr_field_fft - _paint(rn, Lbox, nmesh, pp, W)
        del cols
    if save_3D_power:
        return tr_field_fft

    stack = [tr_field_fft] + [lin_ffts[kn] for kn in keynames]
    return _spectra(pk_tr_dict, stack, keynames, [1.0, 1.0], Lbox, k_bin_edges, mu_bin_edges,
                    pp['poles'])
