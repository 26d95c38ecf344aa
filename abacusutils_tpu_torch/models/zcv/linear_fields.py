r"""The linear control-variate fields delta and delta mu^2 and their three
spectra (the compute of abacusutils_tpu/models/zcv/linear_fields.py:main,
arrays in and arrays out).

delta_k = rfftn(delta) / float32(nmesh^3) on the array's device (cuFFT on
the card), delta mu^2 from it (``ops/power.py:get_delta_mu2``), and the
three pairs' P(k, mu) and poles in one K3 launch
(``calc_pk_pairs_from_deltak``). :func:`main` is the LCV chain's file
step: it reads ``ic_filt`` of ic_fields.main under ``lcv_dir`` and writes
the spectra (or the pair cubes) under JAX's names, columns and headers.
"""

import os

import numpy as np
import torch

from ...config import load_config
from ...convert import resolve_device
from ...io.asdf_file import open_asdf
from ...metadata import get_meta
from ...ops.grid import _f32
from ...ops.power import _device_tensor, calc_pk_pairs_from_deltak, get_delta_mu2, get_k_mu_edges
from .files import k_tag, sim_dirs
from .ic_fields import compress_asdf

__all__ = ['LIN_FIELDS', 'linear_field_ffts', 'power_lin', 'linear_fields', 'main']

LIN_FIELDS = ('delta', 'deltamu2')


def linear_field_ffts(delta, nmesh, device=None):
    """{'delta': rfftn(delta) / float32(nmesh^3), 'deltamu2': delta_k mu^2}
    as complex64 meshes (linear_fields.py:main's fields_fft). delta: the
    (nmesh,)*3 filtered linear density (numpy goes to `device`, the card
    when None, or a tensor)."""
    nmesh = int(nmesh)
    d = _device_tensor(delta, device, torch.float32)
    delta_fft = torch.fft.rfftn(d) / _f32(nmesh**3)
    return {'delta': delta_fft, 'deltamu2': get_delta_mu2(delta_fft, nmesh)}


def power_lin(field_ffts, Lbox, power_params):
    """linear_fields.py:main's pk_lin_dict: k_binc, mu_binc and, for the
    pairs delta_delta, deltamu2_delta and deltamu2_deltamu2, P_kmu_, N_kmu_,
    P_ell_ and N_ell_, all from one K3 launch."""
    pp = power_params
    k_bin_edges, mu_bin_edges = get_k_mu_edges(Lbox, pp['k_hMpc_max'], pp['nbins_k'],
                                               pp['nbins_mu'], pp['logk'])
    pk_lin_dict = {
        'k_binc': (k_bin_edges[1:] + k_bin_edges[:-1]) * 0.5,
        'mu_binc': (mu_bin_edges[1:] + mu_bin_edges[:-1]) * 0.5,
    }
    res = calc_pk_pairs_from_deltak(
        [field_ffts[k] for k in LIN_FIELDS], Lbox, k_bin_edges, mu_bin_edges,
        poles=np.asarray(pp['poles']),
    )
    for i in range(len(LIN_FIELDS)):
        for j in range(i + 1):
            P = res[(i, j)]
            key = f'{LIN_FIELDS[i]}_{LIN_FIELDS[j]}'
            pk_lin_dict[f'P_kmu_{key}'] = np.asarray(P['power'])
            pk_lin_dict[f'N_kmu_{key}'] = np.asarray(P['N_mode'])
            pk_lin_dict[f'P_ell_{key}'] = np.asarray(P['binned_poles'])
            pk_lin_dict[f'N_ell_{key}'] = np.asarray(P['N_mode_poles'])
    return pk_lin_dict


def linear_fields(delta, Lbox, nmesh, power_params, device=None):
    """The compute of linear_fields.py:main: (pk_lin_dict, field_ffts), the
    spectra of :func:`power_lin` and the two Fourier fields of
    :func:`linear_field_ffts`, whose pair cubes the field-level LCV builds
    in the JAX package's order [delta delta, deltamu2 delta, deltamu2
    deltamu2]."""
    field_ffts = linear_field_ffts(delta, nmesh, device)
    return power_lin(field_ffts, Lbox, power_params), field_ffts


def main(path2config, alt_simname=None, save_3D_power=False, device=None):
    """The linear fields of ``lcv_dir/<sim>/ic_filt_nmesh{n}.asdf`` and their
    spectra, written to ``lcv_dir/<sim>/power_lin_<k tag>.asdf`` and
    returned; with save_3D_power the cubes ``power_{fi}_{fj}_lin_nmesh{n}
    .asdf`` under ``z<z>/`` instead, whose paths are returned in the order
    [delta delta, deltamu2 delta, deltamu2 deltamu2] (linear_fields.py:
    main). path2config: a config dict or JSON file; the FFT and K3 run on
    `device` (the card when None)."""
    config = load_config(path2config)
    lp, pp = config['lcv_params'], config['power_params']
    nmesh, kcut = lp['nmesh'], lp['kcut']
    sim_name = alt_simname or config['sim_params']['sim_name']
    z_this = config['sim_params']['z_mock']
    Lbox = get_meta(sim_name, redshift=z_this)['BoxSize']
    save_dir, save_z_dir = sim_dirs(lp['lcv_dir'], sim_name, z_this)
    os.makedirs(save_z_dir, exist_ok=True)
    tag = k_tag(Lbox, nmesh, pp['k_hMpc_max'], pp['nbins_k'], pp['nbins_mu'], pp['logk'])

    with open_asdf(save_dir / f'ic_filt_nmesh{nmesh:d}.asdf') as f:
        delta = np.asarray(f['data']['dens'])
    print('mean delta', np.mean(delta))
    field_ffts = linear_field_ffts(delta, nmesh, resolve_device(device))
    del delta
    header = {'sim_name': sim_name, 'Lbox': Lbox, 'nmesh': nmesh, 'kcut': kcut}
    if save_3D_power:
        fns = []
        for i in range(len(LIN_FIELDS)):
            for j in range(i + 1):
                a, b = LIN_FIELDS[i], LIN_FIELDS[j]
                fn = save_z_dir / f'power_{a}_{b}_lin_nmesh{nmesh:d}.asdf'
                cube = (field_ffts[a] * field_ffts[b].conj()).real
                compress_asdf(fn, {f'P_k3D_{a}_{b}': cube}, header)
                fns.append(fn)
        return fns
    pk_lin_dict = power_lin(field_ffts, Lbox, pp)
    compress_asdf(save_dir / f'power_lin_{tag}.asdf', pk_lin_dict, header)
    return pk_lin_dict
