r"""Tracer auto spectra and their crosses with the control-variate fields
(the counterpart of abacusutils_tpu/models/zcv/tracer_power.py, arrays in
and arrays out): ``get_tracer_power`` against the advected ZCV fields,
``get_recon_power`` against the linear LCV fields.

The tracer field is painted by K1 (``ops/power.py:get_field_fft``); its
auto spectrum and its crosses with the fields come from one K3 launch over
the tracer and the fields held in memory. With ``save_3D_power`` each
returns the tracer's Fourier field, from which the field-level flows
(``tools_cv.run_zcv_field``, ``run_lcv_field``) build their 3-D power.

The file layer is JAX's: without fields in memory they are read from the
chain's files under ``zcv_dir`` (``lcv_dir``), and with ``want_save`` the
tracer's field (``tr_field{rsd}_fft*``), its spectra
(``power{rsd}_tr{tag}_*``) and, with save_3D_power, its cubes are written
under ``tracer_dir`` (default the zcv_dir) with JAX's names, columns and
headers.
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
from .files import k_tag, read_fft, sim_dirs
from .ic_fields import compress_asdf

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


def _file_header(config, cv, meta, kcut=False):
    pp = config['power_params']
    h = {'sim_name': config['sim_params']['sim_name'], 'Lbox': meta['BoxSize'],
         'nmesh': config[cv]['nmesh']}
    if kcut:
        h['kcut'] = config[cv]['kcut']
    else:
        h.update(compensated=pp['compensated'], interlaced=pp['interlaced'], paste=pp['paste'])
    return h


def _save_tr_field(fn, tr_field_fft, config, cv, meta):
    compress_asdf(fn, {'tr_field_fft_Re': tr_field_fft.real, 'tr_field_fft_Im': tr_field_fft.imag},
                  _file_header(config, cv, meta))


def _save_cubes(save_z_dir, stem, tr_field_fft, fields, scales, config, cv, meta, tag=''):
    """The tracer's auto cube and its cubes with `fields` (a {name: mesh}
    dict, each cube times its scale), written as power{stem}_tr_tr*,
    power{stem}_{field}_tr* (tracer_power.py, save_3D_power); returns the
    paths, the auto first."""
    nmesh = config[cv]['nmesh']
    header = _file_header(config, cv, meta, kcut=True)
    rsd, suffix = stem
    fns = [save_z_dir / f'power{rsd}_tr_tr{suffix}{tag}_nmesh{nmesh:d}.asdf']
    compress_asdf(fns[0], {'P_k3D_tr_tr': (tr_field_fft * tr_field_fft.conj()).real}, header)
    for (kn, F), scale in zip(fields.items(), scales):
        fns.append(save_z_dir / f'power{rsd}_{kn}_tr{suffix}{tag}_nmesh{nmesh:d}.asdf')
        cube = (F * tr_field_fft.conj()).real
        if scale != 1.0:
            cube = cube * _f32(scale)
        compress_asdf(fns[-1], {f'P_k3D_{kn}_tr': cube}, header)
    return fns


def get_tracer_power(tracer_pos, want_rsd, config, field_ffts=None, meta=None, device=None,
                     save_3D_power=False, want_save=False, tracer_tag=''):
    """Auto P_tr,tr and the crosses P_{field,tr} with the advected fields
    (tracer_power.py:get_tracer_power, ZCV).

    tracer_pos: (N, 3) positions in [-Lbox/2, Lbox/2) (numpy, going to
    `device`, the card when None, or a tensor); field_ffts: the
    {name: rfft mesh} of advect_fields.advected_field_ffts in the same
    space (RSD or real) as the tracer, holding config's zcv fields (None:
    read from advect_fields.main's files under zcv_dir); meta: the
    cosmo.get_meta dict of the simulation at z_mock (None: the
    registry's, by config's sim_name). Returns pk_tr_dict with the keys the
    JAX package writes: k_binc, mu_binc and, for 'tr_tr' and each
    '{field}_tr', P_kmu_, N_kmu_, P_ell_, N_ell_. With save_3D_power,
    returns the tracer's Fourier field instead (the field-level flow's
    input; field_ffts is not read).

    want_save: write, under zcv_params' tracer_dir (default zcv_dir),
    ``tr_field{rsd}_fft{_tag}_nmesh{n}.asdf`` and ``power{rsd}_tr{_tag}_<k
    tag>.asdf``, or with save_3D_power the cubes ``power{rsd}_tr_tr{_tag}``
    and ``power{rsd}_{field}_tr{_tag}`` (the fields then read as without
    field_ffts); tracer_tag names a tracer's files ('' for one tracer)."""
    keynames = list(config['zcv_params']['fields'])
    pp, nmesh, meta, Lbox, k_bin_edges, mu_bin_edges, W, pk_tr_dict = _setup(
        config, 'zcv_params', meta)
    zp, z_this = config['zcv_params'], config['sim_params']['z_mock']
    sim_name = config['sim_params']['sim_name']
    rsd_str = '_rsd' if want_rsd else ''
    tag = f'_{tracer_tag}' if tracer_tag else ''
    if want_save:
        _, save_z_dir = sim_dirs(zp.get('tracer_dir', zp['zcv_dir']), sim_name, z_this)

    # the tracer field, shifted into [0, Lbox) as the JAX package shifts it
    if isinstance(tracer_pos, torch.Tensor):
        device = tracer_pos.device
    cols = [torch.remainder(c + _f32(Lbox / 2.0), _f32(Lbox))
            for c in _pos_columns(tracer_pos, device)]
    tr_field_fft = _paint(cols, Lbox, nmesh, pp, W)
    del cols
    if want_save:
        save_z_dir.mkdir(exist_ok=True, parents=True)
        _save_tr_field(save_z_dir / f'tr_field{rsd_str}_fft{tag}_nmesh{nmesh:d}.asdf',
                       tr_field_fft, config, 'zcv_params', meta)

    D, _ = growth_from_meta(meta, z_this, want_rsd)
    if field_ffts is None and (want_save or not save_3D_power):
        _, advected_z_dir = sim_dirs(zp['zcv_dir'], sim_name, z_this)
        field_ffts = {kn: read_fft(advected_z_dir / f'advected_{kn}_field{rsd_str}_fft_nmesh'
                                                    f'{nmesh:d}.asdf', kn, tr_field_fft.device)
                      for kn in keynames}
    if save_3D_power:
        if want_save:
            _save_cubes(save_z_dir, (rsd_str, ''), tr_field_fft,
                        {kn: field_ffts[kn] for kn in keynames}, field_growth(D), config,
                        'zcv_params', meta, tag)
        return tr_field_fft

    stack = [tr_field_fft] + [field_ffts[kn] for kn in keynames]
    pk_tr_dict = _spectra(pk_tr_dict, stack, keynames, field_growth(D), Lbox, k_bin_edges,
                          mu_bin_edges, pp['poles'])
    if want_save:
        ktag = k_tag(Lbox, nmesh, pp['k_hMpc_max'], pp['nbins_k'], pp['nbins_mu'], pp['logk'])
        compress_asdf(save_z_dir / f'power{rsd_str}_tr{tag}_{ktag}.asdf', pk_tr_dict,
                      _file_header(config, 'zcv_params', meta, kcut=True))
    return pk_tr_dict


def get_recon_power(tracer_pos, random_pos, want_rsd, config, lin_ffts=None, meta=None,
                    device=None, save_3D_power=False, tr_field_fft=None, want_save=False,
                    want_load_tr_fft=False):
    """Auto P_tr,tr and the crosses with the linear fields delta and
    delta mu^2 (tracer_power.py:get_recon_power, LCV).

    tracer_pos, random_pos: (N, 3) reconstructed positions in [0, Lbox)
    (numpy, going to `device`, the card when None, or tensors), painted as
    they are (the JAX package does not shift them, unlike
    get_tracer_power's); the randoms' field, when given, is subtracted from
    the tracer's. lin_ffts: the {'delta', 'deltamu2'} meshes of
    linear_fields.linear_field_ffts (precompute.LCVProducts.field_ffts;
    None: made from ``lcv_dir/<sim>/ic_filt_nmesh{n}.asdf``); meta: the
    cosmo.get_meta dict at z_mock (None: the registry's). tr_field_fft: the
    tracer's Fourier field of an earlier call, taken instead of painting;
    want_load_tr_fft: read it from ``tr_field{rsd}_fft_nmesh{n}.asdf`` under
    lcv_dir instead (the JAX package's). want_save: write the painted field
    there, and the spectra as ``power{rsd}_tr_{rec_algo}_lin_<k tag>.asdf``
    (with save_3D_power the cubes ``power{rsd}_tr_tr_{rec_algo}_lin_*`` and
    ``power{rsd}_{field}_tr_{rec_algo}_lin_*``). Returns pk_tr_dict (k_binc,
    mu_binc and, for 'tr_tr', 'delta_tr' and 'deltamu2_tr', P_kmu_, N_kmu_,
    P_ell_, N_ell_), all from one K3 launch; with save_3D_power the
    tracer's Fourier field (the input of tools_cv.run_lcv_field; lin_ffts
    is read only to save the cubes)."""
    from .linear_fields import linear_field_ffts
    from ...io.asdf_file import open_asdf

    keynames = ['delta', 'deltamu2']
    pp, nmesh, meta, Lbox, k_bin_edges, mu_bin_edges, W, pk_tr_dict = _setup(
        config, 'lcv_params', meta)
    lp, z_this = config['lcv_params'], config['sim_params']['z_mock']
    save_dir, save_z_dir = sim_dirs(lp['lcv_dir'], config['sim_params']['sim_name'], z_this) \
        if 'lcv_dir' in lp else (None, None)
    rsd_str = '_rsd' if want_rsd else ''
    tr_fn = None if save_z_dir is None else save_z_dir / f'tr_field{rsd_str}_fft_nmesh{nmesh:d}.asdf'

    if want_load_tr_fft:
        tr_field_fft = read_fft(tr_fn, 'tr_field_fft', device)
    if tr_field_fft is None:
        if isinstance(tracer_pos, torch.Tensor):
            device = tracer_pos.device
        cols = _pos_columns(tracer_pos, device)
        tr_field_fft = _paint(cols, Lbox, nmesh, pp, W)
        if random_pos is not None:
            rn = _pos_columns(random_pos, cols[0].device)
            tr_field_fft = tr_field_fft - _paint(rn, Lbox, nmesh, pp, W)
        del cols
        if want_save:
            save_z_dir.mkdir(exist_ok=True, parents=True)
            _save_tr_field(tr_fn, tr_field_fft, config, 'lcv_params', meta)
    if lin_ffts is None and (want_save or not save_3D_power):
        with open_asdf(save_dir / f'ic_filt_nmesh{nmesh:d}.asdf') as f:
            dens = np.asarray(f['data']['dens'])
        lin_ffts = linear_field_ffts(dens, nmesh, tr_field_fft.device)
    rec = config['HOD_params']['rec_algo']
    if save_3D_power:
        if want_save:
            _save_cubes(save_z_dir, (rsd_str, f'_{rec}_lin'), tr_field_fft, lin_ffts, [1.0, 1.0],
                        config, 'lcv_params', meta)
        return tr_field_fft

    stack = [tr_field_fft] + [lin_ffts[kn] for kn in keynames]
    pk_tr_dict = _spectra(pk_tr_dict, stack, keynames, [1.0, 1.0], Lbox, k_bin_edges,
                          mu_bin_edges, pp['poles'])
    if want_save:
        ktag = k_tag(Lbox, nmesh, pp['k_hMpc_max'], pp['nbins_k'], pp['nbins_mu'], pp['logk'])
        compress_asdf(save_z_dir / f'power{rsd_str}_tr_{rec}_lin_{ktag}.asdf', pk_tr_dict,
                      _file_header(config, 'lcv_params', meta, kcut=True))
    return pk_tr_dict
