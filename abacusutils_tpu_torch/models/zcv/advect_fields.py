r"""Zel'dovich advection of the IC bias fields and their 15 auto and cross
spectra (the compute of abacusutils_tpu/models/zcv/advect_fields.py:main,
arrays in and arrays out).

:func:`advected_positions` moves the lattice by the scaled displacement in
the f32 order of operations of ``main``; :func:`advected_field_ffts`
deposits the five fields (1cb, delta, delta^2, s^2, nabla^2 delta) on it
through K1's multi-weight form (``ops/power.py:get_field_ffts``: one launch
a stage); :func:`power_ij` bins every auto and cross spectrum with poles in
one K3 launch. :func:`main` is the chain's advection step on files: it
reads ``ic_filt`` and ``fields`` of ic_fields.main and writes the Fourier
fields, the P_ij table and, with save_3D_power, the pair cubes, under
JAX's names, columns and headers; with ``mesh=`` each field is painted and
transformed sharded over the mesh (``parallel/fft.py:field_fft_slab``),
gathered, and written by rank 0.
"""

import os
import warnings

import numpy as np
import torch

from ...config import DEFAULT_CONFIG, load_config
from ...convert import resolve_device
from ...io.asdf_file import open_asdf
from ...metadata import get_meta
from ...ops.grid import _f32
from ...ops.power import (
    calc_pk_pairs_from_deltak,
    get_field_ffts,
    get_k_mu_edges,
    get_W_compensated,
)
from .cosmo import growth_from_meta
from .files import k_tag, read_data, read_fft, sim_dirs
from .ic_fields import compress_asdf
from .tools_cv import ZCV_FIELDS, field_cube

__all__ = ['advected_positions', 'advected_field_ffts', 'field_growth', 'power_ij', 'main']


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


def main(path2config, want_rsd=False, alt_simname=None, save_3D_power=False,
         only_requested_fields=False, mesh=None, device=None):
    """Advect the five fields to z_mock and write, under ``zcv_dir/<sim>/z<z>/``,
    ``advected_{field}_field{rsd}_fft_nmesh{n}.asdf`` ({field}_Re and
    {field}_Im, f32) and ``power{rsd}_ij_<k tag>.asdf`` (power_ij's table), or
    with save_3D_power the pair cubes ``power{rsd}_{fi}_{fj}_nmesh{n}.asdf``
    (advect_fields.py:main). Files that exist are skipped; an existing P_ij
    table is read back and returned. path2config: a config dict or JSON
    file; only_requested_fields: zcv_params' fields only. The paint (K1's
    multi-weight form), FFTs and binning (K3) run on `device` (the card when
    None). With `mesh` (``parallel.mesh.make_mesh``; every rank calls main
    with the same config) each field is ``field_fft_slab`` (TSC only) on the
    mesh's devices, gathered on every rank; rank 0 writes the files and the
    ranks wait for it. Returns the P_ij dict (k_binc and mu_binc alone with
    save_3D_power)."""
    config = load_config(path2config)
    zp, pp = config['zcv_params'], config['power_params']
    nmesh, kcut = zp['nmesh'], zp['kcut']
    if only_requested_fields:
        keynames = list(zp['fields'])
        warnings.warn('Saving only requested fields.')
    else:
        keynames = list(ZCV_FIELDS)
    sim_name = alt_simname or config['sim_params']['sim_name']
    z_this = config['sim_params']['z_mock']
    rsd_str = '_rsd' if want_rsd else ''
    if mesh is not None:
        from ...parallel.mesh import mesh_device, mesh_rank

        dev, writer = mesh_device(mesh), mesh_rank(mesh) == 0
    else:
        dev, writer = resolve_device(device), True

    meta = get_meta(sim_name, redshift=z_this)
    Lbox = meta['BoxSize']
    k_bin_edges, mu_bin_edges = get_k_mu_edges(Lbox, pp['k_hMpc_max'], pp['nbins_k'],
                                               pp['nbins_mu'], pp['logk'])
    save_dir, save_z_dir = sim_dirs(zp['zcv_dir'], sim_name, z_this)
    os.makedirs(save_z_dir, exist_ok=True)
    ic_fn = save_dir / f'ic_filt_nmesh{nmesh:d}.asdf'
    fields_fn = save_dir / f'fields_nmesh{nmesh:d}.asdf'
    fft_fns = {kn: save_z_dir / f'advected_{kn}_field{rsd_str}_fft_nmesh{nmesh:d}.asdf'
               for kn in keynames}
    tag = k_tag(Lbox, nmesh, pp['k_hMpc_max'], pp['nbins_k'], pp['nbins_mu'], pp['logk'])
    power_ij_fn = save_z_dir / f'power{rsd_str}_ij_{tag}.asdf'

    D, f_growth = growth_from_meta(meta, z_this, want_rsd=want_rsd)
    print('D = ', D)
    field_D = field_growth(D)

    ffts = {}
    todo = [kn for kn in keynames if not os.path.exists(fft_fns[kn])]
    if todo:
        with open_asdf(ic_fn) as f:
            header = f['header']
            assert header['nmesh'] == nmesh, f'Mismatch in the file: {ic_fn}'
            assert np.isclose(header['kcut'], kcut), f'Mismatch in the file: {ic_fn}'
            disp = [np.asarray(f['data'][f'disp_{a}']) for a in 'xyz']
        pos = advected_positions(disp, Lbox, nmesh, D, f_growth, dev)
        del disp
        ws = []
        for kn in todo:
            if kn == '1cb':
                ws.append(None)
                continue
            with open_asdf(fields_fn) as f:
                assert f['header']['nmesh'] == nmesh
                assert np.isclose(f['header']['kcut'], kcut)
                ws.append(np.asarray(f['data'][kn]).reshape(-1))
        W = (get_W_compensated(Lbox, nmesh, pp['paste'], pp['interlaced'])
             if pp['compensated'] else None)
        if mesh is None:
            new = get_field_ffts(pos, Lbox, nmesh, pp['paste'], ws, W, pp['compensated'],
                                 pp['interlaced'], dev)
        else:
            new = _sharded_ffts(pos, Lbox, nmesh, pp, ws, mesh)
        del pos, ws
        header = {'sim_name': sim_name, 'Lbox': Lbox, 'nmesh': nmesh, 'kcut': kcut,
                  'compensated': pp['compensated'], 'interlaced': pp['interlaced'],
                  'paste': pp['paste']}
        for kn, F in zip(todo, new):
            print(kn)
            if writer:
                compress_asdf(fft_fns[kn], {f'{kn}_Re': F.real, f'{kn}_Im': F.imag}, header)
            ffts[kn] = F
        del new
        _wait_for_writer(mesh)

    def load_fft(kn):
        if kn in ffts:
            return ffts[kn]
        with open_asdf(fft_fns[kn]) as f:
            h = f['header']
            for key, val in (('sim_name', sim_name), ('nmesh', nmesh),
                             ('compensated', pp['compensated']),
                             ('interlaced', pp['interlaced']), ('paste', pp['paste'])):
                assert h[key] == val, f'Mismatch in the file: {fft_fns[kn]}'
            assert np.isclose(h['Lbox'], Lbox) and np.isclose(h['kcut'], kcut)
        return read_fft(fft_fns[kn], kn, dev)

    if os.path.exists(power_ij_fn) and not save_3D_power:
        return read_data(power_ij_fn)

    header = {'sim_name': sim_name, 'Lbox': Lbox, 'nmesh': nmesh, 'kcut': kcut}
    if not save_3D_power:
        pk_ij_dict = power_ij({kn: load_fft(kn) for kn in keynames}, Lbox, pp, D)
        if writer:
            compress_asdf(power_ij_fn, pk_ij_dict, header)
        _wait_for_writer(mesh)
        return pk_ij_dict

    for i in range(len(keynames)):
        for j in range(i + 1):
            fn = save_z_dir / f'power{rsd_str}_{keynames[i]}_{keynames[j]}_nmesh{nmesh:d}.asdf'
            if os.path.exists(fn):
                continue
            print('Computing cross-correlation of', keynames[i], keynames[j])
            cube = field_cube(load_fft(keynames[i]), load_fft(keynames[j]),
                              field_D[i] * field_D[j])
            if writer:
                compress_asdf(fn, {f'P_k3D_{keynames[i]}_{keynames[j]}': cube}, header)
            del cube
    _wait_for_writer(mesh)
    return {'k_binc': (k_bin_edges[1:] + k_bin_edges[:-1]) * 0.5,
            'mu_binc': (mu_bin_edges[1:] + mu_bin_edges[:-1]) * 0.5}


def _sharded_ffts(pos, Lbox, nmesh, pp, ws, mesh):
    """Each weight column's Fourier field by ``parallel.fft.field_fft_slab``
    (ws None: unit weight), gathered whole on every rank (advect_fields.py:
    main's mesh= route)."""
    from ...parallel.fft import field_fft_slab, gather_slab

    return [gather_slab(field_fft_slab(pos, Lbox, nmesh, mesh, w=w, paste=pp['paste'],
                                       compensated=pp['compensated'],
                                       interlaced=pp['interlaced']), mesh)
            for w in ws]


def _wait_for_writer(mesh):
    """Hold every rank of `mesh` until rank 0 has written its files."""
    if mesh is not None:
        import torch.distributed as dist

        from ...parallel.mesh import _group

        dist.barrier(group=_group(mesh))


def _cli(argv=None):
    """The command line of advect_fields.py:_cli, with --device: --want_rsd
    runs the RSD and the real-space advection, in that order."""
    import argparse

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--path2config', help='Path to the config file (JSON)',
                        default=DEFAULT_CONFIG)
    parser.add_argument('--want_rsd', action='store_true', help='Include RSD effects?')
    parser.add_argument('--alt_simname', help='Alternative simulation name')
    parser.add_argument('--save_3D_power', action='store_true',
                        help='Record full 3D power spectrum')
    parser.add_argument('--only_requested_fields', action='store_true',
                        help='Save only the fields requested in the config')
    parser.add_argument('--device', help='torch device of the advection (default: the card)')
    args = vars(parser.parse_args(argv))
    if args.pop('want_rsd'):
        for want_rsd in (True, False):
            main(want_rsd=want_rsd, **args)
    else:
        main(want_rsd=False, **args)


if __name__ == '__main__':
    _cli()
