r"""Initial-condition field operators for the control variates
(the counterpart of abacusutils_tpu/models/zcv/ic_fields.py).

Builds the quadratic bias fields (delta, delta^2, s^2, nabla^2 delta) from
the linear IC density with ``torch.fft`` and elementwise tensor ops, in the
f32 arithmetic of the JAX package's ``_fields_jit``. s^2 is accumulated one
s_ij component at a time (as ``ops/shear.py`` does), so the working set is a
few grids instead of six complex ones. numpy inputs go to `device` (the card
when None); tensors stay where they are. :func:`main` is the first file
step of the ZCV chain: the filtered IC and the bias fields, written under
``zcv_dir`` with JAX's file names, columns and headers.
:func:`get_fields_sharded` computes the same fields with the grid sharded
in x-slabs over a device mesh (``parallel/fft.py``'s transpose FFTs), and
``get_fields(mesh=)`` gathers them.
"""

import os
from pathlib import Path

import numpy as np
import torch

from ...config import DEFAULT_CONFIG, load_config
from ...convert import resolve_device
from ...io.asdf_file import open_asdf, write_asdf
from ...metadata import get_meta
from ...ops.grid import _f32

__all__ = ['get_fields', 'get_fields_sharded', 'gaussian_filter', 'filter_field', 'get_n2_fft',
           'get_sij_fft', 'add_ij', 'get_dk_to_s2', 'get_dk_to_n2', 'compress_asdf',
           'load_dens', 'load_disp', 'main']

# s_ij components (i, j) and their factor in s^2 = sum_ij s_ij^2, in the
# order of ic_fields.py:_fields_jit
SIJ = ((0, 0, 1.0), (0, 1, 2.0), (0, 2, 2.0), (1, 1, 1.0), (1, 2, 2.0), (2, 2, 1.0))


def _grid(a, device):
    if isinstance(a, torch.Tensor):
        return a
    return torch.from_numpy(np.ascontiguousarray(a)).to(resolve_device(device))


def _kvec(n1d, lbox, device):
    """The f32 k of each mesh axis (kv, length n1d) and of the rfft axis (kz,
    n1d // 2 + 1), ic_fields.py:_kvec."""
    dk = _f32(2 * np.pi / lbox)
    i = torch.arange(n1d, device=device)
    kv = torch.where(i < n1d // 2, i, i - n1d).to(torch.float32) * dk
    kz = torch.arange(n1d // 2 + 1, device=device).to(torch.float32) * dk
    return kv, kz


def _kaxes(n1d, lbox, device):
    kv, kz = _kvec(n1d, lbox, device)
    return kv[:, None, None], kv[None, :, None], kz[None, None, :]


def _k2(ks):
    return ks[0] * ks[0] + ks[1] * ks[1] + ks[2] * ks[2]


def _inv_k2(k2):
    return torch.where(k2 > 0, 1.0 / torch.where(k2 > 0, k2, 1.0), 0.0)


def gaussian_filter(field, nmesh, lbox, kcut, device=None):
    """Gaussian k-space filter exp(-k^2 / (2 kcut^2)) of a real field
    (ic_fields.py:gaussian_filter). Returns an f32 tensor."""
    field = _grid(field, device).to(torch.float32)
    k2 = _k2(_kaxes(nmesh, lbox, field.device))
    fk = torch.fft.rfftn(field)
    fk *= torch.exp(-k2 / _f32(2.0 * kcut**2))
    return torch.fft.irfftn(fk, s=field.shape)


def filter_field(delta_k, n1d, L, kcut, device=None):
    """The rfft field `delta_k` times exp(-k^2 / (2 kcut^2))."""
    delta_k = _grid(delta_k, device).to(torch.complex64)
    k2 = _k2(_kaxes(n1d, L, delta_k.device))
    return delta_k * torch.exp(-k2 / _f32(2.0 * kcut**2))


def get_n2_fft(delta_k, n1d, L, device=None):
    """-k^2 delta_k in Fourier space (ic_fields.py:get_n2_fft)."""
    delta_k = _grid(delta_k, device).to(torch.complex64)
    return -_k2(_kaxes(n1d, L, delta_k.device)) * delta_k


def get_sij_fft(i_comp, j_comp, delta_k, n1d, L, device=None):
    """(k_i k_j / k^2 - delta_ij / 3) delta_k (ic_fields.py:get_sij_fft)."""
    delta_k = _grid(delta_k, device).to(torch.complex64)
    ks = _kaxes(n1d, L, delta_k.device)
    sij = delta_k * (ks[i_comp] * ks[j_comp] * _inv_k2(_k2(ks)))
    if i_comp == j_comp:
        sij = sij - delta_k * _f32(1.0 / 3.0)
    return sij


def add_ij(final_field, field_to_add, n1d, factor=1.0, dtype=np.float32):
    """final_field += factor * field_to_add^2, in place, `factor` rounded to
    `dtype` (ic_fields.py:add_ij); numpy arrays or tensors."""
    if isinstance(final_field, torch.Tensor):
        final_field += float(dtype(factor)) * field_to_add**2
    else:
        final_field += dtype(factor) * np.asarray(field_to_add) ** 2
    return final_field


def get_dk_to_s2(delta_k, nmesh, lbox, device=None):
    """s^2 = s_ij s^ij from the density's rfft, not mean-subtracted
    (ic_fields.py:get_dk_to_s2): an f32 tensor on delta_k's device (the card
    for numpy input when `device` is None)."""
    delta_k = _grid(delta_k, device).to(torch.complex64)
    shape = (int(nmesh),) * 3
    tidesq = torch.zeros(shape, dtype=torch.float32, device=delta_k.device)
    for i, j, factor in SIJ:
        sij = torch.fft.irfftn(get_sij_fft(i, j, delta_k, nmesh, lbox), s=shape)
        add_ij(tidesq, sij, nmesh, factor)
    return tidesq


def get_dk_to_n2(delta_k, nmesh, lbox, device=None):
    """nabla^2 delta = IFFT(-k^2 delta_k) (ic_fields.py:get_dk_to_n2): an f32
    tensor on delta_k's device."""
    delta_k = _grid(delta_k, device).to(torch.complex64)
    return torch.fft.irfftn(get_n2_fft(delta_k, nmesh, lbox), s=(int(nmesh),) * 3)


def get_fields(delta_lin, Lbox, nmesh, device=None, mesh=None):
    """(delta, delta^2, s^2, nabla^2 delta) of the linear density
    (ic_fields.py:get_fields / _fields_jit): delta and delta^2 with their
    means subtracted, s^2 = sum_ij s_ij^2 with the factors (1, 2, 2, 1, 2,
    1) and its mean subtracted, nabla^2 delta = IFFT(-k^2 delta_k). Four f32
    (nmesh,)*3 tensors on the input's device. With `mesh` (a
    ``parallel.mesh.make_mesh`` mesh) the fields are computed sharded
    (:func:`get_fields_sharded`) and gathered: the whole fields on every
    rank's device."""
    if mesh is not None:
        from ...parallel.fft import gather_slab

        return tuple(gather_slab(f, mesh, dim=0)
                     for f in get_fields_sharded(delta_lin, Lbox, nmesh, mesh))
    delta_lin = _grid(delta_lin, device).to(torch.float32)
    shape = (int(nmesh),) * 3
    delta_fft = torch.fft.rfftn(delta_lin)

    d = delta_lin - delta_lin.mean()
    d2 = delta_lin * delta_lin
    d2 -= d2.mean()

    ks = _kaxes(int(nmesh), float(Lbox), delta_lin.device)
    k2 = _k2(ks)
    inv_k2 = _inv_k2(k2)
    third = _f32(1.0 / 3.0)
    s2 = torch.zeros(shape, dtype=torch.float32, device=delta_lin.device)
    for i, j, factor in SIJ:
        w = ks[i] * ks[j] * inv_k2
        if i == j:
            w = w - third
        sij = torch.fft.irfftn(delta_fft * w, s=shape)
        s2 += factor * (sij * sij)
        del sij
    s2 -= s2.mean()

    n2 = torch.fft.irfftn(-k2 * delta_fft, s=shape)
    return d, d2, s2, n2


def get_fields_sharded(delta_lin, Lbox, nmesh, mesh):
    """:func:`get_fields` with the density grid sharded end to end
    (ic_fields.py:get_fields_sharded): each rank uploads its x-slab of
    `delta_lin` (numpy or a tensor, the whole grid on every rank), the
    forward transform is ``parallel.fft.slab_rfftn``, the k-space products
    take the rank's ky rows, each inverse is a slab irfftn, and the field
    means meet in all_reduces. Returns four ``parallel.mesh.LocalSlab``
    pieces: the rank's (nmesh / n, nmesh, nmesh) x-slabs and their first
    plane. A rank's memory is ~1/n of :func:`get_fields`'."""
    from ...parallel.fft import slab_irfftn, slab_rfftn
    from ...parallel.mesh import LocalSlab, _xl, all_reduce, mesh_device, mesh_rank

    nmesh = int(nmesh)
    xl = _xl(nmesh, mesh, False)
    x0 = mesh_rank(mesh) * xl
    dev = mesh_device(mesh)
    if isinstance(delta_lin, torch.Tensor):
        slab = delta_lin[x0:x0 + xl].to(dev, torch.float32)
    else:
        slab = torch.from_numpy(np.ascontiguousarray(np.asarray(delta_lin)[x0:x0 + xl],
                                                     np.float32)).to(dev)
    n3 = float(nmesh) ** 3

    def mean(f):
        return all_reduce(f.sum().reshape(1), mesh)[0] / _f32(n3)

    delta_fft = slab_rfftn(slab, mesh)
    d = slab - mean(slab)
    d2 = slab * slab
    d2 -= mean(d2)
    kv, kz = _kvec(nmesh, float(Lbox), dev)
    ks = (kv[:, None, None], kv[None, x0:x0 + xl, None], kz[None, None, :])
    k2 = _k2(ks)
    inv_k2 = _inv_k2(k2)
    third = _f32(1.0 / 3.0)
    s2 = torch.zeros_like(slab)
    for i, j, factor in SIJ:
        w = ks[i] * ks[j] * inv_k2
        if i == j:
            w = w - third
        sij = slab_irfftn(delta_fft * w, mesh, nmesh)
        s2 += factor * (sij * sij)
        del sij
    s2 -= mean(s2)
    n2 = slab_irfftn(-k2 * delta_fft, mesh, nmesh)
    return tuple(LocalSlab(f, x0) for f in (d, d2, s2, n2))


# ---------------------------------------------------------------------------
# the file layer (ic_fields.py:compress_asdf, load_dens, load_disp, main)
# ---------------------------------------------------------------------------


def compress_asdf(asdf_fn, table, header):
    """Write the columns `table` and `header` to a blsc-compressed ASDF file
    (ic_fields.py:compress_asdf); tensors are copied to the host."""
    data = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in dict(table).items()}
    write_asdf(str(asdf_fn), {'data': data, 'header': dict(header)}, compression='blsc')


def load_dens(ic_dir, sim_name, nmesh):
    """The IC density ``ic_dens_N{nmesh}.asdf`` of `sim_name` under `ic_dir`."""
    with open_asdf(Path(ic_dir) / sim_name / f'ic_dens_N{nmesh:d}.asdf') as f:
        return np.asarray(f['data']['density'])


def load_disp(ic_dir, sim_name, nmesh):
    """The IC displacement ``ic_disp_N{nmesh}.asdf`` of `sim_name` under
    `ic_dir`, its three components in units of the box."""
    with open_asdf(Path(ic_dir) / sim_name / f'ic_disp_N{nmesh:d}.asdf') as f:
        Lbox = f['header']['BoxSize']
        disp = np.asarray(f['data']['displacements'])
        return disp[..., 0] / Lbox, disp[..., 1] / Lbox, disp[..., 2] / Lbox


def cv_params(config):
    """(the zcv or lcv section of `config`, the name of its directory key):
    zcv_params when there is one, else lcv_params (ic_fields.py:main)."""
    if 'zcv_params' in config:
        return config['zcv_params'], 'zcv_dir'
    return config['lcv_params'], 'lcv_dir'


def main(path2config, alt_simname=None, verbose=False, device=None):
    """Write the filtered IC ``ic_filt_nmesh{n}.asdf`` (dens and disp_x,
    disp_y, disp_z, Gaussian-filtered at kcut) and the bias fields
    ``fields_nmesh{n}.asdf`` (delta, delta2, nabla2, tidal2) under
    ``zcv_dir/<sim_name>`` (or lcv_dir), skipping each file that exists
    (ic_fields.py:main). path2config: a config dict or JSON file; the IC is
    read from ``ic_dir``'s ``ic_dens_N{n}.asdf`` / ``ic_disp_N{n}.asdf``.
    The filters and fields run on `device` (the card when None)."""
    config = load_config(path2config)
    cv, dir_key = cv_params(config)
    zcv_dir, ic_dir, nmesh, kcut = cv[dir_key], cv['ic_dir'], cv['nmesh'], cv['kcut']
    sim_name = alt_simname or config['sim_params']['sim_name']
    z_this = config['sim_params']['z_mock']
    dev = resolve_device(device)

    save_dir = Path(zcv_dir) / sim_name
    os.makedirs(save_dir, exist_ok=True)
    Lbox = get_meta(sim_name, redshift=z_this)['BoxSize']
    ic_fn = save_dir / f'ic_filt_nmesh{nmesh:d}.asdf'
    fields_fn = save_dir / f'fields_nmesh{nmesh:d}.asdf'
    header = {'sim_name': sim_name, 'Lbox': Lbox, 'nmesh': nmesh, 'kcut': kcut}

    if os.path.exists(ic_fn):
        with open_asdf(ic_fn) as f:
            dens = np.asarray(f['data']['dens'])
    else:
        dens = gaussian_filter(load_dens(ic_dir, sim_name, nmesh), nmesh, Lbox, kcut, dev)
        disp = [gaussian_filter(d, nmesh, Lbox, kcut, dev)
                for d in load_disp(ic_dir, sim_name, nmesh)]
        compress_asdf(ic_fn, {'dens': dens, 'disp_x': disp[0], 'disp_y': disp[1],
                              'disp_z': disp[2]}, header)
        del disp
        if verbose:
            print('Saved filtered displacement and density fields')

    if os.path.exists(fields_fn):
        print('Already saved fields for this simulation')
        return
    d, d2, s2, n2 = get_fields(dens, Lbox, nmesh, dev)
    compress_asdf(fields_fn, {'delta': d, 'delta2': d2, 'nabla2': n2, 'tidal2': s2}, header)
    print('Saved all filtered fields for this simulation')


def _cli(argv=None):
    """The command line of ic_fields.py's ``__main__``, with --device."""
    import argparse

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--path2config', default=DEFAULT_CONFIG)
    parser.add_argument('--alt_simname')
    parser.add_argument('--verbose', action='store_true')
    parser.add_argument('--device', help='torch device of the fields (default: the card)')
    return main(**vars(parser.parse_args(argv)))


if __name__ == '__main__':
    _cli()
