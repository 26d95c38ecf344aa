"""The file names and readers the ZCV / LCV chain shares (the JAX package's
``zcv_dir`` / ``lcv_dir`` layout): ``<dir>/<sim_name>/`` holds the IC
products and the window, ``<dir>/<sim_name>/z<z_mock>/`` the advected
fields, the spectra and the templates. Spectra binned otherwise than in
nmesh / 2 linear k bins carry ``_dk<dk>`` in their names."""

from pathlib import Path

import numpy as np
import torch

from ...convert import resolve_device
from ...io.asdf_file import open_asdf
from ...ops.power import get_k_mu_edges

__all__ = ['sim_dirs', 'k_tag', 'read_data', 'read_fft', 'read_header']


def sim_dirs(base, sim_name, z_this):
    """(``base/sim_name``, ``base/sim_name/z{z_this:.3f}``)."""
    save_dir = Path(base) / sim_name
    return save_dir, save_dir / f'z{z_this:.3f}'


def k_tag(Lbox, nmesh, k_hMpc_max, nbins_k, nbins_mu, logk):
    """``nmesh{n}`` for nmesh / 2 k bins, else ``nmesh{n}_dk{dk:.3f}`` with dk
    the bins' width (of log k when logk) (advect_fields.py:main)."""
    k_bin_edges, _ = get_k_mu_edges(Lbox, k_hMpc_max, nbins_k, nbins_mu, logk)
    if nbins_k == nmesh // 2:
        return f'nmesh{nmesh:d}'
    dk = (k_bin_edges[1] - k_bin_edges[0] if not logk
          else np.log(k_bin_edges[1] / k_bin_edges[0]))
    return f'nmesh{nmesh:d}_dk{dk:.3f}'


def read_data(fn):
    """Every column of an ASDF file's ``data``, as numpy arrays."""
    with open_asdf(fn) as f:
        return {k: np.asarray(v) for k, v in f['data'].items()}


def read_header(fn):
    with open_asdf(fn) as f:
        return dict(f['header'])


def read_fft(fn, name, device=None):
    """The complex64 rfft mesh stored as ``{name}_Re`` and ``{name}_Im`` in
    `fn`, on `device` (the card when None)."""
    with open_asdf(fn) as f:
        re_, im = np.asarray(f['data'][f'{name}_Re']), np.asarray(f['data'][f'{name}_Im'])
    dev = resolve_device(device)
    return torch.complex(torch.from_numpy(re_).to(dev), torch.from_numpy(im).to(dev))
