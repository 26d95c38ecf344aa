r"""Initial-condition field operators for the control variates
(the counterpart of abacusutils_tpu/models/zcv/ic_fields.py).

Builds the quadratic bias fields (delta, delta^2, s^2, nabla^2 delta) from
the linear IC density with ``torch.fft`` and elementwise tensor ops, in the
f32 arithmetic of the JAX package's ``_fields_jit``. s^2 is accumulated one
s_ij component at a time (as ``ops/shear.py`` does), so the working set is a
few grids instead of six complex ones. numpy inputs go to `device` (the card
when None); tensors stay where they are. The ASDF ``main``, ``load_dens``
and ``load_disp`` are not ported, nor is the slab-sharded
``get_fields_sharded``.
"""

import numpy as np
import torch

from ...convert import resolve_device
from ...ops.grid import _f32

__all__ = ['get_fields', 'gaussian_filter', 'filter_field', 'get_n2_fft', 'get_sij_fft']

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


def get_fields(delta_lin, Lbox, nmesh, device=None):
    """(delta, delta^2, s^2, nabla^2 delta) of the linear density
    (ic_fields.py:get_fields / _fields_jit): delta and delta^2 with their
    means subtracted, s^2 = sum_ij s_ij^2 with the factors (1, 2, 2, 1, 2,
    1) and its mean subtracted, nabla^2 delta = IFFT(-k^2 delta_k). Four f32
    (nmesh,)*3 tensors on the input's device."""
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
