"""P(k) mode binning of an rfft mesh (PyTorch + a CUDA kernel).

Counterpart of the parts of abacusutils_tpu/ops/power.py that the fused HOD
step uses:

- :func:`get_k_mu_edges`, :func:`get_W_compensated` and
  :func:`mode_bin_plan` are numpy copies of the host helpers
  (``get_k_mu_edges``, ``get_W_compensated`` and the host build of
  ``_ModeBinPlan``: each mode's bin ``seg`` and the dup-weighted bin
  ``counts``).
- :func:`bin_power_modes_plain` is the bin sum of ``_segsum_matmul`` as one
  float64 ``torch.bincount``.
- :func:`bin_power_modes` launches the fused CUDA kernel
  (``csrc/mode_bin.cu``) on CUDA tensors and runs the plain version on CPU
  tensors.
"""

import numpy as np
import torch

from .. import _build
from .grid import MAX_SMEM_BYTES, _f32

__all__ = [
    'get_k_mu_edges',
    'get_W_compensated',
    'mode_bin_plan',
    'mode_dup',
    'bin_power_modes_plain',
    'bin_power_modes',
    'MAX_BINS',
]

# bins whose f32 histogram fits the 227 KB of shared memory of one block
MAX_BINS = MAX_SMEM_BYTES // 4


def get_k_mu_edges(Lbox, k_max, kbins, mubins, logk):
    """Bin edges for k and mu (ops/power.py:get_k_mu_edges)."""
    if isinstance(kbins, int):
        if logk:
            k_min = (1.0 - 1.0e-4) * 2.0 * np.pi / Lbox
            kbins = np.geomspace(k_min, k_max, kbins + 1)
        else:
            kbins = np.linspace(0.0, k_max, kbins + 1)
    if isinstance(mubins, int):
        mubins = np.linspace(0.0, 1.0, mubins + 1)
    return kbins, mubins


def get_W_compensated(Lbox, nmesh, paste, interlaced):
    """TSC/CIC deconvolution kernel, per axis (ops/power.py:get_W_compensated)."""
    d = Lbox / nmesh
    kN = np.pi / d
    k = (np.fft.fftfreq(nmesh, d=d) * 2.0 * np.pi).astype(np.float32)
    paste = paste.upper()
    if paste not in ('TSC', 'CIC'):
        raise ValueError(f'Unknown pasting method {paste}')
    if interlaced:
        return np.sinc(0.5 * k / kN) ** (3.0 if paste == 'TSC' else 2.0)
    s = np.sin(0.5 * np.pi * k / kN) ** 2
    if paste == 'TSC':
        return (1 - s + 2.0 / 15 * s**2) ** 0.5
    return (1 - 2.0 / 3 * s) ** 0.5


def mode_dup(n1d):
    """Hermitian multiplicity of each rfft mode, flat f32: 1 on the kz=0
    plane and on the kz=n1d/2 plane of an even mesh, 2 elsewhere
    (ops/power.py:_mode_geometry)."""
    kzlen = n1d // 2 + 1
    dup = np.ones((n1d, n1d, kzlen), np.float32)
    dup[:, :, 1:] = 2.0
    if n1d % 2 == 0:
        dup[:, :, -1] = 1.0
    return dup.reshape(-1)


def mode_bin_plan(n1d, kedges2, muedges2):
    """Host build of the (k, mu) bin of every mode of a (n1d, n1d, n1d/2+1)
    rfft mesh, from squared edges in units of the fundamental mode
    (the host branch of ops/power.py:_ModeBinPlan, no poles).

    Returns (seg, counts): seg is int32 per mode, Nk*Nmu for a mode outside
    every bin; counts is the (Nk, Nmu) float64 dup-weighted mode count."""
    Nk, Nmu = len(kedges2) - 1, len(muedges2) - 1
    kzlen = n1d // 2 + 1
    i = np.arange(n1d)
    i2 = np.where(i < n1d // 2, i, i - n1d).astype(np.int64) ** 2
    kz2 = np.arange(kzlen, dtype=np.int64) ** 2
    kmag2 = (i2[:, None, None] + i2[None, :, None] + kz2[None, None, :]).astype(np.float32)
    mu2 = np.divide(
        kz2[None, None, :].astype(np.float32), kmag2,
        out=np.zeros_like(kmag2), where=kmag2 > 0,
    )
    kflat = kmag2.reshape(-1)
    muflat = mu2.reshape(-1)
    valid = (kflat >= kedges2[0]) & (kflat < kedges2[-1])
    bk = np.clip(np.searchsorted(kedges2, kflat, side='left') - 1, 0, Nk - 1)
    bmu = np.clip(np.searchsorted(muedges2, muflat, side='left') - 1, 0, Nmu - 1)
    seg = np.where(valid, bk * Nmu + bmu, Nk * Nmu)
    counts = np.bincount(seg, weights=mode_dup(n1d), minlength=Nk * Nmu + 1)[: Nk * Nmu]
    return seg.astype(np.int32), counts.reshape(Nk, Nmu)


def _check_mesh(delta_k, seg, W):
    n1d = delta_k.shape[0]
    shape = (n1d, n1d, n1d // 2 + 1)
    if delta_k.dtype != torch.complex64 or tuple(delta_k.shape) != shape:
        raise ValueError(f'delta_k must be a complex64 {shape} rfft mesh')
    if seg.dtype != torch.int32 or seg.numel() != delta_k.numel():
        raise ValueError(f'seg must hold one int32 bin per mode ({delta_k.numel()})')
    if W is not None and (W.dtype != torch.float32 or W.shape != (n1d,)):
        raise ValueError(f'W must be a ({n1d},) float32 tensor')
    return n1d


def bin_power_modes_plain(delta_k, seg, W, scale, nbins):
    """Sum dup * |delta_k * scale / (W[ix] W[iy] W[kz])|^2 over the modes of
    each bin (W=None: no compensation); the contraction of
    ops/power.py:_segsum_matmul, accumulated in float64. Returns (nbins,) f32."""
    n1d = _check_mesh(delta_k, seg, W)
    dk = delta_k * _f32(scale)
    if W is not None:
        kzlen = n1d // 2 + 1
        dk = dk / (W[:, None, None] * W[None, :, None] * W[None, None, :kzlen])
    p3d = dk.abs() ** 2
    dup = torch.from_numpy(mode_dup(n1d)).to(p3d.device)
    sums = torch.bincount(
        seg.reshape(-1).long(), weights=(p3d.reshape(-1) * dup).double(), minlength=nbins + 1
    )
    return sums[:nbins].float()


def bin_power_modes(delta_k, seg, W, scale, nbins):
    """Binned power of a (n1d, n1d, n1d/2+1) complex64 rfft mesh: for each
    of `nbins` bins, the sum over its modes (seg == bin) of
    dup * |delta_k * scale / (W[ix] W[iy] W[kz])|^2. Returns (nbins,) f32.

    On CUDA tensors this launches K2 (csrc/mode_bin.cu) on the current
    stream; on CPU tensors it runs :func:`bin_power_modes_plain`."""
    if delta_k.device.type == 'cpu':
        return bin_power_modes_plain(delta_k, seg, W, scale, nbins)
    n1d = _check_mesh(delta_k, seg, W)
    if not 0 < nbins <= MAX_BINS:
        raise ValueError(f'bin_power_modes: nbins={nbins} outside (0, {MAX_BINS}]')
    for name, t in (('seg', seg), ('W', W)):
        if t is not None and t.device != delta_k.device:
            raise ValueError(f'{name} is on {t.device}, delta_k on {delta_k.device}')
    delta_k, seg = delta_k.contiguous(), seg.contiguous()
    W = None if W is None else W.contiguous()
    out = torch.zeros(nbins, dtype=torch.float64, device=delta_k.device)
    lib = _build.lib()
    with torch.cuda.device(delta_k.device):
        code = lib.mode_bin_power(
            delta_k.data_ptr(), seg.data_ptr(), None if W is None else W.data_ptr(),
            _f32(scale), n1d, nbins, out.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(code, 'mode_bin_power')
    bin_power_modes.launches += 1
    return out.float()


bin_power_modes.launches = 0
