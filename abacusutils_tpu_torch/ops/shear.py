r"""Tidal shear field q from a density grid (PyTorch).

Counterpart of abacusutils_tpu/ops/shear.py: the tidal tensor
T_ij = k_i k_j delta(k) / k^2 is built in Fourier space, keeping the
reference's quirk of skipping every mode with ANY zero wavenumber index
(``a*b*c == 0``), transformed back, and the shear invariant

    q^2 = 0.5 * sum_{i<j} (l_i - l_j)^2 = (3 tr(T^2) - tr(T)^2) / 2

is computed from the components without an eigendecomposition.

:func:`get_shear` differs from ``_shear_jit`` in one respect, memory: JAX
stacks the six complex components before one batched inverse FFT, 6 x
1000 * 1000 * 501 x 8 B = 24 GB at prepare_sim's N_dim = 1000. Here each
component is transformed alone and folded into three running grids, tr(T),
the diagonal squares and the off-diagonal squares, with JAX's association
``tr = (xx + yy) + zz`` and ``tr2 = ((xx^2 + yy^2) + zz^2) + 2 ((xy^2 +
xz^2) + yz^2)``. The FFTs are torch.fft's (cuFFT on the card, pocketfft on
the CPU), so values agree with JAX's to float32 round-off, not bit for bit.

:func:`smooth_density` stays scipy's reflect-mode ``gaussian_filter`` on the
host, as in the JAX package: its output feeds a rank, and a device filter
would change last bits.
"""

import numpy as np
import torch

from ..convert import resolve_device

__all__ = [
    'smooth_density',
    'get_shear',
    'smooth_density_periodic',
    'Wth',
    'Wg',
    'get_tidal',
    'get_shear_nb',
]


def Wth(ksq, r):
    """Tophat window W(kR) = 3 (sin kR - kR cos kR) / (kR)^3 for squared k
    (reference shear.py:26-31)."""
    k = np.sqrt(ksq)
    kr = k * r
    return 3 * (np.sin(kr) - kr * np.cos(kr)) / kr**3


def Wg(k, r):
    """Gaussian window exp(-k r^2 / 2); callers pass k = |k|^2 (reference
    shear.py:34-36 keeps the same quirkily named parameter)."""
    return np.exp(-k * r * r / 2.0)


def _as_tensor(a, device, dtype=None):
    if isinstance(a, torch.Tensor):
        return a if dtype is None else a.to(dtype)
    return torch.as_tensor(np.asarray(a), device=resolve_device(device), dtype=dtype)


def _dok2(dfour, karr, N_dim, R):
    """The k-space axes (ka, kb, kc), as broadcastable f32 tensors, and
    delta(k) / k^2 with the a*b*c == 0 modes zeroed and the optional tophat
    window, in the f32 / complex64 arithmetic of ops/shear.py:_shear_jit."""
    kzlen = N_dim // 2 + 1
    ka = karr[:, None, None]
    kb = karr[None, :, None]
    kc = karr[:kzlen][None, None, :]
    ksq = ka**2 + kb**2 + kc**2
    nz = (ka != 0) & (kb != 0) & (kc != 0)
    one = torch.ones((), dtype=ksq.dtype, device=ksq.device)
    dok2 = torch.where(nz, dfour / torch.where(ksq == 0, one, ksq), torch.zeros_like(dfour))
    if R is not None:
        k = torch.sqrt(ksq)
        kr = torch.where(k > 0, k * R, one)
        wth = torch.where(k > 0, 3 * (torch.sin(kr) - kr * torch.cos(kr)) / kr**3, one)
        dok2 = dok2 * wth
    return ka, kb, kc, dok2


def _pairs(ka, kb, kc):
    """The six tensor components' wavevector factors, in the order (xx, xy,
    xz, yy, yz, zz)."""
    return ((ka, ka), (ka, kb), (ka, kc), (kb, kb), (kb, kc), (kc, kc))


def get_tidal(dfour, karr, N_dim, R=None, dtype=np.float32, device=None):
    """Fourier tidal tensor components k_i k_j delta(k)/k^2, component order
    (xx, xy, xz, yy, yz, zz), with the reference's a*b*c == 0 mode skip and
    optional tophat smoothing (ops/shear.py:get_tidal). Returns the
    (N, N, N//2+1, 6) complex64 numpy array."""
    dfour = _as_tensor(dfour, device, torch.complex64)
    karr = torch.as_tensor(np.asarray(karr, dtype), device=dfour.device).to(torch.float32)
    ka, kb, kc, dok2 = _dok2(dfour, karr, N_dim, R)
    comps = torch.stack([a * b * dok2 for a, b in _pairs(ka, kb, kc)], dim=-1)
    return comps.to(torch.complex64).cpu().numpy()


def get_shear_nb(tidr, N_dim):
    """Shear invariant from real-space tidal components (xx, xy, xz, yy, yz,
    zz) on the last axis (ops/shear.py:get_shear_nb). Host numpy, float32
    out."""
    txx, txy, txz, tyy, tyz, tzz = np.moveaxis(np.asarray(tidr), -1, 0)
    tr = txx + tyy + tzz
    tr2 = txx * txx + tyy * tyy + tzz * tzz + 2 * (txy * txy + txz * txz + tyz * tyz)
    q2 = 0.5 * (3 * tr2 - tr * tr)
    return np.sqrt(np.maximum(q2, 0.0)).astype(np.float32)


def smooth_density(D, R, N_dim, Lbox):
    """Gaussian smoothing in units of grid cells: scipy's reflect-mode
    gaussian_filter on the host (ops/shear.py:smooth_density)."""
    from scipy.ndimage import gaussian_filter

    cell = Lbox / N_dim
    return gaussian_filter(np.asarray(D), R / cell)


def smooth_density_periodic(D, R, N_dim, Lbox, device=None):
    """Periodic Gaussian smoothing by FFT (ops/shear.py:smooth_density_periodic):
    exp(-k^2 Rcell^2 / 2) with k in radians per cell. A numpy `D` runs on
    `device` (None: the card) and comes back as numpy; a tensor stays where
    it lies."""
    as_numpy = not isinstance(D, torch.Tensor)
    D = _as_tensor(D, device, torch.float32)
    rcell_sq = float(np.float32((R / (Lbox / N_dim)) ** 2))
    karr = torch.fft.fftfreq(N_dim, device=D.device, dtype=torch.float32) * 2 * np.pi
    k2 = (
        karr[:, None, None] ** 2
        + karr[None, :, None] ** 2
        + (karr[: N_dim // 2 + 1] ** 2)[None, None, :]
    )
    out = torch.fft.irfftn(torch.fft.rfftn(D) * torch.exp(-k2 * rcell_sq / 2.0), s=D.shape)
    return out.cpu().numpy() if as_numpy else out


def shear_grid(dsmo, karr, N_dim, R=None):
    """The shear invariant of the f32 grid `dsmo` on its device
    (ops/shear.py:_shear_jit), one tensor component at a time. `karr`: the
    f32 wavenumbers of one axis. Returns an (N, N, N) f32 tensor."""
    dfour = torch.fft.rfftn(dsmo.to(torch.float32))
    ka, kb, kc, dok2 = _dok2(dfour, karr, N_dim, R)
    del dfour
    shape = dsmo.shape
    tr = diag = off = None
    for c, (a, b) in enumerate(_pairs(ka, kb, kc)):
        t = torch.fft.irfftn(a * b * dok2, s=shape)
        if c in (0, 3, 5):  # xx, yy, zz
            tr = t.clone() if tr is None else tr.add_(t)
            sq = t.mul_(t)
            diag = sq if diag is None else diag.add_(sq)
        else:  # xy, xz, yz
            sq = t.mul_(t)
            off = sq if off is None else off.add_(sq)
        del t, sq
    del dok2
    tr2 = diag.add_(off.mul_(2))
    del off
    q2 = tr2.mul_(3).sub_(tr.mul_(tr)).mul_(0.5)
    del tr
    return torch.sqrt(torch.clamp_min(q2, 0.0))


def get_shear(dsmo, N_dim, Lbox, R=None, dtype=np.float32, device=None):
    """Shear invariant per cell from a (smoothed) density grid
    (ops/shear.py:get_shear). A numpy grid (or the path of a .npy file) runs
    on `device` (None: the card) and comes back as float32 numpy; a tensor
    stays where it lies."""
    if isinstance(dsmo, str):
        dsmo = np.load(dsmo)
    as_numpy = not isinstance(dsmo, torch.Tensor)
    dsmo = _as_tensor(dsmo, device)
    karr = np.fft.fftfreq(N_dim, d=Lbox / (2 * np.pi * N_dim)).astype(dtype)
    karr = torch.from_numpy(karr).to(dsmo.device, torch.float32)
    out = shear_grid(dsmo, karr, int(N_dim), None if R is None else float(np.float32(R)))
    return out.cpu().numpy() if as_numpy else out
