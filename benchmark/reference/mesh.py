"""TSC mesh, Fourier transform and binned spectra, plainly.

- TSC (Hockney & Eastwood 1988): mesh node i sits at i L / n; a point at
  g = (x mod L) n / L gives its nearest node i0 = floor(g + 1/2) the weight
  3/4 - d^2 and the nodes i0 -+ 1 the weights (1/2 + d)^2 / 2 and
  (1/2 - d)^2 / 2, d = i0 - g, along each axis, periodically.
- The overdensity is mesh * n^3 / N - 1, N the number of points, and its
  rfft the Fourier field.
- A mode (kx, ky, kz), in units of 2 pi / L, of the rfft half mesh counts
  twice unless kz is 0 or n / 2. It falls in k bin j when e_j < k^2 <= e_{j+1}
  (k = 0 in bin 0) for the float32 squared edges e in those units, and in no
  bin from the last edge on; mu = kz / k (0 at k = 0) and the
  mu bins follow the same rule on mu^2, mu = 1 in the last.
- P(k) of fields a, b is L^3 sum dup Re(A conj(B)) / n^6 / W(k)^2 over the
  bin's modes divided by its mode count (sum of dup), W the TSC window's
  compensation per axis, (1 - s + 2 s^2 / 15)^(1/2) with s = sin^2(pi k / 2 k_N),
  where compensated; pole l adds (2l + 1) L_l(mu) to each mode's weight.
"""

import math

import numpy as np
import torch

from .precision import Precision

_BLOCK = 1 << 22  # points a block of the deposit


def _axis(g, n):
    i0 = torch.floor(g + 0.5)
    d = i0 - g
    i0 = i0.to(torch.int64)
    idx = [torch.remainder(i0 + o, n) for o in (-1, 0, 1)]
    w = [0.5 * (0.5 + d) ** 2, 0.75 - d * d, 0.5 * (0.5 - d) ** 2]
    return idx, w


def tsc_mesh(pos, n, lbox, P=None):
    """The TSC mesh (n, n, n) of the points `pos` (m, 3), in P's type."""
    P = P or Precision()
    grid = torch.zeros(n * n * n, dtype=P.dtype, device=pos.device)
    for b in range(0, pos.shape[0], _BLOCK):
        g = P(P(torch.remainder(P(pos[b:b + _BLOCK]), lbox)) * (n / lbox))
        (ix, wx), (iy, wy), (iz, wz) = (_axis(g[:, a], n) for a in range(3))
        for a in range(3):
            for c in range(3):
                flat = (ix[a] * n + iy[c]) * n
                wac = P(wx[a] * wy[c])
                for e in range(3):
                    grid.index_add_(0, flat + iz[e], P(wac * wz[e]))
    return P(grid.view(n, n, n))


def fourier_field(pos, n, lbox, P=None):
    """rfft of the TSC overdensity of `pos`."""
    P = P or Precision()
    mesh = tsc_mesh(pos, n, lbox, P)
    delta = P(mesh * (n**3 / pos.shape[0]) - 1.0)
    del mesh
    return P(torch.fft.rfftn(delta))


def tsc_compensation(n, lbox):
    """W per axis (float64 numpy), index as fftfreq."""
    d = lbox / n
    k = np.fft.fftfreq(n, d=d) * 2.0 * np.pi
    s = np.sin(0.5 * k * d) ** 2
    return np.sqrt(1.0 - s + 2.0 / 15.0 * s * s)


def squared_edges(kedges, lbox):
    """Squared k edges in units of the fundamental mode, as float32."""
    dk = 2.0 * np.pi / lbox
    return ((np.asarray(kedges, np.float64) / dk) ** 2).astype(np.float32)


def _bins(v, e2, bounded=True):
    """Bin of each value v (float32) for squared edges e2: e_j < v <= e_{j+1},
    the first edge itself in bin 0; -1 outside [e_0, e_last) when
    `bounded`, else the nearest end bin."""
    e = torch.as_tensor(e2, dtype=torch.float32, device=v.device)
    b = (torch.searchsorted(e, v, side='left') - 1).clamp_(0, len(e2) - 2)
    if not bounded:
        return b
    return torch.where((v >= e[0]) & (v < e[-1]), b, -1)


def _legendre(ell, mu):
    if ell == 0:
        return torch.ones_like(mu)
    if ell == 2:
        return 0.5 * (3.0 * mu**2 - 1.0)
    if ell == 4:
        return (35.0 * mu**4 - 30.0 * mu**2 + 3.0) / 8.0
    raise ValueError(f'pole {ell}')


class ModeRows:
    """The modes of one kx plane of the rfft half mesh: their k bin, mu bin,
    mu and dup."""

    def __init__(self, n, e2k, e2mu, device):
        self.n = n
        f = torch.fft.fftfreq(n, d=1.0 / n, device=device).to(torch.int64)
        self.f = f
        kz = torch.arange(n // 2 + 1, device=device, dtype=torch.int64)
        self.kz = kz
        self.dup = torch.where((kz == 0) | ((kz == n // 2) & (n % 2 == 0)), 1.0, 2.0).to(
            torch.float64)
        self.e2k, self.e2mu = e2k, e2mu

    def plane(self, ix):
        """(k bin, mu bin, mu, dup) of the (n, n/2+1) modes at kx = f[ix]."""
        kx, ky, kz = self.f[ix], self.f[:, None], self.kz[None, :]
        k2 = kx * kx + ky * ky + kz * kz
        k2f = k2.to(torch.float32)
        mu2 = torch.where(k2 > 0, (kz * kz).to(torch.float32) / k2f.clamp(min=1.0), 0.0)
        bk = _bins(k2f, self.e2k)
        bmu = _bins(mu2, self.e2mu, bounded=False)
        mu = torch.where(k2 > 0, kz.to(torch.float64) / k2.to(torch.float64).sqrt(), 0.0)
        return bk, bmu, mu, self.dup.expand_as(mu)


def binned_spectra(fields, lbox, kedges, muedges, poles=(), window=None, P=None):
    """Every pair (i <= j) of the rfft fields: {(i, j): (P (nk, nmu),
    poles (npoles, nk))}, mode counts (nk, nmu) and pole mode counts (nk,),
    float64 numpy. `window`: the per-axis compensation or None."""
    P = P or Precision()
    n = fields[0].shape[0]
    dev = fields[0].device
    nk, nmu = len(kedges) - 1, len(muedges) - 1
    rows = ModeRows(n, squared_edges(kedges, lbox), (np.asarray(muedges) ** 2).astype(np.float32),
                    dev)
    pairs = [(i, j) for i in range(len(fields)) for j in range(i, len(fields))]
    sums = torch.zeros((len(pairs), nk * nmu), dtype=torch.float64, device=dev)
    psums = torch.zeros((len(pairs), len(poles), nk), dtype=torch.float64, device=dev)
    counts = torch.zeros(nk * nmu, dtype=torch.float64, device=dev)
    pcounts = torch.zeros(nk, dtype=torch.float64, device=dev)
    win = None if window is None else torch.as_tensor(window, dtype=torch.float64, device=dev)
    scale = 1.0 / n**3
    for ix in range(n):
        bk, bmu, mu, dup = rows.plane(ix)
        ok = bk >= 0
        if not bool(ok.any()):
            continue
        flat = (bk * nmu + bmu)[ok]
        d = dup[ok]
        counts.index_add_(0, flat, d)
        pcounts.index_add_(0, bk[ok], d)
        if win is None:
            wmode = d
        else:
            wmode = d / (win[ix] * win[:, None] * win[None, : n // 2 + 1])[ok] ** 2
        pw = [((2 * ell + 1) * _legendre(ell, mu[ok]), ell) for ell in poles]
        for p, (i, j) in enumerate(pairs):
            a, b = fields[i][ix][ok], fields[j][ix][ok]
            v = P(P(a.real * b.real + a.imag * b.imag).to(torch.float64) * (scale * scale) * wmode)
            v = v.to(torch.float64)
            sums[p].index_add_(0, flat, v)
            for q, (w, _) in enumerate(pw):
                psums[p, q].index_add_(0, bk[ok], v * w)
    c = counts.cpu().numpy()
    pc = pcounts.cpu().numpy()
    out = {}
    for p, ij in enumerate(pairs):
        s = sums[p].cpu().numpy()
        ps = psums[p].cpu().numpy()
        pk = np.divide(s, c, out=np.zeros_like(s), where=c != 0) * lbox**3
        pp = np.divide(ps, pc, out=np.zeros_like(ps), where=pc != 0) * lbox**3
        out[ij] = (pk.reshape(nk, nmu), pp)
    return out, c.reshape(nk, nmu), pc


def dk_edges_pk(nmesh, lbox, nbins_k):
    """The run_hod_pk_fused k edges: nbins_k linear bins to the Nyquist k."""
    return np.linspace(0.0, math.pi * nmesh / lbox, nbins_k + 1)
