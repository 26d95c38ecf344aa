"""xi(rp, pi) of a periodic box from its pair counts, plainly.

Ordered pairs (i, j), i != j, of one catalog (each unordered pair twice,
Corrfunc's DDrppi convention), or every pair of two catalogs, are counted
by their separation in the minimum image of the box: rp^2 = dx^2 + dy^2 in bin b when
rp_b^2 <= rp^2 < rp_{b+1}^2, and |dz| < pimax in unit bins of pi, which
are then summed pi_bin_size at a time. With the analytic
RR = N1 N2 2 pi (rp_{b+1}^2 - rp_b^2) pi_bin_size / L^3, xi = DD / RR - 1.

The pairs are found through a grid of cells at least max(rp_max, pimax)
wide: a point's partners lie in its own cell and the 26 around it. The
candidate pairs are made in blocks, so memory stays bounded.
"""

import math

import numpy as np
import torch

from .precision import Precision

_BLOCK_PAIRS = 1 << 25


def _cells(p, nc, lbox):
    cell = torch.clamp((p.to(torch.float64) * (nc / lbox)).to(torch.int64), max=nc - 1)
    return cell, (cell[:, 0] * nc + cell[:, 1]) * nc + cell[:, 2]


def rppi_counts(pos, lbox, rpbins, pimax, P=None, pos2=None, block_pairs=_BLOCK_PAIRS):
    """Ordered pair counts (nrp, pimax) int64 of `pos` (n, 3), or of the
    pairs of `pos` and `pos2`."""
    P = P or Precision()
    rpbins = np.asarray(rpbins, np.float64)
    pimax = int(pimax)
    nrp = len(rpbins) - 1
    rmax = max(float(rpbins[-1]), float(pimax))
    nc = int(lbox // rmax)
    if nc < 3:
        raise ValueError(f'a box of {lbox} holds {nc} cells of {rmax}: the 27 are not distinct')
    dev = pos.device
    auto = pos2 is None
    q = P(torch.remainder(P(pos if auto else pos2), lbox))
    _, qid = _cells(q, nc, lbox)
    qid, order = torch.sort(qid)
    q = q[order]
    cnt = torch.bincount(qid, minlength=nc**3)
    if auto:
        p, cell = q, _cells(q, nc, lbox)[0]
    else:
        p = P(torch.remainder(P(pos), lbox))
        cell = _cells(p, nc, lbox)[0]
    start = torch.cumsum(cnt, 0) - cnt
    e2 = torch.as_tensor(rpbins**2, dtype=P.dtype, device=dev)
    hist = torch.zeros(nrp * pimax + 1, dtype=torch.int64, device=dev)
    n = p.shape[0]
    idx = torch.arange(n, device=dev)
    for ox in (-1, 0, 1):
        for oy in (-1, 0, 1):
            for oz in (-1, 0, 1):
                nb = ((torch.remainder(cell[:, 0] + ox, nc) * nc
                       + torch.remainder(cell[:, 1] + oy, nc)) * nc
                      + torch.remainder(cell[:, 2] + oz, nc))
                c = cnt[nb]
                s = start[nb]
                csum = torch.cumsum(c, 0)
                i0 = 0
                while i0 < n:
                    base = int(csum[i0 - 1]) if i0 else 0
                    i1 = int(torch.searchsorted(csum, base + block_pairs, right=True))
                    i1 = max(i1, i0 + 1)
                    ci = c[i0:i1]
                    tot = int(ci.sum())
                    if tot:
                        _count_block(hist, p, q, idx[i0:i1], ci, s[i0:i1], tot, lbox, e2,
                                     nrp, pimax, P, auto)
                    i0 = i1
    return hist[:-1].reshape(nrp, pimax)


def _count_block(hist, p, q, rows, ci, si, tot, lbox, e2, nrp, pimax, P, auto):
    ii = torch.repeat_interleave(rows, ci)
    first = torch.repeat_interleave(si - (torch.cumsum(ci, 0) - ci), ci)
    jj = first + torch.arange(tot, device=p.device)
    d = P(p[ii] - q[jj])
    d = P(d - lbox * torch.round(d / lbox))
    rp2 = P(P(d[:, 0] * d[:, 0]) + P(d[:, 1] * d[:, 1]))
    adz = d[:, 2].abs()
    b = torch.searchsorted(e2, rp2, right=True) - 1
    ok = (b >= 0) & (b < nrp) & (adz < pimax)
    if auto:
        ok &= ii != jj
    flat = torch.where(ok, b * pimax + adz.to(torch.int64).clamp(max=pimax - 1), nrp * pimax)
    hist += torch.bincount(flat, minlength=nrp * pimax + 1)


def xirppi(pos, lbox, rpbins, pimax, pi_bin_size, P=None, pos2=None):
    """xi(rp, pi) (nrp, pimax / pi_bin_size) with the analytic RR
    (N1 N2 for a cross)."""
    dd = rppi_counts(pos, lbox, rpbins, pimax, P, pos2).cpu().numpy().astype(np.float64)
    nrp = dd.shape[0]
    dd = dd.reshape(nrp, int(pimax) // int(pi_bin_size), int(pi_bin_size)).sum(axis=2)
    rpbins = np.asarray(rpbins, np.float64)
    n1 = float(pos.shape[0])
    n2 = n1 if pos2 is None else float(pos2.shape[0])
    rr = math.pi * (rpbins[1:] ** 2 - rpbins[:-1] ** 2) * pi_bin_size / lbox**3 * n1 * n2 * 2
    return dd / rr[:, None] - 1.0
