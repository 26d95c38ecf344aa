r"""HOD occupation shape functions (elementwise PyTorch).

Counterpart of abacusutils_tpu/models/hod/shapes.py, function for function:

- LRG: Zheng+05 central erfc / modified power-law satellite
- ELG: arXiv:1910.05095 central (v1), arXiv:2007.09012 (v2), exp-cutoff sats
- QSO: erf central, generic power-law satellite

Arguments are tensors or Python floats; dtype follows the tensors.
"""

import math

import torch
from torch.special import erf, erfc

SQRT2 = 1.41421356  # matches the reference's literal constant
INV_SQRT2PI = 0.3989422804014327


def n_cen_LRG(M_h, logM_cut, sigma):
    return 0.5 * erfc((logM_cut - torch.log10(M_h)) / (SQRT2 * sigma))


def n_sat_LRG_modified(M_h, logM_cut, M_cut, M_1, sigma, alpha, kappa):
    x = M_h - kappa * M_cut
    base = torch.where(x < 0, 1.0, x)  # avoid nan from negative base
    val = (base / M_1) ** alpha * 0.5 * erfc((logM_cut - torch.log10(M_h)) / (SQRT2 * sigma))
    return torch.where(x < 0, 0.0, val)


def N_sat_generic(M_h, M_cut, kappa, M_1, alpha, A_s=1.0):
    x = M_h - kappa * M_cut
    base = torch.where(x < 0, 1.0, x)
    val = A_s * (base / M_1) ** alpha
    return torch.where(x < 0, 0.0, val)


def N_sat_elg(M_h, M_cut, kappa, M_1, alpha, A_s=1.0, alpha1=0.0, beta=0.0):
    return N_sat_generic(M_h, M_cut, kappa, M_1, alpha, A_s)


def Gaussian_fun(x, mean, sigma):
    return INV_SQRT2PI / sigma * torch.exp(-((x - mean) ** 2) / 2 / sigma**2)


def N_cen_ELG_v1(M_h, p_max, Q, logM_cut, sigma, gamma, Anorm=1.0):
    logM_h = torch.log10(M_h)
    phi = Gaussian_fun(logM_h, logM_cut, sigma)
    Phi = 0.5 * (1 + erf(gamma * (logM_h - logM_cut) / sigma / math.sqrt(2.0)))
    return 2.0 * (p_max - 1.0 / Q) * phi * Phi / Anorm


def N_cen_ELG_v2(M_h, p_max, logM_cut, sigma, gamma):
    logM_h = torch.log10(M_h)
    lo = p_max * Gaussian_fun(logM_h, logM_cut, sigma)
    hi = p_max * (M_h / 10**logM_cut) ** gamma / (2.5066283 * sigma)
    return torch.where(logM_h <= logM_cut, lo, hi)


def N_cen_QSO(M_h, logM_cut, sigma):
    return 0.5 * (1 + erf((torch.log10(M_h) - logM_cut) / SQRT2 / sigma))
