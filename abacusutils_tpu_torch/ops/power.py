"""P(k) of painted catalogs: mode-bin plans, mode binning and the spectrum
pipeline (PyTorch + CUDA kernels).

Counterpart of abacusutils_tpu/ops/power.py:

- :func:`get_k_mu_edges`, :func:`get_W_compensated` and
  :func:`mode_bin_plan` are numpy copies of the host helpers
  (``get_k_mu_edges``, ``get_W_compensated`` and the host build of
  ``_ModeBinPlan``: each mode's bin ``seg`` and the dup-weighted bin
  ``counts``). :func:`mode_bin_plan` is the reference the device build is
  tested against; no route calls it.
- :func:`mode_bin_plan_device` builds the plan with torch on the device it
  is given (``_mode_bin_plan_device`` and the host build's ``ksum`` and
  Legendre pole weights); :func:`get_mode_bin_plan` caches its plans with
  their row spans (:class:`RowSpans`: the kz interval of each (ix, iy) row
  that holds its in-bin modes, and the kernel's work lists of groups of four
  rows along y and along x), which :func:`mode_spans` hands to the binning
  kernel; :func:`span_groups` picks the list the fields' layout reads in
  whole sectors. A plan of ``yslab=(y0, y1)`` holds the ky rows y0 .. y1
  of the mesh, the piece of a y-sharded spectrum one rank bins
  (parallel/fft.py); the binning takes the same ``yslab``.
- :func:`bin_power_modes_plain` is the bin sum of ``_segsum_matmul`` as one
  float64 ``torch.bincount``; :func:`bin_power_modes` launches the binning
  kernel (``csrc/mode_bin_pairs.cu``) at one field without poles (K2) on
  CUDA tensors and runs the plain version on CPU tensors.
- :func:`bin_pair_modes_plain` is the all-pairs bin sum of
  ``_segsum_matmul_pairs``, with the Legendre pole rows of
  ``_bin_kmu_planned`` / ``_segsum_matmul`` when pole weights are given,
  as float64 ``torch.bincount``; :func:`bin_pair_modes` launches the same
  kernel for every pair (K3) on CUDA tensors.
- :func:`get_field`, :func:`get_field_fft` (TSC or CIC, interlaced or
  not), :func:`get_field_ffts` (F TSC weight columns of one point set, each
  stage deposited by one launch of K1's multi-weight form),
  :func:`get_raw_power`, :func:`bin_kmu`, :func:`calc_pk_from_deltak`,
  :func:`calc_pk_pairs_from_deltak` and :func:`calc_power`: the spectrum
  pipeline, which paints with K1 (``ops/grid.py:paint_3d``) and bins every
  pair of fields through one K3 launch.
- :func:`bin_kmu` with ``fourier=False`` bins a real mesh by separation (a
  plan of edges in units of the cell L / n1d, the same K3 launch);
  :func:`project_3d_to_poles` and :func:`pk_to_xi` (``torch.fft.irfftn``,
  then that binning) are built on it.
- :func:`bin_kppi` bins an rfft mesh in (k_perp, pi) through a separable
  host plan (:class:`KppiPlan`: the rows of each k_perp bin, the kz range of
  each pi bin, the exact counts) and :func:`bin_kppi_sums`, which launches
  K9 (``csrc/kppi_bin.cu``) on CUDA tensors and runs
  :func:`bin_kppi_sums_plain` on CPU tensors; it replaces the one-hot
  matmuls of ``_bin_kppi_sums``.
- :class:`StagedPower` stages a catalog once on K1's brick stage and
  measures P(k) many times, a z column per call gathered into the stage.
- The host helpers (:func:`factorial`, :func:`factorial_slow`,
  :func:`n_choose_k`, :func:`P_n`, :func:`linear_interp`) are numpy, the
  field helpers (:func:`normalize_field`, :func:`shift_field_fft`,
  :func:`get_smoothing`, :func:`get_delta_mu2`,
  :func:`expand_poles_to_3d`) elementwise torch on the device.

Entry points that take numpy send it to `device`, the card when None, and
raise where there is none; tensors stay where they are.
"""

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from ..convert import resolve_device
from ..utils import profiling
from .grid import (
    MAX_SMEM_BYTES,
    RSD_MARGIN,
    _f32,
    paint_3d,
    paint_3d_multi,
    stage_bricks,
    tsc_deposit_cells,
)

__all__ = [
    'get_k_mu_edges',
    'get_W_compensated',
    'mode_bin_plan',
    'mode_bin_plan_device',
    'ModeBinPlan',
    'get_mode_bin_plan',
    'RowSpans',
    'row_spans',
    'mode_spans',
    'span_groups',
    'mode_dup',
    'bin_power_modes_plain',
    'bin_power_modes',
    'field_pairs',
    'bin_pair_modes_plain',
    'bin_pair_modes',
    'get_field',
    'get_field_fft',
    'get_field_ffts',
    'get_interlaced_field_fft',
    'get_raw_power',
    'bin_kmu',
    'calc_pk_from_deltak',
    'calc_pk_pairs_from_deltak',
    'calc_power',
    'SpectrumTable',
    'MAX_BINS',
    'MAX_FIELDS',
    'MAX_POLES',
    'MAX_POLE_DEGREE',
    'factorial',
    'factorial_slow',
    'n_choose_k',
    'P_n',
    'linear_interp',
    'normalize_field',
    'shift_field_fft',
    'get_smoothing',
    'get_delta_mu2',
    'expand_poles_to_3d',
    'project_3d_to_poles',
    'pk_to_xi',
    'KppiPlan',
    'KPPI_ITEM_ROWS',
    'kppi_plan',
    'get_kppi_plan',
    'bin_kppi_sums_plain',
    'bin_kppi_sums',
    'bin_kppi',
    'StagedPower',
]

# bins whose f32 histogram fits the 227 KB of shared memory of one block
MAX_BINS = MAX_SMEM_BYTES // 4
# fields one all-pairs binning takes (csrc/mode_bin_pairs.cu instantiates 1..8)
MAX_FIELDS = 8
# shared memory for the binning kernel's per-warp histograms in one block:
# half an SM's, so two blocks fit
HIST_BYTES = MAX_SMEM_BYTES // 2
MAX_WARPS = 8
# a warp keeps a histogram for each row of its tile (no merge of the rows'
# sums) when the eight warps' copies fit in this many bytes
ROW_COPY_BYTES = 48 * 1024
# non-zero Legendre poles K3 takes, and their largest degree
MAX_POLES = 4
MAX_POLE_DEGREE = 8


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


def _legendre_coeffs(n):
    """[(coef, power)] with P_n(mu) = sum coef * mu^power, power = n - 2k
    (ops/power.py:_legendre_coeffs)."""
    out = []
    for k in range(n // 2 + 1):
        c = math.comb(n, k) * math.comb(2 * n - 2 * k, n) * (0.5**n) * (-1 if k % 2 else 1)
        out.append((c, n - 2 * k))
    return out


def factorial(n):
    """n! for 0 <= n <= 20 (ops/power.py:factorial)."""
    if n < 0 or n > 20:
        raise ValueError('n must be in [0, 20]')
    return math.factorial(int(n))


def factorial_slow(x):
    """Brute-force factorial (ops/power.py:factorial_slow)."""
    out = 1
    for i in range(2, int(x) + 1):
        out *= i
    return out


def n_choose_k(n, k):
    """Binomial coefficient (ops/power.py:n_choose_k)."""
    return factorial(n) // (factorial(k) * factorial(n - k))


def _P_n(mu2, n):
    """Legendre P_n at mu = sqrt(mu2), elementwise on a tensor, in the JAX
    program's f32 terms (ops/power.py:_P_n): f32(c) (mu2)^(p/2), an integer
    power for even p, mu2 ** f32(p/2) for odd p, added in order."""
    tot = torch.zeros_like(mu2)
    for c, p in _legendre_coeffs(n):
        c = _f32(c)
        if p == 0:
            tot = tot + c
        elif p % 2 == 0:
            tot = tot + c * mu2 ** (p // 2)
        else:
            tot = tot + c * mu2 ** _f32(0.5 * p)
    return tot


def P_n(x, n, dtype=np.float32):
    """Legendre polynomial P_n of a SQUARED variable x = mu^2, as a numpy
    array (ops/power.py:P_n; a host helper, computed on the CPU)."""
    x = torch.from_numpy(np.ascontiguousarray(x, dtype))
    return _P_n(x, int(n)).numpy().astype(dtype, copy=False)


def linear_interp(xd, x, y):
    """Linear interpolation on an equidistant monotonic grid, clamped to the
    endpoint values (ops/power.py:linear_interp; numpy)."""
    x = np.asarray(x)
    y = np.asarray(y)
    f = np.clip((np.asarray(xd) - x[0]) / (x[1] - x[0]), 0.0, len(x) - 1.000001)
    fl = np.floor(f).astype(np.int64)
    out = y[fl] + (f - fl) * (y[fl + 1] - y[fl])
    return np.where(xd <= x[0], y[0], np.where(xd >= x[-1], y[-1], out))


def _device_tensor(a, device, dtype=None):
    """A tensor stays where it is (cast to `dtype` if given); anything else
    goes through numpy to `device`, the card when None."""
    if isinstance(a, torch.Tensor):
        return a if dtype is None else a.to(dtype)
    t = torch.from_numpy(np.ascontiguousarray(a)).to(resolve_device(device))
    return t if dtype is None else t.to(dtype)


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


def _sqrt_rn_f32(x):
    """The correctly rounded f32 square root of the f32 tensor `x`, as
    numpy's and CUDA's: the f64 root rounded once to f32. torch's CPU f32
    sqrt is not correctly rounded on every host (its AVX-512 path differs
    from numpy on thousands of a 32^3 mesh's |k|), and one ulp moves a mode
    whose |k| sits on a bin edge into the next bin. An f64 root within an
    ulp of the true one rounds to the right f32, since the root of an f32
    never lies within 2^-51 of an f32 rounding midpoint."""
    return torch.sqrt(x.double()).float()


def _yrows(n1d, yslab):
    """(y0, ny) of the ky rows `yslab` = (y0, y1) of an n1d mesh (None: all
    of them); raises outside the mesh."""
    if yslab is None:
        return 0, int(n1d)
    y0, y1 = (int(v) for v in yslab)
    if not 0 <= y0 < y1 <= n1d:
        raise ValueError(f'yslab {tuple(yslab)} outside the {n1d} rows of the mesh')
    return y0, y1 - y0


def _mode_geometry(n1d, device, yslab=None):
    """Flat f32 |k|^2 (in units of the fundamental mode), mu^2 and dup of
    every rfft mode (of the ky rows `yslab`, when given), in the host
    build's arithmetic: |k|^2 is the integer sum of squares rounded once to
    f32, mu^2 = kz^2 / |k|^2 one IEEE f32 division (0 at k = 0)."""
    kzlen = n1d // 2 + 1
    y0, ny = _yrows(n1d, yslab)
    i = torch.arange(n1d, dtype=torch.int32, device=device)
    i2 = torch.where(i < n1d // 2, i, i - n1d) ** 2
    kz = torch.arange(kzlen, dtype=torch.int32, device=device)
    kz2 = kz * kz
    kmag2 = (i2[:, None, None] + i2[None, y0:y0 + ny, None]
             + kz2[None, None, :]).to(torch.float32)
    kz2f = kz2.to(torch.float32).expand_as(kmag2)
    mu2 = torch.where(kmag2 > 0, kz2f / kmag2.clamp_min(1.0), 0.0)
    single = (kz == 0) | ((kz == kzlen - 1) if n1d % 2 == 0 else False)
    dup = torch.where(single, 1.0, 2.0).to(torch.float32).expand_as(kmag2)
    return kmag2.reshape(-1), mu2.reshape(-1), dup.reshape(-1)


def _pole_weight(mu2, dup, pole):
    """(2l+1) L_l(mu) dup per mode in f32, summed as the host build sums
    it (ops/power.py:_ModeBinPlan: odd powers through mu2 ** 0.5)."""
    pw = torch.zeros_like(mu2)
    for c, p in _legendre_coeffs(pole):
        pw = pw + c * (mu2 ** (0.5 * p) if p % 2 else mu2 ** (p // 2))
    return (2 * pole + 1) * pw * dup


def mode_bin_plan_device(n1d, kedges2, muedges2, poles=(), device='cuda', yslab=None):
    """The mode-bin plan of a (n1d, n1d, n1d/2+1) rfft mesh, built with
    torch on `device`, the card unless the caller names another
    (ops/power.py:_mode_bin_plan_device and the host build of
    _ModeBinPlan): squared k and mu edges in units of the fundamental mode,
    float32.

    Returns (seg, counts, ksum, pole_w), all on `device`: seg is int32 per
    mode (Nk*Nmu outside every bin); counts and ksum the (Nk, Nmu) float64
    dup-weighted mode counts and |k| sums; pole_w maps each non-zero pole
    l to its f32 per-mode weight (2l+1) L_l(mu) dup. seg and counts are
    bit-identical to :func:`mode_bin_plan` (the bin is
    searchsorted(side='left') - 1 on the same f32 values).

    yslab=(y0, y1): the plan of the ky rows y0 .. y1 alone (ops/power.py's
    _ModeBinPlan(yslab=)): seg and pole_w are the full plan's for those rows,
    (n1d, y1 - y0, n1d/2+1) flat; counts and ksum count their modes, so the
    slabs' counts of a split of the rows add up to the full plan's."""
    kedges2 = np.asarray(kedges2, np.float32)
    muedges2 = np.asarray(muedges2, np.float32)
    Nk, Nmu = len(kedges2) - 1, len(muedges2) - 1
    device = resolve_device(device)
    kflat, muflat, dup = _mode_geometry(int(n1d), device, yslab)
    ke = torch.from_numpy(kedges2).to(device)
    me = torch.from_numpy(muedges2).to(device)
    valid = (kflat >= float(kedges2[0])) & (kflat < float(kedges2[-1]))
    bk = (torch.searchsorted(ke, kflat, side='left') - 1).clamp_(0, Nk - 1)
    bmu = (torch.searchsorted(me, muflat, side='left') - 1).clamp_(0, Nmu - 1)
    nseg = Nk * Nmu
    seg = torch.where(valid, bk * Nmu + bmu, nseg)
    del bk, bmu, valid

    def segsum(w):
        return torch.bincount(seg, weights=w.double(), minlength=nseg + 1)[:nseg].reshape(Nk, Nmu)

    counts = segsum(dup)
    ksum = segsum(_sqrt_rn_f32(kflat) * dup)
    pole_w = {int(p): _pole_weight(muflat, dup, int(p)) for p in poles if p != 0}
    return seg.to(torch.int32), counts, ksum, pole_w


# rows of one warp's tile in the binning kernel (csrc/mode_bin_pairs.cu kRows)
SPAN_GROUP = 4


class RowSpans(NamedTuple):
    """Where a mesh's in-bin modes lie: `bounds` is the (n1d^2, 2) int32
    [lo, hi) kz interval of each (ix, iy) row that holds its modes with
    0 <= seg < nbins ([0, 0) for a row without one); `groups` the int32 ids
    ix * ceil(n1d / 4) + iy // 4, in order, of the groups of four
    neighbouring rows along y (iy // 4 alike) that hold any, and `xgroups`
    the ids iy * ceil(n1d / 4) + ix // 4 of the groups of four neighbouring
    rows along x (ix // 4 alike): the binning kernel's two work lists, a
    group a warp (:func:`span_groups` picks one)."""

    bounds: torch.Tensor
    groups: torch.Tensor
    xgroups: torch.Tensor


class ModeBinPlan(NamedTuple):
    """A cached mode-bin plan: seg, pole_w and the row spans on the device,
    counts and ksum as read-only (Nk, Nmu) float64 numpy arrays; `yslab`
    the (y0, y1) ky rows it holds, or None for the whole mesh."""

    seg: torch.Tensor
    counts: np.ndarray
    ksum: np.ndarray
    pole_w: dict
    nk: int
    nmu: int
    spans: RowSpans
    yslab: tuple = None


# plans by (n1d, squared edges, poles, device, ky slab), the most recently
# used _MAX_BIN_PLANS of them (ops/power.py:_get_mode_bin_plan's bounded
# cache; a multi-tracer loop and a ky-slab split hold several at once)
_BIN_PLANS = {}
_MAX_BIN_PLANS = 4


def _mesh_side(nmodes):
    """n1d of an (n1d, n1d, n1d/2+1) rfft mesh of `nmodes` modes."""
    guess = round((2 * nmodes) ** (1 / 3))
    for n in range(max(guess - 2, 1), guess + 3):
        if n * n * (n // 2 + 1) == nmodes:
            return n
    raise ValueError(f'{nmodes} modes are no (n1d, n1d, n1d/2+1) rfft mesh')


def row_spans(seg, nbins, ny=None):
    """The :class:`RowSpans` of `seg` (one int32 bin per mode of an rfft
    mesh, or of its ny ky rows: a (n1d, ny, n1d/2+1) slab), built with torch
    where seg lies (one host sync, for the count of non-empty rows). A row's
    span runs from its first in-bin mode to its last, so it holds every one
    of them whatever seg is; for a plan's seg (bins by |k|, which grows with
    kz along a row) it holds nothing else. Group ids count the slab's rows:
    ix * ceil(ny / 4) + iy // 4 along y, iy * ceil(n1d / 4) + ix // 4 along
    x (iy local to the slab)."""
    if ny is None:
        n1d = ny = _mesh_side(seg.numel())
    else:
        n1d = _slab_side(seg.numel(), ny)
    kzlen = n1d // 2 + 1
    s = seg.reshape(n1d * ny, kzlen)
    valid = (s >= 0) & (s < nbins)
    kz = torch.arange(kzlen, dtype=torch.int32, device=seg.device)
    lo = torch.where(valid, kz, kzlen).amin(1)
    hi = torch.where(valid, kz + 1, 0).amax(1)
    lo = torch.where(hi > 0, lo, 0)
    rows = (hi > 0).reshape(n1d, ny)
    return RowSpans(torch.stack([lo, hi], 1).to(torch.int32).contiguous(),
                    _nonempty_groups(rows), _nonempty_groups(rows.t()))


def _nonempty_groups(rows):
    """The int32 ids a * ceil(nb / 4) + b // 4, in order, of the groups of
    four neighbouring rows along b of the (na, nb) bool `rows` that hold
    any true row."""
    na, nb = rows.shape
    per = -(-nb // SPAN_GROUP)
    full = torch.zeros((na, per * SPAN_GROUP), dtype=torch.bool, device=rows.device)
    full[:, :nb] = rows
    return torch.nonzero(full.reshape(na * per, SPAN_GROUP).any(1)).reshape(-1).to(torch.int32)


def span_groups(spans, strides):
    """The work list of :class:`RowSpans` `spans` that the binning kernel
    reads in whole sectors from fields of element `strides` (x, y, z), and
    whether its groups run along x: `xgroups` where x is faster than y (the
    ky slabs of parallel/fft.py:slab_rfftn), else `groups` (cuFFT's rfftn
    layout, iy fastest, and kz-contiguous meshes)."""
    along_x = strides[0] < strides[1]
    return (spans.xgroups if along_x else spans.groups), along_x


def _slab_side(nmodes, ny):
    """n1d of an (n1d, ny, n1d/2+1) ky slab of `nmodes` modes."""
    guess = round((2 * nmodes / ny) ** 0.5)
    for n in range(max(guess - 2, 1), guess + 3):
        if n * ny * (n // 2 + 1) == nmodes:
            return n
    raise ValueError(f'{nmodes} modes are no (n1d, {ny}, n1d/2+1) slab of an rfft mesh')


def mode_spans(seg, nbins, ny=None):
    """The row spans the binning kernel walks for `seg` (of a whole mesh, or
    of a slab of `ny` ky rows): those of the cached plan whose seg is this
    very tensor (identity, not equality) and whose bins number `nbins`;
    otherwise built anew by :func:`row_spans`, each build counted in
    ``mode_spans.builds``."""
    for plan in _BIN_PLANS.values():
        if plan.seg is seg and plan.nk * plan.nmu == nbins:
            return plan.spans
    mode_spans.builds += 1
    return row_spans(seg, nbins, ny)


mode_spans.builds = 0


def get_mode_bin_plan(n1d, kedges2, muedges2, poles, device, yslab=None):
    """The :class:`ModeBinPlan` of :func:`mode_bin_plan_device` with its row
    spans (:func:`row_spans`), cached by (n1d, edges, poles, device, yslab)
    as ops/power.py:_get_mode_bin_plan keys it (``get_mode_bin_plan.builds``
    counts the builds)."""
    kedges2 = np.asarray(kedges2, np.float32)
    muedges2 = np.asarray(muedges2, np.float32)
    poles = tuple(int(p) for p in poles)
    device = torch.device(device)
    if yslab is not None:
        yslab = tuple(int(v) for v in yslab)
        _yrows(n1d, yslab)
    key = (int(n1d), kedges2.tobytes(), muedges2.tobytes(), poles, str(device), yslab)
    plan = _BIN_PLANS.pop(key, None)
    if plan is None:
        seg, counts, ksum, pole_w = mode_bin_plan_device(n1d, kedges2, muedges2, poles, device,
                                                         yslab)
        host = []
        for a in (counts, ksum):
            a = a.cpu().numpy()
            a.flags.writeable = False
            host.append(a)
        nk, nmu = len(kedges2) - 1, len(muedges2) - 1
        ny = _yrows(n1d, yslab)[1]
        plan = ModeBinPlan(seg, *host, pole_w, nk, nmu, row_spans(seg, nk * nmu, ny), yslab)
        while len(_BIN_PLANS) >= _MAX_BIN_PLANS:
            del _BIN_PLANS[next(iter(_BIN_PLANS))]  # the least recently used
        get_mode_bin_plan.builds += 1
    _BIN_PLANS[key] = plan
    return plan


get_mode_bin_plan.builds = 0


def _check_mesh(delta_k, seg, W, yslab=None):
    n1d = delta_k.shape[0]
    shape = (n1d, _yrows(n1d, yslab)[1], n1d // 2 + 1)
    if delta_k.dtype != torch.complex64 or tuple(delta_k.shape) != shape:
        raise ValueError(f'delta_k must be a complex64 {shape} rfft mesh'
                         + ('' if yslab is None else f' (the ky rows {tuple(yslab)})'))
    if seg.dtype != torch.int32 or seg.numel() != delta_k.numel():
        raise ValueError(f'seg must hold one int32 bin per mode ({delta_k.numel()})')
    if W is not None and (W.dtype != torch.float32 or W.shape != (n1d,)):
        raise ValueError(f'W must be a ({n1d},) float32 tensor')
    return n1d


def _scaled(dk, scale, W, y0=0):
    """dk * scale / (W[ix] W[iy] W[kz]) in the kernels' f32 order; dk may
    be the ky rows y0 .. of a mesh."""
    dk = dk * _f32(scale)
    if W is None:
        return dk
    n1d, ny = dk.shape[:2]
    return dk / (W[:, None, None] * W[None, y0:y0 + ny, None] * W[None, None, : n1d // 2 + 1])


def _slab_dup(n1d, ny, device):
    """:func:`mode_dup` of the (n1d, ny, n1d/2+1) modes of ny ky rows (dup
    depends on kz alone)."""
    kzlen = n1d // 2 + 1
    dup = torch.from_numpy(mode_dup(n1d)[:kzlen]).to(device)
    return dup.repeat(n1d * ny)


def bin_power_modes_plain(delta_k, seg, W, scale, nbins, yslab=None):
    """Sum dup * |delta_k * scale / (W[ix] W[iy] W[kz])|^2 over the modes of
    each bin (W=None: no compensation); the contraction of
    ops/power.py:_segsum_matmul, accumulated in float64. delta_k and seg may
    be the ky rows `yslab` = (y0, y1) of the mesh. Returns (nbins,) f32."""
    n1d = _check_mesh(delta_k, seg, W, yslab)
    y0, ny = _yrows(n1d, yslab)
    p3d = _scaled(delta_k, scale, W, y0).abs() ** 2
    dup = _slab_dup(n1d, ny, p3d.device)
    sums = torch.bincount(
        seg.reshape(-1).long(), weights=(p3d.reshape(-1) * dup).double(), minlength=nbins + 1
    )
    return sums[:nbins].float()


def _hist_floats(nfields, npoles, nbins, nmu):
    """Floats of one warp's histogram: every pair's bins and pole rows."""
    nk = nbins // nmu if npoles else 0
    return nfields * (nfields + 1) // 2 * (nbins + npoles * nk)


def _check_smem(name, nfields, npoles, nbins, nmu, n1d):
    """Raise unless one warp's histogram and the window's kz row fit the
    shared memory of a block."""
    H = _hist_floats(nfields, npoles, nbins, nmu)
    if nbins <= 0 or 4 * (H + n1d // 2 + 1) > MAX_SMEM_BYTES:
        raise ValueError(
            f'{name}: the f32 histogram of {H} floats ({nfields} fields, {nbins} bins, '
            f'{npoles} pole rows) and {n1d // 2 + 1} window values exceed the '
            f'{MAX_SMEM_BYTES} B of shared memory a block may use'
        )


# (warps a block, histogram copies a warp, dynamic shared bytes, most
# resident blocks) of the binning kernel by (device, fields, poles,
# histogram floats, kz length)
_BIN_GRIDS = {}


def _bin_grid(lib, device, nfields, npoles, H, kzlen):
    """The binning kernel's block shape for one instance and histogram: a
    histogram for each of the 4 rows of a warp's tile where ROW_COPY_BYTES
    holds 8 warps' of them, else one a warp; as many warps (at most 8) as
    HIST_BYTES holds histograms of; all the blocks the card keeps resident
    at that shape (occupancy asked once)."""
    key = (device.index, nfields, npoles, H, kzlen)
    grid = _BIN_GRIDS.get(key)
    if grid is None:
        copies = SPAN_GROUP if 4 * H * SPAN_GROUP * MAX_WARPS <= ROW_COPY_BYTES else 1
        warps = max(1, min(MAX_WARPS, HIST_BYTES // (4 * H * copies)))
        smem = 4 * (kzlen + warps * copies * H)
        per_sm = ctypes.c_int(0)
        code = lib.mode_bin_pairs_occupancy(nfields, npoles, warps, smem, device.index,
                                            ctypes.byref(per_sm))
        _build.check(code, 'mode_bin_pairs_occupancy')
        nsm = torch.cuda.get_device_properties(device).multi_processor_count
        grid = _BIN_GRIDS[key] = (warps, copies, smem, max(per_sm.value, 1) * nsm)
    return grid


def _bin_launch(lib, deltas, seg, W, scale, nbins, poles, nmu, out_dtype, yslab=None):
    """Launch the binning kernel of csrc/mode_bin_pairs.cu over the row
    spans of `seg` (:func:`mode_spans`) on the current stream, then its
    fixed-order reduction. The fields are read through their strides, over
    the work list their layout reads in whole sectors (:func:`span_groups`);
    only fields of mixed layouts are copied. Returns the flat (npairs x
    (nbins + len(poles) x nbins / nmu)) sums as `out_dtype`, and whether the
    groups ran along x."""
    device = deltas[0].device
    n1d = deltas[0].shape[0]
    y0, ny = _yrows(n1d, yslab)
    spans = mode_spans(seg, nbins, ny)
    if len({d.stride() for d in deltas}) > 1:
        deltas = [d.contiguous() for d in deltas]
    groups, along_x = span_groups(spans, deltas[0].stride())
    seg = seg.contiguous()
    W = None if W is None else W.contiguous()
    H = _hist_floats(len(deltas), len(poles), nbins, nmu)
    with torch.cuda.device(device):
        warps, copies, smem, most = _bin_grid(lib, device, len(deltas), len(poles), H,
                                              n1d // 2 + 1)
        ngroups = groups.numel()
        blocks = max(1, min(most, -(-ngroups // warps)))
        partials = torch.empty(blocks * H, dtype=torch.float32, device=device)
        out = torch.empty(H, dtype=out_dtype, device=device)
        ptrs = (ctypes.c_void_p * MAX_FIELDS)(*[d.data_ptr() for d in deltas])
        degs = (ctypes.c_int * MAX_POLES)(*poles)
        code = lib.mode_bin_pairs(
            ptrs, len(deltas), *deltas[0].stride(), seg.data_ptr(), groups.data_ptr(),
            ngroups, spans.bounds.data_ptr(), None if W is None else W.data_ptr(), _f32(scale), n1d,
            nbins, max(int(nmu), 1), degs, len(poles), blocks, warps, copies, smem, device.index,
            partials.data_ptr(), out.data_ptr(), int(out_dtype == torch.float64), ny, y0,
            int(along_x), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(code, 'mode_bin_pairs')
    return out, along_x


def bin_power_modes(delta_k, seg, W, scale, nbins, yslab=None):
    """Binned power of a (n1d, n1d, n1d/2+1) complex64 rfft mesh: for each
    of `nbins` bins, the sum over its modes (seg == bin) of
    dup * |delta_k * scale / (W[ix] W[iy] W[kz])|^2. Returns (nbins,) f32.
    With `yslab` = (y0, y1), delta_k and seg are those ky rows of the mesh,
    (n1d, y1 - y0, n1d/2+1) (a plan of ``yslab``).

    On CUDA tensors this launches the binning kernel at one field without
    poles (K2, csrc/mode_bin_pairs.cu) on the current stream, reading
    delta_k through its strides; on CPU tensors it runs
    :func:`bin_power_modes_plain`."""
    if delta_k.device.type == 'cpu':
        return bin_power_modes_plain(delta_k, seg, W, scale, nbins, yslab)
    n1d = _check_mesh(delta_k, seg, W, yslab)
    if not 0 < nbins <= MAX_BINS:
        raise ValueError(f'bin_power_modes: nbins={nbins} outside (0, {MAX_BINS}]')
    _check_smem('bin_power_modes', 1, 0, nbins, 1, n1d)
    for name, t in (('seg', seg), ('W', W)):
        if t is not None and t.device != delta_k.device:
            raise ValueError(f'{name} is on {t.device}, delta_k on {delta_k.device}')
    lib = _build.lib()
    out, _ = _bin_launch(lib, [delta_k], seg, W, scale, nbins, (), 1, torch.float32, yslab)
    bin_power_modes.launches += 1
    return out


bin_power_modes.launches = 0


def field_pairs(nfields):
    """The (i, j), i <= j, pairs of `nfields` fields in i-major order: the
    order of the spectra dicts of models/pipeline.py:hod_pk_fused_multi."""
    return [(i, j) for i in range(nfields) for j in range(i, nfields)]


def _check_fields(deltas, seg, W, nbins, pole_w, nmu, yslab=None):
    if not 1 <= len(deltas) <= MAX_FIELDS:
        raise ValueError(f'bin_pair_modes takes 1 to {MAX_FIELDS} fields, not {len(deltas)}')
    n1d = _check_mesh(deltas[0], seg, W, yslab)
    for d in deltas[1:]:
        if d.dtype != deltas[0].dtype or d.shape != deltas[0].shape:
            raise ValueError('every field must be a complex64 rfft mesh of one shape')
        if d.device != deltas[0].device:
            raise ValueError(f'fields lie on {d.device} and {deltas[0].device}')
    if pole_w:
        if nmu < 1 or nbins % nmu:
            raise ValueError(f'nbins={nbins} is not a multiple of nmu={nmu}')
        for p, w in pole_w.items():
            if not 0 < p <= MAX_POLE_DEGREE:
                raise ValueError(f'pole {p} outside (0, {MAX_POLE_DEGREE}]')
            if w.shape != seg.reshape(-1).shape or w.dtype != torch.float32:
                raise ValueError(f'pole {p} weights must be float32, one per mode')
    return n1d


def bin_pair_modes_plain(deltas, seg, W, scale, nbins, pole_w=None, nmu=1, yslab=None):
    """For every pair (i, j), i <= j, of the (n1d, n1d, n1d/2+1) complex64
    rfft meshes `deltas` (in :func:`field_pairs` order), sum
    dup * Re(d_i conj(d_j)) over the modes of each bin, where
    d = delta_k * scale / (W[ix] W[iy] W[kz]) (W=None: no compensation):
    the contraction of ops/power.py:_segsum_matmul_pairs, accumulated in
    float64. Returns (npairs, nbins) float64.

    With `pole_w`, the plan's {l: (2l+1) L_l(mu) dup} per-mode weights of
    the non-zero poles (:func:`mode_bin_plan_device`), it also sums
    pole_w[l] * Re(d_i conj(d_j)) into the k-bin seg // nmu of every mode
    in a bin (ops/power.py:_bin_kmu_planned's kbounds) and returns
    (sums, pole_sums), pole_sums (npairs, len(pole_w), nbins // nmu).
    With `yslab` = (y0, y1) the meshes, seg and pole_w are those ky rows."""
    deltas = tuple(deltas)
    n1d = _check_fields(deltas, seg, W, nbins, pole_w, nmu, yslab)
    y0, ny = _yrows(n1d, yslab)
    scaled = [_scaled(dk, scale, W, y0) for dk in deltas]
    dup = _slab_dup(n1d, ny, seg.device)
    seg = seg.reshape(-1).long()
    pairs = field_pairs(len(deltas))
    out = torch.empty((len(pairs), nbins), dtype=torch.float64, device=seg.device)
    nk = nbins // nmu
    kseg = torch.div(seg, nmu, rounding_mode='floor')  # nbins // nmu == nk for modes outside
    poles = list(pole_w or {})
    pout = torch.empty((len(pairs), len(poles), nk), dtype=torch.float64, device=seg.device)
    for p, (i, j) in enumerate(pairs):
        a, b = scaled[i], scaled[j]
        v = (a.real * b.real + a.imag * b.imag).reshape(-1)
        out[p] = torch.bincount(seg, weights=(v * dup).double(), minlength=nbins + 1)[:nbins]
        for q, pole in enumerate(poles):
            w = (v * pole_w[pole]).double()
            pout[p, q] = torch.bincount(kseg, weights=w, minlength=nk + 1)[:nk]
    return (out, pout) if pole_w else out


def bin_pair_modes(deltas, seg, W, scale, nbins, pole_w=None, nmu=1, yslab=None):
    """All auto and cross bin sums of the rfft meshes `deltas` in one pass
    over the modes, with the Legendre pole rows when `pole_w` is given:
    the contract of :func:`bin_pair_modes_plain` (ky rows `yslab` too).

    On CUDA tensors this launches K3 (csrc/mode_bin_pairs.cu) on the current
    stream; the kernel evaluates each pole's weight in registers from the
    mode's indices and uses only the degrees (the keys) of `pole_w`. On CPU
    tensors it runs :func:`bin_pair_modes_plain`."""
    deltas = tuple(deltas)
    if deltas and deltas[0].device.type == 'cpu':
        return bin_pair_modes_plain(deltas, seg, W, scale, nbins, pole_w, nmu, yslab)
    n1d = _check_fields(deltas, seg, W, nbins, pole_w, nmu, yslab)
    poles = list(pole_w or {})
    if len(poles) > MAX_POLES:
        raise ValueError(f'bin_pair_modes takes at most {MAX_POLES} non-zero poles')
    _check_smem('bin_pair_modes', len(deltas), len(poles), nbins, nmu, n1d)
    device = deltas[0].device
    for name, t in (('seg', seg), ('W', W)):
        if t is not None and t.device != device:
            raise ValueError(f'{name} is on {t.device}, the fields on {device}')
    lib = _build.lib()
    npairs = len(deltas) * (len(deltas) + 1) // 2
    nk = nbins // nmu if poles else 0
    out, along_x = _bin_launch(lib, deltas, seg, W, scale, nbins, poles, nmu, torch.float64,
                               yslab)
    out = out.reshape(npairs, nbins + len(poles) * nk)
    bin_pair_modes.launches += 1
    form = ((f'poles nmu={nmu}' if poles else 'no poles') + ('' if yslab is None else ' ky slab')
            + (' x-grouped' if along_x else ''))
    bin_pair_modes.launches_by_form[form] = bin_pair_modes.launches_by_form.get(form, 0) + 1
    if not poles:
        return out
    return out[:, :nbins], out[:, nbins:].reshape(npairs, len(poles), nk)


bin_pair_modes.launches = 0
# launches of each form ('no poles', 'poles nmu=<Nmu>', each with ' ky slab'
# when it bins a slab of ky rows and then ' x-grouped' when its work list
# runs along x), within `launches`
bin_pair_modes.launches_by_form = {}


# ---------------------------------------------------------------------------
# The spectrum pipeline: paint -> rfftn -> one all-pairs binning launch
# ---------------------------------------------------------------------------


def _pos_columns(pos, device):
    """(N, 3) array/tensor or a 3-sequence of columns -> three flat float32
    tensors (numpy inputs go to `device`, the card when None; tensors stay
    where they are)."""
    if isinstance(pos, (tuple, list)) and len(pos) == 3 and np.ndim(pos[0]) == 1:
        cols = pos
    else:
        cols = [pos[:, i] for i in range(3)]
    out = []
    for c in cols:
        if isinstance(c, torch.Tensor):
            out.append(c.to(torch.float32).contiguous())
        else:
            a = np.ascontiguousarray(c, dtype=np.float32)
            out.append(profiling.count_copy(a, torch.from_numpy(a).to(resolve_device(device))))
    return out


def _weights(w, device):
    if w is None:
        return None
    if isinstance(w, torch.Tensor):
        return profiling.count_copy(w, w.to(device, torch.float32).contiguous())
    w = np.ascontiguousarray(w, dtype=np.float32)
    return profiling.count_copy(w, torch.from_numpy(w).to(device))


def get_field(pos, Lbox, nmesh, paste, w=None, d=0.0, device=None, overflow=None):
    """Paint the catalog and normalise it to an overdensity,
    field * (nmesh^3 / N) - 1 with N the number of points even when
    weighted (ops/power.py:get_field). TSC wraps each coordinate once and
    then adds the offset `d`; CIC takes pos + d unwrapped, as the JAX
    package paints it (``paint_3d(..., wrap=False)``). numpy positions go to
    `device` (the card when None); tensors stay where they are. On CUDA
    tensors the paint is K1 (:func:`ops.grid.paint_3d`, `overflow` its
    overflow word). Returns the (nmesh,)*3 f32 tensor."""
    px, py, pz = _pos_columns(pos, device)
    n_pos = px.shape[0]
    field = paint_3d(
        px, py, pz, nmesh, Lbox, weights=_weights(w, px.device), offset=d, kind=paste.lower(),
        overflow=overflow,
    )
    return field * _f32(field.numel() / n_pos) - 1.0


def _interlace_combine(field_fft, field_shift_fft, nmesh, Lbox, d):
    """(F + F_shift * exp(i k.d/2)) * 0.5 / N^3 (ops/power.py:_interlace_combine)."""
    dk = _f32(2.0 * np.pi / Lbox)
    dev = field_fft.device
    i = torch.arange(nmesh, device=dev)
    kvec = torch.where(i < nmesh // 2, i, i - nmesh).to(torch.float32) * dk
    kz = torch.arange(nmesh // 2 + 1, device=dev).to(torch.float32) * dk
    theta = (kvec[:, None, None] + kvec[None, :, None] + kz[None, None, :]) * _f32(0.5 * d)
    phase = torch.polar(torch.ones_like(theta), theta)
    return (field_fft + field_shift_fft * phase) * _f32(0.5 / nmesh**3)


def shift_field_fft(field_fft, field_shift_fft, n1d, L, d, dtype=np.float32, device=None):
    """Interlaced Fourier field (F + F_shift e^{ik.d/2}) / (2 N^3)
    (ops/power.py:shift_field_fft), a complex64 tensor. numpy meshes go to
    `device` (the card when None); tensors stay where they are."""
    F, Fs = (_device_tensor(f, device, torch.complex64) for f in (field_fft, field_shift_fft))
    return _interlace_combine(F, Fs.to(F.device), int(n1d), float(L), float(d))


def normalize_field(field, tot_weight=None, inplace=False, nthread=None, device=None):
    """Overdensity field * (size / tot_weight) - 1 in f32
    (ops/power.py:normalize_field: np.multiply(..., dtype=float32) - 1).
    tot_weight defaults to the field's sum: numpy's for a numpy field, as
    the JAX package sums it, a float64 torch sum for a tensor. numpy fields
    go to `device` (the card when None); `inplace` writes the result back
    into `field` and returns it."""
    if tot_weight is None:
        tot_weight = float(field.sum(dtype=torch.float64) if isinstance(field, torch.Tensor)
                           else np.asarray(field).sum())
    f = _device_tensor(field, device)
    out = f.to(torch.float32) * _f32(f.numel() / tot_weight) - 1.0
    if not inplace:
        return out
    if isinstance(field, torch.Tensor):
        return field.copy_(out)
    field[...] = out.cpu().numpy()
    return field


def _field_fft(pos, Lbox, nmesh, paste, w, interlaced, device=None, overflow=None):
    """The Fourier field before its 1/N^3 scale and compensation, and that
    scale: (rfftn(field), 1/N^3), or (the interlaced combination, which
    carries its own 0.5/N^3, 1.0). K3 applies scale and window per mode.
    Host columns are uploaded once, for both paints of an interlaced field."""
    with profiling.span('abacus.upload'):
        pos = _pos_columns(pos, device)
        w = _weights(w, pos[0].device)
    if interlaced:
        return get_interlaced_field_fft(pos, Lbox, nmesh, paste, w, device, overflow), 1.0
    with profiling.span('abacus.deposit'):
        field = get_field(pos, Lbox, nmesh, paste, w, device=device, overflow=overflow)
    with profiling.span('abacus.transform'):
        return torch.fft.rfftn(field), 1.0 / field.numel()


def get_interlaced_field_fft(pos, Lbox, nmesh, paste, w, device=None, overflow=None):
    """Interlaced Fourier field: a second paint at offset d/2, d = L/nmesh
    (ops/power.py:get_interlaced_field_fft). numpy positions go to `device`
    (the card when None)."""
    d = Lbox / nmesh
    kw = dict(device=device, overflow=overflow)
    F = torch.fft.rfftn(get_field(pos, Lbox, nmesh, paste, w, **kw))
    Fs = torch.fft.rfftn(get_field(pos, Lbox, nmesh, paste, w, d=0.5 * d, **kw))
    return _interlace_combine(F, Fs, int(nmesh), float(Lbox), float(d))


def get_field_fft(pos, Lbox, nmesh, paste, w, W, compensated, interlaced, device=None):
    """Fourier overdensity field with optional compensation and interlacing
    (ops/power.py:get_field_fft): the field the spectrum functions bin.
    numpy positions go to `device` (the card when None). The pipeline
    itself hands scale and window to K3 instead of forming this mesh."""
    field_fft, scale = _field_fft(pos, Lbox, nmesh, paste, w, interlaced, device)
    if compensated:
        if W is None:
            raise ValueError('compensated=True needs the window W')
        W = torch.as_tensor(np.asarray(W, np.float32), device=field_fft.device)
        return _scaled(field_fft, scale, W)
    return field_fft * _f32(scale) if scale != 1.0 else field_fft


def _fields_multi(cols, Lbox, nmesh, ws, d):
    """get_field for each weight column of one point set: the (F, nmesh,
    nmesh, nmesh) stack of field * (nmesh^3 / N) - 1, painted by one
    multi-weight K1 launch (TSC)."""
    grids = paint_3d_multi(*cols, nmesh, Lbox, ws, offset=d)
    return grids.mul_(_f32(nmesh**3 / cols[0].shape[0])).sub_(1.0)


def get_field_ffts(pos, Lbox, nmesh, paste, ws, W, compensated, interlaced, device=None):
    """:func:`get_field_fft` of one point set for each weight column of `ws`
    (None: unit weight), as a list of F complex64 rfft meshes: equal to F
    separate get_field_fft calls. The points are staged once (and once more
    at the interlacing shift) and each stage's F fields are deposited by one
    launch of K1's multi-weight form (TSC only), then transformed one by one.
    numpy positions and weights go to `device` (the card when None)."""
    if paste.upper() != 'TSC':
        raise NotImplementedError(f'the multi-weight deposit is TSC only, not {paste}')
    cols = _pos_columns(pos, device)
    ws = [_weights(w, cols[0].device) for w in ws]
    nmesh = int(nmesh)
    ffts = [torch.fft.rfftn(g) for g in _fields_multi(cols, Lbox, nmesh, ws, 0.0)]
    scale = 1.0 / nmesh**3
    if interlaced:
        d = Lbox / nmesh
        shifted = _fields_multi(cols, Lbox, nmesh, ws, 0.5 * d)
        ffts = [_interlace_combine(F, torch.fft.rfftn(g), nmesh, float(Lbox), float(d))
                for F, g in zip(ffts, shifted)]
        del shifted
        scale = 1.0
    if compensated:
        if W is None:
            raise ValueError('compensated=True needs the window W')
        W = torch.as_tensor(np.asarray(W, np.float32), device=ffts[0].device)
        return [_scaled(F, scale, W) for F in ffts]
    return [F * _f32(scale) if scale != 1.0 else F for F in ffts]


def get_raw_power(field_fft, field2_fft=None):
    """|delta_k|^2, or Re[conj(delta1) delta2] (ops/power.py:get_raw_power)."""
    if field2_fft is None:
        return field_fft.abs() ** 2
    return (field_fft.conj() * field2_fft).real


def _plan_for(n1d, dk, kedges, muedges, poles, device):
    """The cached plan of edges in units of `dk`: the fundamental mode 2 pi /
    L of a Fourier mesh, or the cell L / n1d of a real one."""
    kedges2 = ((np.asarray(kedges) / dk) ** 2).astype(np.float32)
    muedges2 = (np.asarray(muedges) ** 2).astype(np.float32)
    return get_mode_bin_plan(int(n1d), kedges2, muedges2, poles, device)


def _binned_spectra(ffts, W, scale, dk, kedges, muedges, poles):
    """Every pair (i <= j) of the fields `ffts` through one K3 launch, the
    edges in units of `dk` (2 pi / L for Fourier meshes). Returns (plan,
    {(i, j): (wsum (Nk, Nmu), pole_sums (npoles_nz, Nk))}) as float64
    numpy."""
    n1d = int(ffts[0].shape[0])
    device = ffts[0].device
    poles = tuple(int(p) for p in poles)
    plan = _plan_for(n1d, dk, kedges, muedges, poles, device)
    nbins = plan.nk * plan.nmu
    pole_w = {p: plan.pole_w[p] for p in poles if p != 0}
    Wt = None
    if W is not None:
        W = np.asarray(W, np.float32)
        Wt = profiling.count_copy(W, torch.as_tensor(W, device=device))
    out = bin_pair_modes(ffts, plan.seg, Wt, scale, nbins, pole_w or None, plan.nmu)
    sums, psums = out if pole_w else (out, None)
    sums = profiling.count_copy(sums, sums.cpu()).numpy().reshape(-1, plan.nk, plan.nmu)
    psums = (np.zeros((len(sums), 0, plan.nk)) if psums is None
             else profiling.count_copy(psums, psums.cpu()).numpy())
    return plan, {ij: (sums[p], psums[p]) for p, ij in enumerate(field_pairs(len(ffts)))}


def _bin_means(plan, dk, wsum, psums, poles, dtype=np.float32):
    """The host tail of ops/power.py:bin_kmu from one pair's bin sums:
    (weighted_counts, counts, weighted_counts_poles, counts_poles,
    weighted_counts_k); the l = 0 pole is the (k, mu) sum over mu."""
    counts = np.asarray(plan.counts, np.int64)
    counts_poles = counts.sum(axis=1)
    rows = iter(psums)
    pole_sums = np.array([wsum.sum(axis=1) if p == 0 else next(rows) for p in poles])
    pole_sums = pole_sums.reshape(len(poles), plan.nk)
    with np.errstate(invalid='ignore', divide='ignore'):
        means = np.where(counts != 0, wsum / counts, 0.0).astype(dtype)
        k_avg = np.where(counts != 0, plan.ksum * dk / counts, 0.0).astype(dtype)
        pole_means = np.where(counts_poles != 0, pole_sums / counts_poles, 0.0).astype(dtype)
    return means, counts, pole_means, counts_poles, k_avg


def _spectrum(plan, dk, wsum, psums, Lbox, poles, squeeze_mu_axis):
    """calc_pk_from_deltak's dict from one pair's bin sums
    (ops/power.py:calc_pk_from_deltak)."""
    power, N_mode, binned_poles, N_mode_poles, k_avg = _bin_means(plan, dk, wsum, psums, poles)
    power = power * Lbox**3
    if len(poles):
        binned_poles = binned_poles * Lbox**3
    if squeeze_mu_axis and plan.nmu == 1:
        power, N_mode, k_avg = power[:, 0], N_mode[:, 0], k_avg[:, 0]
    return dict(
        power=power, N_mode=N_mode, binned_poles=binned_poles, N_mode_poles=N_mode_poles,
        k_avg=k_avg,
    )


def bin_kmu(n1d, L, kedges, muedges, weights, poles=(), dtype=np.float32, fourier=True,
            nthread=None, device=None):
    """Mean weights and mode counts in (k, mu) bins of the modes of an rfft
    mesh (fourier=True, k in units of 2 pi / L) or in (r, mu) bins of a real
    mesh (fourier=False, r in units of the cell L / n1d; separation binning
    for pk_to_xi), read as the JAX package reads it: the [:, :, :n1d/2+1]
    half with the rfft mesh's dup factors (ops/power.py:bin_kmu). Returns
    (weighted_counts, counts, weighted_counts_poles, counts_poles,
    weighted_counts_k). The weight sums are the (weights, 1) cross of K3,
    Re(w * conj(1)) = w exactly. numpy weights go to `device` (the card
    when None); tensors stay where they are."""
    poles = tuple(int(p) for p in np.asarray(poles).reshape(-1))
    kzlen = int(n1d) // 2 + 1
    w = _device_tensor(weights, device)[:, :, :kzlen].to(torch.float32)
    zero = torch.zeros_like(w)
    pair = [torch.complex(w, zero), torch.complex(torch.ones_like(w), zero)]
    dk = 2.0 * np.pi / L if fourier else L / n1d
    plan, res = _binned_spectra(pair, None, 1.0, dk, kedges, muedges, poles)
    return _bin_means(plan, dk, *res[(0, 1)], poles, dtype)


def project_3d_to_poles(k_bin_edges, raw_p3d, Lbox, poles, device=None):
    """3-D power on an rfft mesh -> its Legendre multipoles in k bins, times
    Lbox^3 (ops/power.py:project_3d_to_poles): (binned_poles, Npoles)."""
    _, _, binned_poles, Npoles, _ = bin_kmu(
        raw_p3d.shape[0], Lbox, k_bin_edges, np.array([0.0, 1.0]), raw_p3d, poles, device=device
    )
    return binned_poles * Lbox**3, Npoles


def pk_to_xi(Pk, Lbox, r_bins, poles=(0, 2, 4), device=None):
    """3-D P(k) on the rfft half mesh -> xi_l(r): irfftn (cuFFT on the card),
    then the real mesh's separation binning (:func:`bin_kmu`,
    fourier=False), times nmesh^3 (ops/power.py:pk_to_xi). Returns (r_binc,
    binned_poles, Npoles). numpy input goes to `device` (the card when
    None), as float32 (complex64 when complex)."""
    P = _device_tensor(Pk, device)
    P = P.to(torch.complex64 if P.is_complex() else torch.float32)
    Xi = torch.fft.irfftn(P)
    r_bins = np.asarray(r_bins)
    r_binc = (r_bins[1:] + r_bins[:-1]) * 0.5
    nmesh = Xi.shape[0]
    _, _, binned_poles, Npoles, _ = bin_kmu(
        nmesh, Lbox, r_bins, np.array([0.0, 1.0]), Xi, poles, fourier=False
    )
    return r_binc, binned_poles * nmesh**3, Npoles


def get_smoothing(n1d, L, R, dtype=np.float32, device=None):
    """The Gaussian kernel exp(-k^2 R^2 / 2) on the (n1d, n1d, n1d/2+1) rfft
    mesh, f32 on `device` (the card when None): exp(-|k|^2 f32(dk^2 R^2) / 2)
    with |k|^2 in units of the fundamental mode (ops/power.py:get_smoothing)."""
    n1d = int(n1d)
    kmag2, _, _ = _mode_geometry(n1d, resolve_device(device))
    dk = 2.0 * np.pi / L
    out = torch.exp(-kmag2 * _f32(dk**2 * R**2) / 2.0)
    return out.reshape(n1d, n1d, n1d // 2 + 1)


def get_delta_mu2(delta, n1d, dtype_c=np.complex64, dtype_f=np.float32, device=None):
    """delta * mu^2 on the rfft mesh, mu^2 = kz^2 / |k|^2 one f32 division
    (ops/power.py:get_delta_mu2). numpy input goes to `device` (the card
    when None)."""
    n1d = int(n1d)
    delta = _device_tensor(delta, device, torch.complex64)
    _, mu2, _ = _mode_geometry(n1d, delta.device)
    return delta * mu2.reshape(n1d, n1d, n1d // 2 + 1)


def expand_poles_to_3d(k_ell, P_ell, n1d, L, poles, dtype=np.float32, device=None):
    """P(k, mu) = sum_l P_l(|k|) L_l(mu) on the (n1d, n1d, n1d/2+1) rfft
    mesh, f32 on `device` (the card when None): each pole linearly
    interpolated on its equidistant k table and clamped to the end values,
    the poles added in order (ops/power.py:expand_poles_to_3d and
    _expand_poles_jit, in their f32 steps; |k| from the correctly rounded
    root)."""
    k_ell = np.asarray(k_ell, dtype=dtype)
    P_ell = np.atleast_2d(np.asarray(P_ell, dtype=dtype))
    if not abs((k_ell[1] - k_ell[0]) - (k_ell[-1] - k_ell[-2])) < 1.0e-6:
        raise ValueError('expand_poles_to_3d needs equidistant k_ell')
    n1d = int(n1d)
    dev = resolve_device(device)
    kmag2, mu2, _ = _mode_geometry(n1d, dev)
    kmag = _sqrt_rn_f32(kmag2) * _f32(2 * np.pi / L)
    x0, xn = _f32(k_ell[0]), _f32(k_ell[-1])
    dx = _f32(np.float32(k_ell[1]) - np.float32(k_ell[0]))
    f = ((kmag - x0) / dx).clamp(0.0, _f32(len(k_ell) - 1.000001))
    fl = torch.floor(f).to(torch.int64)
    frac = f - fl.to(torch.float32)
    Pk = torch.zeros_like(kmag)
    for ip, pole in enumerate(int(p) for p in np.asarray(poles).reshape(-1)):
        y = torch.from_numpy(np.ascontiguousarray(P_ell[ip], np.float32)).to(dev)
        # f's upper clip, len - 1.000001, rounds to len - 1 in f32 from 34
        # entries up: the upper neighbour is clamped into the table, as
        # XLA's gather clamps it
        y0, y1 = y[fl], y[(fl + 1).clamp_(max=len(k_ell) - 1)]
        interp = y0 + frac * (y1 - y0)
        interp = torch.where(kmag <= x0, y[0], interp)
        interp = torch.where(kmag >= xn, y[-1], interp)
        Pk = Pk + (interp if pole == 0 else interp * _P_n(mu2, pole))
    return Pk.reshape(n1d, n1d, n1d // 2 + 1)


# ---------------------------------------------------------------------------
# (k_perp, pi) binning: the separable plan and K9 (csrc/kppi_bin.cu)
# ---------------------------------------------------------------------------

# rows of one k_perp bin a K9 block sums (csrc/kppi_bin.cu kItemRows)
KPPI_ITEM_ROWS = 32


class KppiPlan(NamedTuple):
    """The (k_perp, pi) bins of an (n1d, n1d, n1d/2+1) rfft mesh, separable:
    k_perp^2 = ix^2 + iy^2 fixes a row's bin, kz^2 the pi bin, which rises
    with kz, so each pi bin is a contiguous kz range. On the device: `rows`,
    the int32 ids ix * n1d + iy of the rows in a k_perp bin, sorted by bin
    (stably); `items`, the (nitems, 2) int32 [begin, end) runs of at most
    KPPI_ITEM_ROWS of them within one bin, a K9 block each; `item_start`,
    the (nk + 1,) first item of each bin; `zstart`, the (npi + 1,) first kz
    of each pi bin (the last: `kzv`, the kz in any bin, a prefix of the
    row); `row_bin` (n1d^2,) and `z_bin` (kzlen,), each row's and kz's bin
    or -1, for the plain version. `counts` is the exact (nk, npi) int64
    dup-weighted mode count, read-only numpy; `nyq` the kz of the
    self-conjugate Nyquist plane (dup 1), -1 on an odd mesh."""

    rows: torch.Tensor
    items: torch.Tensor
    item_start: torch.Tensor
    zstart: torch.Tensor
    row_bin: torch.Tensor
    z_bin: torch.Tensor
    counts: np.ndarray
    n1d: int
    nk: int
    npi: int
    kzv: int
    nyq: int


def kppi_plan(n1d, kedges2, piedges2, device):
    """Build the :class:`KppiPlan` of squared edges in units of the mesh's dk
    (ops/power.py:_bin_kppi_sums' bins: bk = clip(searchsorted(kedges2,
    k_perp^2, 'left') - 1, 0, Nk - 1), valid where kedges2[0] <= k_perp^2 <
    kedges2[-1]; bpi likewise over piedges2, valid where kz^2 <
    piedges2[-1]), on the host with numpy, then uploaded to `device`."""
    n1d = int(n1d)
    kedges2, piedges2 = np.asarray(kedges2), np.asarray(piedges2)
    nk, npi = len(kedges2) - 1, len(piedges2) - 1
    if nk < 1 or npi < 1:
        raise ValueError('bin_kppi needs at least one k_perp and one pi bin')
    kzlen = n1d // 2 + 1
    i = np.arange(n1d)
    i2 = np.where(i < n1d // 2, i, i - n1d).astype(np.int64) ** 2
    kp2 = (i2[:, None] + i2[None, :]).astype(np.float32).reshape(-1)
    validk = (kp2 >= kedges2[0]) & (kp2 < kedges2[-1])
    bk = np.clip(np.searchsorted(kedges2, kp2, side='left') - 1, 0, nk - 1)
    row_bin = np.where(validk, bk, -1)
    rows = np.nonzero(validk)[0]
    rows = rows[np.argsort(bk[rows], kind='stable')]
    row_start = np.searchsorted(bk[rows], np.arange(nk + 1))

    kz2 = (np.arange(kzlen, dtype=np.int64) ** 2).astype(np.float32)
    validz = kz2 < piedges2[-1]  # a prefix: kz^2 rises along the row
    kzv = int(validz.sum())
    bpi = np.clip(np.searchsorted(piedges2, kz2, side='left') - 1, 0, npi - 1)
    z_bin = np.where(validz, bpi, -1)
    zstart = np.searchsorted(bpi[:kzv], np.arange(npi + 1))
    nyq = n1d // 2 if n1d % 2 == 0 else -1
    dup = np.where((np.arange(kzlen) == 0) | (np.arange(kzlen) == nyq), 1, 2)
    zdup = np.concatenate([[0], np.cumsum(dup[:kzv])])
    counts = np.diff(row_start)[:, None] * np.diff(zdup[zstart])[None, :]
    counts = counts.astype(np.int64)
    counts.flags.writeable = False

    nchunk = -(-np.diff(row_start) // KPPI_ITEM_ROWS)
    item_start = np.concatenate([[0], np.cumsum(nchunk)])
    item = np.arange(item_start[-1])
    ibin = np.repeat(np.arange(nk), nchunk)
    begin = row_start[ibin] + (item - item_start[ibin]) * KPPI_ITEM_ROWS
    end = np.minimum(begin + KPPI_ITEM_ROWS, row_start[ibin + 1])
    items = np.stack([begin, end], 1).reshape(-1, 2)

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

    return KppiPlan(up(rows), up(items), up(item_start), up(zstart), up(row_bin), up(z_bin),
                    counts, n1d, nk, npi, kzv, nyq)


# plans by (n1d, squared edges, device), at most _MAX_BIN_PLANS of them
_KPPI_PLANS = {}


def get_kppi_plan(n1d, kedges2, piedges2, device):
    """:func:`kppi_plan`, cached by (n1d, edges, device)
    (``get_kppi_plan.builds`` counts the builds)."""
    kedges2, piedges2 = np.asarray(kedges2), np.asarray(piedges2)
    device = torch.device(device)
    key = (int(n1d), kedges2.dtype.str, kedges2.tobytes(), piedges2.dtype.str,
           piedges2.tobytes(), str(device))
    plan = _KPPI_PLANS.get(key)
    if plan is None:
        plan = kppi_plan(n1d, kedges2, piedges2, device)
        if len(_KPPI_PLANS) >= _MAX_BIN_PLANS:
            _KPPI_PLANS.clear()
        _KPPI_PLANS[key] = plan
        get_kppi_plan.builds += 1
    return plan


get_kppi_plan.builds = 0


def _check_kppi(weights, plan):
    n1d, kzlen = plan.n1d, plan.n1d // 2 + 1
    if weights.dtype != torch.float32 or weights.dim() != 3 or (
        tuple(weights.shape[:2]) != (n1d, n1d) or weights.shape[2] < kzlen
    ):
        raise ValueError(f'weights must be a float32 ({n1d}, {n1d}, >= {kzlen}) tensor, not '
                         f'{weights.dtype} {tuple(weights.shape)}')
    if weights.stride(2) != 1:
        raise ValueError(f'weights must be contiguous along kz (strides {weights.stride()})')
    if weights.device != plan.rows.device:
        raise ValueError(f'weights are on {weights.device}, the plan on {plan.rows.device}')


def bin_kppi_sums_plain(weights, plan):
    """The (nk, npi) float64 sums of dup * w over the modes of each (k_perp,
    pi) bin of `plan` (ops/power.py:_bin_kppi_sums' wsum): per kx plane a
    torch ``bincount`` of the flat bk * npi + bpi index with f64 weights,
    the planes added in order. weights: (n1d, n1d, >= n1d/2+1) float32, read
    through its strides."""
    _check_kppi(weights, plan)
    n1d, nk, npi = plan.n1d, plan.nk, plan.npi
    kzlen = n1d // 2 + 1
    dev = weights.device
    kz = torch.arange(kzlen, device=dev)
    dup = torch.where((kz == 0) | (kz == plan.nyq), 1.0, 2.0).to(torch.float64)
    zb = plan.z_bin.long()
    rb = plan.row_bin.long().reshape(n1d, n1d)
    out = torch.zeros(nk * npi + 1, dtype=torch.float64, device=dev)
    for ix in range(n1d):
        r = rb[ix][:, None]
        idx = torch.where((r >= 0) & (zb[None, :] >= 0), r * npi + zb[None, :], nk * npi)
        w = weights[ix, :, :kzlen].double() * dup
        out += torch.bincount(idx.reshape(-1), weights=w.reshape(-1), minlength=nk * npi + 1)
    return out[: nk * npi].reshape(nk, npi)


def bin_kppi_sums(weights, plan):
    """The (nk, npi) float64 (k_perp, pi) bin sums of dup * w of
    :func:`bin_kppi_sums_plain`.

    On CUDA tensors this launches K9 (csrc/kppi_bin.cu) and its fixed-order
    reduction on the current stream: no atomics, so repeated calls give the
    same bits. `weights` is read through its strides (a full real mesh's
    [:, :, :n1d/2+1] view is not copied) and must be contiguous along kz. On
    CPU tensors it runs :func:`bin_kppi_sums_plain`."""
    if weights.device.type == 'cpu':
        return bin_kppi_sums_plain(weights, plan)
    _check_kppi(weights, plan)
    dev = weights.device
    nitems = plan.items.shape[0]
    threads = min(1024, max(32, -(-plan.kzv // 32) * 32))
    partials = torch.empty(max(nitems, 1) * plan.npi, dtype=torch.float64, device=dev)
    out = torch.empty((plan.nk, plan.npi), dtype=torch.float64, device=dev)
    lib = _build.lib()
    with torch.cuda.device(dev):
        code = lib.kppi_bin(
            weights.data_ptr(), weights.stride(0), weights.stride(1), plan.n1d, plan.kzv,
            plan.nyq, plan.rows.data_ptr(), plan.items.data_ptr(), nitems,
            plan.item_start.data_ptr(), plan.zstart.data_ptr(), plan.nk, plan.npi, threads,
            partials.data_ptr(), out.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(code, 'kppi_bin')
    bin_kppi_sums.launches += 1
    return out


bin_kppi_sums.launches = 0


def bin_kppi(n1d, L, kedges, pimax, Npi, weights, dtype=np.float32, fourier=True, nthread=None,
             device=None):
    """Mean weights and mode counts in (k_perp, pi) bins of an rfft mesh
    (ops/power.py:bin_kppi): k_perp edges `kedges`, Npi pi bins to `pimax`,
    in units of dk = 2 pi / L (fourier=True) or L / n1d (fourier=False).
    Returns (weighted_counts (Nk, Npi) `dtype`, counts (Nk, Npi) int64); the
    counts come exactly from the plan, the sums from K9. numpy weights go
    to `device` (the card when None); tensors stay where they are."""
    kedges = np.asarray(kedges)
    dk = 2.0 * np.pi / L if fourier else L / n1d
    kedges2 = ((kedges / dk) ** 2).astype(dtype)
    piedges2 = ((np.linspace(0.0, pimax, int(Npi) + 1) / dk) ** 2).astype(dtype)
    w = _device_tensor(weights, device, torch.float32)
    if w.dim() == 3 and w.stride(2) != 1:
        w = w.contiguous()
    plan = get_kppi_plan(int(n1d), kedges2, piedges2, w.device)
    wsum = bin_kppi_sums(w, plan).cpu().numpy()
    counts = np.array(plan.counts)
    with np.errstate(invalid='ignore', divide='ignore'):
        weighted_counts = np.where(counts != 0, wsum / counts, 0.0).astype(dtype)
    return weighted_counts, counts


def calc_pk_from_deltak(
    field_fft, Lbox, k_bin_edges, mu_bin_edges, field2_fft=None, poles=(), squeeze_mu_axis=True,
):
    """P(k, mu) (+ multipoles) of one field or one cross pair, through one
    K3 launch (ops/power.py:calc_pk_from_deltak)."""
    poles = tuple(int(p) for p in np.asarray(poles).reshape(-1))
    ffts = [field_fft] if field2_fft is None else [field_fft, field2_fft]
    dk = 2.0 * np.pi / Lbox
    plan, res = _binned_spectra(ffts, None, 1.0, dk, k_bin_edges, mu_bin_edges, poles)
    wsum, psums = res[(0, 0) if field2_fft is None else (0, 1)]
    return _spectrum(plan, dk, wsum, psums, Lbox, poles, squeeze_mu_axis)


def calc_pk_pairs_from_deltak(
    ffts, Lbox, k_bin_edges, mu_bin_edges, poles=(), squeeze_mu_axis=True, pairs=None,
):
    """calc_pk_from_deltak for every auto and cross pair of a field stack
    through ONE K3 launch, for any Nk * Nmu and poles
    (ops/power.py:calc_pk_pairs_from_deltak, which falls back to a per-pair
    loop at Nk * Nmu > 256). Returns {(i, j): dict}, i >= j (all pairs) or
    the requested `pairs`; (i, j) and (j, i) are the same spectrum."""
    poles = tuple(int(p) for p in np.asarray(poles).reshape(-1))
    nf = len(ffts)
    if pairs is None:
        pairs = tuple((i, j) for i in range(nf) for j in range(i + 1))
    dk = 2.0 * np.pi / Lbox
    plan, res = _binned_spectra(list(ffts), None, 1.0, dk, k_bin_edges, mu_bin_edges, poles)
    out = {}
    for i, j in pairs:
        wsum, psums = res[(min(i, j), max(i, j))]
        out[(int(i), int(j))] = _spectrum(plan, dk, wsum, psums, Lbox, poles, squeeze_mu_axis)
    return out


class SpectrumTable(dict):
    """calc_power's result: its columns by name (numpy arrays, the columns of
    the JAX package's Table) and the run's settings in ``meta``."""

    def __init__(self, columns, meta):
        super().__init__(columns)
        self.meta = meta


def _spectrum_table(P, kbins, mubins, poles, return_mubins, meta):
    """calc_power's SpectrumTable from one pair's spectrum dict
    (ops/power.py:_spectrum_table)."""
    k_binc = (kbins[1:] + kbins[:-1]) * 0.5
    mu_binc = (mubins[1:] + mubins[:-1]) * 0.5
    res = dict(
        k_min=kbins[:-1], k_max=kbins[1:], k_mid=k_binc, k_avg=P['k_avg'], power=P['power'],
        N_mode=P['N_mode'],
    )
    if len(poles) > 0:
        res.update(poles=np.asarray(P['binned_poles']).T, N_mode_poles=P['N_mode_poles'])
    if return_mubins:
        shape = res['power'].shape
        res.update(
            mu_min=np.broadcast_to(mubins[:-1], shape).copy(),
            mu_max=np.broadcast_to(mubins[1:], shape).copy(),
            mu_mid=np.broadcast_to(mu_binc, shape).copy(),
        )
    return SpectrumTable({k: np.asarray(v) for k, v in res.items()}, meta)


def _n_pos(pos):
    return len(pos[0]) if isinstance(pos, (tuple, list)) else len(pos)


def calc_power(
    pos, Lbox, kbins=None, mubins=None, k_max=None, logk=False, paste='TSC', nmesh=128,
    compensated=True, interlaced=True, w=None, pos2=None, w2=None, poles=None,
    squeeze_mu_axis=True, device=None,
):
    """Paint -> rfftn -> bin (ops/power.py:calc_power): one or two catalogs
    painted with K1, their auto (or cross) spectrum binned by one K3 launch
    that applies the 1/N^3 scale and the window. numpy inputs go to
    `device` (the card when None; raises where there is none); tensors
    stay where they are. Returns a
    :class:`SpectrumTable` with the JAX Table's columns and meta."""
    if kbins is None:
        kbins = nmesh
    if k_max is None:
        k_max = np.pi * nmesh / Lbox
    return_mubins = mubins is not None
    if mubins is None:
        mubins = 1
    meta = dict(
        Lbox=Lbox, logk=logk, paste=paste, nmesh=nmesh, compensated=compensated,
        interlaced=interlaced, poles=poles, N_pos=_n_pos(pos), is_weighted=w is not None,
        squeeze_mu_axis=squeeze_mu_axis,
    )
    if pos2 is not None:
        meta['N_pos2'] = _n_pos(pos2)
        meta['is_weighted2'] = w2 is not None
    W = get_W_compensated(Lbox, nmesh, paste, interlaced) if compensated else None
    poles = tuple(int(p) for p in np.asarray(poles if poles is not None else [], np.int64))
    kbins, mubins = get_k_mu_edges(Lbox, k_max, kbins, mubins, logk)
    dev = device
    if dev is None and isinstance(pos, torch.Tensor):
        dev = pos.device
    F, scale = _field_fft(pos, Lbox, nmesh, paste, w, interlaced, dev)
    ffts = [F]
    if pos2 is not None:
        ffts.append(_field_fft(pos2, Lbox, nmesh, paste, w2, interlaced, F.device)[0])
    dk = 2.0 * np.pi / Lbox
    plan, res = _binned_spectra(ffts, W, scale, dk, kbins, mubins, poles)
    wsum, psums = res[(0, len(ffts) - 1)]
    P = _spectrum(plan, dk, wsum, psums, Lbox, poles, squeeze_mu_axis)
    return _spectrum_table(P, kbins, mubins, poles, return_mubins, meta)


class StagedPower:
    """One catalog staged once for many P(k) measurements
    (ops/power.py:StagedPower): parameter scans, RSD loops.

    The points are staged once on K1's brick stage
    (:func:`ops.grid.stage_bricks`, bricks with the fused route's z margin
    of RSD_MARGIN cells), keeping the sort's permutation; each
    :meth:`power` call deposits the staged columns with K1, transforms and
    bins with K3, as :func:`calc_power` does. ``pz=`` overrides the z
    column for one call: one device gather, pz[order], into the cached
    layout, with no re-sort. A point whose new z leaves its brick's tile and
    margin goes through K1's overflow path, which deposits it straight into
    the grid, so every pz is right; :attr:`overflow` holds the overflow word
    of the last call (its points, summed over the stages), so the share it
    costs can be read. ``interlaced=True`` stages a second time at the
    half-cell offset, as the JAX package does. TSC only. pos: (N, 3) or an
    SoA (x, y, z) tuple; numpy inputs go to `device` (the card when None),
    tensors stay where they are."""

    def __init__(self, pos, lbox, nmesh=256, w=None, paste='TSC', interlaced=False,
                 device=None):
        if paste.upper() != 'TSC':
            raise ValueError('StagedPower supports TSC paste only')
        cols = _pos_columns(pos, device)
        self.device = cols[0].device
        self.lbox = float(lbox)
        self.nmesh = int(nmesh)
        self.n_part = int(cols[0].shape[0])
        self.interlaced = bool(interlaced)
        self._is_weighted = w is not None
        wcol = _weights(w, self.device)
        cols.append(torch.ones_like(cols[0]) if wcol is None else wcol)
        offsets = [0.0] + ([0.5 * self.lbox / self.nmesh] if interlaced else [])
        self._stages = []
        for off in offsets:
            staged, plan, order = stage_bricks(cols, self.nmesh, self.lbox,
                                               margin=(0, 0, RSD_MARGIN), offset=off,
                                               return_order=True)
            self._stages.append((staged, plan, order, off))
        self.overflow = torch.zeros(1, dtype=torch.int32, device=self.device)

    def _staged_z(self, order, pz):
        if len(pz) != self.n_part:
            raise ValueError(f'pz override has {len(pz)} entries for a stage of '
                             f'{self.n_part} particles')
        pz = _device_tensor(pz, self.device, torch.float32).to(self.device)
        return pz.index_select(0, order)

    def _fft(self, pz=None):
        """(rfftn of the overdensity, or the interlaced combination, and the
        scale K3 applies: 1/N^3, or 1.0 for the interlaced field, which
        carries its own); the overflow words of the deposits go into
        :attr:`overflow`."""
        self.overflow.zero_()
        ffts = []
        for (x, y, z, w), plan, order, off in self._stages:
            if pz is not None:
                z = self._staged_z(order, pz)
            grid = torch.zeros((self.nmesh,) * 3, dtype=torch.float32, device=self.device)
            tsc_deposit_cells(grid, x, y, z, w, plan, self.lbox, off, self.overflow)
            ffts.append(torch.fft.rfftn(grid * _f32(grid.numel() / self.n_part) - 1.0))
            del grid
        if not self.interlaced:
            return ffts[0], 1.0 / self.nmesh**3
        d = self.lbox / self.nmesh
        return _interlace_combine(ffts[0], ffts[1], self.nmesh, self.lbox, d), 1.0

    def _window(self, compensated):
        if not compensated:
            return None
        return get_W_compensated(self.lbox, self.nmesh, 'TSC', self.interlaced).astype(np.float32)

    def field_fft(self, compensated=True, pz=None):
        """The Fourier overdensity of the staged catalog (optionally with a
        z column for this call): delta = grid (N^3 / n) - 1, rfftn, the
        interlace combination or 1/N^3, then the window; equal to
        :func:`get_field_fft` of the same points with this stage's
        interlacing."""
        F, scale = self._fft(pz)
        W = self._window(compensated)
        if W is not None:
            return _scaled(F, scale, torch.from_numpy(W).to(F.device))
        return F * _f32(scale) if scale != 1.0 else F

    def power(self, kbins=None, mubins=None, k_max=None, logk=False, compensated=True,
              poles=None, squeeze_mu_axis=True, pz=None, cross=None, pz2=None):
        """One staged P(k, mu) / P_l measurement: the :class:`SpectrumTable`
        of :func:`calc_power` with this stage's interlacing. `cross`, another
        StagedPower of the same box, mesh and interlacing, gives the cross
        spectrum; pz / pz2 override the z column of either side for this
        call."""
        nmesh, lbox = self.nmesh, self.lbox
        if cross is not None and (cross.nmesh != nmesh or cross.lbox != lbox
                                  or cross.interlaced != self.interlaced):
            raise ValueError('cross-stage must share (lbox, nmesh, interlaced)')
        if kbins is None:
            kbins = nmesh
        if k_max is None:
            k_max = np.pi * nmesh / lbox
        return_mubins = mubins is not None
        if mubins is None:
            mubins = 1
        meta = dict(
            Lbox=lbox, logk=logk, paste='TSC', nmesh=nmesh, compensated=compensated,
            interlaced=self.interlaced, poles=poles, N_pos=self.n_part,
            is_weighted=self._is_weighted, squeeze_mu_axis=squeeze_mu_axis,
        )
        F, scale = self._fft(pz)
        ffts = [F]
        if cross is not None:
            meta['N_pos2'] = cross.n_part
            meta['is_weighted2'] = cross._is_weighted
            ffts.append(cross._fft(pz2)[0].to(self.device))
        poles = tuple(int(p) for p in np.asarray(poles if poles is not None else [], np.int64))
        kbins, mubins = get_k_mu_edges(lbox, k_max, kbins, mubins, logk)
        dk = 2.0 * np.pi / lbox
        W = self._window(compensated)
        plan, res = _binned_spectra(ffts, W, scale, dk, kbins, mubins, poles)
        P = _spectrum(plan, dk, *res[(0, len(ffts) - 1)], lbox, poles, squeeze_mu_axis)
        return _spectrum_table(P, kbins, mubins, poles, return_mubins, meta)
