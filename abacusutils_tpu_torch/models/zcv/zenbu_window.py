r"""Mode-coupling window matrix and the ZeNBu templates
(the counterpart of abacusutils_tpu/models/zcv/zenbu_window.py).

The window reduces to per-bin mode sums over the rfft mesh: seven weight
rows (counts, |k| and the Legendre products) summed into the output |k|
bins. Two engines compute them:

- 'host': :func:`_window_mode_sums_host`, a numpy copy of the JAX package's
  vectorized bincounts;
- 'device': :func:`window_mode_sums`, which launches K8
  (``csrc/zcv_window.cu``) on CUDA tensors over a row plan
  (:func:`get_window_plan`: the distinct f32 kx^2 + ky^2 of the mesh's
  rows with their multiplicities, each cut to its run of in-range kz) and
  runs the plain version :func:`window_mode_sums_plain` (a torch
  ``bincount`` a kx plane over the whole mesh) on CPU tensors. It replaces
  the JAX package's ``_window_sums_impl``. :func:`window_mode_sums_rows_plain`
  sums the plan's rows in torch, for the tests.

'auto' takes the device at nmesh >= 256, as the JAX package does. The
templates come from the native ZA engine (``zenbu_native``), k split over
processes (:func:`_templates`). :func:`window_and_templates` returns what
the JAX package's ``main`` saves as ``.npz`` files, from arrays in memory;
:func:`main` writes those files.
"""

import os
import pickle
from typing import NamedTuple
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from ... import _build
from ...config import DEFAULT_CONFIG, load_config
from ...convert import resolve_device
from ...metadata import get_meta
from ...ops.power import _sqrt_rn_f32, get_k_mu_edges
from .files import k_tag, sim_dirs
from .zenbu_native import zenbu_spectra_native

__all__ = [
    'periodic_window_function', 'window_mode_sums', 'window_mode_sums_plain',
    'window_mode_sums_rows_plain', 'window_plan', 'get_window_plan', 'WindowPlan',
    'zenbu_spectra', 'window_and_templates', 'K8_ITEM_ROWS', 'main', 'meshgrid',
]

_PREF = (1, 5, 9)  # (2*ell + 1) for ell = 0, 2, 4
# the seven weight rows of a mode, in K8's order
_ROWS = 7
# the plan rows of one bin a K8 block takes (4 a thread)
K8_ITEM_ROWS = 1024
K8_THREADS = 256


def _mode_kgrids(nmesh, lbox):
    dk = 2 * np.pi / lbox
    i = np.arange(nmesh)
    kvals = np.where(i < nmesh // 2, i, i - nmesh).astype(np.float32) * dk
    kvalsr = np.arange(nmesh // 2 + 1, dtype=np.float32) * dk
    return kvals, kvalsr


def _window_mode_sums_host(nmesh, lbox, kout):
    """Per-output-bin mode sums with vectorized numpy bincounts.

    Returns (S, nmodes_out_k, keff_sum): S[ell, ellp, bin] is the
    dup-weighted sum of pref[ell] * L_ell(mu) * L_ellp(mu) over the rfft
    modes whose |k| falls in the bin; keff_sum is the un-normalized
    dup-weighted |k| sum.
    """
    kvals, kvalsr = _mode_kgrids(nmesh, lbox)
    kx = kvals[:, None, None]
    ky = kvals[None, :, None]
    kz = kvalsr[None, None, :]
    knorm = np.sqrt(kx**2 + ky**2 + kz**2)
    mu = np.divide(kz, knorm, out=np.zeros_like(knorm + kz), where=knorm > 0)
    nkout = len(kout) - 1

    idx_o = np.digitize(knorm, kout) - 1  # (nmesh, nmesh, kzlen)
    # mode weights: kz=0 plane counted once, else twice
    dup = np.ones_like(knorm)
    dup[:, :, 1:] = 2.0
    inbin = (idx_o >= 0) & (idx_o < nkout)
    flat_o = np.where(inbin, idx_o, nkout).reshape(-1)

    nmodes_out_k = np.bincount(
        flat_o, weights=dup.reshape(-1), minlength=nkout + 1
    )[:nkout]
    keff_sum = np.bincount(
        flat_o, weights=(dup * knorm).reshape(-1), minlength=nkout + 1
    )[:nkout]

    L0 = np.ones_like(mu)
    L2 = (3 * mu**2 - 1) / 2
    L4 = (35 * mu**4 - 30 * mu**2 + 3) / 8
    legs = [L0, L2, L4]

    S = np.zeros((3, 3, nkout))
    for ell in range(3):
        for ellp in range(3):
            w = (dup * _PREF[ell] * legs[ell] * legs[ellp]).reshape(-1)
            S[ell, ellp] = np.bincount(
                flat_o, weights=w, minlength=nkout + 1
            )[:nkout]
    return S, nmodes_out_k, keff_sum


def _f32_ge_edges(kout):
    """f32 thresholds e32 such that (knorm_f32 >= e32) == (knorm >= e_f64)
    for every f32 knorm — matches the host digitize, which compares the f32
    |k| grid against f64 edges."""
    kout = np.asarray(kout, np.float64)
    e32 = kout.astype(np.float32)
    low = e32.astype(np.float64) < kout
    e32[low] = np.nextafter(e32[low], np.float32(np.inf), dtype=np.float32)
    return e32


def _mode_weights(ksq, kz):
    """|k| and the seven f32 weight rows of modes of squared norm `ksq` (f32,
    summed as (kx kx + ky ky) + kz kz) and rfft axis `kz`, in K8's
    arithmetic (_window_sums_impl's association; the root correctly
    rounded, as K8's __fsqrt_rn, on every CPU)."""
    knorm = _sqrt_rn_f32(ksq)
    mu = torch.where(knorm > 0, kz / torch.where(knorm > 0, knorm, 1.0), 0.0)
    L2 = (3 * mu * mu - 1) / 2
    m2 = mu * mu
    L4 = (35 * (m2 * m2) - 30 * mu * mu + 3) / 8
    dup = torch.where(kz > 0, 2.0, 1.0).expand_as(knorm)
    dL2, dL4 = dup * L2, dup * L4
    return knorm, (dup, dup * knorm, dL2, dL4, dL2 * L2, dL2 * L4, dL4 * L4)


def _mode_rows(kx, ky, kz):
    """(bin-free) |k| and the seven f32 weight rows of the modes of one kx
    plane (:func:`_mode_weights`)."""
    return _mode_weights(kx * kx + ky * ky + kz * kz, kz)


def _k2_thresholds(edges):
    """For each f32 edge e the least f32 s >= 0 whose correctly rounded root
    is at least e: a mode of squared norm s has |k| >= e exactly when s >=
    the threshold, since the rounded root is monotone (0 for e <= 0, inf
    past every f32 root)."""
    e = np.asarray(edges, np.float32)

    def root(a):
        return np.sqrt(a.astype(np.float64)).astype(np.float32)

    with np.errstate(over='ignore', invalid='ignore'):
        t = np.where(e > 0, (e.astype(np.float64) ** 2).astype(np.float32), np.float32(0))
    for _ in range(64):
        lower = np.maximum(np.nextafter(t, np.float32(-np.inf)), np.float32(0))
        down = (t > 0) & (root(lower) >= e)
        up = root(t) < e
        if not (down.any() or up.any()):
            return t
        t = np.where(down, lower, np.where(up, np.nextafter(t, np.float32(np.inf)), t))
    raise ValueError('window thresholds did not settle (edges must be finite or inf)')


class WindowPlan(NamedTuple):
    """K8's row plan of an rfft mesh and its f32 edges (:func:`window_plan`).

    kv, kzv, edges: the tensors it was built for; thresholds: the (nkout +
    1,) f32 squared-norm thresholds of the edges (:func:`_k2_thresholds`);
    kz2: kzv * kzv; kxy2: the distinct f32 kx kx + ky ky over the mesh's
    (ix, iy) rows that hold a mode in a bin, ascending; mult: the f64
    number of rows that share each value's bits; izlo, izhi: int32, the
    first and last kz of each value's in-bin modes (a row's squared norm
    rises with kz, so they are one run); cut_mult: the multiplicities of
    the distinct values with no mode in a bin; reach: (nkout,) int32, the
    rows with kxy2 below each bin's upper threshold, a prefix of the rows
    that holds every row with a mode in the bin; nkout; modes: the in-bin
    modes of the rows, sum of izhi - izlo + 1."""

    kv: torch.Tensor
    kzv: torch.Tensor
    edges: torch.Tensor
    thresholds: torch.Tensor
    kz2: torch.Tensor
    kxy2: torch.Tensor
    mult: torch.Tensor
    izlo: torch.Tensor
    izhi: torch.Tensor
    cut_mult: torch.Tensor
    reach: torch.Tensor
    nkout: int
    modes: int


def _check_window_args(kv, kzv, edges, nkout):
    nmesh = kv.shape[0]
    for name, t, n in (('kv', kv, nmesh), ('kzv', kzv, nmesh // 2 + 1),
                       ('edges', edges, nkout + 1)):
        if t.dtype != torch.float32 or t.shape != (n,) or not t.is_contiguous() or (
            t.device != kv.device
        ):
            raise ValueError(f'{name} must be a contiguous ({n},) float32 tensor on {kv.device}')


def window_plan(kv, kzv, edges, nkout):
    """The :class:`WindowPlan` of the mesh axes kv (nmesh,), kzv (nmesh // 2
    + 1,) and the f32 thresholds `edges` (nkout + 1,) of
    :func:`_f32_ge_edges`, built with torch on their device: the distinct
    values of kv[ix] kv[ix] + kv[iy] kv[iy] (``torch.unique`` of the mesh's
    own table, so an odd mesh's unpaired -(n + 1) / 2 dk counts as it
    lies), each value's run of in-bin kz (its squared norms against the
    first and last edges' thresholds, rows at a time), and the prefix of
    the rows each bin reaches."""
    _check_window_args(kv, kzv, edges, nkout)
    dev = kv.device
    thr = torch.from_numpy(_k2_thresholds(edges.cpu().numpy())).to(dev)
    kx2 = kv * kv
    vals, counts = torch.unique((kx2[:, None] + kx2[None, :]).reshape(-1), return_counts=True)
    kz2 = kzv * kzv
    # a row's squared norms rise with kz: its in-bin kz are those from the
    # first at or above the first threshold to the last below the last one
    lo = torch.empty(vals.numel(), dtype=torch.int32, device=dev)
    end = torch.empty_like(lo)
    per = max(1, (1 << 24) // kz2.numel())
    for r0 in range(0, vals.numel(), per):
        ksq = vals[r0:r0 + per, None] + kz2[None, :]
        torch.sum(ksq < thr[0], 1, dtype=torch.int32, out=lo[r0:r0 + per])
        torch.sum(ksq < thr[nkout], 1, dtype=torch.int32, out=end[r0:r0 + per])
    keep = end > lo
    kxy2, lo, end = vals[keep], lo[keep], end[keep]
    # bin b reaches the rows with kxy2 below its upper threshold
    reach = torch.searchsorted(kxy2, thr[1:], out_int32=True)
    return WindowPlan(
        kv, kzv, edges, thr, kz2, kxy2, counts[keep].double(), lo, end - 1,
        counts[~keep].double(), reach, int(nkout),
        int((end - lo).sum()),
    )


def get_window_plan(nmesh, lbox, kout, device):
    """The :class:`WindowPlan` of an nmesh^3 mesh of side lbox and the output
    edges kout on `device`. Built anew on each call: a window is computed
    once per :func:`~.precompute.zcv_products`."""
    kvals, kvalsr = _mode_kgrids(nmesh, lbox)
    kv, kzv, edges = (torch.from_numpy(a).to(torch.device(device))
                      for a in (kvals, kvalsr, _f32_ge_edges(kout)))
    return window_plan(kv, kzv, edges, len(kout) - 1)


def window_mode_sums_plain(kv, kzv, edges, nkout):
    """The seven (7, nkout) float64 mode sums of the window: per kx plane a
    torch ``bincount`` of each weight row over the modes' bins (the modes
    with edges[b] <= |k| < edges[b + 1]), the planes added in order. kv:
    (nmesh,) f32 k of the mesh axes; kzv: (nmesh // 2 + 1,) f32 k of the rfft
    axis; edges: (nkout + 1,) f32 thresholds (:func:`_f32_ge_edges`)."""
    out = torch.zeros((_ROWS, nkout), dtype=torch.float64, device=kv.device)
    ky, kz = kv[:, None], kzv[None, :]
    for ix in range(kv.shape[0]):
        knorm, rows = _mode_rows(kv[ix], ky, kz)
        idx = torch.searchsorted(edges, knorm.reshape(-1), right=True) - 1
        idx = torch.where((idx >= 0) & (idx < nkout), idx, nkout)
        for r, w in enumerate(rows):
            out[r] += torch.bincount(idx, weights=w.reshape(-1).double(),
                                     minlength=nkout + 1)[:nkout]
    return out


def window_mode_sums_rows_plain(plan):
    """The plan's rows in torch, a mirror of what K8 sums (the tests hold
    the plan to the plain version with it): each row's modes izlo..izhi,
    binned by the plan's squared-norm thresholds, their seven weight rows
    times the row's multiplicity added in f64 (``bincount``), in (7, nkout)
    float64. Equal to :func:`window_mode_sums_plain` in the counts row; the
    other rows are the same f32 weights summed in another order."""
    nkout = plan.nkout
    out = torch.zeros((_ROWS, nkout), dtype=torch.float64, device=plan.kxy2.device)
    n = (plan.izhi - plan.izlo + 1).long()
    if n.numel() == 0:
        return out
    first = torch.cumsum(n, 0) - n
    for r0 in range(0, plan.modes, 1 << 22):
        pos = torch.arange(r0, min(r0 + (1 << 22), plan.modes), device=out.device)
        row = torch.searchsorted(first, pos, right=True) - 1
        iz = plan.izlo[row].long() + (pos - first[row])
        ksq = plan.kxy2[row] + plan.kz2[iz]
        idx = torch.searchsorted(plan.thresholds, ksq, right=True) - 1
        _, rows = _mode_weights(ksq, plan.kzv[iz])
        m = plan.mult[row]
        for r, w in enumerate(rows):
            out[r] += torch.bincount(idx, weights=w.double() * m, minlength=nkout)[:nkout]
    return out


def window_mode_sums(plan):
    """The window's (7, nkout) float64 mode sums (rows: dup, dup |k|, dup
    L2, dup L4, dup L2 L2, dup L2 L4, dup L4 L4; see
    :func:`window_mode_sums_plain`) of the mesh and edges of the
    :class:`WindowPlan` `plan`.

    On CUDA tensors this launches K8 (csrc/zcv_window.cu: each bin's prefix
    of the plan's rows in chunks of :data:`K8_ITEM_ROWS`, then a
    fixed-order reduction) on the current stream; the
    counts row equals the plain version's exactly and repeated calls give
    the same bits. On CPU tensors it runs :func:`window_mode_sums_plain`."""
    dev = plan.kv.device
    if dev.type == 'cpu':
        return window_mode_sums_plain(plan.kv, plan.kzv, plan.edges, plan.nkout)
    lib = _build.lib()
    nkout, nrows = plan.nkout, plan.kxy2.numel()
    nchunks = -(-nrows // K8_ITEM_ROWS)
    partials = torch.empty(max(nkout * nchunks, 1) * _ROWS, dtype=torch.float64, device=dev)
    out = torch.empty((_ROWS, nkout), dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        code = lib.zcv_window_rows(
            plan.reach.data_ptr(), nrows, K8_ITEM_ROWS, plan.kxy2.data_ptr(),
            plan.mult.data_ptr(), plan.izlo.data_ptr(), plan.izhi.data_ptr(),
            plan.kzv.data_ptr(), plan.kz2.data_ptr(), plan.thresholds.data_ptr(), nkout,
            K8_THREADS, partials.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(code, 'zcv_window_rows')
    window_mode_sums.launches += 1
    return out


window_mode_sums.launches = 0


def _window_mode_sums_device(nmesh, lbox, kout, device):
    """(S, nmodes_out_k, keff_sum) of :func:`_window_mode_sums_host` from
    :func:`window_mode_sums` on `device` over a row plan
    (zenbu_window.py:_window_mode_sums_device)."""
    nkout = len(kout) - 1
    r = window_mode_sums(get_window_plan(nmesh, lbox, kout, resolve_device(device)))
    r = r.cpu().numpy()
    nmodes_out_k, keff_sum = r[0], r[1]
    prod = {(0, 0): r[0], (0, 1): r[2], (0, 2): r[3],
            (1, 1): r[4], (1, 2): r[5], (2, 2): r[6]}
    S = np.empty((3, 3, nkout))
    for ell in range(3):
        for ellp in range(3):
            S[ell, ellp] = _PREF[ell] * prod[min(ell, ellp), max(ell, ellp)]
    return S, nmodes_out_k, keff_sum


def periodic_window_function(nmesh, lbox, kout, kin, k2weight=True, engine='auto', device=None):
    """Matrix convolving a finely-evaluated theory P_ell with the periodic
    box's mode coupling: `window @ pell_th` gives the binned estimator's
    expectation (zenbu_window.py:periodic_window_function; rows are output
    (ell, k-bin) pairs).

    engine: 'host' (numpy bincounts), 'device' (:func:`window_mode_sums` on
    `device` over a row plan: K8 on the card, the default, or the plain
    version on the CPU), or 'auto' (the device at nmesh >= 256).

    Returns (window, keff).
    """
    kout = np.asarray(kout, np.float64)
    kin = np.asarray(kin)
    nkin = len(kin)
    nkout = len(kout) - 1

    if k2weight:
        dkin = np.zeros_like(kin)
        dkin[:-1] = kin[1:] - kin[:-1]
        dkin[-1] = dkin[-2]
        win = kin**2 * dkin
    else:
        win = np.ones_like(kin)

    idx_i = np.digitize(kin, kout) - 1

    # input-side normalization per output bin
    nmodes_in = np.zeros(nkout + 2)
    np.add.at(nmodes_in, idx_i + 1, win)
    nmodes_in = nmodes_in[1 : nkout + 1]
    with np.errstate(divide='ignore'):
        norm_in = np.where(nmodes_in > 0, 1.0 / nmodes_in, 0.0)

    if engine == 'auto':
        engine = 'device' if nmesh >= 256 else 'host'
    if engine == 'device':
        S, nmodes_out_k, keff = _window_mode_sums_device(nmesh, lbox, kout, device)
    elif engine == 'host':
        S, nmodes_out_k, keff = _window_mode_sums_host(nmesh, lbox, kout)
    else:
        raise ValueError(f"engine must be 'auto', 'device' or 'host', not {engine!r}")

    window = np.zeros((nkout * 3, nkin * 3), dtype=np.float32)
    # input k fall in output bin idx_i[beta]; weight win[beta]
    valid_i = (idx_i >= 0) & (idx_i < nkout)
    for ell in range(3):
        for ellp in range(3):
            # window[ell*nkout + b_out, ellp*nkin + beta] = S[ell,ellp,b_out] * win[beta]
            # but only when idx_i[beta] == b_out
            rows = ell * nkout + idx_i[valid_i]
            cols = ellp * nkin + np.nonzero(valid_i)[0]
            window[rows, cols] += (S[ell, ellp, idx_i[valid_i]] * win[valid_i]).astype(
                np.float32
            )

    nmodes_out = np.concatenate([nmodes_out_k] * 3)
    with np.errstate(divide='ignore'):
        norm_out = np.where(nmodes_out > 0, 1.0 / nmodes_out, 0.0)
    norm_in_allell = np.concatenate([norm_in] * 3)
    window = window * norm_out.reshape(-1, 1) * norm_in_allell.reshape(-1, 1)
    with np.errstate(divide='ignore', invalid='ignore'):
        keff = np.where(nmodes_out_k > 0, keff / nmodes_out_k, 0.0)
    return window, keff.astype(np.float32)


def zenbu_spectra(k, z, cfg, kin, pin, rsd=True, nmax=6, ngauss=6):
    """ZeNBu LPT template spectra from the native ZA engine
    (zenbu_window.py:zenbu_spectra without the optional external package:
    :func:`zenbu_native.zenbu_spectra_native` with nmax and ngauss at least
    8). Returns (pk_ij_zenbu, None)."""
    return zenbu_spectra_native(np.asarray(k, np.float64), z, cfg, kin, pin, rsd=rsd,
                                nmax=max(nmax, 8), ngauss=max(ngauss, 8))


# k a template process takes at the least: each process builds the
# q-functions (~40 s on the default q grid) before its first k (~2 s a k in
# redshift space), so a smaller share would not pay for the build
_K_PER_PROCESS = 16
_ONE_BLAS_THREAD = {v: '1' for v in ('OMP_NUM_THREADS', 'OPENBLAS_NUM_THREADS', 'MKL_NUM_THREADS')}
_PACKAGE_ROOT = str(Path(__file__).resolve().parents[3])


def _templates(k, z, cfg, kin, pin, rsds, kw):
    """The template table of each `rsds` entry at every k, in `rsds` order.

    k is split into runs, one a process, over as many processes as the
    cores this process may use, with at least _K_PER_PROCESS k a process;
    each process runs ``python -m ...zenbu_native`` with one BLAS thread.
    A single run is computed here. Each k is computed alone, so the table
    is the one a single run with one BLAS thread makes."""
    nproc = max(1, min(len(os.sched_getaffinity(0)), len(k) // _K_PER_PROCESS))
    if nproc == 1:
        return [zenbu_spectra_native(k, z, cfg, kin, pin, rsd=r, **kw)[0] for r in rsds]
    path = os.pathsep.join(p for p in (_PACKAGE_ROOT, os.environ.get('PYTHONPATH')) if p)
    env = {**os.environ, **_ONE_BLAS_THREAD, 'PYTHONPATH': path}
    procs = []
    try:
        for run in np.array_split(k, nproc):
            err = tempfile.TemporaryFile()
            procs.append((subprocess.Popen(
                [sys.executable, '-m', zenbu_spectra_native.__module__],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=err, env=env), err))
            procs[-1][0].stdin.write(pickle.dumps((run, z, cfg, kin, pin, rsds, kw)))
            procs[-1][0].stdin.close()
        runs = []
        for p, err in procs:
            out = p.stdout.read()
            if p.wait() != 0:
                err.seek(0)
                raise RuntimeError(f'template process exited with {p.returncode}:\n'
                                   f'{err.read().decode(errors="replace")[-2000:]}')
            runs.append(pickle.loads(out))
    finally:
        for p, err in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            p.stdout.close()
            err.close()
    return [np.concatenate([r[i] for r in runs], axis=-1) for i in range(len(rsds))]


def window_and_templates(nmesh, Lbox, power_params, kcut, z, meta, want_rsd=True,
                         engine='auto', device=None):
    """The window matrix and the ZeNBu templates of zenbu_window.py:main as
    arrays: the window of the power_params k bins at their centres
    (:func:`periodic_window_function`, `engine` on `device`) and, for RSD
    and real space (real space only when want_rsd is False), the template
    table of the metadata's CLASS P(k) scaled from z = 1 to the initial
    redshift (:func:`_templates`). meta: the :func:`cosmo.get_meta` dict of
    the simulation at z.

    Returns {'window', 'keff', 'k_binc', 'kcut', 'pk_ij_zenbu_rsd' (when
    want_rsd), 'pk_ij_zenbu'}."""
    pp = power_params
    k_bins, _ = get_k_mu_edges(Lbox, pp['k_hMpc_max'], pp['nbins_k'], pp['nbins_mu'], pp['logk'])
    k_binc = 0.5 * (k_bins[1:] + k_bins[:-1])
    window, keff = periodic_window_function(nmesh, Lbox, k_bins, k_binc, k2weight=True,
                                            engine=engine, device=device)
    kth = np.asarray(meta['CLASS_power_spectrum']['k (h/Mpc)'])
    pk_th = np.asarray(meta['CLASS_power_spectrum']['P (Mpc/h)^3'])
    z_ic = meta['InitialRedshift']
    D_ratio = meta['GrowthTable'][z_ic] / meta['GrowthTable'][1.0]
    p_m_lin = D_ratio**2 * pk_th
    cfg = {'sim_name': meta['SimName'], 'surrogate_gaussian_cutoff': kcut, 'z_ic': z_ic}
    rsds = [True, False] if want_rsd else [False]
    tabs = _templates(k_binc, z, cfg, kth, p_m_lin, rsds, dict(nmax=8, ngauss=8))
    out = {'window': window, 'keff': keff, 'k_binc': k_binc, 'kcut': kcut}
    for rsd, tab in zip(rsds, tabs):
        out['pk_ij_zenbu_rsd' if rsd else 'pk_ij_zenbu'] = tab
    return out


def main(path2config, alt_simname=None, want_xi=False, engine='auto', device=None):
    """Write the window matrix ``zcv_dir/<sim>/window_<k tag>.npz`` (window,
    keff) and the ZA templates ``zcv_dir/<sim>/z<z>/zenbu_pk{rsd}_ij_lpt_<k
    tag>.npz`` (pk_ij_zenbu, k_binc, kcut) of RSD and real space (real space
    only when HOD_params' want_rsd is False), skipping the files that exist
    (zenbu_window.py:main). The k bins are power_params', or with want_xi
    nmesh / 2 linear bins to the Nyquist k. The templates of both spaces are
    built in one :func:`_templates` call; the window runs on `engine` and
    `device` (:func:`periodic_window_function`)."""
    config = load_config(path2config)
    zp, pp = config['zcv_params'], config['power_params']
    nmesh, kcut = zp['nmesh'], zp['kcut']
    sim_name = alt_simname or config['sim_params']['sim_name']
    z_this = config['sim_params']['z_mock']
    meta = get_meta(sim_name, redshift=z_this)
    Lbox = meta['BoxSize']
    if want_xi:
        k_hMpc_max, logk, n_k_bins, n_mu_bins = np.pi * nmesh / Lbox, False, nmesh // 2, 1
    else:
        k_hMpc_max, logk = pp['k_hMpc_max'], pp['logk']
        n_k_bins, n_mu_bins = pp['nbins_k'], pp['nbins_mu']
    save_dir, save_z_dir = sim_dirs(zp['zcv_dir'], sim_name, z_this)
    os.makedirs(save_z_dir, exist_ok=True)
    k_bins, _ = get_k_mu_edges(Lbox, k_hMpc_max, n_k_bins, n_mu_bins, logk)
    k_binc = 0.5 * (k_bins[1:] + k_bins[:-1])
    tag = k_tag(Lbox, nmesh, k_hMpc_max, n_k_bins, n_mu_bins, logk)

    window_fn = save_dir / f'window_{tag}.npz'
    if not os.path.exists(window_fn):
        window, keff = periodic_window_function(nmesh, Lbox, k_bins, k_binc, k2weight=True,
                                                engine=engine, device=device)
        np.savez(window_fn, window=window, keff=keff)
        print('Saved window function')

    rsds = [True, False] if config['HOD_params'].get('want_rsd', True) else [False]
    fns = {rsd: save_z_dir / f'zenbu_pk{"_rsd" if rsd else ""}_ij_lpt_{tag}.npz' for rsd in rsds}
    todo = [rsd for rsd in rsds if not os.path.exists(fns[rsd])]
    if not todo:
        return
    kth = np.asarray(meta['CLASS_power_spectrum']['k (h/Mpc)'])
    pk_th = np.asarray(meta['CLASS_power_spectrum']['P (Mpc/h)^3'])
    z_ic = meta['InitialRedshift']
    p_m_lin = (meta['GrowthTable'][z_ic] / meta['GrowthTable'][1.0]) ** 2 * pk_th
    cfg = {'sim_name': sim_name, 'surrogate_gaussian_cutoff': kcut, 'z_ic': z_ic}
    tabs = _templates(k_binc, z_this, cfg, kth, p_m_lin, todo, dict(nmax=8, ngauss=8))
    for rsd, tab in zip(todo, tabs):
        np.savez(fns[rsd], pk_ij_zenbu=tab, k_binc=k_binc, kcut=kcut)
        print('Saved ZeNBu templates', fns[rsd])


def meshgrid(x, y, z):
    """A 3-D mesh of the shape (y.size, x.size, z.size) with xx[i, j, k] =
    x[i], yy[i, j, k] = y[j], zz[i, j, k] = z[k] (zenbu_window.py:meshgrid,
    the reference's quirk kept; callers pass axes of equal length)."""
    shape = (y.size, x.size, z.size)
    xx = np.empty(shape, dtype=x.dtype)
    yy = np.empty(shape, dtype=y.dtype)
    zz = np.empty(shape, dtype=z.dtype)
    xx[:] = x[: y.size, None, None]
    yy[:] = y[None, : x.size, None]
    zz[:] = z[None, None, :]
    return xx, yy, zz


def _cli(argv=None):
    """The command line of zenbu_window.py:_cli, with --device."""
    import argparse

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--path2config', help='Path to the config file (JSON)',
                        default=DEFAULT_CONFIG)
    parser.add_argument('--alt_simname', help='Alternative simulation name')
    parser.add_argument('--want_xi', action='store_true',
                        help='Set up parameters for Xi computation')
    parser.add_argument('--device', help='torch device of the window (default: the card)')
    return main(**vars(parser.parse_args(argv)))


if __name__ == '__main__':
    _cli()
