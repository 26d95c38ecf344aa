r"""The control-variate reductions, ZCV and LCV, at the k level and at the
field level (the counterpart of abacusutils_tpu/models/zcv/tools_cv.py).

Bias-monomial template combination, the Kaiser forms of LCV, Gaussian
multipole covariance couplings, the least-squares bias fits and the four
flows: beta = cov(CV, tr) / var(CV) with tanh damping at k0 (default
0.618) / dk (0.167), beta = 1 below beta1_k (0.05), Savitzky-Golay
smoothing (window 21), and P_cv = P_tt - beta (P_CV - theory).

``run_zcv`` and ``run_lcv`` reduce binned spectra: numpy and scipy on the
host, as in the JAX package; they take the window, keff and templates as
arrays (the ``.npz`` files of ``zcv_dir`` / ``lcv_dir`` otherwise).
``run_zcv_field`` and ``run_lcv_field`` reduce 3-D power: the JAX package
reads each cube Re(F_i F_j*) from a file; here each is built on the
fields' device from the Fourier fields in memory (:func:`field_cube`),
projected to poles by K3 (``ops/power.py:project_3d_to_poles``) and
dropped, and the model cubes are accumulated in float64 in the JAX
package's order. The reduced 3-D power is returned in a dict the caller
passes (`out`) instead of an ASDF file. Box size, CLASS P(k) and growth
come from the package's metadata registry (``cosmo.py``).
"""

import warnings
from pathlib import Path

import numpy as np
import torch
from scipy.interpolate import interp1d
from scipy.optimize import minimize
from scipy.signal import savgol_filter

from ...ops.grid import _f32
from ...ops.power import (
    expand_poles_to_3d,
    get_k_mu_edges,
    get_smoothing,
    project_3d_to_poles,
)
from .cosmo import get_meta, get_meta_cfg, growth_from_meta

__all__ = [
    'ZCV_FIELDS', 'combine_spectra', 'combine_cross_spectra', 'combine_kaiser_spectra',
    'combine_cross_kaiser_spectra', 'get_poles', 'multipole_cov', 'measure_2pt_bias',
    'measure_2pt_bias_lcv', 'read_power_dict', 'run_zcv', 'run_zcv_field', 'run_lcv',
    'run_lcv_field', 'field_cube', 'combine_field_spectra_k3D',
    'combine_field_cross_spectra_k3D', 'combine_field_spectra_k3D_lcv',
]

ZCV_FIELDS = np.array(['1cb', 'delta', 'delta2', 'tidal2', 'nabla2'])


# ---------------------------------------------------------------------------
# template combination
# ---------------------------------------------------------------------------


def _bias_monomials(bias_params):
    bias_params = np.hstack([bias_params, np.zeros(5 - len(bias_params))])
    b1, b2, bs, bk2, sn = bias_params
    return (
        np.array(
            [
                1, 2 * b1, b1**2, b2, b1 * b2, 0.25 * b2**2, 2 * bs, 2 * b1 * bs,
                b2 * bs, bs**2, 2 * bk2, 2 * bk2 * b1, bk2 * b2, 2 * bk2 * bs,
            ]
        ),
        sn,
    )


def combine_spectra(k, spectra, bias_params, rsd=False, numerical_nabla=False):
    """ZCV model auto-spectrum from the 15 templates + bias monomials."""
    monos, sn = _bias_monomials(bias_params)
    if rsd:
        pkvec = np.zeros((14, spectra.shape[1], spectra.shape[2]))
        pkvec[:10, ...] = spectra[:10, ...]
        pk = np.stack(
            [
                np.sum(monos[:, None] * pkvec[:, ell, :], axis=0)
                for ell in range(spectra.shape[1])
            ]
        )
    else:
        pkvec = np.zeros((14, spectra.shape[1]))
        if numerical_nabla:
            pkvec[...] = spectra[:14]
        else:
            pkvec[:10, ...] = spectra[:10]
            # nabla^2 terms approximated as -k^2 <1,X>
            nabla_idx = [0, 1, 3, 6]
            pkvec[10:, ...] = -(k[None, :] ** 2) * pkvec[nabla_idx, ...]
        pk = np.einsum('b,bk->k', monos, pkvec) + sn
    return pk


def combine_cross_spectra(k, spectra, bias_params, rsd=False):
    """ZCV model-tracer cross spectrum (no shot noise)."""
    bias_params = np.hstack([bias_params, np.zeros(5 - len(bias_params))])
    b1, b2, bs, bk, sn = bias_params
    monos = np.array([1, b1, 0.5 * b2, bs, bk])
    if rsd:
        pk = np.stack(
            [
                np.sum(monos[:, None] * spectra[:5, ell, :], axis=0)
                for ell in range(spectra.shape[1])
            ]
        )
    else:
        pk = np.sum(monos[:, None] * spectra[:5, :], axis=0)
    return pk


def _reshape_feff(f_eff, k, ref_array):
    """Broadcast an f_eff(k) vector against a spectra array whose k-axis can
    be at different positions depending on rsd/field layout."""
    ref = np.asarray(ref_array)
    shape = [1] * ref.ndim
    kaxis = next(i for i, s in enumerate(ref.shape) if s == len(k))
    shape[kaxis] = len(k)
    return np.asarray(f_eff).reshape(shape)


def combine_cross_kaiser_spectra(k, spectra_dict, D, bias, f_growth, rec_algo, R, rsd=False):
    """LCV tracer-model cross under the Kaiser approximation."""
    key = 'P_ell' if rsd else 'P_kmu'
    if rec_algo == 'recsym':
        f_eff = f_growth
    elif rec_algo == 'reciso':
        assert R is not None
        S = np.exp(-(k**2) * R**2 / 2.0)
        f_eff = _reshape_feff(f_growth * (1.0 - S), k, spectra_dict[f'{key}_deltamu2_tr'])
    else:
        raise ValueError(rec_algo)
    return D * (
        bias * spectra_dict[f'{key}_delta_tr'] + f_eff * spectra_dict[f'{key}_deltamu2_tr']
    )


def combine_kaiser_spectra(k, spectra_dict, D, bias, f_growth, rec_algo, R, rsd=False):
    """LCV model-model auto under the Kaiser approximation."""
    key = 'P_ell' if rsd else 'P_kmu'
    if rec_algo == 'recsym':
        f_eff = f_growth
    elif rec_algo == 'reciso':
        assert R is not None
        S = np.exp(-(k**2) * R**2 / 2.0)
        f_eff = _reshape_feff(f_growth * (1.0 - S), k, spectra_dict[f'{key}_deltamu2_delta'])
    else:
        raise ValueError(rec_algo)
    return D**2 * (
        2.0 * bias * f_eff * spectra_dict[f'{key}_deltamu2_delta']
        + f_eff**2 * spectra_dict[f'{key}_deltamu2_deltamu2']
        + bias**2 * spectra_dict[f'{key}_delta_delta']
    )


# Kaiser P_ell / (b^2 D^2 P_lin) as polynomials in beta = f/b:
# {ell: (c0, c1*beta, c2*beta^2)}
_KAISER_POLE_COEFFS = {
    0: (1.0, 2.0 / 3.0, 1.0 / 5.0),
    2: (0.0, 4.0 / 3.0, 4.0 / 7.0),
    4: (0.0, 0.0, 8.0 / 35.0),
}


def get_poles(k, pk, D, bias, f_growth, poles=(0, 2, 4)):
    """Linear Kaiser multipoles of a linear power spectrum."""
    beta = f_growth / bias
    p_ell = np.zeros((len(poles), len(k)))
    for i, ell in enumerate(poles):
        c0, c1, c2 = _KAISER_POLE_COEFFS[ell]
        p_ell[i] = (c0 + c1 * beta + c2 * beta**2) * pk
    return k, p_ell * (bias**2 * D**2)


def multipole_cov(pell, ell):
    """Gaussian covariance couplings between multipoles."""
    if ell == 0:
        return 2 * pell[0] ** 2 + 2 / 5 * pell[1] ** 2 + 2 / 9 * pell[2] ** 2
    if ell == 2:
        return (
            2 / 5 * pell[0] ** 2 + 6 / 35 * pell[1] ** 2 + 3578 / 45045 * pell[2] ** 2
            + 8 / 35 * pell[0] * pell[1] + 8 / 35 * pell[0] * pell[2]
            + 48 / 385 * pell[1] * pell[2]
        )
    if ell == 4:
        return (
            2 / 9 * pell[0] ** 2 + 3578 / 45045 * pell[1] ** 2
            + 1058 / 17017 * pell[2] ** 2 + 80 / 693 * pell[0] * pell[1]
            + 72 / 1001 * pell[0] * pell[2] + 80 / 1001 * pell[1] * pell[2]
        )
    raise ValueError(ell)


# ---------------------------------------------------------------------------
# bias fitting
# ---------------------------------------------------------------------------


def measure_2pt_bias(k, pk_ij, pk_tt, kmax, keynames, kmin=0.0, rsd=False):
    """Least-squares fit of (b1, b2, bs, bn, sn) to the real-space tracer
    spectrum using the field templates.

    The data are normalized to unit scale before the minimization and the
    fitted shot-noise is scaled back: the loss is scale-invariant in the
    spectra but `sn` is in data units, so the raw problem (reference
    tools_cv.py:277-310) conditions BFGS differently in physical vs
    volume-normalized units — the k-level and 3D-field-level flows feed
    the SAME monopoles in different units and must land on the same
    minimum."""
    kidx_max = k.searchsorted(kmax)
    kidx_min = max(k.searchsorted(kmin), 1)
    kcut = k[kidx_min:kidx_max]
    scale = np.mean(np.abs(pk_tt[kidx_min:kidx_max]))
    if not (np.isfinite(scale) and scale > 0):
        scale = 1.0
    pk_tt_kcut = pk_tt[kidx_min:kidx_max] / scale
    pk_ij_kcut = pk_ij[:, kidx_min:kidx_max] / scale

    bvec0 = np.zeros(len(keynames))

    def loss(bvec):
        model = combine_spectra(
            kcut,
            pk_ij_kcut,
            np.hstack([bvec[:-1], np.zeros(5 - len(bvec)), bvec[-1]]),
            rsd=rsd,
        )
        return np.sum((pk_tt_kcut - model) ** 2 / (2 * pk_tt_kcut**2))

    fit = minimize(loss, bvec0)
    fit['x'][-1] *= scale  # sn back to data units
    return fit


def measure_2pt_bias_lcv(
    k, power_dict, power_rsd_tr_dict, D, f_growth, kmax, rsd, rec_algo, R, ellmax=2, kmin=0.0,
):
    """LCV linear-bias fit under the Kaiser approximation."""
    pk_tt = power_rsd_tr_dict['P_ell_tr_tr'][:ellmax, :]
    kidx_max = k.searchsorted(kmax)
    kidx_min = k.searchsorted(kmin)
    kcut = k[kidx_min:kidx_max]
    pk_tt_kcut = pk_tt[:ellmax, kidx_min:kidx_max]

    power_lin_dict = dict(power_dict)
    for key in power_lin_dict:
        if 'P_ell' in key:
            power_lin_dict[key] = power_lin_dict[key][:, kidx_min:kidx_max]

    def loss(bias):
        model = combine_kaiser_spectra(
            kcut, power_lin_dict, D, bias, f_growth, rec_algo, R, rsd=rsd
        )[:ellmax, :]
        return np.sum((pk_tt_kcut - model) ** 2 / (2 * pk_tt_kcut**2))

    return minimize(loss, 1.0)


def read_power_dict(power_tr_dict, power_ij_dict, want_rsd, keynames, poles):
    """Marshal the spectra dicts into zenbu-shaped arrays."""
    k = np.asarray(power_tr_dict['k_binc']).flatten()
    mu = np.zeros((len(k), 1))
    nell = len(poles)
    if want_rsd:
        pk_tt = np.zeros((1, nell, len(k)))
        pk_ij_zz = np.zeros((15, nell, len(k)))
        pk_ij_zt = np.zeros((5, nell, len(k)))
        pk_tt[0] = np.asarray(power_tr_dict['P_ell_tr_tr']).reshape(nell, len(k))
        nmodes = np.asarray(power_tr_dict['N_ell_tr_tr']).flatten()
    else:
        pk_tt = np.zeros((1, len(k), 1))
        pk_ij_zz = np.zeros((15, len(k), 1))
        pk_ij_zt = np.zeros((5, len(k), 1))
        pk_tt[0] = np.asarray(power_tr_dict['P_kmu_tr_tr']).reshape(len(k), 1)
        nmodes = np.asarray(power_tr_dict['N_kmu_tr_tr']).flatten()

    count = 0
    for i in range(len(keynames)):
        if want_rsd:
            pk_ij_zt[i] = np.asarray(power_tr_dict[f'P_ell_{keynames[i]}_tr']).reshape(
                nell, len(k)
            )
        else:
            pk_ij_zt[i] = np.asarray(power_tr_dict[f'P_kmu_{keynames[i]}_tr']).reshape(
                len(k), 1
            )
        for j in range(len(keynames)):
            if i < j:
                continue
            key = f'{keynames[i]}_{keynames[j]}'
            if want_rsd:
                pk_ij_zz[count] = np.asarray(power_ij_dict[f'P_ell_{key}']).reshape(
                    nell, len(k)
                )
            else:
                pk_ij_zz[count] = np.asarray(power_ij_dict[f'P_kmu_{key}']).reshape(
                    len(k), 1
                )
            count += 1

    return k, mu, pk_tt, pk_ij_zz, pk_ij_zt, nmodes



# ---------------------------------------------------------------------------


def _beta_smooth_damp(beta, k_binc, k0, dk_cv, beta1_k, sg_window):
    beta_damp = 0.5 * (1 - np.tanh((k_binc - k0) / dk_cv)) * beta
    beta_damp = np.atleast_2d(beta_damp)
    beta_damp[beta_damp != beta_damp] = 0
    beta_damp[:, : k_binc.searchsorted(beta1_k)] = 1
    beta_smooth = np.zeros_like(beta_damp)
    for i in range(beta_smooth.shape[0]):
        try:
            beta_smooth[i, :] = savgol_filter(beta_damp.T[:, i], sg_window, 3)
        except ValueError:
            warnings.warn('This message should only appear when doing a smoke test.')
    return beta_smooth


class _FlowSetup:
    """Everything the four flows read off the config: the zcv or lcv
    section (`kind`) and the power section, the smoothing and damping
    knobs, the box size (`lbox`, else the metadata's), the k binning (with
    `field_level`, the linear nmesh / 2 bins to the Nyquist k that pk_to_xi
    needs, whatever the config says) and the presaved-file directories
    (tools_cv.py:_FlowSetup). meta: the cosmo.get_meta dict at z_mock (None:
    the registry's, read for LCV)."""

    def __init__(self, config, kind='zcv', field_level=False, lbox=None, meta=None):
        cv = config[f'{kind}_params']
        pp = config['power_params']
        self.config = config
        self.kind = kind
        self.sim_name = config['sim_params']['sim_name']
        self.z_this = config['sim_params']['z_mock']
        self.nmesh = cv['nmesh']
        self.kcut = cv['kcut']
        self.kmax_fit = cv.get('kmax_fit', 0.15 if kind == 'zcv' else 0.08)
        self.want_rsd = config['HOD_params']['want_rsd']
        self.rsd_str = '_rsd' if self.want_rsd else ''
        if self.nmesh != pp['nmesh']:
            raise ValueError('zcv/lcv nmesh must equal power_params nmesh')
        self.smoothing = dict(
            sg_window=cv.get('sg_window', 21),
            k0=cv.get('k0_window', 0.618),
            dk_cv=cv.get('dk_window', 0.167),
            beta1_k=cv.get('beta1_k', 0.05),
        )
        self.save_dir = Path(cv.get(f'{kind}_dir', '.')) / self.sim_name
        self.save_z_dir = self.save_dir / f'z{self.z_this:.3f}'
        if kind == 'lcv' and meta is None:
            meta = get_meta(self.sim_name, redshift=self.z_this)
        self.meta = meta
        if lbox is None:
            lbox = (get_meta_cfg(self.sim_name, self.z_this)['lbox'] if meta is None
                    else meta['BoxSize'])
        self.lbox = lbox

        self.poles = pp['poles']
        if field_level:
            # the 3D-field flows feed pk_to_xi downstream, which requires
            # the full linear binning; override anything else
            kmax_native = np.pi * self.nmesh / self.lbox
            as_given = (
                np.isclose(pp.get('k_hMpc_max', kmax_native), kmax_native)
                and not pp.get('logk', False)
                and pp.get('nbins_k', self.nmesh // 2) == self.nmesh // 2
                and pp.get('nbins_mu', 1) == 1
            )
            if not as_given:
                warnings.warn('Setting the parameters correctly for Xi computation')
            self.k_hMpc_max, self.logk = kmax_native, False
            self.n_k_bins, self.n_mu_bins = self.nmesh // 2, 1
        else:
            self.k_hMpc_max, self.logk = pp['k_hMpc_max'], pp['logk']
            self.n_k_bins, self.n_mu_bins = pp['nbins_k'], pp['nbins_mu']
        self.k_bins, self.mu_bins = get_k_mu_edges(
            self.lbox, self.k_hMpc_max, self.n_k_bins, self.n_mu_bins, self.logk
        )
        self.k_binc = 0.5 * (self.k_bins[1:] + self.k_bins[:-1])
        self.dk = (
            self.k_bins[1] - self.k_bins[0]
            if not self.logk
            else np.log(self.k_bins[1] / self.k_bins[0])
        )

    def smooth_beta(self, beta):
        return _beta_smooth_damp(beta, self.k_binc, **self.smoothing)

    def presaved(self, stem, in_z_dir=True):
        """Path of a presaved npz keyed by nmesh (+ dk when the binning is
        not the native nmesh//2 linear one)."""
        base = self.save_z_dir if in_z_dir else self.save_dir
        tag = f'nmesh{self.nmesh:d}'
        if self.n_k_bins != self.nmesh // 2:
            tag += f'_dk{self.dk:.3f}'
        return base / f'{stem}_{tag}.npz'

    def load_window(self, window=None, keff=None):
        """The window matrix: `window` and `keff` when given, else the
        presaved npz; raises when keff does not match the k binning."""
        if window is None:
            data = np.load(self.presaved('window', in_z_dir=False))
            window, keff = data['window'], data['keff']
        if len(keff) != len(self.k_binc) or (
            abs(keff[-1] - self.k_binc[-1]) / self.k_binc[-1] >= 0.1
        ):
            raise ValueError(f'window file does not match the k binning: {keff}')
        return window

    def apply_window(self, template_poles, window=None, keff=None):
        """Mode-couple theory multipoles through the window matrix.

        Deliberate deviation (PARITY.md): the window rows are output
        (ell, k-bin) pairs — `window @ theory` is the binned-estimator
        expectation (pinned against the defining per-mode sum AND against
        measured ZA realization multipoles in test_zenbu_native.py). The
        reference applies the TRANSPOSE of its own matrix
        (tools_cv.py:704-705), which mis-weights the (2l+1) prefactors on
        the ell-mixing terms (its predicted l=0 -> l=4 leakage comes out
        ~9x too small)."""
        window = self.load_window(window, keff)
        stacked = np.dot(window, np.hstack(template_poles))
        return stacked.reshape(len(self.poles), -1)

    def disconnected_covs(self, **spectra):
        """Gaussian disconnected (co)variances per pole for each named
        P_ell stack; real space falls back to the diagonal 2P^2."""
        if self.want_rsd:
            return {
                name: np.stack([multipole_cov(pk, ell) for ell in self.poles])
                for name, pk in spectra.items()
            }
        return {name: 2.0 * pk**2 for name, pk in spectra.items()}

    def beta_rho(self, cov_xt, var_xx, var_tt):
        """Damped+smoothed control-variate coefficient and the
        cross-correlation coefficient rho (NaNs zeroed)."""
        with np.errstate(divide='ignore', invalid='ignore'):
            beta = cov_xt / var_xx
            rho = np.atleast_2d(cov_xt / np.sqrt(var_xx * var_tt))
        rho[rho != rho] = 0
        # snap near-zero correlations exactly to 0 like the reference
        # (tools_cv.py:699) so rho outputs match bin-for-bin
        rho[np.isclose(rho, 0.0)] = 0.0
        return self.smooth_beta(beta), rho


def _zcv_fields(config):
    keynames = np.array(config['zcv_params']['fields'])
    if not (ZCV_FIELDS[: len(keynames)] == keynames).all():
        raise ValueError('Requested keynames should follow the standard order')
    return keynames


def _fit_zcv_bias(k_binc, pk_ij_zz, pk_tt, kmax, keynames):
    """Least-squares quadratic-bias fit; returns the padded 6-vector
    [1, b1, b2, bs, bn, sn] the monomial combiners consume."""
    fit = measure_2pt_bias(k_binc, pk_ij_zz, pk_tt, kmax, keynames, rsd=False)
    fitted = fit['x']
    return np.hstack([1.0, fitted[:-1], np.zeros(5 - len(fitted)), fitted[-1]])


def run_zcv(power_rsd_tr_dict, power_rsd_ij_dict, power_tr_dict, power_ij_dict, config,
            window=None, keff=None, pk_ij_zenbu=None, lbox=None):
    """Apply ZCV reduction to measured P_ell(k) (tools_cv.py:run_zcv).

    window, keff: the window matrix and its effective k
    (zenbu_window.window_and_templates); pk_ij_zenbu: the templates of the
    requested space (RSD when config's want_rsd, else real space). Each
    that is None is loaded from its npz under zcv_dir, as the JAX package
    does. lbox: the box size (None: the metadata registry's)."""
    s = _FlowSetup(config, lbox=lbox)
    keynames = _zcv_fields(config)

    if not s.want_rsd:
        power_tr_dict, power_ij_dict = power_rsd_tr_dict, power_rsd_ij_dict

    # real-space monopoles drive the bias fit; requested-space is reduced
    k, _, pk_tt_real, pk_ij_zz_real, _, _ = read_power_dict(
        power_tr_dict, power_ij_dict, want_rsd=False, keynames=keynames,
        poles=s.poles,
    )
    k, _, pk_tt_poles, pk_ij_zz_poles, pk_ij_zt_poles, nmodes = read_power_dict(
        power_rsd_tr_dict, power_rsd_ij_dict, want_rsd=s.want_rsd,
        keynames=keynames, poles=s.poles,
    )
    assert np.isclose(k, s.k_binc).all()

    bias_vec = _fit_zcv_bias(
        k, pk_ij_zz_real[:, :, 0], pk_tt_real[0, :, 0], s.kmax_fit, keynames
    )

    if s.want_rsd:
        pk_tt_input = pk_tt_poles[0, ...]
        pk_ij_zz_input, pk_ij_zt_input = pk_ij_zz_poles, pk_ij_zt_poles
    else:
        pk_tt_input = pk_tt_poles[0, :, 0]
        pk_ij_zz_input = pk_ij_zz_poles[:, :, 0]
        pk_ij_zt_input = pk_ij_zt_poles[:, :, 0]

    if pk_ij_zenbu is None:
        zenbu_fn = s.presaved(f'zenbu_pk{s.rsd_str}_ij_lpt')
        data = np.load(zenbu_fn)
        pk_ij_zenbu = data['pk_ij_zenbu']
        assert np.allclose(data['k_binc'], s.k_binc), f'Mismatching file: {zenbu_fn}'
        assert np.isclose(data['kcut'], s.kcut), f'Mismatching file: {zenbu_fn}'

    pk_zz = combine_spectra(s.k_binc, pk_ij_zz_input, bias_vec[1:], rsd=s.want_rsd)
    pk_zenbu = combine_spectra(s.k_binc, pk_ij_zenbu, bias_vec[1:], rsd=s.want_rsd)
    pk_zn = combine_cross_spectra(s.k_binc, pk_ij_zt_input, bias_vec[1:], rsd=s.want_rsd)

    shotnoise = (pk_tt_input - 2.0 * pk_zn + pk_zz)[0]
    pk_nn_nosn = pk_tt_input.copy()
    pk_nn_nosn[0] -= shotnoise

    covs = s.disconnected_covs(
        zn=pk_zn, zz=pk_zz, nn=pk_tt_input, nn_nosn=pk_nn_nosn
    )
    with np.errstate(divide='ignore', invalid='ignore'):
        r_zt_sn_lim = covs['nn_nosn'] / np.sqrt(covs['nn'] * covs['nn_nosn'])
    beta_smooth, r_zt = s.beta_rho(covs['zn'], covs['zz'], covs['nn'])

    if s.want_rsd:
        pk_zenbu = s.apply_window(pk_zenbu, window, keff)
    else:
        s.load_window(window, keff)  # keep the reference's window check

    pk_nn_betasmooth = pk_tt_input - beta_smooth * (pk_zz - pk_zenbu)

    return {
        'k_binc': s.k_binc,
        'poles': s.poles,
        'rho_tr_ZD': r_zt,
        'rho_tr_ZD_sn_lim': r_zt_sn_lim,
        'Pk_ZD_ZD_ell': pk_zz,
        'Pk_tr_ZD_ell': pk_zn,
        'Pk_tr_tr_ell': pk_tt_input,
        'Nk_tr_tr_ell': nmodes,
        'Pk_tr_tr_ell_zcv': pk_nn_betasmooth,
        'Pk_ZD_ZD_ell_ZeNBu': pk_zenbu,
        'bias': bias_vec[1:],
    }


# ---------------------------------------------------------------------------
# field-level ZCV: 3-D power built from Fourier fields in memory
# ---------------------------------------------------------------------------


def field_cube(field_a, field_b, scale=1.0):
    """The 3-D power Re(F_a F_b*) on the rfft mesh as float32, times the
    float32 of `scale` (when not 1): the cube the JAX package writes for a
    field pair or a field and the tracer (advect_fields.py:main,
    tracer_power.py:get_tracer_power, save_3D_power)."""
    cube = (field_a * field_b.conj()).real.contiguous()
    return cube.mul_(_f32(scale)) if scale != 1.0 else cube


def _f64_scaled(cube, s):
    """float64(cube) * s, one rounding a mode, as numpy multiplies a float32
    array by a float64 scalar or array."""
    out = cube.to(torch.float64)
    return out.mul_(s if isinstance(s, float) else s.to(torch.float64))


def _field_pairs(n):
    return [(i, j) for i in range(n) for j in range(i + 1)]


def combine_field_spectra_k3D(bias, field_ffts, keynames, field_D):
    """ZCV model-model 3-D power from the field pairs
    (tools_cv.py:combine_field_spectra_k3D): sum over i >= j of bias_i
    bias_j (x 2 off the diagonal) times the pair's cube (:func:`field_cube`
    scaled by field_D[i] field_D[j]), bias[2] halved, accumulated in float64
    in the JAX package's order. Each cube is made, added and dropped."""
    bias = np.array(bias, dtype=np.float64)
    if len(bias) >= 3:
        bias[2] *= 0.5
    power = None
    for i, j in _field_pairs(len(keynames)):
        cube = field_cube(field_ffts[keynames[i]], field_ffts[keynames[j]],
                          field_D[i] * field_D[j])
        fac = float(bias[i] * bias[j] * (1.0 if i == j else 2.0))
        term = _f64_scaled(cube, fac)
        del cube
        power = term if power is None else power.add_(term)
    return power


def combine_field_cross_spectra_k3D(bias, field_ffts, tr_fft, keynames, field_D):
    """ZCV model-tracer 3-D cross power (tools_cv.py:
    combine_field_cross_spectra_k3D): sum of bias_i times the cube of field
    i and the tracer scaled by field_D[i], bias[2] halved, in float64."""
    bias = np.array(bias, dtype=np.float64)
    if len(bias) >= 3:
        bias[2] *= 0.5
    power = None
    for i, kn in enumerate(keynames):
        term = _f64_scaled(field_cube(field_ffts[kn], tr_fft, field_D[i]), float(bias[i]))
        power = term if power is None else power.add_(term)
    return power


def _project_monopole(s, p3d):
    """3D power -> normalized monopole bandpowers."""
    return project_3d_to_poles(s.k_bins, p3d, s.lbox, poles=[0])[0].flatten() / s.lbox**3


def _field_reduce(s, cubes, template_poles, template_k):
    """Shared 3D-field CV tail for the zcv/lcv field flows
    (tools_cv.py:_field_reduce): project the measured/model/cross 3D
    spectra to poles, fit the damped beta per pole, expand beta and the
    theory template back to 3D, subtract, and project the reduced result.

    `cubes` is a dict {'nn', 'model', 'cross'} of 3D spectra (tensors) that
    this function consumes (pops), so each is freed once it is used.

    Returns (rho, model_proj, cross_proj, nn_proj, reduced_poles, nmodes,
    reduced 3-D power as a float64 tensor)."""
    def proj(p3d):
        out = project_3d_to_poles(s.k_bins, p3d, s.lbox, s.poles)[0]
        return out.reshape(len(s.poles), len(s.k_binc)) / s.lbox**3

    pk_nn3d = cubes.pop('nn')
    pk_model3d = cubes.pop('model')
    cross_proj = proj(cubes.pop('cross'))
    nn_proj = proj(pk_nn3d)
    model_proj = proj(pk_model3d)
    device = pk_nn3d.device

    # theory template off the model field (requires uniform template bins)
    assert np.isclose(np.min(np.diff(template_k)), np.max(np.diff(template_k)))
    template = expand_poles_to_3d(template_k, template_poles, s.nmesh, s.lbox,
                                  np.asarray(s.poles), device=device) / _f32(s.lbox**3)
    pk_model3d = pk_model3d - template
    del template

    covs = s.disconnected_covs(xt=cross_proj, xx=model_proj, tt=nn_proj)
    beta_smooth, rho = s.beta_rho(covs['xt'], covs['xx'], covs['tt'])
    beta3d = expand_poles_to_3d(s.k_binc, beta_smooth, s.nmesh, s.lbox, np.array([0]),
                                device=device)
    pk_nn3d = pk_nn3d - beta3d * pk_model3d
    del beta3d, pk_model3d

    reduced, nmodes = project_3d_to_poles(s.k_bins, pk_nn3d, s.lbox, s.poles)
    reduced = reduced.reshape(len(s.poles), len(s.k_binc)) / s.lbox**3
    nmodes = np.asarray(nmodes).flatten()[: len(s.k_binc)]
    return rho, model_proj, cross_proj, nn_proj, reduced, nmodes, pk_nn3d


def _growth(s, want_rsd=True):
    meta = s.meta if s.meta is not None else get_meta(s.sim_name, redshift=s.z_this)
    return growth_from_meta(meta, s.z_this, want_rsd)


def run_zcv_field(tracer_ffts, field_ffts, config, pk_ij_zenbu=None, meta=None, out=None):
    """Apply ZCV at the 3D-field level (tools_cv.py:run_zcv_field), on
    Fourier fields in memory.

    tracer_ffts: {want_rsd: the tracer's rfft mesh} for True (RSD) and False
    (real space), as tracer_power.get_tracer_power(save_3D_power=True)
    returns them; field_ffts: {want_rsd: {field: rfft mesh}}, the advected
    fields of precompute.ZCVProducts; pk_ij_zenbu: the RSD templates at the
    flow's k bins (None: the npz under zcv_dir); meta: the cosmo.get_meta
    dict at z_mock, which gives the box size (None: the registry's). Every
    cube is built on the fields' device: the real-space tracer and pair
    cubes are projected to their monopoles for the bias fit and dropped one
    by one, and the RSD model and cross cubes are accumulated in float64.
    out: a dict that receives the reduced 3-D power under 'P_k3D_tr_tr_zcv'
    (the JAX package writes it to power_rsd_ZCV_tr_nmesh*.asdf)."""
    s = _FlowSetup(config, 'zcv', field_level=True, meta=meta)
    keynames = _zcv_fields(config)
    assert s.want_rsd, 'Currently only rsd version implemented'
    D, _ = _growth(s)
    field_D = [1, D, D**2, D**2, D]  # advect_fields.py:main's field_D

    # bias fit from real-space monopoles
    pk_nn_mono = _project_monopole(s, field_cube(tracer_ffts[False], tracer_ffts[False]))
    pk_ij_mono = np.zeros((15, len(pk_nn_mono)))
    real = field_ffts[False]
    for counter, (i, j) in enumerate(_field_pairs(len(keynames))):
        cube = field_cube(real[keynames[i]], real[keynames[j]], field_D[i] * field_D[j])
        pk_ij_mono[counter] = _project_monopole(s, cube)
        del cube
    bias_vec = _fit_zcv_bias(s.k_binc, pk_ij_mono, pk_nn_mono, s.kmax_fit, keynames)

    if pk_ij_zenbu is None:
        zenbu_fn = s.presaved(f'zenbu_pk{s.rsd_str}_ij_lpt')
        data = np.load(zenbu_fn)
        pk_ij_zenbu = data['pk_ij_zenbu']
        assert np.allclose(data['k_binc'], s.k_binc), f'Mismatching file: {zenbu_fn}'
        assert np.isclose(data['kcut'], s.kcut)
    elif np.shape(pk_ij_zenbu)[-1] != len(s.k_binc):
        raise ValueError(f'the templates have {np.shape(pk_ij_zenbu)[-1]} k bins, the field '
                         f'flow {len(s.k_binc)}')
    pk_zenbu = combine_spectra(s.k_binc, pk_ij_zenbu, bias_vec[1:], rsd=s.want_rsd)

    rsd, tr = field_ffts[True], tracer_ffts[True]
    cubes = dict(
        nn=field_cube(tr, tr),
        model=combine_field_spectra_k3D(bias_vec, rsd, keynames, field_D),
        cross=combine_field_cross_spectra_k3D(bias_vec, rsd, tr, keynames, field_D),
    )
    rho, zz_proj, zn_proj, nn_proj, reduced, nmodes, cube = _field_reduce(
        s, cubes, pk_zenbu, s.k_binc
    )
    if out is not None:
        out['P_k3D_tr_tr_zcv'] = cube
    del cube

    V = s.lbox**3
    return {
        'k_binc': s.k_binc,
        'poles': s.poles,
        'rho_tr_ZD': rho,
        'Pk_ZD_ZD_ell': zz_proj * V,
        'Pk_tr_ZD_ell': zn_proj * V,
        'Pk_tr_tr_ell': nn_proj * V,
        'Nk_tr_tr_ell': nmodes,
        'Pk_tr_tr_ell_zcv': reduced * V,
        'Pk_ZD_ZD_ell_ZeNBu': pk_zenbu.reshape(len(s.poles), len(s.k_binc)),
        'bias': bias_vec[1:],
    }


# ---------------------------------------------------------------------------
# LCV: the linear field as the control variate of a reconstructed catalog
# ---------------------------------------------------------------------------


def _lcv_recon(config):
    rec_algo = config['HOD_params']['rec_algo']
    R = None if rec_algo == 'recsym' else config['HOD_params']['smoothing']
    return rec_algo, R


def _lcv_linear_template(s, uniform_grid=False):
    """kcut-filtered linear theory P(k) at z_mock from the metadata CLASS
    table (+ GrowthTable scaling). With uniform_grid, resample to even k
    spacing (expand_poles_to_3d needs it) below the mesh's corner mode."""
    kth = np.asarray(s.meta['CLASS_power_spectrum']['k (h/Mpc)'])
    pk_z1 = np.asarray(s.meta['CLASS_power_spectrum']['P (Mpc/h)^3'])
    if uniform_grid:
        keep = kth < np.sqrt(3.0) * 1.2 * np.pi * s.nmesh / s.lbox
        kth, pk_z1 = kth[keep], pk_z1[keep]
        k_even = np.arange(kth.min(), kth.max(), np.min(np.diff(kth)))
        pk_z1 = np.interp(k_even, kth, pk_z1)
        kth = k_even
    z_ic = s.meta['InitialRedshift']
    D_ratio = s.meta['GrowthTable'][z_ic] / s.meta['GrowthTable'][1.0]
    return kth, D_ratio**2 * pk_z1 * np.exp(-((kth / s.kcut) ** 2))


def _rec_f_eff(rec_algo, R, f_growth, kth):
    """Effective growth rate: reciso removes the smoothed modes' RSD."""
    if rec_algo == 'reciso':
        return f_growth * (1.0 - np.exp(-(kth**2) * R**2 / 2.0))
    return f_growth


def _fit_lcv_bias(s, power_lin_dict, power_tr_dict, D, f_growth, rec_algo, R):
    fit = measure_2pt_bias_lcv(
        s.k_binc, power_lin_dict, power_tr_dict, D, f_growth, s.kmax_fit,
        s.want_rsd, rec_algo, R, ellmax=1,
    )
    return np.array(fit['x'])[0]


def run_lcv(power_rsd_tr_dict, power_lin_dict, config, window=None, keff=None, meta=None):
    """Apply LCV reduction to measured P_ell(k) (tools_cv.py:run_lcv).

    power_rsd_tr_dict: tracer_power.get_recon_power's spectra;
    power_lin_dict: the linear fields' (linear_fields.linear_fields,
    precompute.LCVProducts.pk_lin); window, keff: the window matrix at the
    config's k bins (None: the npz under lcv_dir); meta: the cosmo.get_meta
    dict at z_mock (None: the registry's)."""
    s = _FlowSetup(config, 'lcv', meta=meta)
    rec_algo, R = _lcv_recon(config)
    assert s.want_rsd, 'Real space not implemented'

    kth, p_m_lin = _lcv_linear_template(s)
    D, f_growth = _growth(s, s.want_rsd)

    bias = _fit_lcv_bias(s, power_lin_dict, power_rsd_tr_dict, D, f_growth, rec_algo, R)

    f_eff = _rec_f_eff(rec_algo, R, f_growth, kth)
    kth, p_m_lin_poles = get_poles(kth, p_m_lin, D, bias, f_eff, poles=s.poles)
    p_m_lin_input = np.array([
        interp1d(kth, p_m_lin_poles[i], fill_value='extrapolate')(s.k_binc)
        for i in range(len(s.poles))
    ])

    nell, nk = len(s.poles), len(s.k_binc)
    pk_ll_input = combine_kaiser_spectra(
        s.k_binc, power_lin_dict, D, bias, f_growth, rec_algo, R, rsd=s.want_rsd
    ).reshape(nell, nk)
    pk_tl_input = combine_cross_kaiser_spectra(
        s.k_binc, power_rsd_tr_dict, D, bias, f_growth, rec_algo, R, rsd=s.want_rsd,
    ).reshape(nell, nk)
    pk_tt_input = np.asarray(power_rsd_tr_dict['P_ell_tr_tr']).reshape(nell, nk)
    nmodes = np.asarray(power_rsd_tr_dict['N_ell_tr_tr']).flatten()

    shotnoise = (pk_tt_input - 2.0 * pk_tl_input + pk_ll_input)[0]
    pk_tt_nosn = pk_tt_input.copy()
    pk_tt_nosn[0] -= shotnoise

    covs = s.disconnected_covs(tl=pk_tl_input, ll=pk_ll_input, tt=pk_tt_input,
                               tt_nosn=pk_tt_nosn)
    with np.errstate(divide='ignore', invalid='ignore'):
        r_tl_sn_lim = covs['tt_nosn'] / np.sqrt(covs['tt'] * covs['tt_nosn'])
    beta_smooth, r_tl = s.beta_rho(covs['tl'], covs['ll'], covs['tt'])

    p_m_lin_windowed = s.apply_window(p_m_lin_input, window, keff)
    pk_tt_betasmooth = pk_tt_input - beta_smooth * (pk_ll_input - p_m_lin_windowed)

    return {
        'k_binc': s.k_binc,
        'poles': s.poles,
        'rho_tr_lf': r_tl,
        'rho_tr_lf_sn_lim': r_tl_sn_lim,
        'Pk_lf_lf_ell': pk_ll_input,
        'Pk_tr_lf_ell': pk_tl_input,
        'Pk_tr_tr_ell': pk_tt_input,
        'Nk_tr_tr_ell': nmodes,
        'Pk_tr_tr_ell_lcv': pk_tt_betasmooth,
        'Pk_lf_lf_ell_CLASS': p_m_lin_input,
        'bias': bias,
    }


def combine_field_spectra_k3D_lcv(bias, f_growth, D, lin_ffts, tr_fft, nmesh, Lbox, R,
                                  rec_algo):
    """LCV model auto/cross 3D spectra (tools_cv.py:
    combine_field_spectra_k3D_lcv) from the linear fields {'delta',
    'deltamu2'} and the tracer's Fourier field: (pk_tt, pk_ll, pk_lt), the
    tracer auto as float32 and the model auto and cross in float64, each
    term in the JAX package's order and precision."""
    if rec_algo == 'reciso':
        S = get_smoothing(nmesh, Lbox, R, device=tr_fft.device)
        f_eff = f_growth * (1.0 - S)
    else:
        f_eff = f_growth
    bias = float(bias)
    delta, deltamu2 = lin_ffts['delta'], lin_ffts['deltamu2']
    # 2 bias f_eff: a float64 scalar, or the float32 mesh f_eff times 2 bias
    # in float64, as numpy promotes them
    two_b_f = (2.0 * bias * f_eff if isinstance(f_eff, float)
               else f_eff.to(torch.float64).mul_(2.0 * bias))
    pk_tt = field_cube(tr_fft, tr_fft)
    # f_eff^2 and f_eff multiply their float32 cubes in float32
    pk_ll = _f64_scaled(field_cube(deltamu2, delta), two_b_f)
    pk_ll.add_(field_cube(deltamu2, deltamu2).mul_(f_eff**2))
    pk_ll.add_(_f64_scaled(field_cube(delta, delta), bias**2))
    pk_ll.mul_(D**2)
    pk_lt = _f64_scaled(field_cube(delta, tr_fft), bias)
    pk_lt.add_(field_cube(deltamu2, tr_fft).mul_(f_eff))
    pk_lt.mul_(D)
    return pk_tt, pk_ll, pk_lt


def run_lcv_field(tr_fft, lin_ffts, config, meta=None, out=None):
    """Apply LCV at the 3D-field level (tools_cv.py:run_lcv_field), on
    Fourier fields in memory.

    tr_fft: the reconstructed tracer's rfft mesh
    (tracer_power.get_recon_power(save_3D_power=True)); lin_ffts: the
    linear fields {'delta', 'deltamu2'} (precompute.LCVProducts.field_ffts);
    meta: the cosmo.get_meta dict at z_mock (None: the registry's). out: a
    dict that receives the reduced 3-D power under 'P_k3D_tr_tr_lcv' (the
    JAX package writes it to power_rsd_LCV_tr_{rec_algo}_nmesh*.asdf)."""
    s = _FlowSetup(config, 'lcv', field_level=True, meta=meta)
    rec_algo, R = _lcv_recon(config)
    keynames = ['delta', 'deltamu2']
    assert s.want_rsd, 'Real space not implemented'

    kth, p_m_lin = _lcv_linear_template(s, uniform_grid=True)
    D, f_growth = _growth(s, s.want_rsd)

    # bias fit from real-space monopoles, marshaled into the dict shapes
    # measure_2pt_bias_lcv reads
    pk_tt_mono = _project_monopole(s, field_cube(tr_fft, tr_fft))
    pk_lin_mono = {}
    for i, j in _field_pairs(len(keynames)):
        key = f'{keynames[i]}_{keynames[j]}'
        mono = _project_monopole(s, field_cube(lin_ffts[keynames[i]], lin_ffts[keynames[j]]))
        pk_lin_mono[f'P_ell_{key}'] = mono.reshape(1, len(pk_tt_mono), 1)
    bias = _fit_lcv_bias(
        s, pk_lin_mono, {'P_ell_tr_tr': pk_tt_mono.reshape(1, len(pk_tt_mono), 1)},
        D, f_growth, rec_algo, R,
    )

    f_eff = _rec_f_eff(rec_algo, R, f_growth, kth)
    kth, p_m_lin_poles = get_poles(kth, p_m_lin, D, bias, f_eff, poles=s.poles)

    pk_tt, pk_ll, pk_lt = combine_field_spectra_k3D_lcv(
        bias, f_growth, D, lin_ffts, tr_fft, s.nmesh, s.lbox, R, rec_algo,
    )
    cubes = dict(nn=pk_tt, model=pk_ll, cross=pk_lt)
    del pk_tt, pk_ll, pk_lt  # _field_reduce pops + frees each cube

    rho, ll_proj, lt_proj, tt_proj, reduced, nmodes, cube = _field_reduce(
        s, cubes, p_m_lin_poles, kth
    )
    if out is not None:
        out['P_k3D_tr_tr_lcv'] = cube
    del cube

    p_m_lin_input = np.array([
        interp1d(kth, p_m_lin_poles[i], fill_value='extrapolate')(s.k_binc) / s.lbox**3
        for i in range(len(s.poles))
    ])

    V = s.lbox**3
    return {
        'k_binc': s.k_binc,
        'poles': s.poles,
        'rho_tr_lf': rho,
        'Pk_lf_lf_ell': ll_proj * V,
        'Pk_tr_lf_ell': lt_proj * V,
        'Pk_tr_tr_ell': tt_proj * V,
        'Nk_tr_tr_ell': nmodes,
        'Pk_tr_tr_ell_lcv': reduced * V,
        'Pk_lf_lf_ell_CLASS': p_m_lin_input * V,
        'bias': bias,
    }
