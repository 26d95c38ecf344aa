r"""The k-level ZCV reduction (the counterpart of the ZCV part of
abacusutils_tpu/models/zcv/tools_cv.py).

Bias-monomial template combination, Gaussian multipole covariance
couplings, the least-squares bias fit and ``run_zcv``: beta = cov(ZD, tr) /
var(ZD) with tanh damping at k0 (default 0.618) / dk (0.167), beta = 1
below beta1_k (0.05), Savitzky-Golay smoothing (window 21), and P_cv = P_tt
- beta (P_ZZ - window * P_theory). numpy and scipy on the host, as in the
JAX package. ``run_zcv`` takes the window, keff and templates as arrays
(the ``.npz`` files of ``zcv_dir`` otherwise); the box size comes from the
package's metadata extract (``cosmo.py``). The LCV flows and the
field-level flows are not ported.
"""

import warnings
from pathlib import Path

import numpy as np
from scipy.optimize import minimize
from scipy.signal import savgol_filter

from ...ops.power import get_k_mu_edges
from .cosmo import get_meta_cfg

__all__ = [
    'ZCV_FIELDS', 'combine_spectra', 'combine_cross_spectra', 'multipole_cov',
    'measure_2pt_bias', 'read_power_dict', 'run_zcv',
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
    """Everything run_zcv reads off the config: the zcv and power sections,
    the smoothing and damping knobs, the box size (`lbox`, else the
    metadata extract's), the k binning and the presaved-file directories
    (tools_cv.py:_FlowSetup, ZCV and k-level only)."""

    def __init__(self, config, lbox=None):
        cv = config['zcv_params']
        pp = config['power_params']
        self.config = config
        self.sim_name = config['sim_params']['sim_name']
        self.z_this = config['sim_params']['z_mock']
        self.nmesh = cv['nmesh']
        self.kcut = cv['kcut']
        self.kmax_fit = cv.get('kmax_fit', 0.15)
        self.want_rsd = config['HOD_params']['want_rsd']
        self.rsd_str = '_rsd' if self.want_rsd else ''
        if self.nmesh != pp['nmesh']:
            raise ValueError('zcv nmesh must equal power_params nmesh')
        self.smoothing = dict(
            sg_window=cv.get('sg_window', 21),
            k0=cv.get('k0_window', 0.618),
            dk_cv=cv.get('dk_window', 0.167),
            beta1_k=cv.get('beta1_k', 0.05),
        )
        self.save_dir = Path(cv.get('zcv_dir', '.')) / self.sim_name
        self.save_z_dir = self.save_dir / f'z{self.z_this:.3f}'
        self.lbox = get_meta_cfg(self.sim_name, self.z_this)['lbox'] if lbox is None else lbox

        self.poles = pp['poles']
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
    does. lbox: the box size (None: the metadata extract's)."""
    s = _FlowSetup(config, lbox)
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


