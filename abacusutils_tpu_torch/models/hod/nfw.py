r"""NFW-profile satellites (the counterpart of
abacusutils_tpu/models/hod/nfw.py): the satellite route of secondary
redshifts, whose halos have no particle subsamples.

Per halo: Poisson satellite counts from the HOD mean (``shapes_np``, in
float64), isotropic directions, radial draws by rejection from a
user-supplied NFW sample (P(x) ~ x / (1 + x)^2), an optional exponential
mixture, and a Gaussian velocity dispersion sigma_v = 0.577 * sigmav3d *
f_sigv.

Host numpy, as in the JAX package: the route is bound by random numbers,
not by arithmetic. Every draw comes from one PCG64 stream in the JAX
package's order, so one seed gives a bit-equal catalog in both packages.
Halo columns may be numpy arrays or tensors (they are copied to the host
once).
"""

import numpy as np
import torch

from . import shapes_np

__all__ = ['gen_sats_nfw', 'getPointsOnSphere', 'compute_fast_NFW', 'phi_fun', 'Phi_fun']


def _host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def getPointsOnSphere(nPoints, Nthread=None, seed=None):
    """Random unit vectors from a PCG64 stream (nfw.py:getPointsOnSphere)."""
    rng = np.random.default_rng(seed)
    return _points_on_sphere(int(nPoints), rng)


def phi_fun(logM_h, logM_cut, sigma):
    """Gaussian aiding function for N_cen_ELG_v1 (nfw.py:phi_fun)."""
    return shapes_np.Gaussian_fun(logM_h, logM_cut, sigma)


def Phi_fun(logM_h, logM_cut, sigma, gamma):
    """Skew-normal CDF factor for N_cen_ELG_v1 (nfw.py:Phi_fun)."""
    from scipy.special import erf

    x = gamma * (logM_h - logM_cut) / sigma
    return 0.5 * (1 + erf(x / np.sqrt(2)))


def compute_fast_NFW(
    NFW_draw, h_id, x_h, y_h, z_h, vx_h, vy_h, vz_h, vrms_h, c, M, Rvir, rd_pos, num_sat,
    f_sigv, vel_sat='rd_normal', Nthread=16, exp_frac=0, exp_scale=1, nfw_rescale=1, seed=None,
):
    """NFW satellite positions and velocities of halos with `num_sat`
    satellites each (nfw.py:compute_fast_NFW, the same draws in the same
    order)."""
    if vel_sat != 'rd_normal':
        raise ValueError('Wrong vel_sat argument only "rd_normal"')
    rng = np.random.default_rng(seed)
    num_sat = np.asarray(num_sat, np.int64)

    def rep(a):
        return np.repeat(_host(a), num_sat)

    h_id, M, c, Rvir = rep(h_id), rep(M), rep(c), rep(Rvir)
    x_h, y_h, z_h = rep(x_h), rep(y_h), rep(z_h)
    vx_h, vy_h, vz_h, vrms_h = rep(vx_h), rep(vy_h), rep(vz_h), rep(vrms_h)
    n = len(x_h)
    NFW_draw = _host(NFW_draw)

    eta = np.empty(n)
    use_exp = rng.uniform(0, 1, n) < exp_frac
    eta[use_exp] = rng.exponential(exp_scale, use_exp.sum()) / c[use_exp]
    todo = np.flatnonzero(~use_exp)
    draw = NFW_draw[rng.integers(0, len(NFW_draw), len(todo))]
    while True:
        ok = draw <= c[todo]
        eta[todo[ok]] = draw[ok] / c[todo[ok]] * nfw_rescale
        todo = todo[~ok]
        if not len(todo):
            break
        draw = NFW_draw[rng.integers(0, len(NFW_draw), len(todo))]

    p = eta * Rvir
    x_sat = x_h + rd_pos[:n, 0] * p
    y_sat = y_h + rd_pos[:n, 1] * p
    z_sat = z_h + rd_pos[:n, 2] * p
    sig = vrms_h * 0.577 * f_sigv
    vx_sat = rng.normal(vx_h, sig)
    vy_sat = rng.normal(vy_h, sig)
    vz_sat = rng.normal(vz_h, sig)
    return h_id, x_sat, y_sat, z_sat, vx_sat, vy_sat, vz_sat, M


def _points_on_sphere(n, rng):
    u1 = rng.random(n)
    u2 = rng.random(n)
    ra = u1 * 2 * np.pi
    dec = np.pi - np.arccos(-1 + 2 * u2)
    return np.stack([np.sin(dec) * np.cos(ra), np.sin(dec) * np.sin(ra), np.cos(dec)], axis=1)


def _nfw_eta(n, c, NFW_draw, rng, exp_frac, exp_scale, nfw_rescale):
    """Radial position in units of Rvir by rejection from NFW_draw (draws
    above the concentration are drawn again), with an exponential mixture."""
    eta = np.empty(n)
    use_exp = rng.random(n) < exp_frac
    n_exp = int(use_exp.sum())
    if n_exp:
        eta[use_exp] = rng.exponential(exp_scale, n_exp) / c[use_exp]
    todo = np.flatnonzero(~use_exp)
    draw = NFW_draw[rng.integers(0, len(NFW_draw), len(todo))]
    while True:
        bad = draw > c[todo]
        if not bad.any():
            break
        draw[bad] = NFW_draw[rng.integers(0, len(NFW_draw), int(bad.sum()))]
    eta[todo] = draw / c[todo] * nfw_rescale
    return eta


def sat_means(halos_array, tparams, tracer, keep_cent):
    """Each halo's mean satellite count of `tracer` before the Poisson draw
    (nfw.py:gen_sats_nfw's `base`) in float64, whatever the columns' dtype
    (the staged catalogs are float64); None for a tracer without NFW
    satellites. keep_cent: each halo's central keep code (host numpy)."""
    hmass = _host(halos_array['hmass']).astype(np.float64, copy=False)
    zerosH = np.zeros(len(hmass))

    def col(k):
        if k not in halos_array:
            return zerosH
        return _host(halos_array[k]).astype(np.float64, copy=False)

    hdeltac, hfenv, hshear = col('hdeltac'), col('hfenv'), col('hshear')
    p = tparams[tracer]
    if tracer == 'LRG':
        M1 = 10 ** (p['logM1'] + p['Asat'] * hdeltac + p['Bsat'] * hfenv)
        lMc = p['logM_cut'] + p['Acent'] * hdeltac + p['Bcent'] * hfenv
        return shapes_np.n_sat_LRG_modified(
            hmass, lMc, 10**lMc, M1, p['sigma'], p['alpha'], p['kappa']) * p['ic']
    if tracer == 'ELG':
        lMc = p['logM_cut'] + p['Acent'] * hdeltac + p['Bcent'] * hfenv + p['Ccent'] * hshear
        M1 = 10 ** (p['logM1'] + p['Asat'] * hdeltac + p['Bsat'] * hfenv + p['Csat'] * hshear)
        base = shapes_np.N_sat_elg(hmass, 10**lMc, p['kappa'], M1, p['alpha'], p['A_s'])
        M1_EL = 10 ** (p['logM1_EL'] + p['Asat'] * hdeltac + p['Bsat'] * hfenv)
        base_EL = shapes_np.N_sat_elg(hmass, 10**lMc, p['kappa'], M1_EL, p['alpha_EL'], p['A_s'])
        M1_EE = 10 ** (p['logM1_EE'] + p['Asat'] * hdeltac + p['Bsat'] * hfenv)
        base_EE = shapes_np.N_sat_elg(hmass, 10**lMc, p['kappa'], M1_EE, p['alpha_EE'], p['A_s'])
        base = np.where(keep_cent == 1, base_EL, base)
        base = np.where(keep_cent == 2, base_EE, base)
        return base * p['ic']
    if tracer == 'QSO':
        M1 = 10 ** (p['logM1'] + p['Asat'] * hdeltac + p['Bsat'] * hfenv)
        lMc = p['logM_cut'] + p['Acent'] * hdeltac + p['Bcent'] * hfenv
        return shapes_np.N_sat_generic(hmass, 10**lMc, p['kappa'], M1, p['alpha']) * p['ic']
    return None


_NFW_COLUMNS = ('hpos', 'hvel', 'hmass', 'hid', 'hsigma3d', 'hc', 'hrvir', 'hdeltac', 'hfenv',
                'hshear')


def gen_sats_nfw(
    NFW_draw, halos_array, tparams, want, rsd, inv_velz2kms, lbox, keep_cent, params,
    vel_sat='rd_normal', seed=None,
):
    """NFW satellites of each wanted tracer (nfw.py:gen_sats_nfw): returns
    {tracer: {x, y, z, vx, vy, vz, mass, id}} as host numpy, positions and
    velocities float64. halos_array: the staged halo columns (``hpos``,
    ``hvel``, ``hmass``, ``hid``, ``hsigma3d``, ``hc``, ``hrvir`` and the
    optional ``hdeltac``, ``hfenv``, ``hshear``); tparams: the
    population.prepare_tracer_params dict; keep_cent: each halo's central
    keep code (host numpy)."""
    if NFW_draw is None:
        raise ValueError('want_nfw=True requires an NFW_draw sample array')
    rng = np.random.default_rng(seed)

    halos_array = {k: _host(halos_array[k]) for k in _NFW_COLUMNS if k in halos_array}
    hpos, hvel, hmass, hid = (halos_array[k] for k in ('hpos', 'hvel', 'hmass', 'hid'))
    hvrms, hc, hrvir = (halos_array[k] for k in ('hsigma3d', 'hc', 'hrvir'))
    H = len(hmass)
    keep_cent = _host(keep_cent)
    NFW_draw = _host(NFW_draw)

    out = {}
    for tracer in want:
        p = tparams[tracer]
        base = sat_means(halos_array, tparams, tracer, keep_cent)
        if base is None:
            continue

        num_sat = rng.poisson(np.clip(base, 0, None))
        total = int(num_sat.sum())
        rep = np.repeat(np.arange(H), num_sat)

        rd = _points_on_sphere(total, rng)
        eta = _nfw_eta(
            total, hc[rep], NFW_draw, rng, p.get('exp_frac', 0.0), p.get('exp_scale', 1.0),
            p.get('nfw_rescale', 1.0),
        )
        r = eta * hrvir[rep]
        pos = hpos[rep] + rd * r[:, None]

        sig = hvrms[rep] * 0.577 * p.get('f_sigv', 0.0)
        vel = hvel[rep] + rng.standard_normal((total, 3)) * sig[:, None]

        z = pos[:, 2]
        if rsd:
            z = (z + vel[:, 2] * inv_velz2kms) % lbox

        out[tracer] = {
            'x': pos[:, 0], 'y': pos[:, 1], 'z': z,
            'vx': vel[:, 0], 'vy': vel[:, 1], 'vz': vel[:, 2],
            'mass': hmass[rep], 'id': hid[rep],
        }
    return out
