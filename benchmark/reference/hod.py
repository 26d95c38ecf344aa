"""The HOD population of a halo and particle catalog, plainly.

Occupations (log10 M, M in Msun/h):

- LRG centrals, Zheng et al. (2005): ic * erfc((logM_cut - logM) / (sqrt2 sigma)) / 2;
  satellites ((M - kappa M_cut) / M_1)^alpha times the same erfc factor.
- ELG centrals, Alam et al. (2020) eq. 2: 2 (p_max - 1/Q) phi(logM) Phi(gamma logM) ic,
  phi a Gaussian in logM about logM_cut of width sigma, Phi its skewing CDF;
  satellites A_s ((M - kappa M_cut) / M_1)^alpha, with logM1_EL / alpha_EL in
  halos whose central is an LRG and logM1_EE / alpha_EE where it is an ELG
  (conformity, Yuan et al. 2022).
- QSO centrals ic (1 + erf((logM - logM_cut) / (sqrt2 sigma))) / 2; satellites
  ((M - kappa M_cut) / M_1)^alpha.

No satellite where M <= kappa M_cut. Assembly bias shifts logM_cut by
Acent deltac + Bcent fenv and logM_1 by Asat deltac + Bsat fenv where the
catalog has those columns. A particle's satellite rate is its host's
expected count times its weight and ic.

Priority: every halo draws one random and every particle one; the tracers,
in the order LRG, ELG, QSO, stack their rates, and an object becomes the
first tracer whose running sum reaches its random (the staged catalog's
randoms, upstream's ``reseed=None``).

Velocities: centrals the halo's plus alpha_c times its dispersion draw,
satellites the host's plus alpha_s times the particle's relative velocity.
Redshift space: along z in a periodic box (wrapped into [-L/2, L/2)), or
along the line of sight from the light cone's origin, by v / velz2kms.
"""

import math

import torch

TRACERS = ('LRG', 'ELG', 'QSO')
_UNSUPPORTED = ('s', 's_v', 's_p', 's_r', 'Ccent', 'Csat')


def tracer_params(tracers, z):
    """Each tracer's parameters with upstream's defaults and redshift
    evolution filled in (Python floats)."""
    out = {}
    for tracer, hod in tracers.items():
        if tracer not in TRACERS:
            raise ValueError(f'unknown tracer {tracer}')
        bad = [k for k in _UNSUPPORTED if hod.get(k, 0.0)]
        if bad:
            raise ValueError(f'the reference has no rank or shear terms: {bad}')
        p = {k: float(v) for k, v in hod.items()}
        da = 1.0 / (1.0 + z) - 1.0 / (1.0 + hod.get('z_pivot', z))
        p['logM_cut'] = hod['logM_cut'] + hod.get('logM_cut_pr', 0.0) * da
        p['logM1'] = hod['logM1'] + hod.get('logM1_pr', 0.0) * da
        for k, v in (('ic', 1.0), ('alpha_c', 0.0), ('alpha_s', 1.0), ('Acent', 0.0),
                     ('Asat', 0.0), ('Bcent', 0.0), ('Bsat', 0.0), ('A_s', 1.0)):
            p.setdefault(k, v)
        for k in ('logM1', 'alpha'):
            p.setdefault(k + '_EL', p[k])
            p.setdefault(k + '_EE', p[k])
        out[tracer] = p
    return out


def _env(cat, key, like, P):
    return P(cat[key]) if key in cat else torch.zeros_like(like)


def _logm_cut(p, dc, fe, P):
    return P(P(p['logM_cut']) + P(p['Acent']) * dc + P(p['Bcent']) * fe)


def _central_rate(tracer, p, logm, dc, fe, P):
    lmc = _logm_cut(p, dc, fe, P)
    sig = P(p['sigma'])
    if tracer == 'LRG':
        return P(0.5 * torch.special.erfc(P((lmc - logm) / (math.sqrt(2.0) * sig))) * p['ic'])
    if tracer == 'QSO':
        return P(0.5 * (1.0 + torch.special.erf(P((logm - lmc) / (math.sqrt(2.0) * sig))))
                 * p['ic'])
    x = P((logm - lmc) / sig)
    phi = P(torch.exp(-0.5 * x * x) / (math.sqrt(2.0 * math.pi) * sig))
    big_phi = P(0.5 * (1.0 + torch.special.erf(P(p['gamma'] * x / math.sqrt(2.0)))))
    return P(2.0 * (p['p_max'] - 1.0 / p['Q']) * phi * big_phi * p['ic'])


def _power_law(m, mcut, kappa, logm1, alpha, P):
    x = P(m - P(kappa) * mcut)
    val = P(P(torch.clamp(x, min=0.0) / P(10.0 ** logm1)) ** alpha)
    return torch.where(x > 0, val, torch.zeros_like(val))


def _satellite_rate(tracer, p, m, logm, dc, fe, host_code, P):
    lmc = _logm_cut(p, dc, fe, P)
    mcut = P(10.0 ** lmc)
    shift = P(P(p['Asat']) * dc + P(p['Bsat']) * fe)

    def law(logm1, alpha):
        return _power_law(m, mcut, p['kappa'], P(P(logm1) + shift), alpha, P)

    if tracer == 'LRG':
        cut = P(0.5 * torch.special.erfc(P((lmc - logm) / (math.sqrt(2.0) * P(p['sigma'])))))
        return P(law(p['logM1'], p['alpha']) * cut)
    if tracer == 'QSO':
        return law(p['logM1'], p['alpha'])
    base = law(p['logM1'], p['alpha'])
    base = torch.where(host_code == 1, law(p['logM1_EL'], p['alpha_EL']), base)
    base = torch.where(host_code == 2, law(p['logM1_EE'], p['alpha_EE']), base)
    return P(base * p['A_s'])


def _codes(rates, randoms, P):
    """The first tracer (1 LRG, 2 ELG, 3 QSO) whose running rate reaches
    each object's random, 0 for none; int8."""
    code = torch.zeros(randoms.shape, dtype=torch.int8, device=randoms.device)
    total = torch.zeros_like(randoms)
    for c, rate in rates:
        total = P(total + rate)
        code = torch.where((code == 0) & (randoms <= total), torch.full_like(code, c), code)
    return code


def keep_codes(halos, parts, params, P):
    """(halo codes, particle codes) of every object of the catalog; `params`
    from :func:`tracer_params`."""
    want = [t for t in TRACERS if t in params]
    m = P(halos['hmass'])
    logm = P(torch.log10(m))
    dc, fe = _env(halos, 'hdeltac', m, P), _env(halos, 'hfenv', m, P)
    multis = P(halos['hmultis'])
    rates = [(TRACERS.index(t) + 1, P(_central_rate(t, params[t], logm, dc, fe, P) * multis))
             for t in want]
    hcode = _codes(rates, P(halos['hrandoms']), P)
    del rates, logm, dc, fe

    host = parts['pinds'].long()
    pm = P(parts['phmass'])
    plogm = P(torch.log10(pm))
    pdc, pfe = _env(parts, 'pdeltac', pm, P), _env(parts, 'pfenv', pm, P)
    w = P(parts['pweights'])
    host_code = hcode[host]
    rates = [(TRACERS.index(t) + 1,
              P(_satellite_rate(t, params[t], pm, plogm, pdc, pfe, host_code, P) * w
                * params[t]['ic'])) for t in want]
    pcode = _codes(rates, P(parts['prandoms']), P)
    return hcode, pcode


def _wrap_centred(z, lbox):
    z = torch.where(z >= lbox / 2, z - lbox, z)
    return torch.where(z < -lbox / 2, z + lbox, z)


def _rsd(pos, vel, velz2kms, lbox, origin, P):
    """Redshift-space positions of `pos` (n, 3) with velocities `vel`."""
    if origin is None:
        z = P(pos[:, 2] + P(vel[:, 2] / velz2kms))
        return torch.stack([pos[:, 0], pos[:, 1], _wrap_centred(z, lbox)], 1)
    o = torch.as_tensor(origin, dtype=pos.dtype, device=pos.device)
    d = P(pos - o)
    n = P(d / P(torch.linalg.vector_norm(d, dim=1, keepdim=True)))
    proj = P(P((vel * n).sum(1, keepdim=True)) / velz2kms)
    return P(pos + proj * n)


def galaxies(cat, cfg, tracers, P, rsd=True):
    """Each tracer's galaxies, centrals first: {tracer: {'id', 'pos' (n, 3),
    'vel' (n, 3), 'ncent'}}, positions in the box's frame [-L/2, L/2) along
    z (a box) or as the line of sight moved them (a light cone)."""
    halos, parts = cat
    params = tracer_params(tracers, float(cfg['z']))
    hcode, pcode = keep_codes(halos, parts, params, P)
    lbox = float(cfg['Lbox'])
    velz2kms = float(cfg['velz2kms'])
    lc = cfg.get('lightcone')
    origin = None if not lc else lc['origin']
    out = {}
    for t in (t for t in TRACERS if t in params):
        p = params[t]
        code = TRACERS.index(t) + 1
        hk = torch.nonzero(hcode == code).squeeze(1)
        pk = torch.nonzero(pcode == code).squeeze(1)
        hvel = P(P(halos['hvel'][hk]) + P(p['alpha_c']) * P(halos['hveldev'][hk]))
        phv = P(parts['phvel'][pk])
        pvel = P(phv + P(p['alpha_s']) * P(P(parts['pvel'][pk]) - phv))
        pos = torch.cat([P(halos['hpos'][hk]), P(parts['ppos'][pk])])
        vel = torch.cat([hvel, pvel])
        if rsd:
            pos = _rsd(pos, vel, velz2kms, lbox, origin, P)
        out[t] = {'id': torch.cat([halos['hid'][hk], parts['phid'][pk]]), 'pos': pos,
                  'vel': vel, 'ncent': int(hk.numel())}
    return out
