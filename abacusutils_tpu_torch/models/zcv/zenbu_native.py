r"""Native Zel'dovich (ZA) bias-basis power-spectrum templates (a numpy copy of
abacusutils_tpu/models/zcv/zenbu_native.py; the torch package imports nothing
of the JAX package).

Replaces the external ZeNBu/velocileptors dependency of the reference
(`zenbu_spectra`, zenbu_window.py:184-302): the ZCV method needs the
*analytic expectation* of the 10 auto/cross spectra of the ZA-advected
operator fields {1, delta, delta^2 - <delta^2>, s^2 - <s^2>} -- exactly the
fields the surrogate pipeline advects and measures (ic_fields.py /
advect_fields.py).  This module computes those expectations from first
principles; the derivation is self-contained and is validated against
device-measured ZA realizations in tests/test_zenbu_native.py.

Derivation
----------
The advected operator field is X_a(k) = int d^3q F_a(q) e^{-ik.(q+Psi(q))}
with Gaussian linear fields (delta, s_ij, Psi) at the working redshift.
Writing Delta = Psi(q2) - Psi(q1), q = q2 - q1:

    P_ab(k) = int d^3q e^{ik.q} < F_a(1) F_b(2) e^{ik'.Delta} >

where k' = R k with R = 1 + f zhat zhat in redshift space (k' = k in real
space).  Because everything is jointly Gaussian this expectation is EXACT
(no perturbative expansion): completing the square,

    < P(g) e^{iJ.Delta} > = e^{-1/2 J_i J_j A_ij} E[P(g~)],   J = k',

with A_ij = <Delta_i Delta_j> = X(q) delta_ij + Y(q) qhat_i qhat_j and g~
Gaussian with unchanged covariances but shifted means m_X = i J_j <X Delta_j>.
Wick with means then gives every operator-pair column in closed form in a
handful of scalar radial functions (all of the form
(1/2pi^2) int dk k^p P(k) j_n(kq) / (kq)^s):

    xi      = int k^2 P j0                      <delta1 delta2>
    u       = -int k  P j1                      <delta Delta_i> = qhat_i u
    chi2    = int k^2 P j2                      <delta1 s2_ab> = -chi2 (qhat qhat - 1/3)_ab
    X       = int P [2/3 - 2 j1/x]              displacement dispersion
    Y       = int P [-2 j0 + 6 j1/x]
    a_s     = int k  P j2/x   \
    c_s     = int k  P j1      } <s_ab(2) Delta_m> = alpha d_ab qhat_m
    b_s     = 5 a_s - c_s     /    + beta (d_am qhat_b + d_bm qhat_a)
                                   + gamma qhat_a qhat_b qhat_m,
                               alpha = -a_s + c_s/3, beta = -a_s, gamma = b_s
    Z1      = int k^2 P j2/x^2 \
    Z2      = int k^2 P j3/x    } shear-shear cross covariance S_abcd
    Z3      = int k^2 P j4     /
    zeta    = 2 S_abcd S_abcd          <s^2(1) s^2(2)>_c

With sbar_ab = i k'_m <s_ab Delta_m>, m = i (k'.qhat) u, the ten columns
(ordered to match the reference's bias monomials
[1, 2b1, b1^2, b2, b1b2, b2^2/4, 2bs, 2 b1 bs, b2 bs, bs^2],
tools_cv.py:37-111):

    <1,1>      : 1
    <1,d>      : m
    <d,d>      : xi + m^2
    <1,d2>     : m^2
    <d,d2>     : m^3 + 2 xi m
    <d2,d2>    : 2 xi^2 + 4 xi m^2 + m^4
    <1,s2>     : sbar.sbar
    <d,s2>     : m sbar.sbar + 2 Chi.sbar
    <d2,s2>    : m^2 sbar.sbar + 4 m Chi.sbar + (4/3) chi2^2
    <s2,s2>    : (sbar.sbar)^2 + 4 sbar.S.sbar + zeta

where Chi_ab = -chi2 (qhat qhat - 1/3)_ab and the contractions reduce to
polynomials in K1 = k'.qhat and k'^2 (verified numerically against explicit
tensor einsums in the test suite):

    sbar.sbar  = -[2 beta^2 k'^2 + G K1^2],
                 G = 3 alpha^2 + 4 alpha beta + 2 alpha gamma
                     + 2 beta^2 + 4 beta gamma + gamma^2
    Chi.sbar   = -i chi2 K1 (alpha + 2 beta + gamma)
    w.w        = -[((alpha+beta+gamma)^2 + 2 beta (alpha+beta+gamma)) K1^2
                   + beta^2 k'^2],   w_a = sbar_ab qhat_b
    sbar.S.sbar= 2 Z1 sbar.sbar - 4 Z2 w.w + Z3 (-K1^2 (alpha+2beta+gamma)^2)

Angular reduction: with nu = khat.qhat and z = qhat.zhat,
K1 = k nu + f k mu_k z, k'^2 = k^2 (1 + f(2+f) mu_k^2), and the exponent
splits as

    ik q nu - 1/2 X k'^2 - 1/2 Y k^2 nu^2
            - 1/2 Y [2 k nu f k mu_k z + (f k mu_k z)^2].

The last bracket (redshift-space only) is Taylor-expanded to `nmax`
(the moment expansion of Chen/Vlah/White used by ZeNBu); the azimuthal
integral of z^p at fixed nu is a closed-form polynomial in nu, and the
remaining mu-type integrals are

    J_m(x, lam) = int_{-1}^{1} dnu nu^m e^{i x nu + lam (1 - nu^2)},
    x = k q,  lam = 1/2 k^2 Y,

computed either by direct Gauss-Legendre quadrature (small x) or the
Bessel series  J_0 = sum_n lam^n 2^{n+1} j_n(x)/x^n,
J_m = (-i d/dx)^m J_0  (small-lam/x expansion; j_(n)/x^n derivative
recurrences evaluated symbolically).  The q -> infinity disconnected piece
of <1,1> (a k=0 delta) is subtracted explicitly.

Real space is the f = 0 special case.  Multipoles are Gauss-Legendre over
mu_k in [0, 1].
"""

import numpy as np
from scipy.special import eval_legendre, roots_legendre, spherical_jn

__all__ = ['ZAQFuncs', 'za_power_kmu', 'za_basis_spectra', 'zenbu_spectra_native']


# ---------------------------------------------------------------------------
# radial q-functions
# ---------------------------------------------------------------------------

def _default_qgrid(q_switch=20.0, q_max=1600.0, n_log=400, dq_lin=0.18):
    """Log spacing through the BAO-free small-q regime, linear beyond so the
    j_n(kq) oscillation (period 2 pi / k_max in q) stays resolved."""
    qlog = np.geomspace(1e-2, q_switch, n_log, endpoint=False)
    qlin = np.arange(q_switch, q_max, dq_lin)
    return np.concatenate([qlog, qlin])


class ZAQFuncs:
    """All scalar radial functions of q needed by the ZA column integrands.

    Parameters
    ----------
    klin, plin : arrays
        Linear power spectrum at the working redshift (h/Mpc, (Mpc/h)^3).
    cutoff : float or None
        Gaussian damping exp(-(k/cutoff)^2) applied to plin — the ZCV
        surrogate's IC filter squared (field filter exp(-k^2/(2 kcut^2)),
        ic_fields.py:110-148).
    """

    def __init__(self, klin, plin, cutoff=None, qgrid=None, nk=6144):
        klin = np.asarray(klin, np.float64)
        plin = np.asarray(plin, np.float64)
        if cutoff is not None:
            plin = plin * np.exp(-((klin / cutoff) ** 2))
        # resample onto a fine log grid: the source tables are too coarse to
        # resolve j_n(kq) at the largest q
        kk = np.geomspace(klin[klin > 0].min(), klin.max(), nk)
        with np.errstate(divide='ignore'):
            pp = np.exp(
                np.interp(np.log(kk), np.log(klin[plin > 0]),
                          np.log(plin[plin > 0]), left=-np.inf, right=-np.inf)
            )
        pp[~np.isfinite(pp)] = 0.0
        self.k = kk
        self.p = pp
        self.q = _default_qgrid() if qgrid is None else np.asarray(qgrid)
        # trapezoid weights on the k grid, with the 1/(2 pi^2) measure
        w = np.empty_like(kk)
        w[1:-1] = 0.5 * (kk[2:] - kk[:-2])
        w[0] = 0.5 * (kk[1] - kk[0])
        w[-1] = 0.5 * (kk[-1] - kk[-2])
        self._wk = w / (2 * np.pi**2)

        # one-shot moments
        self.sig2 = float(np.sum(self._wk * kk**2 * pp))      # <delta^2>
        self.norm0 = float(np.sum(self._wk * pp))             # int P dk /(2pi^2)
        self.Xinf = 2.0 / 3.0 * self.norm0                    # X(q->inf)

        q = self.q
        # accumulate all transforms chunked over q to bound the (Nq, Nk)
        # Bessel matrix memory
        names = ['j0_k2', 'j1_k2_x', 'j2_k2', 'j1_k1', 'j2_k1_x', 'j0_k0',
                 'j1_k0_x', 'j2_k2_x2', 'j3_k2_x', 'j4_k2']
        acc = {n: np.empty_like(q) for n in names}
        spec = {            # name -> (bessel order, k power, 1/x power)
            'j0_k2': (0, 2, 0), 'j1_k2_x': (1, 2, 1), 'j2_k2': (2, 2, 0),
            'j1_k1': (1, 1, 0), 'j2_k1_x': (2, 1, 1), 'j0_k0': (0, 0, 0),
            'j1_k0_x': (1, 0, 1), 'j2_k2_x2': (2, 2, 2), 'j3_k2_x': (3, 2, 1),
            'j4_k2': (4, 2, 0),
        }
        csize = max(1, int(4e6 // nk))
        for lo in range(0, len(q), csize):
            qs = q[lo:lo + csize]
            x = qs[:, None] * kk[None, :]
            ordmax = max(o for o, _, _ in spec.values())
            jn = {}
            for o in range(ordmax + 1):
                jn[o] = spherical_jn(o, x)
            with np.errstate(divide='ignore', invalid='ignore'):
                invx = np.where(x > 0, 1.0 / x, 0.0)
            for name, (o, kp, xs) in spec.items():
                integ = self._wk * kk**kp * pp
                mat = jn[o] * (invx**xs if xs else 1.0)
                acc[name][lo:lo + csize] = mat @ integ
        self.xi = acc['j0_k2']
        self.u = -acc['j1_k1']
        self.chi2 = acc['j2_k2']
        self.X = 2.0 / 3.0 * self.norm0 - 2.0 * acc['j1_k0_x']
        self.Y = -2.0 * acc['j0_k0'] + 6.0 * acc['j1_k0_x']
        # <s_ab Delta_m> tensor coefficients
        a_s = acc['j2_k1_x']
        c_s = acc['j1_k1']
        b_s = 5.0 * a_s - c_s
        self.alpha = -a_s + c_s / 3.0
        self.beta = -a_s
        self.gamma = b_s
        # shear-shear cross covariance scalars
        self.Z1 = acc['j2_k2_x2']
        self.Z2 = acc['j3_k2_x']
        self.Z3 = acc['j4_k2']
        # xi1 = int k^2 P j1/x, needed for the S_abcd trace parts in zeta
        self.xi1 = acc['j1_k2_x']
        self.zeta = self._zeta_numeric()

        # trapezoid weights in q with the 2 pi q^2 measure, times an
        # adiabatic taper over the last part of the grid: the subtracted
        # <1,1> integrand still ends in a conditionally-convergent
        # oscillatory tail (envelope ~ k^2 Y(q) q^2 j_0(kq) ~ 1/q), and a
        # smooth window spanning many oscillation periods converts the
        # O(envelope * period) truncation error into
        # O(envelope * period^2 / L_taper^2)
        wq = np.empty_like(q)
        wq[1:-1] = 0.5 * (q[2:] - q[:-2])
        wq[0] = 0.5 * (q[1] - q[0])
        wq[-1] = 0.5 * (q[-1] - q[-2])
        qt = 0.5 * q[-1]
        taper = np.ones_like(q)
        m = q > qt
        taper[m] = np.cos(0.5 * np.pi * (q[m] - qt) / (q[-1] - qt)) ** 2
        self._wq = 2.0 * np.pi * q**2 * wq * taper

    # -- <s^2 s^2>_c = 2 S_abcd S_abcd via an explicit tensor contraction --
    def _s_cross_tensor(self):
        """S_abcd(q) = <s_ab(1) s_cd(2)> as an (Nq, 3,3,3,3) array with
        qhat = zhat (the contraction 2 S.S is rotation invariant)."""
        d = np.eye(3)
        qh = np.array([0.0, 0.0, 1.0])
        dd = (np.einsum('ab,cd->abcd', d, d)
              + np.einsum('ac,bd->abcd', d, d)
              + np.einsum('ad,bc->abcd', d, d))
        dqq = (np.einsum('ab,c,d->abcd', d, qh, qh)
               + np.einsum('ac,b,d->abcd', d, qh, qh)
               + np.einsum('ad,b,c->abcd', d, qh, qh)
               + np.einsum('bc,a,d->abcd', d, qh, qh)
               + np.einsum('bd,a,c->abcd', d, qh, qh)
               + np.einsum('cd,a,b->abcd', d, qh, qh))
        qqqq = np.einsum('a,b,c,d->abcd', qh, qh, qh, qh)
        # rank-2 angular block R_ij = xi1 d_ij - chi2 qh_i qh_j
        rank4 = (self.Z1[:, None, None, None, None] * dd
                 - self.Z2[:, None, None, None, None] * dqq
                 + self.Z3[:, None, None, None, None] * qqqq)
        R = (self.xi1[:, None, None] * d
             - self.chi2[:, None, None] * np.outer(qh, qh))
        S = (rank4
             - np.einsum('ab,ncd->nabcd', d / 3.0, R)
             - np.einsum('cd,nab->nabcd', d / 3.0, R)
             + np.einsum('n,ab,cd->nabcd', self.xi / 9.0, d, d))
        return S

    def _zeta_numeric(self):
        S = self._s_cross_tensor()
        return 2.0 * np.einsum('nabcd,nabcd->n', S, S)


# ---------------------------------------------------------------------------
# J_m(x, lam) tables
# ---------------------------------------------------------------------------

def _deriv_tables(mmax, nj):
    """tables[m][n] = {(nu, p): coef} for (d/dx)^m [2^{n+1} j_n(x)/x^n].

    One derivative of c j_nu x^{-p}:
      nu >= 1:  c j_{nu-1} x^{-p} - c (nu+1+p) j_nu x^{-p-1}
                (j_nu' = j_{nu-1} - (nu+1)/x j_nu, plus the power rule)
      nu == 0:  -c j_1 x^{-p} - c p j_0 x^{-p-1}
    """
    def add(d, key, c):
        d[key] = d.get(key, 0.0) + c

    tables = []
    cur = [{(n, n): 2.0 ** (n + 1)} for n in range(nj + 1)]
    tables.append([dict(t) for t in cur])
    for _ in range(mmax):
        nxt = []
        for t in cur:
            d = {}
            for (nu, p), c in t.items():
                if nu == 0:
                    add(d, (1, p), -c)
                    if p:
                        add(d, (0, p + 1), -p * c)
                else:
                    add(d, (nu - 1, p), c)
                    add(d, (nu, p + 1), -(nu + 1 + p) * c)
            nxt.append(d)
        cur = nxt
        tables.append([dict(t) for t in cur])
    return tables


_GL_CACHE = {}


def _gl(n):
    if n not in _GL_CACHE:
        _GL_CACHE[n] = roots_legendre(n)
    return _GL_CACHE[n]


class _JmEvaluator:
    """e^{-lam} J_m(x, lam) for a q-grid: hybrid direct-quadrature /
    Bessel-sum.  The e^{-lam} scaling keeps both branches well conditioned
    (the raw J_m grows like e^{lam} while the physical integrand carries a
    compensating e^{-1/2 k^2 Y} = e^{-lam} in its prefactor: the direct
    quadrature of the raw J_m loses ~lam digits to cancellation at large x).
    """

    def __init__(self, mmax, nj=18, x_switch=40.0, ngl=96):
        self.mmax = mmax
        self.nj = nj
        self.x_switch = x_switch
        self.tables = _deriv_tables(mmax, nj)
        self.ngl = ngl

    def __call__(self, x, lam):
        """Returns (mmax+1, Nq) complex e^{-lam} J_m values."""
        x = np.asarray(x, np.float64)
        lam = np.asarray(lam, np.float64)
        out = np.empty((self.mmax + 1, len(x)), np.complex128)
        lo = x < self.x_switch
        hi = ~lo
        if lo.any():
            nodes, wts = _gl(self.ngl)
            xs, ls = x[lo][:, None], lam[lo][:, None]
            ker = np.exp(1j * xs * nodes[None, :]
                         - ls * nodes[None, :] ** 2) * wts[None, :]
            mupow = np.ones_like(nodes)
            for m in range(self.mmax + 1):
                out[m, lo] = ker @ mupow
                mupow = mupow * nodes
        if hi.any():
            xs, ls = x[hi], lam[hi]
            numax = self.nj + 1
            jn = np.empty((numax + 1, len(xs)))
            for nu in range(numax + 1):
                jn[nu] = spherical_jn(nu, xs)
            invx = 1.0 / xs
            # e^{-lam} lam^n series with the 2^{n+1} j_n/x^n basis terms
            lampow = np.exp(-ls)
            vals = np.zeros((self.mmax + 1, len(xs)))
            for n in range(self.nj + 1):
                for m in range(self.mmax + 1):
                    t = self.tables[m][n]
                    s = np.zeros_like(xs)
                    for (nu, p), c in t.items():
                        s += c * jn[nu] * invx**p
                    vals[m] += lampow * s
                lampow = lampow * ls
            # J_m = (-i)^m (d/dx)^m J_0
            for m in range(self.mmax + 1):
                out[m, hi] = (-1j) ** m * vals[m]
        return out


# ---------------------------------------------------------------------------
# polynomial algebra in (nu, z) with per-q coefficient arrays
# ---------------------------------------------------------------------------

def _pmul(A, B):
    out = {}
    for ka, va in A.items():
        for kb, vb in B.items():
            key = (ka[0] + kb[0], ka[1] + kb[1])
            cur = out.get(key)
            out[key] = va * vb if cur is None else cur + va * vb
    return out


def _padd(A, B):
    out = dict(A)
    for k, v in B.items():
        out[k] = out[k] + v if k in out else v
    return out


def _pscale(A, c):
    return {k: v * c for k, v in A.items()}


_DFACT = [1.0]  # (2r-1)!!/(2r)!! table built on demand; [r=1] = 1/2


def _cos_even_moment(r):
    """(1/2pi) int_0^{2pi} cos^{2r} = (2r-1)!!/(2r)!!"""
    while len(_DFACT) <= r:
        n = len(_DFACT)
        _DFACT.append(_DFACT[n - 1] * (2 * n - 1) / (2 * n))
    return _DFACT[r]


def _zsub_tables(pmax, mu_k):
    """z^p -> polynomial in nu after the azimuthal average:
    z = nu mu + sqrt(1-nu^2) sqrt(1-mu^2) cos(phi)."""
    from math import comb
    smu2 = 1.0 - mu_k**2
    tabs = []
    for p in range(pmax + 1):
        poly = {}
        for j in range(0, p + 1, 2):       # cos^j, j even
            r = j // 2
            c = comb(p, j) * mu_k ** (p - j) * smu2**r * _cos_even_moment(r)
            # nu^{p-j} (1-nu^2)^r
            for t in range(r + 1):
                key = p - j + 2 * t
                poly[key] = poly.get(key, 0.0) + c * comb(r, t) * (-1.0) ** t
        tabs.append(poly)
    return tabs


# ---------------------------------------------------------------------------
# column assembly
# ---------------------------------------------------------------------------

def _columns_kmu(qf, k, f, mu_k, Jm, nmax=8):
    """The 10 ZA basis spectra at one (k, mu_k), given the precomputed
    J_m(kq, lam) table (k-only, shared across mu_k). Returns (10,)."""
    q = qf.q
    kp2 = k * k * (1.0 + f * (2.0 + f) * mu_k**2)     # |k'|^2
    # Jm tables carry e^{-lam} = e^{-1/2 k^2 Y}, so the prefactor is X-only
    pre = np.exp(-0.5 * kp2 * qf.X)

    # K1 = k'.qhat = k nu + f k mu_k z as a (nu, z) polynomial
    K1 = {(1, 0): np.full_like(q, k), (0, 1): np.full_like(q, f * k * mu_k)}
    one = {(0, 0): np.ones_like(q)}
    i_ = 1j

    al, be, ga = qf.alpha, qf.beta, qf.gamma
    G = 3 * al**2 + 4 * al * be + 2 * al * ga + 2 * be**2 + 4 * be * ga + ga**2
    K1sq = _pmul(K1, K1)
    m = _pscale(K1, i_ * qf.u)
    m2 = _pmul(m, m)
    sbar2 = _padd(_pscale(one, -2.0 * qf.beta**2 * kp2), _pscale(K1sq, -G))
    chis = _pscale(K1, -i_ * qf.chi2 * (al + 2 * be + ga))
    abg = al + be + ga
    ww = _padd(_pscale(K1sq, -(abg**2 + 2 * be * abg)),
               _pscale(one, -qf.beta**2 * kp2))
    sqq2 = _pscale(K1sq, -((al + 2 * be + ga) ** 2))   # (sbar qhat qhat)^2
    sSs = _padd(_padd(_pscale(sbar2, 2.0 * qf.Z1), _pscale(ww, -4.0 * qf.Z2)),
                _pscale(sqq2, qf.Z3))

    xi = qf.xi
    cols = [
        one,                                             # <1,1>
        m,                                               # <1,d>
        _padd(_pscale(one, xi), m2),                     # <d,d>
        m2,                                              # <1,d2>
        _padd(_pmul(m2, m), _pscale(m, 2.0 * xi)),       # <d,d2>
        _padd(_padd(_pscale(one, 2.0 * xi**2),
                    _pscale(m2, 4.0 * xi)), _pmul(m2, m2)),   # <d2,d2>
        sbar2,                                           # <1,s2>
        _padd(_pmul(m, sbar2), _pscale(chis, 2.0)),      # <d,s2>
        _padd(_padd(_pmul(m2, sbar2), _pscale(_pmul(m, chis), 4.0)),
              _pscale(one, (4.0 / 3.0) * qf.chi2**2)),   # <d2,s2>
        _padd(_padd(_pmul(sbar2, sbar2), _pscale(sSs, 4.0)),
              _pscale(one, qf.zeta)),                    # <s2,s2>
    ]

    # redshift-space remainder exponential, Taylor to nmax:
    # R = -1/2 Y [ 2 k nu (f k mu z) + (f k mu z)^2 ]
    if f != 0.0 and mu_k != 0.0:
        fkmu = f * k * mu_k
        R = {(1, 1): -qf.Y * k * fkmu, (0, 2): -0.5 * qf.Y * fkmu**2}
        eR = dict(one)
        term = dict(one)
        for n in range(1, nmax + 1):
            term = _pscale(_pmul(term, R), 1.0 / n)
            eR = _padd(eR, term)
        cols = [_pmul(c, eR) for c in cols]

    # azimuthal average: substitute z^p
    pmax = max((key[1] for c in cols for key in c), default=0)
    ztab = _zsub_tables(pmax, mu_k)
    nucols = []
    for c in cols:
        nu_poly = {}
        for (i, j), coef in c.items():
            for deg, zc in ztab[j].items():
                key = i + deg
                nu_poly[key] = nu_poly.get(key, 0.0) + coef * zc
        assert max(nu_poly) < Jm.shape[0], (max(nu_poly), Jm.shape[0])
        nucols.append(nu_poly)

    out = np.empty(10)
    x = k * q
    sub0 = np.exp(-0.5 * kp2 * qf.Xinf) * 2.0 * np.sinc(x / np.pi)
    for ic, c in enumerate(nucols):
        integ = np.zeros_like(q, dtype=np.complex128)
        for deg, coef in c.items():
            integ = integ + coef * Jm[deg]
        integ = pre * integ
        if ic == 0:
            integ = integ - sub0
        val = np.sum(qf._wq * integ)
        out[ic] = val.real
    return out


def za_power_kmu(qf, kout, f=0.0, mu_k=0.0, nmax=8, nj=18):
    """P_ab(k, mu_k) for the 10 ZA basis columns: (10, Nk) array."""
    mmax = 4 + 2 * nmax        # column total degree + RSD expansion
    jm = _JmEvaluator(mmax, nj=nj)
    out = np.empty((10, len(kout)))
    for i, k in enumerate(np.asarray(kout, np.float64)):
        Jm = jm(k * qf.q, 0.5 * k * k * qf.Y)
        out[:, i] = _columns_kmu(qf, k, f, mu_k, Jm, nmax=nmax)
    return out


def za_basis_spectra(kout, klin, plin, f=0.0, cutoff=None, poles=(0, 2, 4),
                     ngauss=8, nmax=8, nj=18, qf=None):
    """ZA bias-basis template spectra.

    Real space (f == 0): returns (10, Nk).
    Redshift space: returns (10, len(poles), Nk) multipoles (Gauss-Legendre
    over mu_k in [0, 1]; P(k, mu) is even in mu).
    """
    if qf is None:
        qf = ZAQFuncs(klin, plin, cutoff=cutoff)
    kout = np.asarray(kout, np.float64)
    if f == 0.0:
        return za_power_kmu(qf, kout, f=0.0, mu_k=0.0, nmax=nmax, nj=nj)
    nodes, wts = _gl(ngauss)
    mus = 0.5 * (nodes + 1.0)          # [0, 1]
    ws = 0.5 * wts
    mmax = 4 + 2 * nmax
    jm = _JmEvaluator(mmax, nj=nj)
    pkmu = np.empty((len(mus), 10, len(kout)))
    for i, k in enumerate(kout):
        Jm = jm(k * qf.q, 0.5 * k * k * qf.Y)   # shared across mu_k
        for a, mu in enumerate(mus):
            pkmu[a, :, i] = _columns_kmu(qf, k, f, mu, Jm, nmax=nmax)
    out = np.empty((10, len(poles), len(kout)))
    for ip, ell in enumerate(poles):
        leg = eval_legendre(ell, mus)
        # int_0^1 ... doubled for the even integrand, (2l+1)/2 normalization
        out[:, ip, :] = np.einsum(
            'a,abk->bk', (2 * ell + 1) * ws * leg, pkmu
        )
    return out


_QF_CACHE = {}


def _cached_qfuncs(klin, plin, cutoff):
    """One radial-transform build per (P_lin, cutoff): rsd and non-rsd
    template passes (and repeated CLI invocations in one process) share it."""
    import hashlib

    key = (hashlib.md5(np.ascontiguousarray(klin)).hexdigest(),
           hashlib.md5(np.ascontiguousarray(plin)).hexdigest(), cutoff)
    if key not in _QF_CACHE:
        _QF_CACHE.clear()   # hold at most one (the grids are ~100 MB)
        _QF_CACHE[key] = ZAQFuncs(klin, plin, cutoff=cutoff)
    return _QF_CACHE[key]


def zenbu_spectra_native(k, z, cfg, kin, pin, rsd=True, nmax=8, ngauss=8,
                         nj=18):
    """Drop-in ZA replacement for the reference's `zenbu_spectra`
    (zenbu_window.py:184-224): same inputs, same (11, ...) row layout (the
    11th row is unused by `combine_spectra` and is returned as zeros)."""
    from .cosmo import growth_factors

    cutoff = float(cfg['surrogate_gaussian_cutoff'])
    D, f = growth_factors(cfg['sim_name'], z, want_rsd=rsd)
    pin = np.asarray(pin, np.float64) * D**2
    k = np.asarray(k, np.float64)
    qf = _cached_qfuncs(np.asarray(kin, np.float64), pin, cutoff)
    if rsd:
        tab = za_basis_spectra(k, kin, pin, f=f, cutoff=cutoff,
                               poles=(0, 2, 4), ngauss=ngauss, nmax=nmax,
                               nj=nj, qf=qf)
        out = np.zeros((11,) + tab.shape[1:])
        out[:10] = tab
    else:
        tab = za_basis_spectra(k, kin, pin, f=0.0, cutoff=cutoff, nj=nj,
                               qf=qf)
        out = np.zeros((11, tab.shape[-1]))
        out[:10] = tab
    return out, None


def _templates_process():
    """One template process of zenbu_window._templates: reads (k, z, cfg,
    kin, pin, rsds, kw) pickled on stdin and writes the list of each rsds
    entry's zenbu_spectra_native table pickled on stdout."""
    import pickle
    import sys

    k, z, cfg, kin, pin, rsds, kw = pickle.load(sys.stdin.buffer)
    tabs = [zenbu_spectra_native(k, z, cfg, kin, pin, rsd=r, **kw)[0] for r in rsds]
    pickle.dump(tabs, sys.stdout.buffer)


if __name__ == '__main__':
    _templates_process()
