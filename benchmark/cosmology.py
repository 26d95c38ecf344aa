"""The linear matter power spectrum the clustered catalogs are drawn from.

Eisenstein & Hu (1998, ApJ 496, 605), eq. 26-31: the transfer function
without baryon wiggles. The primordial slope is n_s, the amplitude is set by
sigma_8 at z = 0, and the linear growth factor of a flat LambdaCDM
cosmology (Heath 1977) carries it to the catalog's redshift. Wavenumbers are
in h/Mpc, the power in (Mpc/h)^3. Every function takes numpy arrays; the
power itself also takes torch tensors (``xp=torch``), so the catalog draws
its Gaussian field on the device.
"""

import math

import numpy as np
from scipy.integrate import quad

T_CMB = 2.7255  # K, Fixsen (2009)
C_KMS = 299792.458


def _e(z, om):
    return math.sqrt(om * (1.0 + z) ** 3 + 1.0 - om)


def growth(z, om):
    """D(z) / D(0) of a flat LambdaCDM cosmology (Heath 1977)."""
    def d(a):
        e = lambda x: math.sqrt(om / x**3 + 1.0 - om)  # noqa: E731
        return e(a) * quad(lambda x: 1.0 / (x * e(x)) ** 3, 0.0, a)[0]

    return d(1.0 / (1.0 + z)) / d(1.0)


def comoving_distance(z, om):
    """The comoving distance to redshift z in Mpc/h (flat)."""
    return C_KMS / 100.0 * quad(lambda x: 1.0 / _e(x, om), 0.0, z)[0]


def velz2kms(z, om):
    """km/s of peculiar velocity a Mpc/h of redshift-space displacement:
    H(z) a, in (km/s) / (Mpc/h)."""
    return 100.0 * _e(z, om) / (1.0 + z)


def transfer_nowiggle(k, c, xp=np):
    """EH98's no-wiggle transfer function at k (h/Mpc); `c` holds h,
    omega_m (Omega_m h^2 with neutrinos), omega_b."""
    h = c['h']
    om, ob = c['omega_m'], c['omega_b']
    fb = ob / om
    theta = T_CMB / 2.7
    s = 44.5 * math.log(9.83 / om) / math.sqrt(1.0 + 10.0 * ob**0.75)
    alpha = 1.0 - 0.328 * math.log(431.0 * om) * fb + 0.38 * math.log(22.3 * om) * fb**2
    kmpc = k * h
    gamma = (om / h) * (alpha + (1.0 - alpha) / (1.0 + (0.43 * kmpc * s) ** 4))
    q = k * theta**2 / gamma
    big_l = xp.log(2.0 * math.e + 1.8 * q)
    big_c = 14.2 + 731.0 / (1.0 + 62.5 * q)
    return big_l / (big_l + big_c * q * q)


def _shape(k, c, xp=np):
    return k ** c['n_s'] * transfer_nowiggle(k, c, xp) ** 2


def sigma8_norm(c):
    """The amplitude A with sigma(8 Mpc/h) = sigma_8 for P = A k^n_s T^2."""
    def w(x):
        return 3.0 * (math.sin(x) - x * math.cos(x)) / x**3

    def integrand(lnk):
        k = math.exp(lnk)
        return k**3 * float(_shape(np.float64(k), c)) * w(8.0 * k) ** 2 / (2.0 * math.pi**2)

    s2 = quad(integrand, math.log(1e-5), math.log(1e2), limit=400)[0]
    return c['sigma8'] ** 2 / s2


def power_at_z(k, c, z, xp=np):
    """Linear P(k) at redshift z, (Mpc/h)^3; k = 0 gives 0."""
    amp = sigma8_norm(c) * growth(z, c['Omega_m']) ** 2
    return amp * _shape(k, c, xp)
