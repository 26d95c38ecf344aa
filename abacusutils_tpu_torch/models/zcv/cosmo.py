"""Growth factors and the zenbu/zcv cosmology config from the metadata
registry (the counterpart of abacusutils_tpu/models/zcv/cosmo.py):
``get_meta`` is abacusutils_tpu_torch.metadata's.
"""

import numpy as np

from ...metadata import get_meta

__all__ = ['get_meta', 'growth_factors', 'growth_from_meta', 'get_meta_cfg']


def _table_lookup(table, z):
    keys = np.array(sorted(table))
    i = np.argmin(np.abs(keys - z))
    if abs(keys[i] - z) > 1e-4 * (1 + abs(z)):
        # interpolate in log(a)
        a = 1 / (1 + keys)
        vals = np.array([table[k] for k in keys])
        return float(np.interp(1 / (1 + z), a[::-1], vals[::-1]))
    return float(table[keys[i]])


def growth_from_meta(meta, z_this, want_rsd=True):
    """(D(z_this)/D(z_ic), f(z_this)) from a :func:`get_meta` dict at
    z_this."""
    gt = meta['GrowthTable']
    D = _table_lookup(gt, z_this) / _table_lookup(gt, meta['InitialRedshift'])
    f_growth = float(meta.get('f_growth', 0.0)) if want_rsd else 0.0
    return D, f_growth


def growth_factors(sim_name, z_this, want_rsd=True):
    """Return (D(z_this)/D(z_ic), f(z_this)) for the simulation."""
    return growth_from_meta(get_meta(sim_name, redshift=z_this), z_this, want_rsd)


def get_meta_cfg(sim_name, z_this):
    """cfg dict used by the zenbu/zcv layer (reference get_cfg
    tools_cv.py:500-531)."""
    meta = get_meta(sim_name, redshift=z_this)
    cosmo = {'output': 'mPk mTk', 'P_k_max_h/Mpc': 20.0}
    for k in (
        'H0', 'omega_b', 'omega_cdm', 'omega_ncdm', 'N_ncdm', 'N_ur',
        'n_s', 'A_s', 'alpha_s',
    ):
        cosmo[k] = meta[k]
    return {'lbox': meta['BoxSize'], 'Cosmology': cosmo, 'z_ic': meta['InitialRedshift']}
