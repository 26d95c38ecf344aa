"""Growth factors and cosmology from the package's metadata extract
(the counterpart of abacusutils_tpu/models/zcv/cosmo.py).

The JAX package reads them with ``get_meta`` from its ASDF metadata bundle,
whose reader needs msgpack and zstandard. The port reads a numpy extract of
the same values, ``data/zcv_meta.npz``, written by
``scripts/torch/zcv_meta_extract.py``: per simulation the box size, initial
redshift, cosmology and growth table, per redshift ``f_growth``, and the
cosmology's CLASS linear P(k).
"""

import json
from functools import cache
from pathlib import Path

import numpy as np

__all__ = ['META_EXTRACT', 'get_meta', 'growth_factors', 'growth_from_meta', 'get_meta_cfg']

META_EXTRACT = Path(__file__).resolve().parents[2] / 'data' / 'zcv_meta.npz'
_SCRIPT = 'scripts/torch/zcv_meta_extract.py'


@cache
def _extract():
    with np.load(META_EXTRACT) as f:
        tree = json.loads(str(f['meta_json']))
        arrays = {k: f[k] for k in f.files if k != 'meta_json'}
    return tree, arrays


def get_meta(sim_name, redshift=None):
    """The extract's metadata of `sim_name` (at `redshift` when given) in the
    layout of the JAX package's ``get_meta``: ``GrowthTable`` a dict of
    redshift -> D, ``CLASS_power_spectrum`` a dict of the 'k (h/Mpc)' and
    'P (Mpc/h)^3' arrays. Raises for a simulation or redshift the extract
    does not hold."""
    tree, arrays = _extract()
    if sim_name not in tree:
        raise ValueError(
            f'simulation {sim_name!r} is not in the metadata extract {META_EXTRACT.name} '
            f'({", ".join(tree)}); add it to {_SCRIPT} and run it'
        )
    rec = tree[sim_name]
    meta = dict(rec['param'])
    meta['GrowthTable'] = {z: d for z, d in meta['GrowthTable']}
    cosmo = rec['class']
    meta['CLASS_power_spectrum'] = {
        'k (h/Mpc)': arrays[f'class_k_{cosmo}'], 'P (Mpc/h)^3': arrays[f'class_p_{cosmo}'],
    }
    if redshift is not None:
        key = f'z{float(redshift):.3f}'
        if key not in rec['state']:
            raise ValueError(
                f'redshift {redshift} of {sim_name!r} is not in the metadata extract '
                f'{META_EXTRACT.name} ({", ".join(rec["state"])}); add it to {_SCRIPT} and run it'
            )
        meta.update(rec['state'][key])
    return meta


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
