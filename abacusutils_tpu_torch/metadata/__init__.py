"""The per-simulation metadata registry: cosmology, code parameters and
per-redshift state (the counterpart of abacusutils_tpu/metadata/__init__.py).

The bundles ``abacussummit_headers_compressed.asdf`` and
``abacusdesi2_headers_compressed.asdf`` hold, per simulation, msgpack
``param`` and ``state`` tables and a CLASS linear power spectrum. They are
read with the package's own ASDF reader and msgpack decoder (_msgpack.py),
from ``$ABACUS_METADATA_DIR`` and then from this package's directory.
AbacusSummit boxes absent from the bundles are synthesized from a bundled
one of the same cosmology (:func:`_synthesize_summit`), and a redshift a
synthesized entry lacks from its growth table (:func:`_synthesize_state`).
No device is used.
"""

import copy
import os
import re
from pathlib import Path

import numpy as np

from ..io.asdf_file import open_asdf
from ._msgpack import loads

__all__ = ['get_meta']

metadata = None
metadata_fns = [
    'abacussummit_headers_compressed.asdf',
    'abacusdesi2_headers_compressed.asdf',
]


def _search_dirs():
    return [os.environ.get('ABACUS_METADATA_DIR'), str(Path(__file__).parent)]


def _load_all():
    """Fill the module's `metadata` from every bundle of the search
    directories; a simulation found earlier is kept (metadata/__init__.py:
    _load_all)."""
    global metadata
    metadata = {}
    dirs = _search_dirs()
    for d in dirs:
        if not d or not Path(d).is_dir():
            continue
        for fn in metadata_fns:
            p = Path(d) / fn
            if not p.is_file():
                continue
            af = open_asdf(p)
            tree = dict(af.tree)
            tree.pop('asdf_library', None)
            tree.pop('history', None)
            for sim, rec in tree.items():
                if sim in metadata:
                    continue
                entry = {
                    'param': loads(np.asarray(rec['param']).tobytes()),
                    'state': loads(np.asarray(rec['state']).tobytes()),
                }
                if 'CLASS_power_spectrum' in rec:
                    # a dict of the file's lazy arrays, read now; or a Table
                    spec = rec['CLASS_power_spectrum']
                    if isinstance(spec, dict):
                        spec = {k: np.asarray(v) for k, v in spec.items()}
                    entry['CLASS_power_spectrum'] = spec
                metadata[sim] = entry
    if not metadata:
        raise FileNotFoundError(
            f'No metadata bundles {metadata_fns} found in search dirs '
            f'{[d for d in dirs if d]}. Set $ABACUS_METADATA_DIR.'
        )


# the AbacusSummit box classes (the public data model): box size, Mpc/h, and
# particles per dimension, for synthesizing a box the bundles lack
_SUMMIT_BOX = {
    'base': (2000.0, 6912),
    'highbase': (2000.0, 6912),
    'hugebase': (2000.0, 2304),
    'high': (1000.0, 6300),
    'huge': (7500.0, 8640),
    'small': (500.0, 1728),
    'fixedbase': (1185.0, 4096),
}

RHO_CRIT = 2.77536627e11  # Msun/h / (Mpc/h)^3


def _synthesize_summit(simname):
    """An AbacusSummit box's entry from the first loaded entry of the same
    cosmology (cXXX): its tables carried over, the box size, particle count
    and particle mass of the box class recomputed (metadata/__init__.py:
    _synthesize_summit). None when there is no such box class or donor."""
    m = re.match(r'AbacusSummit_([a-z]+)_c(\d+)_ph(\d+)', simname)
    if not m:
        return None
    boxtype, cosm = m.group(1), m.group(2)
    if boxtype not in _SUMMIT_BOX:
        return None
    donor = next((e for name, e in metadata.items() if f'_c{cosm}_' in name), None)
    if donor is None:
        return None
    box, ppd = _SUMMIT_BOX[boxtype]
    # the CLASS spectrum is shared, not copied
    new = {k: (copy.deepcopy(v) if k != 'CLASS_power_spectrum' else v) for k, v in donor.items()}
    p = new['param']
    om = p.get('Omega_M', p.get('omega_cdm', 0.12) / (p.get('H0', 67.36) / 100) ** 2)
    p['SimName'] = simname
    p['BoxSize'] = box
    p['BoxSizeHMpc'] = box
    p['NP'] = ppd**3
    p['ppd'] = float(ppd)
    p['ParticleMassHMsun'] = RHO_CRIT * om * (box / ppd) ** 3
    p['_synthesized_from'] = donor['param'].get('SimName', '?')
    return new


def get_meta(simname, redshift=None):
    """The time-independent metadata of a simulation by name, updated with
    its state at `redshift` (a number or a 'zX.XXX' string) when given
    (metadata/__init__.py:get_meta). Raises ValueError for a simulation or
    redshift the registry neither holds nor can synthesize."""
    if not simname.startswith('Abacus'):
        raise ValueError(
            f'It is unknown what simulation set "{simname}" belongs to '
            'based on the simulation name.'
        )
    if metadata is None:
        _load_all()

    if simname not in metadata:
        synth = _synthesize_summit(simname)
        if synth is not None:
            metadata[simname] = synth
    if simname not in metadata:
        raise ValueError(
            f'Simulation "{simname}" is not in metadata files "{metadata_fns}"'
        )

    # a bundle may store the CLASS spectrum once per cosmology
    if 'CLASS_power_spectrum' not in metadata[simname]:
        spec = _same_cosmology_spectrum(simname)
        if spec is not None:
            metadata[simname]['CLASS_power_spectrum'] = spec

    res = dict(metadata[simname]['param'])
    if 'CLASS_power_spectrum' in metadata[simname]:
        res['CLASS_power_spectrum'] = metadata[simname]['CLASS_power_spectrum']

    if redshift is not None:
        zval = redshift if not isinstance(redshift, str) else float(redshift.lstrip('z'))
        if not isinstance(redshift, str):
            redshift = f'z{redshift:.3f}'
        if not redshift.startswith('z'):
            redshift = 'z' + redshift
        state = metadata[simname]['state'].get(redshift)
        if state is None and '_synthesized_from' in metadata[simname]['param']:
            state = _synthesize_state(metadata[simname]['param'], zval)
        if state is None:
            raise ValueError(
                f'Redshift {redshift} metadata not present for "{simname}" '
                f'in metadata files "{metadata_fns}"'
            )
        res.update(state)
    return res


def _same_cosmology_spectrum(simname):
    """The CLASS spectrum of a loaded entry of the same cosmology (cXXX), or
    None."""
    m = re.search(r'_c(\d+)_', simname)
    if not m:
        return None
    tag = f'_c{m.group(1)}_'
    return next((e['CLASS_power_spectrum'] for name, e in metadata.items()
                 if tag in name and 'CLASS_power_spectrum' in e), None)


def _synthesize_state(param, z):
    """Redshift, ScaleFactor, Growth and f_growth at z from the growth table
    (log D against log a, interpolated; f by a centred difference of 1e-3
    in log a), for a synthesized entry without that output redshift."""
    gt = param.get('GrowthTable')
    if not gt:
        return None
    zs = np.array(sorted(gt))
    Ds = np.array([gt[k] for k in zs])
    lna = np.log(1 / (1 + zs))[::-1]
    lnD = np.log(Ds)[::-1]
    lna_z = np.log(1 / (1 + z))
    D_z = float(np.exp(np.interp(lna_z, lna, lnD)))
    eps = 1e-3
    f = float((np.interp(lna_z + eps, lna, lnD) - np.interp(lna_z - eps, lna, lnD)) / (2 * eps))
    return {'Redshift': z, 'ScaleFactor': 1.0 / (1 + z), 'Growth': D_z, 'f_growth': f}
