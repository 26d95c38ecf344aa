#!/usr/bin/env python3
"""Write the metadata extract the torch package's ZCV port and its
synthetic AbacusSummit catalog read.

    python scripts/torch/zcv_meta_extract.py [--out PATH]

The ZCV precompute needs, for a simulation and redshift, the growth table,
the initial redshift, f_growth, the box size, the cosmology that
``get_meta_cfg`` reads and the CLASS linear P(k). They live in the JAX
package's ``metadata/abacussummit_headers_compressed.asdf``, whose reader
needs msgpack and zstandard. This script reads them there, on the CPU, and
writes a plain numpy ``.npz`` into ``abacusutils_tpu_torch/data/`` (by
default): one JSON string with every scalar and table of each (simulation,
redshift), and one (k, P) array pair for each cosmology's CLASS spectrum.
The header keys of HEADER_KEYS feed ``abacusutils_tpu_torch.testing.
summit_header``.

Add a simulation or a redshift to SIMS / REDSHIFTS and run it again.
"""

import argparse
import json
import re
from pathlib import Path

import numpy as np

from abacusutils_tpu.metadata import get_meta

SIMS = ('AbacusSummit_base_c000_ph000', 'AbacusSummit_base_c000_ph006')
REDSHIFTS = (0.5, 0.8)
# the time-independent keys the ZCV modules read
PARAM_KEYS = (
    'SimName', 'BoxSize', 'InitialRedshift', 'H0', 'omega_b', 'omega_cdm', 'omega_ncdm',
    'N_ncdm', 'N_ur', 'n_s', 'A_s', 'alpha_s',
)
# the time-independent keys of a halo_info header that the synthetic
# catalog of abacusutils_tpu_torch/testing.py takes from the metadata
HEADER_KEYS = ('Omega_M', 'Omega_DE', 'ppd', 'ParticleMassHMsun', 'ParticleSubsampleA',
               'ParticleSubsampleB')
# the per-redshift keys
STATE_KEYS = ('Redshift', 'f_growth', 'Growth', 'ScaleFactor')
OUT = Path(__file__).resolve().parents[2] / 'abacusutils_tpu_torch' / 'data' / 'zcv_meta.npz'


def extract(sims=SIMS, redshifts=REDSHIFTS):
    """(the JSON tree, {array name: array}) of the extract."""
    tree, arrays = {}, {}
    for sim in sims:
        cosmo = re.search(r'_(c\d+)_', sim).group(1)
        base = get_meta(sim)
        param = {k: base[k] for k in PARAM_KEYS + HEADER_KEYS}
        gt = base['GrowthTable']
        param['GrowthTable'] = [[float(z), float(gt[z])] for z in sorted(gt)]
        states = {}
        for z in redshifts:
            meta = get_meta(sim, redshift=z)
            states[f'z{z:.3f}'] = {k: meta[k] for k in STATE_KEYS if k in meta}
        tree[sim] = {'param': param, 'state': states, 'class': cosmo}
        spec = base['CLASS_power_spectrum']
        k = np.asarray(spec['k (h/Mpc)'], np.float64)
        p = np.asarray(spec['P (Mpc/h)^3'], np.float64)
        if f'class_k_{cosmo}' in arrays:
            assert np.array_equal(arrays[f'class_k_{cosmo}'], k)
            assert np.array_equal(arrays[f'class_p_{cosmo}'], p)
        arrays[f'class_k_{cosmo}'] = k
        arrays[f'class_p_{cosmo}'] = p
    return tree, arrays


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--out', type=Path, default=OUT)
    args = ap.parse_args()
    tree, arrays = extract()
    args.out.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(args.out, meta_json=np.array(json.dumps(tree, sort_keys=True)), **arrays)
    print(f'wrote {args.out} ({args.out.stat().st_size} bytes): {", ".join(tree)} at '
          f'{", ".join(f"z = {z}" for z in REDSHIFTS)}')


if __name__ == '__main__':
    main()
