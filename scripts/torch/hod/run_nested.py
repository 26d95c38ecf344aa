#!/usr/bin/env python3
"""Nested sampling of HOD parameters with dynesty on the card (the
counterpart of scripts/hod/run_nested.py). Needs the ``dynesty`` package,
which is imported by :func:`main` only; :func:`lnprob` runs without it. The
config is a JSON file or a dict, as run_emcee.py's.

$ python scripts/torch/hod/run_nested.py --path2config config/abacus_hod.json
"""

import argparse
import os
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[3]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from abacusutils_tpu_torch.config import DEFAULT_CONFIG, load_config  # noqa: E402
from abacusutils_tpu_torch.models.hod.abacus_hod import AbacusHOD  # noqa: E402
from scripts.torch.hod.likelihood import Data  # noqa: E402

DEFAULTS = {'path2config': DEFAULT_CONFIG}


def lnprob(p, param_mapping, param_tracer, Data, Ball):
    """The log-likelihood of the parameter vector `p` (run_emcee.lnprob's)."""
    for key in param_mapping.keys():
        Ball.tracers[param_tracer[key]][key] = p[param_mapping[key]]
    mock_dict = Ball.run_hod(Ball.tracers, Ball.want_rsd, write_to_disk=False)
    clustering = Ball.compute_clustering(mock_dict, Ball.rpbins, Ball.pimax, Ball.pi_bin_size)
    return Data.compute_likelihood(clustering)


def main(path2config, device=None):
    try:
        import dynesty
    except ImportError as e:
        raise SystemExit('dynesty is not installed in this environment') from e

    config = load_config(path2config)
    fit_params = config['fit_params']
    ch = config['ch_config_params']

    newData = Data(config['data_params'], config['HOD_params'])
    newBall = AbacusHOD.from_config(config['sim_params'], config['HOD_params'],
                                    config['clustering_params'], device=device)

    nparams = len(fit_params)
    param_mapping = {}
    param_tracer = {}
    bounds = np.zeros((nparams, 2))
    for key, spec in fit_params.items():
        idx, mean, lo, hi, std, tracer = spec
        param_mapping[key] = idx
        param_tracer[key] = tracer
        bounds[idx] = (lo, hi)

    def prior_transform(u):
        return bounds[:, 0] + u * (bounds[:, 1] - bounds[:, 0])

    sampler = dynesty.NestedSampler(
        lnprob, prior_transform, nparams,
        logl_args=(param_mapping, param_tracer, newData, newBall), nlive=ch.get('nlive', 500),
    )
    sampler.run_nested()
    os.makedirs(ch['path2output'], exist_ok=True)
    np.save(os.path.join(ch['path2output'], ch['chainsPrefix'] + '_results.npy'),
            sampler.results.samples)


if __name__ == '__main__':
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument('--path2config', default=DEFAULTS['path2config'])
    parser.add_argument('--device', help='torch device (default: the card)')
    main(**vars(parser.parse_args()))
