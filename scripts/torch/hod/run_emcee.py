#!/usr/bin/env python3
"""emcee sampling of HOD parameters against clustering data on the card
(the counterpart of scripts/hod/run_emcee.py). Needs the ``emcee`` package,
which is imported by :func:`main` only; :func:`lnprob`, the likelihood of
one parameter vector, runs without it. The config is a JSON file or a dict
(``sim_params``, ``HOD_params``, ``clustering_params``, ``data_params``,
``fit_params``, ``ch_config_params``).

$ python scripts/torch/hod/run_emcee.py --path2config config/abacus_hod.json
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
    """The log-likelihood of the parameter vector `p`: each fitted parameter
    set on its tracer of `Ball` (an AbacusHOD), one mock, its clustering
    (``Ball.clustering_type`` at the object's bins) against `Data`."""
    for key in param_mapping.keys():
        mapping_idx = param_mapping[key]
        tracer_type = param_tracer[key]
        Ball.tracers[tracer_type][key] = p[mapping_idx]

    mock_dict = Ball.run_hod(Ball.tracers, Ball.want_rsd, write_to_disk=False)
    clustering = Ball.compute_clustering(mock_dict, Ball.rpbins, Ball.pimax, Ball.pi_bin_size)
    return Data.compute_likelihood(clustering)


def main(path2config, device=None):
    try:
        import emcee
    except ImportError as e:
        raise SystemExit('emcee is not installed in this environment') from e

    config = load_config(path2config)
    fit_params = config['fit_params']
    ch_config_params = config['ch_config_params']

    newData = Data(config['data_params'], config['HOD_params'])
    newBall = AbacusHOD.from_config(config['sim_params'], config['HOD_params'],
                                    config['clustering_params'], device=device)

    nparams = len(fit_params.keys())
    param_mapping = {}
    param_tracer = {}
    params = np.zeros((nparams, 4))
    for key in fit_params.keys():
        mapping_idx = fit_params[key][0]
        tracer_type = fit_params[key][-1]
        param_mapping[key] = mapping_idx
        param_tracer[key] = tracer_type
        params[mapping_idx, :] = fit_params[key][1:-1]

    nwalkers = nparams * ch_config_params['walkersRatio']
    nsteps = ch_config_params['sampleIterations']

    p0 = params[:, 0] + params[:, 3] * np.random.normal(size=(nwalkers, nparams))
    sampler = emcee.EnsembleSampler(nwalkers, nparams, lnprob,
                                    args=(param_mapping, param_tracer, newData, newBall))
    os.makedirs(ch_config_params['path2output'], exist_ok=True)
    sampler.run_mcmc(p0, nsteps, progress=True)
    np.save(os.path.join(ch_config_params['path2output'],
                         ch_config_params['chainsPrefix'] + '_chain.npy'), sampler.get_chain())


if __name__ == '__main__':
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument('--path2config', default=DEFAULTS['path2config'])
    parser.add_argument('--device', help='torch device (default: the card)')
    main(**vars(parser.parse_args()))
