#!/usr/bin/env python3
"""Plot the chains of run_emcee.py (the counterpart of
scripts/hod/plot_chains.py). Needs ``matplotlib``, imported by :func:`main`
only. The config is a JSON file or a dict (``fit_params``,
``ch_config_params``).

$ python scripts/torch/hod/plot_chains.py --path2config config/abacus_hod.json
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


def main(path2config):
    import matplotlib

    matplotlib.use('Agg')
    import matplotlib.pyplot as plt

    config = load_config(path2config)
    ch = config['ch_config_params']
    chain = np.load(os.path.join(ch['path2output'], ch['chainsPrefix'] + '_chain.npy'))
    nsteps, nwalkers, nparams = chain.shape
    names = sorted(config['fit_params'], key=lambda k: config['fit_params'][k][0])

    fig, axes = plt.subplots(nparams, 1, figsize=(8, 2 * nparams), sharex=True)
    axes = np.atleast_1d(axes)
    for i, ax in enumerate(axes):
        ax.plot(chain[:, :, i], alpha=0.3, lw=0.5)
        ax.set_ylabel(names[i])
    axes[-1].set_xlabel('step')
    out = os.path.join(ch['path2output'], ch['chainsPrefix'] + '_chains.png')
    fig.savefig(out, dpi=120, bbox_inches='tight')
    print('saved', out)
    return out


if __name__ == '__main__':
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument('--path2config', default=DEFAULT_CONFIG)
    main(**vars(parser.parse_args()))
