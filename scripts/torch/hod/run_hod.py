#!/usr/bin/env python3
"""Generate HOD mock catalogs and time the run_hod + compute_xirppi loop on
the card (the counterpart of scripts/hod/run_hod.py). The config is a JSON
file or a dict (``sim_params``, ``HOD_params``, ``clustering_params``);
prepare_sim's tables must exist under ``subsample_dir``.

$ python scripts/torch/hod/run_hod.py --path2config config/abacus_hod.json --ntest 20
"""

import argparse
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[3]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from abacusutils_tpu_torch.config import DEFAULT_CONFIG, load_config  # noqa: E402
from abacusutils_tpu_torch.models.hod.abacus_hod import AbacusHOD  # noqa: E402

DEFAULTS = {'path2config': DEFAULT_CONFIG}


def main(path2config, ntest=20, device=None):
    """Stage the simulation (``AbacusHOD.from_config``), run one mock (written
    to disk when ``HOD_params['write_to_disk']``) and its xi(rp, pi), then
    `ntest` timed rounds of run_hod and compute_xirppi. Returns {'xi_first':
    the first call's seconds, 'run_hod': [seconds], 'xi': [seconds],
    'meantime': the mean xi seconds, 'mock': the first mock, 'xirppi': its
    clustering}."""
    config = load_config(path2config)
    sim_params = config['sim_params']
    HOD_params = config['HOD_params']
    clustering_params = config['clustering_params']

    want_rsd = HOD_params['want_rsd']
    write_to_disk = HOD_params.get('write_to_disk', False)

    ball = AbacusHOD.from_config(sim_params, HOD_params, clustering_params, device=device)
    rpbins, pimax, pi_bin_size = ball.rpbins, ball.pimax, ball.pi_bin_size

    # the first call builds the stages (and writes the catalogs if asked)
    mock_dict = ball.run_hod(ball.tracers, want_rsd, write_to_disk=write_to_disk)
    start = time.time()
    xirppi = ball.compute_xirppi(mock_dict, rpbins, pimax, pi_bin_size)
    out = {'xi_first': time.time() - start, 'run_hod': [], 'xi': [], 'mock': mock_dict,
           'xirppi': xirppi}
    print('Done xi, total time ', out['xi_first'])

    meantime = 0.0
    for i in range(ntest):
        start = time.time()
        mock = ball.run_hod(ball.tracers, want_rsd, write_to_disk=False)
        out['run_hod'].append(time.time() - start)
        print(f'[{i}] run_hod took', out['run_hod'][-1])
        start = time.time()
        ball.compute_xirppi(mock, rpbins, pimax, pi_bin_size)
        deltat = time.time() - start
        out['xi'].append(deltat)
        print(f'[{i}] xi took', deltat)
        meantime += deltat
    out['meantime'] = meantime / ntest if ntest else float('nan')
    print('meantime ', out['meantime'])
    return out


if __name__ == '__main__':
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument('--path2config', default=DEFAULTS['path2config'])
    parser.add_argument('--ntest', type=int, default=20)
    parser.add_argument('--device', help='torch device (default: the card)')
    main(**vars(parser.parse_args()))
