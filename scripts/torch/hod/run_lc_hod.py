#!/usr/bin/env python3
"""Generate light-cone HOD mock catalogs on the card (the counterpart of
scripts/hod/run_lc_hod.py). The config is a JSON file or a dict whose
``sim_params`` has ``halo_lc`` true; the catalogs are written under the
mock directory unless ``HOD_params['write_to_disk']`` is false.

$ python scripts/torch/hod/run_lc_hod.py --path2config config/abacus_lc_hod.json
"""

import argparse
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[3]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from abacusutils_tpu_torch.config import load_config  # noqa: E402
from abacusutils_tpu_torch.models.hod.abacus_hod import AbacusHOD  # noqa: E402

DEFAULTS = {'path2config': 'config/abacus_lc_hod.json'}


def main(path2config, device=None):
    """Stage the light cone, run one mock and print each tracer's count.
    Returns the mock dict."""
    config = load_config(path2config)
    ball = AbacusHOD.from_config(config['sim_params'], config['HOD_params'],
                                 config.get('clustering_params'), device=device)
    mock_dict = ball.run_hod(ball.tracers, config['HOD_params']['want_rsd'],
                             write_to_disk=config['HOD_params'].get('write_to_disk', True))
    for tr in mock_dict:
        print(tr, 'galaxies:', len(mock_dict[tr]['x']), 'Ncent:', mock_dict[tr]['Ncent'])
    return mock_dict


if __name__ == '__main__':
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument('--path2config', default=DEFAULTS['path2config'])
    parser.add_argument('--device', help='torch device (default: the card)')
    main(**vars(parser.parse_args()))
