#!/usr/bin/env python3
"""Run chip_smoke.py's disk phases alone on one GPU: phase 1 (the kernels'
build and the card's name and power limit), phase 16 (the box's disk path)
and phase 17 (the light cone's), in about half the whole script's time.

    python3 scripts/torch/disk_phases.py

Prints the phases' lines, then each main path's launches; exits non-zero
when a phase's check fails.
"""

import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
import chip_smoke as cs  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print('disk_phases: no CUDA device', file=sys.stderr)
        return 1
    dev = torch.device('cuda', 0)
    torch.cuda.set_device(dev)
    t0 = time.perf_counter()
    paths = {}
    try:
        cs.phase_build()
        cs.phase_disk(dev, paths)
        cs.phase_lc_disk(dev, paths)
    except cs.PhaseError as e:
        print(f'disk_phases: FAILED: {e}', file=sys.stderr)
        return 1
    for path, launches in paths.items():
        print(f'{path}: launches {({k: v for k, v in launches.items() if v})}')
    print(f'disk_phases: phases 1, 16, 17 in {time.perf_counter() - t0:.1f} s')
    return 0


if __name__ == '__main__':  # the spawned pool of phase 16 (c) imports this file
    sys.exit(main())
