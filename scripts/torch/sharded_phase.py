#!/usr/bin/env python3
"""Run phase 20 of chip_smoke.py (the sharded path) alone, on seeded inputs.

    python3 scripts/torch/sharded_phase.py

Needs a CUDA device; with several cards, phase 20 spawns a rank a card. The
phase takes phase 7's LRG positions and phase 8's sparse QSO sample from the
earlier phases; here they are 10^7 and 8x10^4 points drawn uniformly over
the box (seed 5), in box-centred coordinates as those phases give them.
Prints phase 20's lines: each sharded call against the unsharded one (P(k)
with its worst bin against calc_power), the slab kernels against their plain
versions, seconds, launches and peak memory.
"""

import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import chip_smoke as cs  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print('sharded_phase: no CUDA device', file=sys.stderr)
        return 1
    dev = torch.device('cuda', 0)
    torch.cuda.set_device(dev)
    cs.phase_build()
    rng = np.random.default_rng(5)
    pk_pos = (rng.random((10_000_000, 3)) * cs.LBOX - cs.LBOX / 2).astype(np.float32)
    qso = (rng.random((80_000, 3)) * cs.LBOX - cs.LBOX / 2).astype(np.float32)
    paths, timing = {}, {}
    t0 = time.perf_counter()
    cs.phase_sharded(dev, paths, timing, pk_pos, qso)
    print(f'phase 20 alone in {time.perf_counter() - t0:.1f} s')
    return 0


if __name__ == '__main__':
    sys.exit(main())
