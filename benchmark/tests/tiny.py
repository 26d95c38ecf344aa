"""Small sizes of the benchmark's cells for the CPU tests: the port's plain
PyTorch paths and the reference agree there as they do at the cells' own
sizes on the card."""

import torch

from benchmark import harness

# a box of 10^4 halos (the light cone keeps its octant), a 32^3 field;
# meshes of 32 (fused) and 40 (two-step) cells; the LRG pair counts on 4,000
# halos, where the all-pairs plain count stays quick
_CONFIG = {'n_halo': 10_000, 'n_part': 50_000, 'field': {'ngrid': 32, 'bias': 1.3}}
_CALL = {
    'pk_fused': {'nmesh': 32, 'nbins_k': 16},
    'xirppi': {},
    'power': {'num_cells': 40, 'nbins_k': 16, 'k_hMpc_max': 0.06},
}
_SMALLER = {'xirppi': {'n_halo': 4_000, 'n_part': 20_000}}


def overrides(cell):
    stat = cell.traffic['statistic']
    call = dict(cell.traffic['call'], **_CALL[stat])
    return {'config': dict(_CONFIG, **_SMALLER.get(stat, {})),
            'traffic': {'call': call, 'warmup': 1}}


def run(name, seconds=1.0, seed=2**31 + 7, control=None, root=harness.ROOT):
    """One run of cell `name` at its small size on the CPU: (result, extra)."""
    torch.set_num_threads(2)
    cell = harness.Cell(name, root)
    return harness.run(cell, seed, seconds, False, 'cpu', control=control,
                       overrides=overrides(cell))


def cells(root=harness.ROOT):
    return [w['name'] for w in harness.load_json(root / 'BENCHMARK.json')['workloads']]
