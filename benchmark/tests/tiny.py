"""Small sizes of the benchmark's cells for the CPU tests: the port's plain
PyTorch paths and the reference agree there as they do at the cells' own
sizes on the card.

Every cell runs on a box of 10^4 halos (the light cone keeps its octant)
with a 32^3 field and one warm-up; a statistic changes its call's sizes, or
the catalog's, by its module's ``SMALL`` (``benchmark/stats/__init__.py``)."""

import torch

from benchmark import harness

_CONFIG = {'n_halo': 10_000, 'n_part': 50_000, 'field': {'ngrid': 32, 'bias': 1.3}}


def overrides(cell):
    small = getattr(cell.stat, 'SMALL', {})
    return {'config': dict(_CONFIG, **small.get('config', {})),
            'traffic': {'call': dict(cell.traffic['call'], **small.get('call', {})),
                        'warmup': 1}}


def run(name, seconds=1.0, seed=2**31 + 7, control=None, root=harness.ROOT):
    """One run of cell `name` at its small size on the CPU: (result, extra)."""
    torch.set_num_threads(2)
    cell = harness.Cell(name, root)
    return harness.run(cell, seed, seconds, False, 'cpu', control=control,
                       overrides=overrides(cell))


def cells(root=harness.ROOT):
    return [w['name'] for w in harness.load_json(root / 'BENCHMARK.json')['workloads']]
