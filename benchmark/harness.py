"""One run of one cell: set-up, warm-up, the closed loop of evaluations,
the comparison with the plain reference, the result line.

Everything a cell names is found by name under the benchmark's folder:
``BENCHMARK.json`` at the root lists the cells and metrics; a cell's
configuration is its ``file``, its traffic ``traffic/<name>.json``, the
traffic's statistic ``stats/<statistic>.py``, each per-layer metric
``metrics/<name>.py`` and the cell's comparison limits
``limits/<cell>.json``. Adding a cell, a configuration, a traffic mix, a
statistic or a metric adds files and entries and edits none.

A traffic file holds: ``statistic`` (the module), ``call`` (its keyword
arguments), ``tracers`` (each tracer's fiducial HOD parameters), ``walk``
(``params``, the fitted parameters, their ``step`` width and the ``pull``
back toward the fiducial values), ``warmup`` (evaluations before the
window) and ``sample`` (evaluations of the window held to the reference).
"""

import gc
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

from benchmark import catalog, spans, trace
from benchmark.reference.precision import Precision

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'abacusutils_tpu', 'abacusnbody')


def load_json(path):
    with open(path) as f:
        return json.load(f)


def _module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A cell of BENCHMARK.json and every file it names, under `root`."""

    def __init__(self, name, root=ROOT):
        root = Path(root)
        self.spec = load_json(root / 'BENCHMARK.json')
        cells = {w['name']: w for w in self.spec['workloads']}
        if name not in cells:
            raise KeyError(f'no cell {name!r} in BENCHMARK.json')
        self.name = name
        self.entry = cells[name]
        configs = {c['name']: c for c in self.spec['configs']}
        self.config = load_json(root / configs[self.entry['config']]['file'])
        bench = root / 'benchmark'
        self.traffic = load_json(bench / 'traffic' / f'{self.entry["traffic"]}.json')
        self.stat = _module(bench / 'stats' / f'{self.traffic["statistic"]}.py',
                            f'benchmark_stat_{self.traffic["statistic"]}')
        limits = bench / 'limits' / f'{name}.json'
        self.limits = load_json(limits) if limits.exists() else {}
        self.end_to_end = [m for m in self.spec['end_to_end'] if self._here(m)]
        self.per_layer = [m for m in self.spec['per_layer'] if self._here(m)]
        self.metrics = {m['name']: _module(bench / 'metrics' / f'{m["name"]}.py',
                                           f'benchmark_metric_{m["name"]}')
                        for m in self.per_layer}

    def _here(self, metric):
        return 'workloads' not in metric or self.name in metric['workloads']


class Walk:
    """The chain's parameters: from the fiducial values, each fitted
    parameter steps by `step` times a standard normal draw and is pulled
    back by `pull` times its distance from the fiducial value (a
    mean-reverting walk, so a chain's work does not drift with its seed)."""

    def __init__(self, traffic, rng):
        self.fid = {t: dict(p) for t, p in traffic['tracers'].items()}
        w = traffic['walk']
        self.keys, self.step, self.pull = list(w['params']), float(w['step']), float(w['pull'])
        self.cur = {t: dict(p) for t, p in self.fid.items()}
        self.rng = rng

    def next(self):
        for t, p in self.cur.items():
            for k in self.keys:
                if k in p:
                    pull = self.pull * (p[k] - self.fid[t][k])
                    p[k] += self.step * self.rng.standard_normal() - pull
        return {t: dict(p) for t, p in self.cur.items()}


class Reservoir:
    """A uniform sample of `k` of the window's evaluations (Vitter's
    algorithm R), drawn from `rng` as they complete."""

    def __init__(self, k, rng):
        self.k, self.rng, self.items, self.seen = int(k), rng, [], 0

    def offer(self, item):
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.items[j] = item
        self.seen += 1


def _sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def forbidden_modules():
    """Top-level names of sys.modules that no run may load."""
    return sorted({m.split('.')[0] for m in sys.modules} & set(FORBIDDEN))


def run(cell, seed, seconds, traced, device='cuda', t_process=None, control=None,
        overrides=None):
    """One run of `cell` (a Cell): (the result line's dict, a dict of the
    run's set-up and window seconds, median evaluation ms and sampled
    evaluations). `control` ('bf16') puts the reference, in that precision,
    in the program's place. `overrides` updates the configuration's and the
    traffic's keys (the tests' small sizes)."""
    t0 = time.perf_counter() if t_process is None else t_process
    device = torch.device(device)
    cfg = dict(cell.config, **(overrides or {}).get('config', {}))
    traffic = dict(cell.traffic, **(overrides or {}).get('traffic', {}))
    stat = cell.stat
    call = traffic['call']
    rng = np.random.default_rng(int(seed))
    cat = catalog.draw(cfg, seed, device)
    _sync(device)
    if control:
        P = Precision(control)

        def program(tracers):
            return stat.reference(cat, cfg, tracers, call, P)
    else:
        from abacusutils_tpu_torch.models.hod.abacus_hod import AbacusHOD

        hod = AbacusHOD(cat[0], cat[1], catalog.hod_params(cfg), traffic['tracers'], device,
                        halo_lc=bool(cfg.get('lightcone')))

        def program(tracers):
            return stat.evaluate(hod, tracers, call)

    walk = Walk(traffic, rng)
    warm = Walk(traffic, np.random.default_rng(int(seed) + 1))
    for _ in range(0 if control else int(traffic['warmup'])):
        program(warm.next())
    _sync(device)

    sample = Reservoir(traffic['sample'], rng)
    lat, work = [], []
    failed = 0
    prof = trace.profile() if traced else None
    if prof is not None:
        from abacusutils_tpu_torch.utils import profiling

        counted = dict(profiling.counters)
        prof.__enter__()
        span = torch.profiler.record_function(trace.WINDOW)
        span.__enter__()
    t_start = time.perf_counter()
    setup_s = t_start - t0
    deadline = t_start + float(seconds)
    t_end = t_start
    i = 0
    while t_end < deadline:
        t1 = time.perf_counter()
        tracers = walk.next()
        try:
            with torch.profiler.record_function(f'bench.{traffic["statistic"]}'):
                answer, keep = program(tracers)
        except Exception as e:  # an evaluation that raises is a failed one
            failed += 1
            print(f'evaluation {i} failed: {type(e).__name__}: {e}', file=sys.stderr)
            answer = None
        t_end = time.perf_counter()
        lat.append(t_end - t1)
        if answer is not None:
            work.append(stat.work(answer, keep, call, cfg))
            sample.offer((i, tracers, answer, keep))
        # a chain keeps nothing of a step but its likelihood: the next
        # evaluation runs with this one's catalog released
        answer = keep = None
        i += 1
    window_s = t_end - t_start
    _sync(device)
    tr = None
    if prof is not None:
        counted = spans.window_counters(counted, dict(profiling.counters))
        span.__exit__(None, None, None)
        prof.__exit__(None, None, None)
        tr = trace.from_profiler(prof, window_s, len(lat), work)
        tr.counters = counted
        del prof
    peak = torch.cuda.max_memory_allocated(device) if device.type == 'cuda' else 0

    if not control:
        del hod
    del program
    gc.collect()
    if device.type == 'cuda':
        torch.cuda.empty_cache()

    numbers = {}
    ref_p = Precision('f64')
    for _, tracers, answer, keep in sample.items:
        ref, ref_keep = stat.reference(cat, cfg, tracers, call, ref_p)
        for k, v in stat.compare(answer, keep, ref, ref_keep, cfg).items():
            numbers[k] = max(numbers.get(k, 0.0), float(v))
        del ref, ref_keep
    checks = {k: {'value': v, 'limit': cell.limits.get(k, {}).get('limit')}
              for k, v in numbers.items()}
    correct = (failed == 0 and bool(lat) and bool(numbers)
               and all(c['limit'] is not None and c['value'] <= c['limit']
                       for c in checks.values()))

    metrics = {}
    if traced:
        for m in cell.per_layer:
            v = cell.metrics[m['name']].read(tr)
            if v is not None:
                metrics[m['name']] = {'value': float(v), 'unit': m['unit']}
    else:
        e2e = {
            'evals_per_s': (len(lat) / window_s if window_s > 0 else 0.0, 'evals/s'),
            'eval_p95_ms': (1e3 * float(np.percentile(lat, 95)) if lat else 0.0, 'ms'),
            'peak_mem_gib': (peak / 2**30, 'GiB'),
            'setup_s': (setup_s, 's'),
        }
        for m in cell.end_to_end:
            v, unit = e2e[m['name']]
            metrics[m['name']] = {'value': float(v), 'unit': unit}

    dev = {'platform': 'gpu' if device.type == 'cuda' else device.type,
           'kind': torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu',
           'count': 1, 'memory_peak_bytes': int(peak)}
    if tr is not None:
        dev['busy_s'] = tr.busy_s
        dev['window_s'] = tr.window_s
    result = {'correct': bool(correct), 'attempted': len(lat), 'failed': failed,
              'metrics': metrics, 'device': dev}
    if tr is not None:
        result['breakdown'] = tr.breakdown
    result['checks'] = checks
    extra = {'setup_s': setup_s, 'window_s': window_s,
             'eval_median_ms': 1e3 * statistics.median(lat) if lat else None,
             'sampled': [s[0] for s in sample.items]}
    return result, extra
