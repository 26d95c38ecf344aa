"""Every cell of BENCHMARK.json loads by name and runs at a small size on
the CPU, through the port's plain paths, with the reference agreeing; a new
configuration, traffic mix, statistic (with its answer fault), per-layer
metric of each source and cell are added as files and entries without
editing any file that is there, and the benchmark's tests pass with them."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.tests import tiny

CELLS = tiny.cells()
_BASE = {'n_halo': 10_000, 'n_part': 50_000, 'field': {'ngrid': 32, 'bias': 1.3}}
# each cell's small size, as the tests ran them before the statistics declared them
SMALL = {
    'box3_pk_fused': (_BASE, {'nmesh': 32, 'nbins_k': 16}),
    'lc3_pk_fused': (_BASE, {'nmesh': 32, 'nbins_k': 16}),
    'box_lrg_xirppi': (dict(_BASE, n_halo=4_000, n_part=20_000), {}),
    'box3_pell550': (_BASE, {'num_cells': 40, 'nbins_k': 16, 'k_hMpc_max': 0.06}),
}


@pytest.mark.parametrize('name', CELLS)
def test_cell_files_found_by_name(name):
    cell = harness.Cell(name)
    assert cell.config['name'] == cell.entry['config']
    assert hasattr(cell.stat, 'evaluate') and hasattr(cell.stat, 'reference')
    assert set(cell.limits) - {'_readings'}, 'no comparison limits'
    for m in cell.per_layer:
        assert cell.metrics[m['name']].UNIT == m['unit']
    names = {m['name'] for m in cell.end_to_end}
    assert 'setup_s' in names and len(names) >= 2 and cell.per_layer


@pytest.mark.parametrize('name', sorted(SMALL))
def test_small_sizes(name):
    cell = harness.Cell(name)
    config, call = SMALL[name]
    assert tiny.overrides(cell) == {'config': config,
                                    'traffic': {'call': dict(cell.traffic['call'], **call),
                                                'warmup': 1}}


@pytest.mark.parametrize('name', CELLS)
def test_cell_runs_and_agrees_with_reference(name):
    result, extra = tiny.run(name)
    assert result['attempted'] >= 1 and result['failed'] == 0
    assert result['correct'], result['checks']
    assert list(result)[-1] == 'checks'
    assert set(result['metrics']) == {m['name'] for m in harness.Cell(name).end_to_end}
    assert extra['sampled']


def _digest(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob('*')) if p.is_file() and '__pycache__' not in p.parts}


# a statistic of its own: run_hod then compute_wp, held to the plain pair
# counts summed over pi
_WP_STAT = '''"""run_hod then compute_wp: wp(rp) of every tracer pair."""

import math

import numpy as np

from benchmark.reference import hod as ref_hod
from benchmark.reference import pairs as ref_pairs
from benchmark.stats import common

PRODUCES = 'compute_wp'

SMALL = {'config': {'n_halo': 3_000, 'n_part': 15_000}}


def evaluate(hod, tracers, call):
    mock = hod.run_hod(tracers=tracers, want_rsd=True)
    wp = hod.compute_wp(mock, np.asarray(call['rpbins']), int(call['pimax']))
    ts = common.want(tracers)
    return ({'wp': {(a, b): wp[f'{a}_{b}'] for a, b in common.pairs(ts)},
             'n_gal': {t: float(len(mock[t]['x'])) for t in ts}}, mock)


def reference(cat, cfg, tracers, call, P):
    rpbins, pimax, lbox = np.asarray(call['rpbins']), int(call['pimax']), float(cfg['Lbox'])
    gals = ref_hod.galaxies(cat, cfg, tracers, P, rsd=True)
    ts = common.want(tracers)
    wp = {}
    for a, b in common.pairs(ts):
        pa, pb = gals[a]['pos'], None if a == b else gals[b]['pos']
        dd = ref_pairs.rppi_counts(pa, lbox, rpbins, pimax, P, pb).cpu().numpy()
        n1 = float(pa.shape[0])
        n2 = n1 if pb is None else float(pb.shape[0])
        rr = math.pi * (rpbins[1:] ** 2 - rpbins[:-1] ** 2) / lbox**3 * n1 * n2 * 2
        wp[(a, b)] = 2.0 * np.sum(dd / rr[:, None] - 1.0, axis=1)
    keep = {t: (g['id'], g['pos'], g['vel']) for t, g in gals.items()}
    n_gal = {t: float(gals[t]['pos'].shape[0]) for t in ts}
    return {'wp': wp, 'n_gal': n_gal, 'pimax': pimax}, keep


def compare(got, got_keep, ref, ref_keep, cfg):
    dev = next(iter(ref_keep.values()))[0].device
    out = {'ngal_gap': common.ngal_gap(got['n_gal'], ref['n_gal'])}
    out.update(common.mock_gaps(common.as_columns(got_keep, dev), ref_keep, float(cfg['Lbox'])))
    out['wp_gap'] = 0.0
    for k, r in ref['wp'].items():
        # wp + 2 pimax: twice the pair counts over the analytic ones, summed
        # over pi; bins the reference finds empty left out
        den = r + 2.0 * ref['pimax']
        ok = den > 0
        gap = np.abs(np.asarray(got['wp'][k]) - r)[ok] / den[ok]
        out['wp_gap'] = max(out['wp_gap'], float(gap.max(initial=0.0)))
    return out


def work(answer, keep, call, cfg):
    return {}
'''


# a device_trace metric that reads one form of a kernel that has several:
# the device ms an evaluation of K4's (s, mu) form, found by kernel name
_K4_SMU = """UNIT = 'ms'
KERNELS = ('pair_count_cells_kernel<1',)


def read(trace):
    s = trace.device_seconds(KERNELS)
    return None if s <= 0 or not trace.evals else 1e3 * s / trace.evals
"""

# a program_counter metric read in every cell (no workloads list)
_D2H = """from benchmark.spans import counter_mib

UNIT = 'MiB'


def read(trace):
    return counter_mib(trace, ('d2h_bytes',))
"""


@pytest.fixture(scope='module')
def extended(tmp_path_factory):
    """A copy of BENCHMARK.json and benchmark/ with one of each added as
    files and entries: a configuration, two traffic mixes, a statistic
    (wp, with its PRODUCES), two cells, and per-layer metrics of the
    sources program_counter (one for a cell, one for every cell) and
    device_trace. (root, the digests of the files copied, the spec before
    and after.)"""
    root = tmp_path_factory.mktemp('extended')
    shutil.copy(harness.ROOT / 'BENCHMARK.json', root / 'BENCHMARK.json')
    shutil.copytree(harness.ROOT / 'benchmark', root / 'benchmark',
                    ignore=shutil.ignore_patterns('__pycache__'))
    before = _digest(root / 'benchmark')
    spec = json.loads((root / 'BENCHMARK.json').read_text())
    old = json.loads(json.dumps(spec))

    bench = root / 'benchmark'
    cfg = json.loads((bench / 'configs/abacus_base_box_z05.json').read_text())
    cfg.update(name='throwaway_box_z08', z=0.8)
    (bench / 'configs/throwaway_box_z08.json').write_text(json.dumps(cfg))
    tr = json.loads((bench / 'traffic/pk_fused_chain_3tr.json').read_text())
    tr['tracers'] = {'LRG': tr['tracers']['LRG']}
    (bench / 'traffic/throwaway_lrg.json').write_text(json.dumps(tr))
    (bench / 'metrics/throwaway_evals.py').write_text(
        "UNIT = 'evals'\n\n\ndef read(trace):\n    return float(trace.evals)\n")
    (bench / 'metrics/throwaway_k4_smu_ms.py').write_text(_K4_SMU)
    (bench / 'metrics/throwaway_d2h_mib.py').write_text(_D2H)
    limits = json.loads((bench / 'limits/box3_pk_fused.json').read_text())
    (bench / 'limits/throwaway_cell.json').write_text(json.dumps(limits))
    (bench / 'stats/throwaway_wp.py').write_text(_WP_STAT)
    wp = json.loads((bench / 'traffic/xirppi_chain_lrg.json').read_text())
    wp['statistic'] = 'throwaway_wp'
    (bench / 'traffic/throwaway_wp_lrg.json').write_text(json.dumps(wp))
    limits = json.loads((bench / 'limits/box_lrg_xirppi.json').read_text())
    limits['wp_gap'] = limits.pop('xi_gap')
    (bench / 'limits/throwaway_wp_cell.json').write_text(json.dumps(limits))
    spec['configs'].append({'name': 'throwaway_box_z08', 'source': 'https://example.org',
                            'file': 'benchmark/configs/throwaway_box_z08.json', 'reduced': [],
                            'why': 'a test'})
    spec['workloads'].append({'name': 'throwaway_cell', 'config': 'throwaway_box_z08',
                              'traffic': 'throwaway_lrg', 'chips': 1, 'why': 'a test'})
    spec['workloads'].append({'name': 'throwaway_wp_cell', 'config': 'abacus_base_box_z05',
                              'traffic': 'throwaway_wp_lrg', 'chips': 1, 'why': 'a test'})
    spec['per_layer'].append({'name': 'throwaway_evals', 'unit': 'evals', 'better': 'higher',
                              'source': 'program_counter', 'layer': 'Entry',
                              'moves': 'evals_per_s', 'workloads': ['throwaway_cell']})
    spec['per_layer'].append({'name': 'throwaway_k4_smu_ms', 'unit': 'ms', 'better': 'lower',
                              'source': 'device_trace', 'layer': 'K4 pair counts',
                              'moves': 'evals_per_s', 'workloads': ['throwaway_wp_cell']})
    spec['per_layer'].append({'name': 'throwaway_d2h_mib', 'unit': 'MiB', 'better': 'lower',
                              'source': 'program_counter', 'layer': 'Host transfers',
                              'moves': 'evals_per_s'})
    (root / 'BENCHMARK.json').write_text(json.dumps(spec))
    return root, before, old, spec


def _nothing_edited(extended):
    root, before, old, spec = extended
    after = _digest(root / 'benchmark')
    assert {k: v for k, v in after.items() if k in before} == before
    for key in ('configs', 'workloads', 'end_to_end', 'per_layer'):
        assert spec[key][:len(old[key])] == old[key]


def test_adding_a_cell_edits_no_file(extended):
    root = extended[0]
    cell = harness.Cell('throwaway_cell', root)
    assert cell.config['z'] == 0.8 and list(cell.traffic['tracers']) == ['LRG']
    assert {'throwaway_evals', 'throwaway_d2h_mib'} <= set(cell.metrics)
    assert 'throwaway_k4_smu_ms' not in cell.metrics
    result, _ = tiny.run('throwaway_cell', root=root)
    assert result['correct'], result['checks']

    cell = harness.Cell('throwaway_wp_cell', root)
    assert cell.stat.SMALL == {'config': {'n_halo': 3_000, 'n_part': 15_000}}
    assert {'throwaway_k4_smu_ms', 'throwaway_d2h_mib'} <= set(cell.metrics)
    assert tiny.overrides(cell)['config']['n_halo'] == 3_000
    result, _ = tiny.run('throwaway_wp_cell', root=root)
    assert result['correct'], result['checks']
    assert set(result['checks']) == {'ngal_gap', 'mock_keep_gap', 'mock_pos_gap',
                                     'mock_vel_gap', 'wp_gap'}
    _nothing_edited(extended)


def test_an_added_statistic_brings_its_answer_fault(extended, monkeypatch):
    """The wp statistic's PRODUCES: its answer doubled in a bin where
    compute_wp returns it, and correct is false by its own number."""
    from benchmark.tests.test_bench_faults import alter_answer

    root = extended[0]
    alter_answer(monkeypatch, harness.Cell('throwaway_wp_cell', root).stat.PRODUCES)
    result, _ = tiny.run('throwaway_wp_cell', seconds=1.5, root=root)
    assert result['attempted'] >= 2
    assert not result['correct'], result['checks']
    assert result['checks']['wp_gap']['value'] > result['checks']['wp_gap']['limit']
    _nothing_edited(extended)


def test_the_benchmark_tests_pass_with_the_additions(extended):
    """The tests that read BENCHMARK.json's lists of metrics and cells, run
    in the extended copy (its benchmark package and BENCHMARK.json, the
    port from this checkout), pass with every addition in them."""
    root = extended[0]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [str(harness.ROOT), os.environ.get('PYTHONPATH')])))
    out = subprocess.run(
        [sys.executable, '-m', 'pytest', '-v', '-p', 'no:cacheprovider',
         'benchmark/tests/test_bench_spec.py', 'benchmark/tests/test_bench_spans.py',
         'benchmark/tests/test_bench_cells.py::test_cell_files_found_by_name'],
        cwd=root, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-2000:]
    # the copy's own lists were read: its cells are among the test ids
    assert 'test_cell_files_found_by_name[throwaway_wp_cell] PASSED' in out.stdout
    _nothing_edited(extended)
