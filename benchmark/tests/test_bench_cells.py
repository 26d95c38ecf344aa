"""Every cell of BENCHMARK.json loads by name and runs at a small size on
the CPU, through the port's plain paths, with the reference agreeing; a new
configuration, traffic mix, statistic, metric and cell are added as files
and entries without editing any file that is there."""

import hashlib
import json
import shutil

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


def test_adding_a_cell_edits_no_file(tmp_path):
    shutil.copy(harness.ROOT / 'BENCHMARK.json', tmp_path / 'BENCHMARK.json')
    shutil.copytree(harness.ROOT / 'benchmark', tmp_path / 'benchmark',
                    ignore=shutil.ignore_patterns('__pycache__'))
    before = _digest(tmp_path / 'benchmark')
    spec = json.loads((tmp_path / 'BENCHMARK.json').read_text())
    old = json.loads(json.dumps(spec))

    cfg = json.loads((tmp_path / 'benchmark/configs/abacus_base_box_z05.json').read_text())
    cfg.update(name='throwaway_box_z08', z=0.8)
    (tmp_path / 'benchmark/configs/throwaway_box_z08.json').write_text(json.dumps(cfg))
    tr = json.loads((tmp_path / 'benchmark/traffic/pk_fused_chain_3tr.json').read_text())
    tr['tracers'] = {'LRG': tr['tracers']['LRG']}
    (tmp_path / 'benchmark/traffic/throwaway_lrg.json').write_text(json.dumps(tr))
    (tmp_path / 'benchmark/metrics/throwaway_evals.py').write_text(
        "UNIT = 'evals'\n\n\ndef read(trace):\n    return float(trace.evals)\n")
    limits = json.loads((tmp_path / 'benchmark/limits/box3_pk_fused.json').read_text())
    (tmp_path / 'benchmark/limits/throwaway_cell.json').write_text(json.dumps(limits))
    (tmp_path / 'benchmark/stats/throwaway_wp.py').write_text(_WP_STAT)
    wp = json.loads((tmp_path / 'benchmark/traffic/xirppi_chain_lrg.json').read_text())
    wp['statistic'] = 'throwaway_wp'
    (tmp_path / 'benchmark/traffic/throwaway_wp_lrg.json').write_text(json.dumps(wp))
    limits = json.loads((tmp_path / 'benchmark/limits/box_lrg_xirppi.json').read_text())
    limits['wp_gap'] = limits.pop('xi_gap')
    (tmp_path / 'benchmark/limits/throwaway_wp_cell.json').write_text(json.dumps(limits))
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
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(spec))

    cell = harness.Cell('throwaway_cell', tmp_path)
    assert cell.config['z'] == 0.8 and list(cell.traffic['tracers']) == ['LRG']
    assert 'throwaway_evals' in cell.metrics
    result, _ = tiny.run('throwaway_cell', root=tmp_path)
    assert result['correct'], result['checks']

    cell = harness.Cell('throwaway_wp_cell', tmp_path)
    assert cell.stat.SMALL == {'config': {'n_halo': 3_000, 'n_part': 15_000}}
    assert tiny.overrides(cell)['config']['n_halo'] == 3_000
    result, _ = tiny.run('throwaway_wp_cell', root=tmp_path)
    assert result['correct'], result['checks']
    assert set(result['checks']) == {'ngal_gap', 'mock_keep_gap', 'mock_pos_gap',
                                     'mock_vel_gap', 'wp_gap'}

    after = _digest(tmp_path / 'benchmark')
    assert {k: v for k, v in after.items() if k in before} == before
    for key in ('configs', 'workloads', 'end_to_end', 'per_layer'):
        assert spec[key][:len(old[key])] == old[key]
