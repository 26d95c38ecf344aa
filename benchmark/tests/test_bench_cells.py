"""Every cell of BENCHMARK.json loads by name and runs at a small size on
the CPU, through the port's plain paths, with the reference agreeing; a new
configuration, traffic mix, metric and cell are added as files and entries
without editing any file that is there."""

import hashlib
import json
import shutil

import pytest

from benchmark import harness
from benchmark.tests import tiny

CELLS = tiny.cells()


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
    spec['configs'].append({'name': 'throwaway_box_z08', 'source': 'https://example.org',
                            'file': 'benchmark/configs/throwaway_box_z08.json', 'reduced': [],
                            'why': 'a test'})
    spec['workloads'].append({'name': 'throwaway_cell', 'config': 'throwaway_box_z08',
                              'traffic': 'throwaway_lrg', 'chips': 1, 'why': 'a test'})
    spec['per_layer'].append({'name': 'throwaway_evals', 'unit': 'evals', 'better': 'higher',
                              'source': 'program_counter', 'layer': 'Entry',
                              'moves': 'evals_per_s', 'workloads': ['throwaway_cell']})
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(spec))

    cell = harness.Cell('throwaway_cell', tmp_path)
    assert cell.config['z'] == 0.8 and list(cell.traffic['tracers']) == ['LRG']
    assert 'throwaway_evals' in cell.metrics
    result, _ = tiny.run('throwaway_cell', root=tmp_path)
    assert result['correct'], result['checks']

    after = _digest(tmp_path / 'benchmark')
    assert {k: v for k, v in after.items() if k in before} == before
    for key in ('configs', 'workloads', 'end_to_end', 'per_layer'):
        assert spec[key][:len(old[key])] == old[key]
