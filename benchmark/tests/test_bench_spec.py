"""BENCHMARK.json keeps to its format: names and units of the allowed
characters, the keys each entry may have, every cell's files present, every
per-layer metric with its module."""

import re

import pytest

from benchmark import harness

SPEC = harness.load_json(harness.ROOT / 'BENCHMARK.json')
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
TEXT = re.compile(r'^[^\t\n]{1,200}$')
KEYS = {
    'configs': {'name', 'source', 'file', 'reduced', 'why'},
    'workloads': {'name', 'config', 'traffic', 'chips', 'why'},
    'end_to_end': {'name', 'unit', 'better', 'bound', 'source', 'workloads'},
    'per_layer': {'name', 'unit', 'better', 'source', 'layer', 'moves', 'workloads'},
}


def test_top_level():
    assert set(SPEC) == {'command', 'paths', 'run_seconds', 'configs', 'workloads',
                         'end_to_end', 'per_layer'}
    assert 1 <= SPEC['run_seconds'] <= 51 and isinstance(SPEC['run_seconds'], int)
    assert all(TEXT.match(w) for w in SPEC['command'])
    assert all(re.match(r'^[A-Za-z0-9_./-]{1,200}$', p) for p in SPEC['paths'])


@pytest.mark.parametrize('part', list(KEYS))
def test_entries(part):
    names = [e['name'] for e in SPEC[part]]
    assert len(names) == len(set(names))
    for e in SPEC[part]:
        assert set(e) <= KEYS[part] and NAME.match(e['name']), e
        for k in ('why', 'layer', 'source'):
            if k in e:
                assert TEXT.match(e[k]), e
        if 'unit' in e:
            assert UNIT.match(e['unit']), e
        if 'better' in e:
            assert e['better'] in ('lower', 'higher')
        for k in ('config', 'traffic'):
            if k in e:
                assert NAME.match(e[k])
        for k in e.get('reduced', ()):
            assert NAME.match(k)


def test_metrics_and_cells():
    cells = {w['name'] for w in SPEC['workloads']}
    e2e = {m['name'] for m in SPEC['end_to_end']}
    assert 'setup_s' in e2e
    for m in SPEC['end_to_end']:
        assert m['source'] in ('host_clock', 'device_trace') and 0.0 < m['bound'] <= 0.25
    for m in SPEC['per_layer']:
        assert m['moves'] in e2e and set(m.get('workloads', cells)) <= cells
        assert (harness.ROOT / 'benchmark' / 'metrics' / f'{m["name"]}.py').exists()
        if m['name'].endswith('_roofline'):
            assert m['unit'] == '%'
    for w in SPEC['workloads']:
        assert w['chips'] in (1, 4)
        assert (harness.ROOT / 'benchmark' / 'traffic' / f'{w["traffic"]}.json').exists()
        assert (harness.ROOT / 'benchmark' / 'limits' / f'{w["name"]}.json').exists()
