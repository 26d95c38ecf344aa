"""The program's spans in a traced window (benchmark/spans.py) and the
metric modules that read them, on synthetic Kineto-like event lists.

The program's ``abacus.*`` spans are host ranges with no device event of
their own (tests/test_torch_spans.py holds the program to that): the
trace's reduction gives the same busy time, device time by operation and
per-layer metrics with them as without them, and only the names of idle
gaps inside a span change, from the host's Python to the span."""

import pytest

from benchmark import harness, spans, trace
from benchmark.spans import Event

NEW = ('populate_ms', 'compact_ms', 'cell_stage_ms', 'span_idle_ms', 'transfer_mib',
       'pinned_alloc_mib')


def _window():
    """One evaluation: populate (two kernels, the second launched inside a
    nested cell stage), a kernel launched outside every span, a copy under
    compact, idle gaps inside the spans and outside them. Thread 1 is the
    program's; aten::sum shares a correlation id with a kernel, as the
    host's ids and the runtime's do."""
    h = dict(device=False, thread=1)
    d = dict(device=True, thread=7)
    return [
        Event(trace.WINDOW, start=0.0, end=1000.0, corr=1, **h),
        Event('bench.xirppi', start=10.0, end=990.0, corr=2, **h),
        Event('bench.xirppi', start=50.0, end=900.0, corr=2, **d),  # its annotation
        Event('abacus.populate', start=20.0, end=400.0, corr=3, **h),
        Event('aten::mul', start=30.0, end=60.0, corr=4, **h),
        Event('cudaLaunchKernel', start=40.0, end=55.0, corr=101, **h),
        Event('elementwise_kernel', start=50.0, end=150.0, corr=101, **d),
        Event('abacus.cell_stage', start=200.0, end=350.0, corr=5, **h),
        Event('cudaLaunchKernel', start=210.0, end=220.0, corr=102, **h),
        Event('sort_kernel', start=230.0, end=300.0, corr=102, **d),
        Event('cudaLaunchKernel', start=420.0, end=430.0, corr=103, **h),
        Event('pair_count_cells_kernel', start=440.0, end=600.0, corr=103, **d),
        Event('abacus.compact', start=610.0, end=800.0, corr=6, **h),
        Event('cudaMemcpyAsync', start=620.0, end=700.0, corr=104, **h),
        Event('Memcpy DtoH (Device -> Pinned)', start=650.0, end=690.0, corr=104, **d),
        Event('aten::sum', start=905.0, end=910.0, corr=101, **h),
    ]


def _plain(evs, programs=True):
    return [(e.name, e.device, e.start, e.end) for e in evs
            if programs or not e.name.startswith(spans.PREFIX)]


def _reduce(evs, programs=True):
    return trace.reduce(_plain(evs, programs), 1e-3, 1, [])


def _metric(name):
    return harness._module(harness.ROOT / 'benchmark' / 'metrics' / f'{name}.py', f'm_{name}')


def test_reduce_counts_no_span_as_device_work():
    """The accepted reduction on the window with the program's spans and
    without them: busy, device time by operation, the device ops of the
    breakdown and every accepted metric are equal; idle seconds are equal,
    and a gap with no operation running inside a span is named by it."""
    evs = _window()
    got, ref = _reduce(evs), _reduce(evs, programs=False)
    assert got.busy_s == ref.busy_s and got.device == ref.device
    assert got.breakdown['device_ops'] == ref.breakdown['device_ops']
    for m in harness.load_json(harness.ROOT / 'BENCHMARK.json')['per_layer']:
        mod = _metric(m['name'])
        assert mod.read(got) == mod.read(ref), m['name']
    gaps, ref_gaps = dict(got.breakdown['idle_gaps']), dict(ref.breakdown['idle_gaps'])
    assert sum(gaps.values()) == pytest.approx(sum(ref_gaps.values()), abs=1e-12)
    assert gaps['bench.xirppi / abacus.populate'] == pytest.approx(270e-6)
    assert 'bench.xirppi / abacus.populate' not in ref_gaps


def test_device_time_goes_to_the_launching_span():
    sp = spans.attribute(_window())
    assert sp.device == pytest.approx({'abacus.populate': 100e-6, 'abacus.cell_stage': 70e-6,
                                       'abacus.compact': 40e-6})
    assert sp.rest_s == pytest.approx(160e-6)


def test_spans_and_rest_sum_to_the_device_total():
    evs = _window()
    sp = spans.attribute(evs)
    assert sum(sp.device.values()) + sp.rest_s == pytest.approx(
        _reduce(evs).device_seconds(None), abs=1e-15)


def test_idle_is_split_among_the_open_spans():
    """The gaps and the spans over them: 0-50 (populate from 20), 150-230
    (populate to 200, then the cell stage), 300-440 (the cell stage to 350,
    populate to 400, then none), 600-650 (compact from 610), 690-1000
    (compact to 800)."""
    sp = spans.attribute(_window())
    assert sp.idle == pytest.approx({'abacus.populate': (30 + 50 + 50) * 1e-6,
                                     'abacus.cell_stage': (30 + 50) * 1e-6,
                                     'abacus.compact': (40 + 110) * 1e-6})


def test_timeline_names_the_innermost_span():
    tl = spans.Timeline([e for e in _window() if e.name.startswith(spans.PREFIX)])
    assert [tl.at(t) for t in (10, 20, 199, 200, 349, 350, 399, 400, 700, 800)] == [
        None, 'abacus.populate', 'abacus.populate', 'abacus.cell_stage', 'abacus.cell_stage',
        'abacus.populate', 'abacus.populate', None, 'abacus.compact', None]
    assert tl.at(250, thread=2) is None


def test_window_counters():
    before = {'h2d_bytes': 10, 'pinned_bytes': 4}
    after = {'h2d_bytes': 60, 'd2h_bytes': 30, 'pinned_bytes': 4}
    assert spans.window_counters(before, after) == {'h2d_bytes': 50, 'd2h_bytes': 30}


@pytest.mark.parametrize('name', NEW)
def test_new_metrics_read_none_without_spans(name):
    """The accepted Trace, from a window without the program's spans and
    counters (as the parent's program gives), has nothing they read."""
    assert _metric(name).read(_reduce(_window(), programs=False)) is None


@pytest.mark.parametrize('name', NEW)
def test_new_metrics_read_the_spans(name):
    evs = _window()
    tr = _reduce(evs)
    tr.evals = 2
    sp = spans.attribute(evs)
    tr.span_device, tr.span_idle = sp.device, sp.idle
    tr.counters = {'h2d_bytes': 3 * 2**20, 'd2h_bytes': 2**20, 'pinned_bytes': 2**20}
    want = {'populate_ms': 0.05, 'compact_ms': 0.02, 'cell_stage_ms': 0.035,
            'span_idle_ms': 0.18, 'transfer_mib': 2.0, 'pinned_alloc_mib': 0.5}
    assert _metric(name).read(tr) == pytest.approx(want[name])
