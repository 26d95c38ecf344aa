"""The program's spans in a traced window (benchmark/spans.py, read by
benchmark/trace.py's reduction) and the metric modules that read them, on
synthetic Kineto-like event lists.

The program's ``abacus.*`` spans are host ranges with no device event of
their own (tests/test_torch_spans.py holds the program to that): the
trace's reduction gives the same busy time, device time by operation and
per-layer metrics with them as without them, and as the reduction did
before it read the spans; only the names of idle gaps inside a span change,
from the host's operation to the span."""

from collections import defaultdict

import pytest

from benchmark import harness, spans, trace
from benchmark.spans import Event
from benchmark.tests import tiny

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
    return trace.reduce([e for e in evs if programs or not e.name.startswith(spans.PREFIX)],
                        1e-3, 1, [])


def _metric(name):
    return harness._module(harness.ROOT / 'benchmark' / 'metrics' / f'{name}.py', f'm_{name}')


def _reduce_before_spans(events, window_s, evals, work):
    """The reduction as it was before it read the program's spans, kept
    here as the yardstick of the device time it reports (its helpers are
    unchanged in benchmark.trace)."""
    WINDOW, _TOP = trace.WINDOW, 10
    win = [(s, e) for n, d, s, e in events if not d and n == WINDOW]
    lo, hi = (win[0] if win else (min(s for *_, s, _ in events), max(e for *_, e in events)))
    dev = [(n, max(s, lo), min(e, hi)) for n, d, s, e in events
           if d and e > lo and s < hi and not n.startswith('bench.') and n != WINDOW]
    by_name = defaultdict(float)
    for n, s, e in dev:
        by_name[n] += (e - s) / 1e6
    busy = trace._union([(s, e) for _, s, e in dev])
    busy_s = sum(e - s for s, e in busy) / 1e6
    host = [(n, s, e) for n, d, s, e in events if not d and n != WINDOW and e > s]
    spans = trace._index([h for h in host if h[0].startswith('bench.')])
    ops = trace._index([h for h in host if not h[0].startswith('bench.')])
    gaps = []
    edge = lo
    for s, e in busy + [[hi, hi]]:
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, e)
    idle = defaultdict(float)
    for s, e in gaps:
        mid = 0.5 * (s + e)
        span, op = trace._innermost(spans, mid, 8), trace._innermost(ops, mid, 64)
        idle[f'{span or "host"} / {op or "python"}'] += (e - s) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:_TOP]
    breakdown = {
        'device_ops': [[n[:160], s] for n, s in top],
        'idle_gaps': [[n[:160], s] for n, s in sorted(idle.items(), key=lambda kv: -kv[1])[:_TOP]],
    }
    return trace.Trace(window_s, busy_s, evals, by_name, work, breakdown)


# the metrics that read the device trace when the reduction first read spans
BEFORE_SPANS = ('device_idle_share', 'other_kernels_ms', 'k1_roofline', 'fft_ms', 'k3_roofline',
                'k4_roofline', 'memcpy_ms')


def _existing_metrics():
    """Every per-layer metric of BENCHMARK.json that reads the device trace
    (kernels and copies by name, busy time), not the program's spans or
    counters: a metric added with source device_trace is among them."""
    return [m['name'] for m in harness.load_json(harness.ROOT / 'BENCHMARK.json')['per_layer']
            if m['source'] == 'device_trace']


def test_reduce_gives_the_device_time_it_gave_before_spans():
    """One window with the program's host spans and their launches: the
    reduction that reads the spans (events as benchmark.spans gives them)
    gives the busy time, device time by operation, the
    device ops of the breakdown and every metric that reads them (the seven
    of BEFORE_SPANS and any added since) bit-equal to the reduction before
    it; idle seconds are equal in sum."""
    evs = _window()
    got = _reduce(evs)
    ref = _reduce_before_spans(_plain(evs), 1e-3, 1, [])
    assert got.busy_s == ref.busy_s and got.device == ref.device
    assert got.breakdown['device_ops'] == ref.breakdown['device_ops']
    assert set(_existing_metrics()) >= set(BEFORE_SPANS)
    for name in _existing_metrics():
        mod = _metric(name)
        assert mod.read(got) == mod.read(ref), name
    assert sum(s for _, s in got.breakdown['idle_gaps']) == pytest.approx(
        sum(s for _, s in ref.breakdown['idle_gaps']), abs=1e-12)


def test_idle_gaps_are_named_by_the_open_span():
    """The gap 600-650 lies under abacus.compact while its copy's runtime
    call runs on the host: named by the span, not the call; the gap after
    the last span (690-1000, middle 845) keeps the host's name."""
    evs = _window()
    gaps = dict(_reduce(evs).breakdown['idle_gaps'])
    before = dict(_reduce_before_spans(_plain(evs), 1e-3, 1, []).breakdown['idle_gaps'])
    assert gaps['bench.xirppi / abacus.compact'] == pytest.approx(50e-6)
    assert before['bench.xirppi / cudaMemcpyAsync'] == pytest.approx(50e-6)
    assert gaps['bench.xirppi / abacus.populate'] == pytest.approx(270e-6)
    assert gaps['bench.xirppi / python'] == before['bench.xirppi / python']


def test_reduce_leaves_program_annotations_out():
    """A device-side mirror of a program span, as the profiler makes of a
    user annotation, is not device work, as a bench.* one is not."""
    evs = _window()
    mirrored = evs + [Event('abacus.populate', start=20.0, end=400.0, corr=3, device=True,
                            thread=7)]
    got, ref = _reduce(mirrored), _reduce(evs)
    assert got.busy_s == ref.busy_s and got.device == ref.device


def test_reduce_counts_no_span_as_device_work():
    """The reduction on the window with the program's spans and without
    them: busy, device time by operation, the device ops of the breakdown
    and every metric that reads them are equal; idle seconds are equal,
    and a gap with no operation running inside a span is named by it."""
    evs = _window()
    got, ref = _reduce(evs), _reduce(evs, programs=False)
    assert got.busy_s == ref.busy_s and got.device == ref.device
    assert got.breakdown['device_ops'] == ref.breakdown['device_ops']
    for name in _existing_metrics():
        mod = _metric(name)
        assert mod.read(got) == mod.read(ref), name
    gaps, ref_gaps = dict(got.breakdown['idle_gaps']), dict(ref.breakdown['idle_gaps'])
    assert sum(gaps.values()) == pytest.approx(sum(ref_gaps.values()), abs=1e-12)
    assert gaps['bench.xirppi / abacus.populate'] == pytest.approx(270e-6)
    assert 'bench.xirppi / abacus.populate' not in ref_gaps


def test_device_time_goes_to_the_launching_span():
    tr = _reduce(_window())
    assert tr.span_device == pytest.approx({'abacus.populate': 100e-6, 'abacus.cell_stage': 70e-6,
                                            'abacus.compact': 40e-6})
    assert tr.span_rest == pytest.approx(160e-6)


def test_spans_and_rest_sum_to_the_device_total():
    tr = _reduce(_window())
    assert sum(tr.span_device.values()) + tr.span_rest == pytest.approx(
        tr.device_seconds(None), abs=1e-15)


def test_idle_is_split_among_the_open_spans():
    """The gaps and the spans over them: 0-50 (populate from 20), 150-230
    (populate to 200, then the cell stage), 300-440 (the cell stage to 350,
    populate to 400, then none), 600-650 (compact from 610), 690-1000
    (compact to 800)."""
    assert _reduce(_window()).span_idle == pytest.approx({'abacus.populate': (30 + 50 + 50) * 1e-6,
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
    tr = _reduce(_window())
    tr.evals = 2
    tr.counters = {'h2d_bytes': 3 * 2**20, 'd2h_bytes': 2**20, 'pinned_bytes': 2**20}
    want = {'populate_ms': 0.05, 'compact_ms': 0.02, 'cell_stage_ms': 0.035,
            'span_idle_ms': 0.18, 'transfer_mib': 2.0, 'pinned_alloc_mib': 0.5}
    assert _metric(name).read(tr) == pytest.approx(want[name])


def test_a_traced_run_counts_the_window(monkeypatch):
    """The harness takes the program's counters at the traced window's
    ends: what each evaluation of the window counts reaches transfer_mib,
    the warm-up's does not. On the CPU the program's copies count nothing,
    so each evaluation counts one MiB of its own."""
    from abacusutils_tpu_torch.utils import profiling

    cell = harness.Cell('box_lrg_xirppi')
    evaluate = cell.stat.evaluate

    def counted(hod, tracers, call):
        profiling.count('h2d_bytes', 2**20)
        return evaluate(hod, tracers, call)

    monkeypatch.setattr(cell.stat, 'evaluate', counted)
    result, _ = harness.run(cell, 2**31 + 5, 0.5, True, 'cpu', overrides=tiny.overrides(cell))
    assert result['correct'], result['checks']
    assert result['metrics']['transfer_mib'] == {'value': 1.0, 'unit': 'MiB'}
    assert 'pinned_alloc_mib' not in result['metrics']
