"""The port's spans and transfer counters (utils/profiling.py: span,
counters) on the evaluation paths, on the CPU at a tiny size.

Without a profiler a span is one shared no-op and enters no range. Under a
CPU ``torch.profiler`` run each evaluation path names its steps with the
``abacus.*`` spans below, each span inside its caller's (the cell stage
inside the pair count), never overlapping, at most 16 an evaluation; the
spans are host ranges of the function scope, not user annotations. CPU
tensors cross no bus, so the transfer counters stay where they were.
"""

from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from abacusutils_tpu_torch.convert import staged_state_from_numpy
from abacusutils_tpu_torch.ops import tpcf as ttpcf
from abacusutils_tpu_torch.utils import profiling
from torch_helpers import TRACERS, staged_state

LBOX = 500.0
RPBINS = np.logspace(-1, np.log10(30), 9)

# {path: ({span: entries an evaluation}, {span: its caller's span})}; a span
# not in the second dict nests in no other span
TOP = {}
PATHS = {
    'box_fused': ({'abacus.stage': 1, 'abacus.prepare': 1, 'abacus.populate': 1,
                   'abacus.deposit': 4, 'abacus.transform': 3, 'abacus.bin': 1,
                   'abacus.spectrum': 1}, TOP),
    'lc_fused': ({'abacus.stage': 1, 'abacus.prepare': 1, 'abacus.populate': 1,
                  'abacus.deposit': 3, 'abacus.transform': 3, 'abacus.bin': 1,
                  'abacus.spectrum': 1}, TOP),
    'xirppi': ({'abacus.stage': 1, 'abacus.prepare': 1, 'abacus.populate': 1,
                'abacus.compact': 1, 'abacus.upload': 1, 'abacus.pairs': 1,
                'abacus.cell_stage': 1}, {'abacus.cell_stage': 'abacus.pairs'}),
    'power': ({'abacus.stage': 1, 'abacus.prepare': 1, 'abacus.populate': 1,
               'abacus.compact': 1, 'abacus.upload': 3, 'abacus.deposit': 3,
               'abacus.transform': 3, 'abacus.bin': 1, 'abacus.spectrum': 1}, TOP),
}


def _hod(lc, tracers):
    state = staged_state(3_000, 12_000, LBOX, seed=71)
    params = {'z': 0.5, 'Lbox': LBOX, 'velz2kms': 100.0,
              'origin': np.array([-260.0, -260.0, -260.0]) if lc else None}
    return staged_state_from_numpy(*state, params, {k: TRACERS[k] for k in tracers},
                                   dict(halo_lc=lc), 'cpu')


def _evaluation(path):
    """One evaluation of `path` (a function of no argument), on an object
    warmed by one call."""
    if path in ('box_fused', 'lc_fused'):
        hod = _hod(path == 'lc_fused', TRACERS)

        def run():
            return hod.run_hod_pk_fused(nmesh=16, nbins_k=8)
    elif path == 'xirppi':
        hod = _hod(False, ['LRG'])

        def run():
            return hod.compute_xirppi(hod.run_hod(), RPBINS, 30, 5)
    else:
        hod = _hod(False, TRACERS)

        def run():
            return hod.compute_power(hod.run_hod(), 8, 1, 0.2, False, poles=[0, 2],
                                     num_cells=16)
    run()
    return run


@pytest.fixture
def cell_engine(monkeypatch):
    """The cell engine for the tiny mock, as a full-size mock takes it."""
    monkeypatch.setattr(ttpcf, '_CELL_MIN_N', 100)
    monkeypatch.setattr(ttpcf, '_JAX_CELL_MIN_N', 100)
    ttpcf._stage_cache.clear()
    yield
    ttpcf._stage_cache.clear()


def _spans(prof):
    """[(name, start, end, thread, is a user annotation)] of the abacus.* events."""
    return [(e.name(), e.start_ns(), e.end_ns(), e.start_thread_id(), e.is_user_annotation())
            for e in prof.profiler.kineto_results.events() if e.name().startswith('abacus.')]


def _caller(span, spans):
    """The innermost other span of the same thread holding `span`, or None."""
    name, s, e, th, _ = span
    outer = [o for o in spans if o is not span and o[3] == th and o[1] <= s and e <= o[2]]
    return max(outer, key=lambda o: o[1])[0] if outer else None


def test_span_without_profiler_enters_nothing(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError('a range was entered without a profiler')

    monkeypatch.setattr(profiling, '_Range', refuse)
    monkeypatch.setattr(torch.profiler, 'record_function', refuse)
    assert not torch.autograd._profiler_enabled()
    a, b = profiling.span('abacus.populate'), profiling.span('abacus.bin')
    assert a is b
    with a, b:
        pass


def test_span_is_a_host_range():
    """Under the profiler a span is a range of the function scope on its
    thread: listed by name, not a user annotation (which the profiler would
    mirror on the device's rows)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span('abacus.outer'):
            with profiling.span('abacus.inner'):
                torch.ones(4).add_(1)
    spans = _spans(prof)
    assert [s[0] for s in sorted(spans, key=lambda s: s[1])] == ['abacus.outer', 'abacus.inner']
    assert not any(s[4] for s in spans)
    inner = next(s for s in spans if s[0] == 'abacus.inner')
    assert _caller(inner, spans) == 'abacus.outer'


@pytest.mark.parametrize('path', list(PATHS))
def test_evaluation_spans_nest(cell_engine, path):
    run = _evaluation(path)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    spans = _spans(prof)
    want, callers = PATHS[path]
    assert Counter(s[0] for s in spans) == Counter(want)
    assert len(spans) <= 16
    for span in spans:
        assert _caller(span, spans) == callers.get(span[0]), span[0]
    # siblings never overlap: each pair is disjoint or one holds the other
    for a in spans:
        for b in spans:
            if a is not b and a[3] == b[3] and a[1] < b[1] < a[2]:
                assert b[2] <= a[2], (a[0], b[0])


@pytest.mark.parametrize('path', list(PATHS))
def test_cpu_evaluation_counts_no_transfer(cell_engine, path):
    run = _evaluation(path)
    before = dict(profiling.counters)
    run()
    after = dict(profiling.counters)
    for name in ('h2d_bytes', 'd2h_bytes', 'pinned_bytes'):
        assert after.get(name, 0) == before.get(name, 0), name


def test_count_copy_counts_crossings_by_direction():
    before = Counter(profiling.counters)
    a = np.ones(5, np.float32)
    t = torch.from_numpy(a)
    assert profiling.count_copy(a, t) is t  # host to host: nothing
    profiling.count_copy(t, t.clone())
    assert Counter(profiling.counters) == before
    meta = torch.empty(3, dtype=torch.float64, device='meta')  # stands in for a card
    profiling.count_copy(a, meta)
    profiling.count_copy(meta, t)
    got = Counter(profiling.counters)
    got.subtract(before)
    assert got['h2d_bytes'] == 24 and got['d2h_bytes'] == 20
    profiling.counters.subtract(got)  # leave the process's counts as they were
