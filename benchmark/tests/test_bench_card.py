"""On the card: one short run of each cell through `benchmark/run.py`, its
last line the result with `correct` true; a short traced run reports the
program's spans and counters."""

import json
import subprocess
import sys

import pytest
import torch

from benchmark import harness, trace
from benchmark.tests import tiny
from benchmark.tests.test_bench_spans import NEW


@pytest.mark.cuda
@pytest.mark.parametrize('name', tiny.cells())
def test_cell_runs_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    out = subprocess.run([sys.executable, 'benchmark/run.py', '--workload', name, '--seed',
                          str(2**31 + 11), '--seconds', '3', '--trace', '0'],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result['correct'], result['checks']
    assert result['device']['platform'] == 'gpu' and result['device']['count'] == 1


@pytest.mark.cuda
def test_traced_run_reports_the_spans(monkeypatch):
    """box_lrg_xirppi at its own size, traced for two seconds: the six
    metrics of the program's spans and counters read, and the device time
    by span plus the time launched under none is the window's device total.
    (At the CPU tests' small size its pair counts go to the all-pairs
    engine, which stages no cells, and cell_stage_ms reads nothing.)"""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    traces = []
    from_profiler = trace.from_profiler

    def keep(*a):
        traces.append(from_profiler(*a))
        return traces[-1]

    monkeypatch.setattr(trace, 'from_profiler', keep)
    cell = harness.Cell('box_lrg_xirppi')
    result, _ = harness.run(cell, 2**31 + 13, 2.0, True, 'cuda')
    assert result['correct'], result['checks']
    assert {m['name'] for m in cell.per_layer} >= set(NEW)
    assert set(NEW) <= set(result['metrics']), result['metrics']
    tr = traces[0]
    assert sum(tr.span_device.values()) + tr.span_rest == pytest.approx(
        tr.device_seconds(None), rel=1e-3)
