"""On the card: one short run of each cell through `benchmark/run.py`, its
last line the result with `correct` true."""

import json
import subprocess
import sys

import pytest
import torch

from benchmark import harness
from benchmark.tests import tiny


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
