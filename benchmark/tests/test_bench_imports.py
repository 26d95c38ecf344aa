"""Nothing the benchmark runs loads JAX, flax, the JAX package or its
compatibility alias, and the reference loads nothing of the program either.
Modules are compared by their whole top-level name (``abacusutils_tpu_torch``
begins with ``abacusutils_tpu``)."""

import ast
import json
import subprocess
import sys
from pathlib import Path

from benchmark import harness

BENCH = harness.ROOT / 'benchmark'
FORBIDDEN = {'jax', 'jaxlib', 'flax', 'abacusutils_tpu', 'abacusnbody'}
PROGRAM = 'abacusutils_tpu_torch'


def _loaded(code):
    """Top-level names in sys.modules after `code` runs in a fresh
    interpreter at the repository root."""
    src = (f'import sys, json\nsys.path.insert(0, {str(harness.ROOT)!r})\n{code}\n'
           'print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))')
    out = subprocess.run([sys.executable, '-c', src], capture_output=True, text=True,
                         cwd=harness.ROOT, timeout=600, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    names = _loaded(
        'from benchmark.tests import tiny\n'
        'from benchmark import harness, readings, run\n'
        'for c in tiny.cells():\n'
        '    harness.Cell(c)\n'
        'res, _ = tiny.run("box3_pk_fused", seconds=0.5)\n'
        'assert res["correct"]\n')
    assert PROGRAM in names
    assert not names & FORBIDDEN, names & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    mods = ', '.join(f'benchmark.reference.{p.stem}' for p in (BENCH / 'reference').glob('*.py'))
    names = _loaded(f'import {mods}')
    assert not names & (FORBIDDEN | {PROGRAM}), names & (FORBIDDEN | {PROGRAM})


def _imports(path):
    tree = ast.parse(Path(path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split('.')[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split('.')[0]


def test_sources_name_no_forbidden_module():
    for p in BENCH.rglob('*.py'):
        tops = set(_imports(p))
        assert not tops & FORBIDDEN, (p, tops & FORBIDDEN)
        if 'reference' in p.parts:
            assert PROGRAM not in tops, p
