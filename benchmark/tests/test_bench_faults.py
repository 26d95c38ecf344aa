"""The comparison that decides `correct` fails where it must: with the
control (the plain reference computed in bfloat16, in the program's place)
and with the program broken underneath the run, once for each fault a cell
can have. Small sizes on the CPU; the same numbers and limits as the card.

Faults: a step that returns its state unchanged (every evaluation answers
with the first one's result); half of the batch left out with the mean
taken over the rest (half of the galaxies dropped, the rest counted double);
an answer altered where it is produced (a spectrum bin, or one galaxy's
position). One card does all the work of a cell, so no exchange between
cards can be left out.

A fourth fault, ``answer``, alters the statistic's own answer in every cell
whose statistic names the AbacusHOD method that produces it (``PRODUCES``
in ``stats/<statistic>.py``): a statistic added as files brings its fault
with it."""

import functools

import numpy as np
import pytest
import torch

from abacusutils_tpu_torch.models import pipeline
from abacusutils_tpu_torch.models.hod import abacus_hod
from benchmark import harness
from benchmark.stats import common
from benchmark.tests import tiny

CELLS = tiny.cells()
HOD = abacus_hod.AbacusHOD


def _stat(name):
    return harness.Cell(name).traffic['statistic']


def _first_answer(monkeypatch, method):
    orig = getattr(HOD, method)
    memo = []

    @functools.wraps(orig)
    def stale(self, *a, **k):
        if not memo:
            memo.append(orig(self, *a, **k))
        return memo[0]

    monkeypatch.setattr(HOD, method, stale)


def _half_deposit(monkeypatch):
    orig = pipeline.tsc_deposit_cells

    def half(grid, x, y, z, w, plan, *a, **k):
        keep = torch.zeros_like(w)
        keep[::2] = 2.0
        return orig(grid, x, y, z, w * keep, plan, *a, **k)

    monkeypatch.setattr(pipeline, 'tsc_deposit_cells', half)


def _alter_spectrum(monkeypatch):
    orig = HOD.run_hod_pk_fused

    def altered(self, *a, **k):
        clustering, n_gal = orig(self, *a, **k)
        key = next(k for k in clustering if k.endswith('_modes')).removesuffix('_modes')
        clustering[key] = clustering[key].copy()
        clustering[key][-1] *= 2.0
        return clustering, n_gal

    monkeypatch.setattr(HOD, 'run_hod_pk_fused', altered)


def _mock_fault(monkeypatch, fault):
    orig = HOD.run_hod

    def broken(self, *a, **k):
        mock = orig(self, *a, **k)
        for td in mock.values():
            if fault == 'half':
                for c in ('x', 'y', 'z', 'vx', 'vy', 'vz', 'mass', 'id'):
                    td[c] = np.repeat(td[c][::2], 2)[:len(td[c])]
            else:
                td['z'] = td['z'].copy()
                td['z'][0] += 10.0
        return mock

    monkeypatch.setattr(HOD, 'run_hod', broken)


def _pair_key(key):
    parts = key.split('_')
    return len(parts) == 2 and all(p in common.TRACER_ORDER for p in parts)


def alter_answer(monkeypatch, method):
    """AbacusHOD.`method` returns the answer doubled in one bin: the middle
    bin of its first tracer pair's array ('LRG_LRG', ...), in the dict it
    returns or the first item of the tuple it returns. The middle, as the
    ends of a binned statistic are its least certain bins: a few modes at
    the lowest k, a correlation near nought at the widest separations."""
    orig = getattr(HOD, method)

    @functools.wraps(orig)
    def altered(self, *a, **k):
        out = orig(self, *a, **k)
        answer = out[0] if isinstance(out, tuple) else out
        key = next(k for k in answer if _pair_key(k))
        v = np.array(answer[key])
        v.flat[v.size // 2] *= 2.0
        answer[key] = v
        return out

    monkeypatch.setattr(HOD, method, altered)


def _produces(name):
    return getattr(harness.Cell(name).stat, 'PRODUCES', None)


def _break(monkeypatch, name, fault):
    stat = _stat(name)
    if fault == 'answer':
        alter_answer(monkeypatch, _produces(name))
    elif fault == 'stale':
        _first_answer(monkeypatch, 'run_hod_pk_fused' if stat == 'pk_fused' else 'run_hod')
    elif stat == 'pk_fused':
        (_half_deposit if fault == 'half' else _alter_spectrum)(monkeypatch)
    else:
        _mock_fault(monkeypatch, fault)


@pytest.mark.parametrize('name,fault', [(n, f) for n in CELLS
                                        for f in ('stale', 'half', 'altered')]
                         + [(n, 'answer') for n in CELLS if _produces(n)])
def test_fault_is_not_correct(monkeypatch, name, fault):
    _break(monkeypatch, name, fault)
    result, _ = tiny.run(name, seconds=1.5)
    assert result['attempted'] >= 2
    assert not result['correct'], result['checks']


@pytest.mark.parametrize('name', CELLS)
def test_control_is_not_correct(name):
    result, _ = tiny.run(name, seconds=0.5, control='bf16')
    assert result['attempted'] >= 1 and result['failed'] == 0
    assert not result['correct'], result['checks']
    failing = [k for k, c in result['checks'].items() if c['value'] > c['limit']]
    assert failing, result['checks']
