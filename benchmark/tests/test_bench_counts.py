"""The roofline count functions give hand-worked figures on small shapes."""

import pytest

from benchmark import peaks
from benchmark.harness import ROOT, _module

M = ROOT / 'benchmark' / 'metrics'
k1 = _module(M / 'k1_roofline.py', 'k1_roofline_t')
k3 = _module(M / 'k3_roofline.py', 'k3_roofline_t')
k4 = _module(M / 'k4_roofline.py', 'k4_roofline_t')


def test_k1_bytes():
    # 100 galaxies (x, y, z, w: 16 B) and a 4^3 float32 mesh (256 B); twice
    assert k1.k1_bytes([(100, 4)]) == 1856
    assert k1.k1_bytes([(100, 4), (10, 2)]) == 1856 + 160 + 32


def test_k3_modes_in_range():
    # n = 4, L = 2 pi: k in units of 1; |k| < 1.5 holds k^2 in {0, 1, 2} on
    # the half mesh kz in {0, 1, 2}: the origin, 5 modes of k^2 = 1
    # ((+-1, 0, 0), (0, +-1, 0), (0, 0, 1)) and 8 of k^2 = 2
    assert k3.modes_in_range(4, 1.5, 2 * 3.141592653589793) == 14
    # |k| < 0.5: the origin alone
    assert k3.modes_in_range(4, 0.5, 2 * 3.141592653589793) == 1
    assert k3.k3_bytes([{'nfields': 3, 'nmesh': 4, 'kmax': 1.5,
                         'lbox': 2 * 3.141592653589793}]) == 8 * 3 * 14


def test_k4_least_seconds():
    c = [{'n1': 10, 'n2': 0, 'pairs': 100}]
    # 120 B against 1,200 operations
    assert k4.k4_least_seconds(c) == pytest.approx(max(120 / 3.35e12, 1200 / 67e12))
    big = [{'n1': 1e6, 'n2': 1e6, 'pairs': 1e10}]
    assert k4.k4_least_seconds(big) == pytest.approx(12 * 1e10 / peaks.F32_OPS_PER_S)
