"""K3 binning: the mode-binning kernels' share of their roofline, in %.

Counted from the problem: the rfft modes of each field whose k lies in the
binned range [0, kmax), read once as complex64 (8 B a field). The modes are
counted from nmesh and kmax (the (n, n, n/2+1) half mesh the program
transforms to), not from the program's plan; the sums written are a few KB
and left out. A handful of float operations a mode and pair are far below
the float32 rate, so bytes bound it."""

from functools import cache

import numpy as np

from benchmark.peaks import least_seconds

UNIT = '%'
KERNELS = ('mode_bin',)


@cache
def modes_in_range(nmesh, kmax, lbox):
    """Modes of the rfft half mesh with |k| < kmax."""
    kf = 2.0 * np.pi / lbox
    f = np.fft.fftfreq(nmesh, d=1.0 / nmesh)
    r2 = (kmax / kf) ** 2 - (f[:, None] ** 2 + f[None, :] ** 2)
    # kz = 0 .. n/2 with kz^2 < r2
    nz = np.where(r2 > 0, np.ceil(np.sqrt(np.maximum(r2, 0.0))), 0.0)
    return int(np.minimum(nz, nmesh // 2 + 1).sum())


def k3_bytes(binnings):
    return sum(8.0 * b['nfields'] * modes_in_range(b['nmesh'], b['kmax'], b['lbox'])
               for b in binnings)


def read(trace):
    s = trace.device_seconds(KERNELS)
    bins = [b for w in trace.work for b in w.get('binnings', ())]
    if s <= 0 or not bins:
        return None
    return 100.0 * least_seconds(k3_bytes(bins)) / s
