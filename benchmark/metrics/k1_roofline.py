"""K1 deposit: the TSC deposit kernel's share of its roofline, in %.

Counted from the problem: each deposited galaxy's x, y, z and weight read
once (16 B) and each mesh written once (nmesh^3 float32); the stencil's
27 x 5 float operations a galaxy are far below the float32 rate, so bytes
bound it. The galaxies are those the evaluation returns (its galaxy
counts, or the rows of its run_hod mock)."""

from benchmark.peaks import least_seconds

UNIT = '%'
KERNELS = ('tsc_deposit',)


def k1_bytes(grids):
    """Bytes of deposits [(galaxies, nmesh)], one mesh each."""
    return sum(16.0 * n + 4.0 * m**3 for n, m in grids)


def read(trace):
    s = trace.device_seconds(KERNELS)
    grids = [g for w in trace.work for g in w.get('grids', ())]
    if s <= 0 or not grids:
        return None
    return 100.0 * least_seconds(k1_bytes(grids)) / s
