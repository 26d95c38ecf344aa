"""K4 pair counts: the cell engine's share of its roofline, in %.

Counted from the problem: both sides' x, y, z read once (12 B a point) and,
for every pair the returned histogram counts (an autocorrelation's
unordered pairs once), PAIR_OPS float32 operations: 3 differences, 3
minimum-image corrections, 2 products and a sum for rp^2, and |dz| against
pi_max, the squared edges and the pi bin (3 compares). Pairs outside the
bins that a kernel must still reject are not counted: the share is of the
least work the answer needs."""

from benchmark.peaks import least_seconds

UNIT = '%'
KERNELS = ('pair_count_cells',)
PAIR_OPS = 12


def k4_least_seconds(counts):
    nbytes = sum(12.0 * (c['n1'] + c['n2']) for c in counts)
    ops = sum(PAIR_OPS * c['pairs'] for c in counts)
    return least_seconds(nbytes, ops)


def read(trace):
    s = trace.device_seconds(KERNELS)
    counts = [c for w in trace.work for c in w.get('pair_counts', ())]
    if s <= 0 or not counts:
        return None
    return 100.0 * k4_least_seconds(counts) / s
