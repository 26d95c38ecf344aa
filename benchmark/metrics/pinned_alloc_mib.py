"""Host transfers: page-locked host memory allocated an evaluation (MiB),
by the program's counter ``pinned_bytes`` over the window: run_hod's
download buffers. None without the counter."""

from benchmark.spans import counter_mib

UNIT = 'MiB'


def read(trace):
    return counter_mib(trace, ('pinned_bytes',))
