"""Host transfers: bytes copied between the host and the card an
evaluation (MiB), both ways, by the program's counters ``h2d_bytes`` and
``d2h_bytes`` over the window. None without the counters."""

from benchmark.spans import counter_mib

UNIT = 'MiB'


def read(trace):
    return counter_mib(trace, ('h2d_bytes', 'd2h_bytes'))
