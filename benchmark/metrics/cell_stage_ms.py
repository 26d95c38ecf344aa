"""Stage and plan caches: device time an evaluation (ms) of the pair
counts' cell stage, the ``abacus.cell_stage`` span: the sort of each
tracer's points by cell and the cell starts (``benchmark.spans``); None
without it."""

from benchmark.spans import span_ms

UNIT = 'ms'


def read(trace):
    return span_ms(trace, 'abacus.cell_stage')
