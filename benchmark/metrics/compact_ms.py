"""Populate: device time an evaluation (ms) of run_hod's compaction, the
``abacus.compact`` span: the selection of the kept rows, their gathers and
their copies to the host (``benchmark.spans``); None without it."""

from benchmark.spans import span_ms

UNIT = 'ms'


def read(trace):
    return span_ms(trace, 'abacus.compact')
