"""Populate: device time an evaluation (ms) of the operations launched
inside the program's ``abacus.populate`` span, its nested spans' left to
them: the markers, keep codes and RSD of every halo and particle. Read from
the window's device time by program span (``benchmark.spans``); None
without it."""

from benchmark.spans import span_ms

UNIT = 'ms'


def read(trace):
    return span_ms(trace, 'abacus.populate')
