"""Device: idle time of the card an evaluation (ms) while a program span
was open, summed over the spans (``benchmark.spans``): the host's work
inside the program that the card waited for. None without the spans."""

UNIT = 'ms'


def read(trace):
    idle = getattr(trace, 'span_idle', None)
    if not idle or not trace.evals:
        return None
    return 1e3 * sum(idle.values()) / trace.evals
