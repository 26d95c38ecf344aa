"""Device: the share of the traced window in which no kernel, copy or set
ran on the card, in %."""

UNIT = '%'


def read(trace):
    if trace.window_s <= 0 or trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
