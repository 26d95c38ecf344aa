"""The program's spans in a traced window: the events they are read from,
the innermost ``abacus.*`` span at a time, and the program's counters over
the window.

The program names its steps with ``abacus.*`` host ranges
(``abacusutils_tpu_torch.utils.profiling.span``): ranges of the function
scope, which the profiler does not mirror on the device's rows, so they
add no device event. Spans nest and never overlap on a thread.
``benchmark.trace.reduce`` reads them in its one pass over the window:

- each device operation (kernel, copy, set) of the window goes to the
  innermost span open on the thread that launched it when its launch ran:
  the CUDA runtime or driver call (``cudaLaunchKernel``, ``cuLaunchKernel``,
  ``cudaMemcpyAsync``, ...) with the operation's correlation id; the
  host's other events count by another series of ids. Device time by
  span plus the unspanned rest is the window's device time;
- each idle gap between device operations is split among the spans open
  during it, each piece to the innermost span over it: a gap from the end
  of one evaluation's work to the start of the next runs through several
  of the host's steps, and each gets the time it held the card idle (the
  pieces under no span are left out);
- the counters are the difference of two snapshots of the program's
  ``profiling.counters``, taken at the window's ends (``window_counters``).
"""

import bisect
from collections import defaultdict
from typing import NamedTuple

import torch

PREFIX = 'abacus.'
# the names of the host events that launch device work: the CUDA runtime's
# and driver's calls
LAUNCH = 'cu'


def _field(e, *names):
    for n in names:
        f = getattr(e, n, None)
        if f is not None:
            return f()
    raise AttributeError(names[0])


class Event(NamedTuple):
    name: str
    device: bool
    start: float  # us
    end: float
    corr: int  # correlation id: a device operation's is its launch's
    thread: int


def events(prof):
    """Every Kineto event of `prof` as an :class:`Event`."""
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        try:
            start = _field(e, 'start_ns') / 1e3
            dur = _field(e, 'duration_ns') / 1e3
        except AttributeError:
            start, dur = _field(e, 'start_us'), _field(e, 'duration_us')
        out.append(Event(e.name(), e.device_type() == cuda, float(start), float(start + dur),
                         int(e.correlation_id()), int(e.start_thread_id())))
    return out


class Timeline:
    """The innermost ``abacus.*`` span open at a time, on each thread: the
    nested spans cut into disjoint pieces, each named by the innermost span
    over it."""

    def __init__(self, spans):
        by_thread = defaultdict(list)
        for e in spans:
            by_thread[e.thread].append((e.start, -e.end, e.name))
        self.pieces = {}
        for thread, evs in by_thread.items():
            pieces, open_ = [], []  # open_: [(end, name)], the innermost last
            t = None
            for s, neg_end, name in sorted(evs):
                while open_ and open_[-1][0] <= s:
                    end, outer = open_.pop()
                    pieces.append((t, end, outer))
                    t = end
                if open_:
                    pieces.append((t, s, open_[-1][1]))
                open_.append((-neg_end, name))
                t = s
            while open_:
                end, outer = open_.pop()
                pieces.append((t, end, outer))
                t = end
            pieces = [p for p in pieces if p[1] > p[0]]
            self.pieces[thread] = ([p[0] for p in pieces], pieces)

    def at(self, t, thread=None):
        """The name of the innermost span open at time `t` on `thread` (None:
        on any thread), or None."""
        threads = self.pieces if thread is None else (thread,)
        for th in threads:
            starts, pieces = self.pieces.get(th, ((), ()))
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t < pieces[i][1]:
                return pieces[i][2]
        return None

    def overlaps(self, a, b):
        """{name: us} of the interval [a, b] under each innermost span, on
        every thread."""
        out = defaultdict(float)
        for starts, pieces in self.pieces.values():
            i = max(bisect.bisect_right(starts, a) - 1, 0)
            while i < len(pieces) and pieces[i][0] < b:
                s, e, name = pieces[i]
                if e > a:
                    out[name] += min(e, b) - max(s, a)
                i += 1
        return out


def window_counters(before, after):
    """The counters' growth from snapshot `before` to `after` (dicts), the
    counters that did not move left out."""
    return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


def span_ms(trace, name):
    """Device ms an evaluation of span `name` in `trace` (a Trace carrying
    ``span_device``), or None."""
    s = (getattr(trace, 'span_device', None) or {}).get(name, 0.0)
    return 1e3 * s / trace.evals if s > 0 and trace.evals else None


def counter_mib(trace, names):
    """MiB an evaluation of the counters `names` in `trace` (a Trace
    carrying ``counters``), or None where none of them moved."""
    counts = getattr(trace, 'counters', None) or {}
    if not trace.evals or not any(n in counts for n in names):
        return None
    return sum(counts.get(n, 0) for n in names) / 2**20 / trace.evals
