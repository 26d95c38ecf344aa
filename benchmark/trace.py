"""The traced window: torch.profiler's events reduced to what the per-layer
metrics read.

The window runs under ``torch.profiler.profile`` (CPU and CUDA activities),
with a ``benchmark.window`` span around it and a ``bench.<stage>`` span
around each call into the program. Afterwards the raw Kineto events give:

- the device operations (kernels, copies, sets), their names and
  intervals; busy_s is the length of their union inside the window;
- the idle gaps between them, each named by the innermost host span and,
  at its middle, the innermost of the program's ``abacus.*`` spans open
  there or, where none is, the innermost host operation running;
- device time by operation name, which the metric modules group;
- the program's spans and counters (``benchmark.spans``): device and idle
  seconds by span, and the counters' growth over the window, which the
  harness sets.

Nothing is written to disk; the events stay in memory.
"""

import bisect
from collections import defaultdict

import torch

from benchmark import spans

WINDOW = 'benchmark.window'
# host ranges that the profiler may mirror on the device's rows: the
# benchmark's own and the program's spans, not device work
_ANNOTATIONS = ('bench.', 'abacus.')
_TOP = 10


class Trace:
    """What the metrics read: the window's length and busy time (s), the
    evaluations in it, device seconds by operation name, and each
    evaluation's work (the statistic's ``work``). From the program's spans
    (set by :func:`reduce`): ``span_device`` and ``span_idle`` ({span: s})
    and ``span_rest`` (device seconds launched under no span); from its
    counters (set by the harness, None untraced): ``counters`` ({name:
    growth over the window})."""

    def __init__(self, window_s, busy_s, evals, device, work, breakdown=None):
        self.window_s = window_s
        self.busy_s = busy_s
        self.evals = evals
        self.device = dict(device)
        self.work = list(work)
        self.breakdown = breakdown or {}
        self.span_device = self.span_idle = self.span_rest = self.counters = None

    def device_seconds(self, keys):
        """Device seconds of the operations whose names hold one of `keys`
        (case-insensitive); None: all of them."""
        if keys is None:
            return sum(self.device.values())
        low = [k.lower() for k in keys]
        return sum(s for n, s in self.device.items() if any(k in n.lower() for k in low))


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _innermost(events, t, reach):
    """The name of the innermost of `events` ((starts, [(name, start, end)])
    sorted by start) that runs at time t, looking back `reach` events."""
    i = bisect.bisect_right(events[0], t)
    for j in range(i - 1, max(i - reach, 0) - 1, -1):
        name, _, e = events[1][j]
        if e >= t:
            return name
    return None


def _index(evs):
    evs = sorted(evs, key=lambda x: x[1])
    return [s for _, s, _ in evs], evs


def reduce(events, window_s, evals, work):
    """The Trace of a window from `events` (``benchmark.spans.Event``, as
    ``spans.events`` gives them): the ``benchmark.window`` host range, or
    every event's extent without one. One pass over its device operations
    gives device time by name and by the program's launching span, and one
    walk over its idle gaps names them and splits them among the spans."""
    win = [(e.start, e.end) for e in events if not e.device and e.name == WINDOW]
    lo, hi = win[0] if win else (min(e.start for e in events), max(e.end for e in events))
    timeline = spans.Timeline([e for e in events
                               if not e.device and e.name.startswith(spans.PREFIX)])
    launch = {e.corr: e for e in events if not e.device and e.name.startswith(spans.LAUNCH)}
    by_name, by_span, rest = defaultdict(float), defaultdict(float), 0.0
    busy = []
    for e in events:
        # the spans' own device-side annotations are not device work
        if (not e.device or e.end <= lo or e.start >= hi or e.name.startswith(_ANNOTATIONS)
                or e.name == WINDOW):
            continue
        s, t = max(e.start, lo), min(e.end, hi)
        busy.append((s, t))
        by_name[e.name] += (t - s) / 1e6
        by = launch.get(e.corr)
        span = None if by is None else timeline.at(by.start, by.thread)
        if span is None:
            rest += (t - s) / 1e6
        else:
            by_span[span] += (t - s) / 1e6
    busy = _union(busy)
    busy_s = sum(t - s for s, t in busy) / 1e6
    host = [(e.name, e.start, e.end) for e in events
            if not e.device and e.name != WINDOW and e.end > e.start]
    benches = _index([h for h in host if h[0].startswith('bench.')])
    ops = _index([h for h in host if not h[0].startswith('bench.')])
    idle, span_idle = defaultdict(float), defaultdict(float)
    edge = lo
    for s, t in busy + [[hi, hi]]:
        if s > edge:
            mid = 0.5 * (edge + s)
            bench = _innermost(benches, mid, 8)
            op = timeline.at(mid) or _innermost(ops, mid, 64)
            idle[f'{bench or "host"} / {op or "python"}'] += (s - edge) / 1e6
            for span, us in timeline.overlaps(edge, s).items():
                span_idle[span] += us / 1e6
        edge = max(edge, t)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:_TOP]
    breakdown = {
        'device_ops': [[n[:160], s] for n, s in top],
        'idle_gaps': [[n[:160], s] for n, s in sorted(idle.items(), key=lambda kv: -kv[1])[:_TOP]],
    }
    tr = Trace(window_s, busy_s, evals, by_name, work, breakdown)
    tr.span_device, tr.span_idle, tr.span_rest = dict(by_span), dict(span_idle), rest
    return tr


def profile():
    """A profiler over the card and the host, events kept in memory."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts, record_shapes=False, with_stack=False)


def from_profiler(prof, window_s, evals, work):
    return reduce(spans.events(prof), window_s, evals, work)
