"""The traced window: torch.profiler's events reduced to what the per-layer
metrics read.

The window runs under ``torch.profiler.profile`` (CPU and CUDA activities),
with a ``benchmark.window`` span around it and a ``bench.<stage>`` span
around each call into the program. Afterwards the raw Kineto events give:

- the device operations (kernels, copies, sets), their names and
  intervals; busy_s is the length of their union inside the window;
- the idle gaps between them, each named by the innermost host span and
  the innermost host operation running at its middle;
- device time by operation name, which the metric modules group.

Nothing is written to disk; the events stay in memory.
"""

import bisect
from collections import defaultdict

import torch

WINDOW = 'benchmark.window'
_TOP = 10


def _field(e, *names):
    for n in names:
        f = getattr(e, n, None)
        if f is not None:
            return f()
    raise AttributeError(names[0])


def _events(prof):
    """(name, is_device, start_us, end_us) of every Kineto event."""
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        try:
            start = _field(e, 'start_ns') / 1e3
            dur = _field(e, 'duration_ns') / 1e3
        except AttributeError:
            start, dur = _field(e, 'start_us'), _field(e, 'duration_us')
        out.append((e.name(), e.device_type() == cuda, float(start), float(start + dur)))
    return out


class Trace:
    """What the metrics read: the window's length and busy time (s), the
    evaluations in it, device seconds by operation name, and each
    evaluation's work (the statistic's ``work``)."""

    def __init__(self, window_s, busy_s, evals, device, work, breakdown=None):
        self.window_s = window_s
        self.busy_s = busy_s
        self.evals = evals
        self.device = dict(device)
        self.work = list(work)
        self.breakdown = breakdown or {}

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
    """The Trace of a window from `events` ((name, is_device, start_us,
    end_us), as :func:`_events` gives them)."""
    win = [(s, e) for n, d, s, e in events if not d and n == WINDOW]
    lo, hi = (win[0] if win else (min(s for *_, s, _ in events), max(e for *_, e in events)))
    # the spans' own device-side annotations are not device work
    dev = [(n, max(s, lo), min(e, hi)) for n, d, s, e in events
           if d and e > lo and s < hi and not n.startswith('bench.') and n != WINDOW]
    by_name = defaultdict(float)
    for n, s, e in dev:
        by_name[n] += (e - s) / 1e6
    busy = _union([(s, e) for _, s, e in dev])
    busy_s = sum(e - s for s, e in busy) / 1e6
    host = [(n, s, e) for n, d, s, e in events if not d and n != WINDOW and e > s]
    spans = _index([h for h in host if h[0].startswith('bench.')])
    ops = _index([h for h in host if not h[0].startswith('bench.')])
    gaps = []
    edge = lo
    for s, e in busy + [[hi, hi]]:
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, e)
    idle = defaultdict(float)
    for s, e in gaps:
        mid = 0.5 * (s + e)
        span, op = _innermost(spans, mid, 8), _innermost(ops, mid, 64)
        idle[f'{span or "host"} / {op or "python"}'] += (e - s) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:_TOP]
    breakdown = {
        'device_ops': [[n[:160], s] for n, s in top],
        'idle_gaps': [[n[:160], s] for n, s in sorted(idle.items(), key=lambda kv: -kv[1])[:_TOP]],
    }
    return Trace(window_s, busy_s, evals, by_name, work, breakdown)


def profile():
    """A profiler over the card and the host, events kept in memory."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts, record_shapes=False, with_stack=False)


def from_profiler(prof, window_s, evals, work):
    return reduce(_events(prof), window_s, evals, work)
