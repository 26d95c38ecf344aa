"""Stage timing, device traces, the program's spans and its transfer
counters (the counterpart of abacusutils_tpu/utils/profiling.py).

:func:`stage_timer` times a block by the host's clock, synchronising the
CUDA device before and after so that the interval holds the block's kernels
and not only their launches; on a CPU run it synchronises nothing.
:func:`device_trace` records a ``torch.profiler`` trace of CPU and CUDA
activity around a block and writes it as a Chrome / Perfetto JSON file.

:func:`span` names a step of the program (``abacus.populate``,
``abacus.deposit``, ...) on the profiler's timeline, where a trace is being
recorded, and costs one check where none is; it never waits for the
device. :data:`counters` counts, always, the bytes the evaluation paths
copy between the host and a card (``h2d_bytes``, ``d2h_bytes``) and the
page-locked host memory they allocate (``pinned_bytes``).
"""

import collections
import contextlib
import logging
import os
import time
from contextlib import contextmanager

import torch

__all__ = ['stage_timer', 'device_trace', 'Timings', 'span', 'counters', 'count', 'count_copy']

# {name: int}: the program's counters since the process started; read a
# difference of two snapshots (dict(counters)) for a stretch of work
counters = collections.Counter()

_NO_SPAN = contextlib.nullcontext()
_profiling = torch.autograd._profiler_enabled
_Range = torch._C._profiler._RecordFunctionFast


class Timings(dict):
    """Accumulated {stage: seconds}; pretty string via str()."""

    def __str__(self):
        total = sum(self.values())
        parts = [f'{k}: {v:.4g}s' for k, v in self.items()]
        return ', '.join(parts) + f' (total {total:.4g}s)'


def _synchronize(device):
    """Wait for the CUDA device `device` (None: the current one); nothing for
    a CPU device, or where there is no CUDA device at all. A CUDA error
    raised by the wait is not caught."""
    if device is not None:
        device = torch.device(device)
        if device.type != 'cuda':
            return
    elif not torch.cuda.is_available():
        return
    torch.cuda.synchronize(device)


@contextmanager
def stage_timer(name, timings=None, logger=None, sync=True, device=None):
    """Time a stage, synchronising `device` (None: the current CUDA device)
    at entry and at exit when `sync`, so that the interval is this stage's
    device work. Adds the seconds to ``timings[name]`` and logs them at debug
    level.

    >>> t = Timings()
    >>> with stage_timer('paint', t): grid = paint(...)
    """
    if sync:
        _synchronize(device)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync:
            _synchronize(device)
        dt = time.perf_counter() - t0
        if timings is not None:
            timings[name] = timings.get(name, 0.0) + dt
        (logger or logging.getLogger('abacusutils_tpu_torch')).debug('%s: %.4f s', name, dt)


@contextmanager
def device_trace(logdir):
    """Record a ``torch.profiler`` trace (CPU activity, and CUDA activity
    where there is a CUDA device) around a block and write it to
    ``logdir/trace_<pid>_<ns>.json`` (Chrome trace format: Perfetto and
    chrome://tracing read it). Yields the path the trace will be written
    to; the file exists once the block has ended.

    >>> with device_trace('traces') as fn: run_step()
    """
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    fn = os.path.join(logdir, f'trace_{os.getpid()}_{time.time_ns()}.json')
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield fn
    prof.export_chrome_trace(fn)


def span(name):
    """A context naming a step of the program on the profiler's timeline.

    Under a running ``torch.profiler`` (:func:`device_trace`, or any other)
    the step is a host range of the launching thread, on the clock of the
    CUDA activity the profiler records: in the Perfetto view of
    :func:`device_trace`'s file it is a slice of that thread, and the flow
    arrows of the launches inside it lead to their kernels and copies.
    Spans nest; every name starts with ``abacus.``. A span is a range of
    the function scope, not a ``record_function`` user annotation, which
    the profiler would mirror on the device's rows as one interval from
    the first to the last kernel launched inside it: the device rows hold
    only device work. Without a profiler the span is a shared no-op: one
    check, no range entered, nothing synchronised.

    >>> with span('abacus.populate'): keep = codes(halo, params)
    """
    if not _profiling():
        return _NO_SPAN
    return _Range(name)


def count(name, n=1):
    """Add `n` to ``counters[name]``."""
    counters[name] += n


def count_copy(src, dst):
    """Count `dst`, the copy of `src` (a tensor, or a host array), in
    ``counters['h2d_bytes']`` or ``counters['d2h_bytes']`` where the copy
    crossed between the host and a card, by its bytes; nothing where both
    lie on the host, or both on a card. Returns `dst`.

    >>> t = count_copy(a, torch.from_numpy(a).to(device))
    """
    on_host = [not isinstance(a, torch.Tensor) or a.device.type == 'cpu' for a in (src, dst)]
    if on_host[0] != on_host[1]:
        counters['d2h_bytes' if on_host[1] else 'h2d_bytes'] += dst.nbytes
    return dst
