"""Stage timing and device traces (the counterpart of
abacusutils_tpu/utils/profiling.py).

:func:`stage_timer` times a block by the host's clock, synchronising the
CUDA device before and after so that the interval holds the block's kernels
and not only their launches; on a CPU run it synchronises nothing.
:func:`device_trace` records a ``torch.profiler`` trace of CPU and CUDA
activity around a block and writes it as a Chrome / Perfetto JSON file.
"""

import logging
import os
import time
from contextlib import contextmanager

import torch

__all__ = ['stage_timer', 'device_trace', 'Timings']


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
