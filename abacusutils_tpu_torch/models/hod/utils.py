"""Logging for the HOD scripts: an elapsed-time formatter, a global
exception hook, ``mkdir -p`` and the command lines' help formatter (the
counterpart of abacusutils_tpu/models/hod/utils.py)."""

import argparse
import logging
import os
import sys
import time
import traceback

__all__ = ['setup_logging', 'exception_handler', 'mkdir', 'ArgParseFormatter']


class ElapsedTimeFormatter(logging.Formatter):
    """Prefixes log lines with the wall-clock time elapsed since setup."""

    def __init__(self, fmt='%(asctime)s %(name)-20s %(levelname)-8s %(message)s', **kw):
        super().__init__(fmt=fmt, **kw)
        self._start = time.time()

    def formatTime(self, record, datefmt=None):
        dt = record.created - self._start
        h, rem = divmod(dt, 3600)
        m, s = divmod(rem, 60)
        return f'[{int(h):03d}:{int(m):02d}:{s:06.3f}]'


_handler = None


def setup_logging(level=logging.INFO, stream=sys.stdout, filename=None, filemode='w', **kwargs):
    """Turn on logging with elapsed-time stamps; safe to call repeatedly."""
    global _handler
    if isinstance(level, str):
        level = getattr(logging, level.upper())
    root = logging.getLogger()
    if _handler is not None:
        root.removeHandler(_handler)
    if filename is not None:
        _handler = logging.FileHandler(filename)
    else:
        _handler = logging.StreamHandler(stream)
    _handler.setFormatter(ElapsedTimeFormatter())
    root.addHandler(_handler)
    root.setLevel(level)
    sys.excepthook = exception_handler


def exception_handler(exc_type, exc_value, exc_traceback):
    """Route uncaught exceptions through logging before exiting."""
    logging.critical(''.join(traceback.format_exception(exc_type, exc_value, exc_traceback)))
    if exc_type is KeyboardInterrupt:
        sys.__excepthook__(exc_type, exc_value, exc_traceback)


def mkdir(dirname):
    """mkdir -p."""
    os.makedirs(dirname, exist_ok=True)


class ArgParseFormatter(argparse.RawDescriptionHelpFormatter,
                        argparse.ArgumentDefaultsHelpFormatter):
    """Help formatter of the command lines: the description as written,
    each flag with its default."""
