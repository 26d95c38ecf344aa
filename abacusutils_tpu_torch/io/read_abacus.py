"""Abacus particle files (the counterpart of
abacusutils_tpu/io/read_abacus.py:read_asdf), limited to the RVint files of
a box: the ``field_rv_A`` and ``halo_rv_A`` files prepare_sim's shear field
reads. pack9 and packed-PID files, and the light cone's, are not on the
port's disk path yet (ROADMAP.md)."""

import numpy as np

from .asdf_file import open_asdf
from .bitpacked import unpack_rvint
from .table import Table

__all__ = ['read_asdf']

_NOT_PORTED = ('pack9 and packed-PID particle files are not ported yet '
               '(ROADMAP.md, queue 1: the PID unpackers and pack9)')


def read_asdf(fn, load=None):
    """Decode one RVint particle file into a Table of float32 'pos' and/or
    'vel' (``load``, default both), its ``meta`` the file's header."""
    with open_asdf(fn) as af:
        blobs, header = af.tree['data'], af.tree['header']
        hits = [c for c in ('rvint', 'pack9', 'packedpid', 'pid') if c in blobs]
        if len(hits) != 1:
            raise ValueError(f'{fn}: data columns {hits}, expected one')
        column = hits[0]
        fields = tuple(('pos', 'vel') if load is None else load)
        if column != 'rvint' or any(f not in ('pos', 'vel') for f in fields):
            raise NotImplementedError(f'{fn}: column {column!r}, fields {fields}: {_NOT_PORTED}')
        packed = np.asarray(blobs[column])
        n = len(packed)
        pos = np.empty((n, 3), dtype=np.float32) if 'pos' in fields else False
        vel = np.empty((n, 3), dtype=np.float32) if 'vel' in fields else False
        n_valid = max(unpack_rvint(packed, header['BoxSize'], posout=pos, velout=vel))
    out = Table(meta=header)
    for name, arr in (('pos', pos), ('vel', vel)):
        if name in fields:
            out.add_column(arr[:n_valid], name=name, copy=False)
    return out
