"""Abacus particle files (the counterpart of
abacusutils_tpu/io/read_abacus.py:read_asdf): RVint, pack9 and packed-PID
files of a box or a light cone, decoded on the host into a Table."""

import warnings
from os.path import basename

import numpy as np

from .asdf_file import open_asdf
from .bitpacked import unpack_pids, unpack_rvint
from .pack9 import unpack_pack9
from .table import Table

__all__ = ['read_asdf']

# the fields a packed-PID column can expand into
_PID_FIELDS = ('pid', 'lagr_pos', 'tagged', 'density', 'lagr_idx')

# the data columns the reader decodes, and the fields each gives when
# `load` is omitted; 'aux' (the raw words) can be asked of every one
_FORMAT_REGISTRY = {
    'rvint': ('pos', 'vel'),
    'pack9': ('pos', 'vel'),
    'packedpid': ('pid',),
    'pid': ('pid',),
}


def read_asdf(fn, load=None, colname=None, dtype=np.float32, verbose=True, **kwargs):
    """Decode one Abacus particle file into a Table, its ``meta`` the file's
    header.

    load: the fields, drawn from pos, vel, pid, lagr_pos, tagged, density,
    lagr_idx and aux (default: the column's, ``_FORMAT_REGISTRY``);
    colname: the data column when the file holds more than one; dtype: the
    float type of the decoded floats. ``data_key``, ``header_key`` and
    ``ppd`` may be given as keywords, and the deprecated ``load_pos`` /
    ``load_vel`` switches. A light cone's header (``OutputType``
    'LightCone') of AbacusSummit gets ``SubsampleFraction``, A + B."""
    tree_data_key = kwargs.get('data_key', 'data')
    tree_header_key = kwargs.get('header_key', 'header')

    with open_asdf(fn) as af:
        blobs = af.tree[tree_data_key]
        column = _pick_column(blobs, colname, fn)
        fields = _select_fields(column, load, kwargs)

        header = af.tree[tree_header_key]
        _annotate_lightcone(header, fn, verbose)

        packed = np.asarray(blobs[column])
        n_stored = len(packed)

        cols = {}
        if column in ('rvint', 'pack9'):
            # the decoders fill the buffers and return how many rows of the
            # blob were particles
            pos = np.empty((n_stored, 3), dtype=dtype) if 'pos' in fields else False
            vel = np.empty((n_stored, 3), dtype=dtype) if 'vel' in fields else False
            if column == 'rvint':
                counts = unpack_rvint(packed, header['BoxSize'], float_dtype=dtype, posout=pos,
                                      velout=vel)
            else:
                counts = unpack_pack9(packed, header['BoxSize'], header['VelZSpace_to_kms'],
                                      float_dtype=dtype, posout=pos, velout=vel)
            n_valid = max(counts)
            if 'pos' in fields:
                cols['pos'] = pos
            if 'vel' in fields:
                cols['vel'] = vel
        elif 'pid' in column:
            ppd = kwargs.get('ppd', int(round(header['ppd'])))
            wanted = {f: (f in fields) for f in _PID_FIELDS}
            cols.update(unpack_pids(packed, box=header['BoxSize'], ppd=ppd, float_dtype=dtype,
                                    **wanted))
            n_valid = n_stored
        else:
            raise ValueError(f'{fn}: no decoder for data column {column!r}')

        if 'aux' in fields:
            cols['aux'] = packed

    out = Table(meta=header)
    for name, arr in cols.items():
        out.add_column(arr, name=name, copy=False)
    return out[:n_valid]


def _pick_column(blobs, requested, fn):
    """The data column to decode: `requested`, or the one known column."""
    if requested is not None:
        return requested
    hits = [c for c in _FORMAT_REGISTRY if c in blobs]
    if len(hits) == 1:
        return hits[0]
    if not hits:
        raise ValueError(f'{fn}: found none of the known data columns {tuple(_FORMAT_REGISTRY)}; '
                         f'pass colname=')
    raise ValueError(f'{fn}: multiple candidate data columns {hits}; pass colname=')


def _select_fields(column, load, kwargs):
    """The requested fields: `load`, the deprecated load_pos / load_vel
    switches (each on when the other is explicitly off), or the column's
    default."""
    lp = kwargs.pop('load_pos', None)
    lv = kwargs.pop('load_vel', None)
    if lp is not None or lv is not None:
        if load is not None:
            warnings.warn('Both `load` and deprecated `load_pos`/`load_vel` given; '
                          'the deprecated switches are ignored.')
        else:
            warnings.warn('`load_pos`/`load_vel` are deprecated; use load=("pos","vel").',
                          FutureWarning)
            load = []
            if lp or (lp is None and lv is False):
                load.append('pos')
            if lv or (lv is None and lp is False):
                load.append('vel')

    if load is None:
        if column in _FORMAT_REGISTRY:
            load = _FORMAT_REGISTRY[column]
        elif 'pid' in column:
            load = ('pid',)
        else:
            load = ('pos', 'vel')
    return tuple(load)


def _annotate_lightcone(header, fn, verbose):
    """A light cone's files hold the A and B subsamples together: record the
    combined fraction in an AbacusSummit header."""
    if header.get('OutputType', None) != 'LightCone':
        return
    if header.get('SimSet', None) == 'AbacusSummit':
        frac = header['ParticleSubsampleA'] + header['ParticleSubsampleB']
        header['SubsampleFraction'] = frac
        if verbose:
            print(f'Loading "{basename(fn)}" (light cone: A+B subsamples, '
                  f'{int(frac * 100):d}% of particles)')
