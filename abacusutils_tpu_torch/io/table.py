"""A minimal column-store Table with ECSV write and read (the counterpart of
abacusutils_tpu/io/table.py): the galaxy catalogs of ``AbacusHOD.run_hod``
(``write_to_disk=True``) and ``AbacusHOD.gal_reader``.

The JAX package writes the ECSV header with ``yaml.safe_dump`` and reads it
with ``yaml.safe_load``. This module writes and reads the same header by
hand: the ``# %ECSV 1.0`` datatype lines, and ``meta`` as a flat YAML block
of ints, floats, strings, booleans and nulls (what run_hod stores: Ncent,
Gal_type and the tracer's HOD parameters), in PyYAML's sorted key order and
scalar forms. The data rows are ``%d`` for integers, ``%.9g`` for float32
and ``%.17g`` for float64, so values survive a round trip bit for bit.
"""

import json
import math
import re

import numpy as np

__all__ = ['Table']


class Table:
    """Columns (numpy arrays) by name, in insertion order, and a ``meta``
    dict (io/table.py:Table): what run_hod's catalogs and gal_reader need of
    it."""

    def __init__(self, data=None, meta=None, copy=True):
        self.columns = {}
        self.meta = dict(meta) if meta else {}
        if data is not None:
            if isinstance(data, Table):
                self.meta.update(data.meta)
                data = data.columns
            for k, v in data.items():
                self.add_column(v, name=k, copy=copy)

    @property
    def colnames(self):
        return list(self.columns)

    def add_column(self, col, name=None, copy=True):
        if name is None:
            name = f'col{len(self.columns)}'
        arr = np.asarray(col)
        self.columns[name] = arr.copy() if copy else arr

    def __setitem__(self, name, col):
        """Add or replace the column `name` (not copied)."""
        self.add_column(col, name=name, copy=False)

    def remove_column(self, name):
        del self.columns[name]

    def rename_column(self, old, new):
        """Rename a column in place, keeping the column order."""
        self.columns = {new if k == old else k: v for k, v in self.columns.items()}

    def __getitem__(self, key):
        """A column by name, a Table of the named columns, or a Table of the
        rows a slice, mask or index array selects."""
        if isinstance(key, str):
            return self.columns[key]
        if isinstance(key, (list, tuple)) and key and isinstance(key[0], str):
            return Table({k: self.columns[k] for k in key}, meta=self.meta, copy=False)
        return Table({k: v[key] for k, v in self.columns.items()}, meta=self.meta, copy=False)

    def __contains__(self, key):
        return key in self.columns

    def __len__(self):
        return len(next(iter(self.columns.values()))) if self.columns else 0

    def __iter__(self):
        return iter(self.columns)

    def keys(self):
        return self.columns.keys()

    def items(self):
        return self.columns.items()

    def __repr__(self):
        cols = ', '.join(f'{k}[{v.dtype}]' for k, v in self.columns.items())
        return f'<Table length={len(self)} cols=({cols})>'

    # -- ECSV ------------------------------------------------------------------
    _ECSV_TYPES = {
        'int8': np.int8, 'int16': np.int16, 'int32': np.int32, 'int64': np.int64,
        'uint8': np.uint8, 'uint16': np.uint16, 'uint32': np.uint32,
        'uint64': np.uint64, 'float32': np.float32, 'float64': np.float64,
        'bool': np.bool_, 'string': 'U32',
    }

    def write(self, fn, format='ascii.ecsv', overwrite=True):
        """Write the ECSV file of io/table.py:Table.write (scalar columns;
        meta a flat dict of ints, floats, strings, booleans and None)."""
        if format != 'ascii.ecsv':
            raise NotImplementedError(format)
        names = self.colnames
        cols = [self.columns[k] for k in names]
        for k, c in zip(names, cols):
            if c.ndim != 1:
                raise NotImplementedError(f'ECSV write of non-1D column {k}')
        inv = {v: k for k, v in self._ECSV_TYPES.items() if isinstance(v, type)}
        with open(fn, 'w') as f:
            f.write('# %ECSV 1.0\n# ---\n')
            f.write('# datatype:\n')
            for k, c in zip(names, cols):
                f.write(f'# - {{name: {k}, datatype: {inv.get(c.dtype.type, str(c.dtype))}}}\n')
            if self.meta:
                f.write('# meta:\n')
                for k in sorted(self.meta):
                    f.write(f'#   {_yaml_key(k)}: {_yaml_scalar(self.meta[k])}\n')
            f.write('# schema: astropy-2.0\n')
            f.write(' '.join(names) + '\n')
            stacked = np.rec.fromarrays(cols, names=names)
            fmt = ' '.join(
                '%d' if np.issubdtype(c.dtype, np.integer) else '%.9g'
                if c.dtype == np.float32
                else '%.17g'
                if np.issubdtype(c.dtype, np.floating)
                else '%s'
                for c in cols
            )
            np.savetxt(f, stacked, fmt=fmt)

    @classmethod
    def read(cls, fn, format='ascii.ecsv'):
        """Read an ECSV file of :meth:`write` or of the JAX package's
        Table.write (io/table.py:Table.read). A meta block that is not flat
        is refused."""
        names, dtypes, meta_lines = [], [], []
        with open(fn) as f:
            lines = f.readlines()
        i = 0
        for i, line in enumerate(lines):
            if not line.startswith('#'):
                break
            s = line[1:].removeprefix(' ').rstrip('\n')
            st = s.strip()
            m = _DATATYPE.fullmatch(st)
            if m:
                names.append(m['name'])
                dtypes.append(cls._ECSV_TYPES.get(m['datatype'], m['datatype']))
            elif st and not st.startswith(('%ECSV', '---', 'datatype:', 'schema:')):
                meta_lines.append(s)
        header = lines[i].split()
        assert header == names, (header, names)
        data = np.loadtxt(lines[i + 1:], dtype=[(n, d) for n, d in zip(names, dtypes)], ndmin=1)
        t = cls({n: data[n] for n in names}, copy=False)
        t.meta.update(_read_meta(meta_lines))
        return t


_DATATYPE = re.compile(r'- \{name: (?P<name>[^,]+), datatype: (?P<datatype>[^}]+)\}')

# PyYAML's resolvers (yaml/resolver.py) for the scalars a flat meta holds
_YAML_BOOL = {**dict.fromkeys(('yes', 'Yes', 'YES', 'true', 'True', 'TRUE', 'on', 'On', 'ON'),
                              True),
              **dict.fromkeys(('no', 'No', 'NO', 'false', 'False', 'FALSE', 'off', 'Off', 'OFF'),
                              False)}
_YAML_NULL = ('~', 'null', 'Null', 'NULL', '')
_YAML_INT = re.compile(r'[-+]?(0|[1-9][0-9_]*)')
_YAML_FLOAT = re.compile(
    r'[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?')
_YAML_SPECIAL = {'.inf': math.inf, '.Inf': math.inf, '.INF': math.inf, '+.inf': math.inf,
                 '+.Inf': math.inf, '+.INF': math.inf, '-.inf': -math.inf, '-.Inf': -math.inf,
                 '-.INF': -math.inf, '.nan': math.nan, '.NaN': math.nan, '.NAN': math.nan}
_PLAIN = re.compile(r'[A-Za-z_][A-Za-z0-9_.\-/]*')


def _parse_scalar(s):
    """A YAML scalar of a flat block mapping, as yaml.safe_load reads it."""
    s = s.strip()
    if s.startswith("'"):
        if len(s) < 2 or not s.endswith("'"):
            raise ValueError(f'unterminated quoted scalar {s!r}')
        return s[1:-1].replace("''", "'")
    if s.startswith('"'):
        return json.loads(s)
    if s in _YAML_NULL:
        return None
    if s in _YAML_BOOL:
        return _YAML_BOOL[s]
    if _YAML_INT.fullmatch(s):
        return int(s.replace('_', ''))
    if s in _YAML_SPECIAL:
        return _YAML_SPECIAL[s]
    if _YAML_FLOAT.fullmatch(s):
        return float(s.replace('_', ''))
    if s[:1] in '[{&*!|>%@`':
        raise ValueError(f'meta value {s!r} is not a flat scalar')
    return s


def _yaml_scalar(v):
    """A flat meta value in the form yaml.safe_dump writes it."""
    if isinstance(v, np.generic):
        v = v.item()
    if v is None:
        return 'null'
    if isinstance(v, bool):
        return 'true' if v else 'false'
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if v != v:
            return '.nan'
        if math.isinf(v):
            return '.inf' if v > 0 else '-.inf'
        r = repr(v).lower()
        if '.' not in r and 'e' in r:
            r = r.replace('e', '.0e', 1)
        return r
    if isinstance(v, str):
        if _PLAIN.fullmatch(v) and _parse_scalar(v) == v:
            return v
        return "'" + v.replace("'", "''") + "'"
    raise NotImplementedError(f'ECSV meta value of type {type(v).__name__}: only flat scalars')


def _yaml_key(k):
    if not isinstance(k, str):
        raise NotImplementedError(f'ECSV meta key {k!r}: only strings')
    return _yaml_scalar(k)


def _read_meta(lines):
    """The flat ``meta:`` block of an ECSV header as a dict."""
    if not lines:
        return {}
    if lines[0].strip() != 'meta:':
        raise ValueError(f'ECSV header line {lines[0]!r} is not a meta block')
    meta = {}
    for line in lines[1:]:
        body = line.strip()
        if body.endswith(':'):
            key, value = body[:-1], ''
        else:
            key, sep, value = body.partition(': ')
        if not line.startswith('  ') or line.startswith('   ') or (
                not body.endswith(':') and not sep):
            raise ValueError(f'ECSV meta line {line!r} is not a flat key: value pair')
        meta[_parse_scalar(key)] = _parse_scalar(value)
    return meta
