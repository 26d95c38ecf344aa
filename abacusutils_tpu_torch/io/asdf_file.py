"""A minimal ASDF reader and writer (the counterpart of
abacusutils_tpu/io/asdf_file.py), with the YAML tree read and written by
:mod:`.asdf_yaml` instead of PyYAML and the Blosc blocks by :mod:`.blosc`.

- The YAML tree's ``!core/ndarray-1.0.0`` nodes resolve lazily against the
  binary blocks (:class:`NDArrayRef`); an inline ndarray becomes an array.
- Blocks are raw or ``blsc`` (zstd Blosc chunks, the Abacus format).
- An astropy table tag (``tag:astropy.org:astropy/table/table-*``) becomes
  :class:`~.table.Table`, so files written by the JAX package's
  ``write_asdf`` read back as they do there.

File layout (ASDF standard 1.x)::

    #ASDF 1.0.0
    #ASDF_STANDARD 1.5.0
    %YAML 1.1
    %TAG ! tag:stsci.edu:asdf/
    --- !core/asdf-1.1.0
    <tree>
    ...
    <binary blocks>  each: d3 42 4c 4b ("\\xd3BLK"), u16be header_size,
                     header = u32be flags, 4-byte compression label,
                     u64be allocated_size, u64be used_size, u64be data_size,
                     16-byte md5; then `used_size` bytes of data.
    [#ASDF BLOCK INDEX ...]  (ignored on read, written for compatibility)
"""

import hashlib
import io
import re
import struct

import numpy as np

from . import asdf_yaml
from .asdf_yaml import ASDF_TAG, ASTROPY_TAG, Tagged
from .blosc import ChunkedBloscDecoder
from .table import Table

__all__ = ['AsdfFile', 'NDArrayRef', 'open_asdf', 'write_asdf', 'set_nthreads']

BLOCK_MAGIC = b'\xd3BLK'
INDEX_MAGIC = b'#ASDF BLOCK INDEX'

_DTYPES = {
    'int8': np.int8,
    'int16': np.int16,
    'int32': np.int32,
    'int64': np.int64,
    'uint8': np.uint8,
    'uint16': np.uint16,
    'uint32': np.uint32,
    'uint64': np.uint64,
    'float32': np.float32,
    'float64': np.float64,
    'bool8': np.bool_,
    'complex64': np.complex64,
    'complex128': np.complex128,
}
_DTYPE_NAMES = {np.dtype(v): k for k, v in _DTYPES.items()}

# threads that decompress (and compress) a block's Blosc chunks
_NTHREADS = 4


def set_nthreads(nthreads):
    """The number of threads that decode (and encode) a block's Blosc
    chunks, at least 1 (io/asdf_file.py:set_nthreads; libzstd releases the
    GIL)."""
    global _NTHREADS
    _NTHREADS = max(1, int(nthreads))


class NDArrayRef:
    """Lazy handle to an ndarray stored in an ASDF binary block."""

    def __init__(self, info, asdf_file):
        self._info = info
        self._af = asdf_file
        self.shape = tuple(info.get('shape', ()))
        dt = np.dtype(_DTYPES[info['datatype']])
        if info.get('byteorder', 'little') == 'big':
            dt = dt.newbyteorder('>')
        self.dtype = dt
        self._data = None

    def load(self):
        if self._data is None:
            raw = self._af._read_block(self._info['source'])
            offset = self._info.get('offset', 0)
            count = int(np.prod(self.shape, dtype=np.int64)) if self.shape else 1
            arr = np.frombuffer(raw, dtype=self.dtype, count=count, offset=offset)
            self._data = arr.reshape(self.shape)
        return self._data

    def __array__(self, dtype=None, copy=None):
        a = self.load()
        if dtype is not None:
            a = a.astype(dtype, copy=False)
        return a


def _resolve(node, af):
    """Turn the loaded tree's Tagged nodes into arrays, NDArrayRefs and
    Tables (io/asdf_file.py:_resolve)."""
    if isinstance(node, Tagged):
        tag = node.tag
        if 'core/ndarray' in tag:
            if isinstance(node.value, list):
                return np.array(node.value)  # an inline ndarray
            return NDArrayRef(node.value, af)
        if re.search(r'table/table-', tag):
            cols = {}
            for col in node.value.get('columns', []):
                cv = _resolve(col, af)
                if isinstance(cv, dict):
                    cols[cv['name']] = cv['data']
            t = Table(cols, copy=False)
            meta = node.value.get('meta')
            if meta:
                t.meta.update(_resolve(meta, af))
            return t
        if re.search(r'table/column', tag):
            return {k: _resolve(v, af) for k, v in node.value.items()}
        return _resolve(node.value, af)
    if isinstance(node, dict):
        return {k: _resolve(v, af) for k, v in node.items()}
    if isinstance(node, list):
        return [_resolve(v, af) for v in node]
    return node


class AsdfFile:
    """Read-only view of an ASDF file with lazy block loading."""

    def __init__(self, fn):
        with open(fn, 'rb') as f:
            self._raw = f.read()
        self._block_cache = {}
        self._parse()

    # -- container parsing --------------------------------------------------
    def _parse(self):
        data = self._raw
        end = data.find(b'\n...')
        if end == -1:
            blk = data.find(BLOCK_MAGIC)
            yaml_src = data[:blk] if blk >= 0 else data
            pos = blk
        else:
            # include the "..." end-of-document line
            nl = data.find(b'\n', end + 1)
            yaml_src = data[: nl + 1 if nl >= 0 else len(data)]
            pos = nl + 1
        tree = asdf_yaml.load(yaml_src.decode('utf-8'))
        if isinstance(tree, Tagged):
            tree = tree.value

        self._blocks = []
        n = len(data)
        while 0 <= pos < n:
            pos = data.find(BLOCK_MAGIC, pos)  # skip padding up to the next magic
            if pos == -1:
                break
            (hsize,) = struct.unpack_from('>H', data, pos + 4)
            hdr = data[pos + 6 : pos + 6 + hsize]
            flags = struct.unpack_from('>I', hdr, 0)[0]
            compression = hdr[4:8]
            alloc, used, dsize = struct.unpack_from('>QQQ', hdr, 8)
            data_start = pos + 6 + hsize
            self._blocks.append(dict(
                flags=flags, compression=compression.rstrip(b'\x00').decode() or None,
                allocated=alloc, used=used, data_size=dsize, offset=data_start,
            ))
            pos = data_start + alloc

        self.tree = _resolve(tree, self)

    def _read_block(self, i):
        if i in self._block_cache:
            return self._block_cache[i]
        b = self._blocks[i]
        raw = memoryview(self._raw)[b['offset'] : b['offset'] + b['used']]
        comp = b['compression']
        if comp is None:
            out = np.frombuffer(raw, dtype=np.uint8)
        elif comp == 'blsc':
            out = np.empty(b['data_size'], dtype=np.uint8)
            ChunkedBloscDecoder(_NTHREADS).decompress(raw, out)
        else:
            raise NotImplementedError(f'block compression {comp!r}')
        self._block_cache[i] = out
        return out

    # -- dict-like access ---------------------------------------------------
    def __getitem__(self, key):
        return self.tree[key]

    def close(self):
        self._raw = None
        self._block_cache.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def open_asdf(fn):
    return AsdfFile(fn)


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------


def _extract_arrays(tree, arrays):
    """The tree with each ndarray replaced by an ndarray node whose source is
    its index in `arrays` (where it is appended), and each Table by the
    astropy table tags (io/asdf_file.py:_extract_arrays)."""
    if isinstance(tree, Table):
        columns = [
            Tagged(ASTROPY_TAG + 'table/column-1.0.0',
                   {'data': _extract_arrays(tree[k], arrays), 'name': k})
            for k in tree.colnames
        ]
        return Tagged(ASTROPY_TAG + 'table/table-1.0.0', {
            'columns': columns, 'meta': _extract_arrays(dict(tree.meta), arrays),
            'qtable': False,
        })
    if isinstance(tree, dict):
        return {k: _extract_arrays(v, arrays) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_extract_arrays(v, arrays) for v in tree]
    if isinstance(tree, (np.ndarray, NDArrayRef)):
        arr = np.ascontiguousarray(np.asarray(tree))
        arr = arr.astype(arr.dtype.newbyteorder('<'), copy=False)
        arrays.append(arr)
        return Tagged(ASDF_TAG + 'core/ndarray-1.0.0', {
            'source': len(arrays) - 1, 'datatype': _DTYPE_NAMES[arr.dtype.newbyteorder('=')],
            'byteorder': 'little', 'shape': list(arr.shape),
        })
    return tree


def write_asdf(fn, tree, compression=None, nthreads=None, shuffle=True):
    """Write `tree` (nested dicts, lists, ndarrays, Tables and scalars) to an
    ASDF file; the JAX package's ``open_asdf`` and ``asdf`` read it.

    compression: None, or 'blsc' (zstd Blosc chunks, byte-shuffled unless
    `shuffle` is False: the Abacus format)."""
    arrays = []
    body = asdf_yaml.dump(_extract_arrays(tree, arrays))

    buf = io.BytesIO()
    buf.write(b'#ASDF 1.0.0\n#ASDF_STANDARD 1.5.0\n')
    buf.write(b'%YAML 1.1\n%TAG ! tag:stsci.edu:asdf/\n--- !core/asdf-1.1.0\n')
    buf.write(body.encode())
    buf.write(b'...\n')

    block_offsets = []
    for arr in arrays:
        raw = arr.view(np.uint8).reshape(-1)
        if compression == 'blsc':
            payload = ChunkedBloscDecoder(nthreads or _NTHREADS).compress(
                raw, arr.dtype.itemsize, shuffle=shuffle)
            label = b'blsc'
        elif compression is None:
            payload = raw.tobytes()
            label = b'\x00\x00\x00\x00'
        else:
            raise ValueError(f'unknown compression {compression!r}')
        md5 = hashlib.md5(raw).digest()
        block_offsets.append(buf.tell())
        hdr = (struct.pack('>I', 0) + label
               + struct.pack('>QQQ', len(payload), len(payload), raw.nbytes) + md5)
        buf.write(BLOCK_MAGIC)
        buf.write(struct.pack('>H', len(hdr)))
        buf.write(hdr)
        buf.write(payload)

    if block_offsets:
        buf.write(INDEX_MAGIC + b'\n')
        buf.write(b'%YAML 1.1\n---\n')
        for off in block_offsets:
            buf.write(f'- {off}\n'.encode())
        buf.write(b'...\n')

    with open(fn, 'wb') as f:
        f.write(buf.getbuffer())
