"""A msgpack decoder for the metadata bundles' ``param`` and ``state``
tables: what ``msgpack.loads(data, strict_map_key=False)`` returns, without
the msgpack package.

Every msgpack type but the extension types: nil, bool, the positive and
negative fixints, uint and int 8 to 64, float32 and float64, str (fix, 8,
16, 32) as str, bin (8, 16, 32) as bytes, arrays (fix, 16, 32) as lists and
maps (fix, 16, 32) as dicts whose keys may be any hashable value (the
bundles' growth tables are keyed by float redshifts). Extension types,
trailing bytes and truncated input raise ValueError.
"""

import struct

__all__ = ['loads']

# the fixed-width scalars: type byte -> struct format (big-endian)
_SCALARS = {
    0xCA: '>f', 0xCB: '>d',
    0xCC: '>B', 0xCD: '>H', 0xCE: '>I', 0xCF: '>Q',
    0xD0: '>b', 0xD1: '>h', 0xD2: '>i', 0xD3: '>q',
}
# the length prefixes of str, bin, array and map: type byte -> (kind, format)
_SIZED = {
    0xD9: ('str', '>B'), 0xDA: ('str', '>H'), 0xDB: ('str', '>I'),
    0xC4: ('bin', '>B'), 0xC5: ('bin', '>H'), 0xC6: ('bin', '>I'),
    0xDC: ('array', '>H'), 0xDD: ('array', '>I'),
    0xDE: ('map', '>H'), 0xDF: ('map', '>I'),
}
_EXT = frozenset((0xC7, 0xC8, 0xC9, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8))


class _Reader:
    def __init__(self, data):
        self.buf = memoryview(bytes(data))
        self.pos = 0

    def take(self, n):
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError(f'truncated msgpack data: {n} bytes wanted at offset {self.pos}, '
                             f'{len(self.buf) - self.pos} left')
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        t = self.take(1)[0]
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0xA0 <= t <= 0xBF:
            return self.text(t & 0x1F)
        if 0x90 <= t <= 0x9F:
            return self.array(t & 0x0F)
        if 0x80 <= t <= 0x8F:
            return self.map(t & 0x0F)
        if t == 0xC0:
            return None
        if t in (0xC2, 0xC3):
            return t == 0xC3
        if t in _SCALARS:
            return self.unpack(_SCALARS[t])
        if t in _SIZED:
            kind, fmt = _SIZED[t]
            n = self.unpack(fmt)
            if kind == 'str':
                return self.text(n)
            if kind == 'bin':
                return bytes(self.take(n))
            return self.array(n) if kind == 'array' else self.map(n)
        if t in _EXT:
            raise ValueError(f'msgpack extension type 0x{t:02x} at offset {self.pos - 1} is not '
                             f'supported')
        raise ValueError(f'invalid msgpack type byte 0x{t:02x} at offset {self.pos - 1}')

    def text(self, n):
        return str(self.take(n), 'utf-8')

    def array(self, n):
        return [self.value() for _ in range(n)]

    def map(self, n):
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out


def loads(data):
    """The object msgpack-encoded in `data` (bytes-like), as
    ``msgpack.loads(data, strict_map_key=False)`` decodes it."""
    r = _Reader(data)
    out = r.value()
    if r.pos != len(r.buf):
        raise ValueError(f'trailing bytes after the msgpack object: {len(r.buf) - r.pos} at '
                         f'offset {r.pos}')
    return out
