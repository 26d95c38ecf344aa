"""Blosc1 chunk codec with zstd reached through ctypes (the counterpart of
abacusutils_tpu/io/blosc.py).

AbacusSummit stores each ASDF binary block as a stream of independently
compressed Blosc chunks, each prefixed with its 4-byte big-endian length. A
chunk is a c-blosc1 container:

    byte 0    : format version
    byte 1    : codec format version
    byte 2    : flags (bit0 byte-shuffle, bit1 memcpyed, bit2 bit-shuffle,
                bit4 dont_split, bits5-7 codec format id)
    byte 3    : typesize
    bytes 4-7 : nbytes   (uncompressed chunk size, LE uint32)
    bytes 8-11: blocksize (LE uint32)
    bytes12-15: cbytes   (total compressed chunk size incl. header, LE uint32)

Unless memcpyed, the header is followed by one LE uint32 offset per block.
A block holds ``typesize`` streams if it is split, else one, each prefixed
by its LE int32 compressed length: a length equal to the stream's size
means the stream is stored raw, 0 an all-zero stream. Byte-shuffle acts per
block on the largest multiple of ``typesize``.

Only the zstd codec (format id 4) is read, the one Abacus uses. zstd is the
system's ``libzstd``, loaded with ctypes at first use (``ZSTD_decompress``,
``ZSTD_compress``, ``ZSTD_getFrameContentSize``, ``ZSTD_isError``); without
it the codec raises. ctypes releases the GIL during each call, so the
chunks of a block decode in a thread pool. Compression writes zstd +
byte-shuffle + dont_split chunks, as the JAX package's pure-Python path
does; c-blosc reads them.
"""

import ctypes
import ctypes.util
import struct
from concurrent.futures import ThreadPoolExecutor
from functools import cache

import numpy as np

__all__ = ['decompress_chunk', 'compress_chunk', 'ChunkedBloscDecoder', 'zstd_library']

# blosc1 flag bits
_DOSHUFFLE = 0x1
_MEMCPYED = 0x2
_DOBITSHUFFLE = 0x4
_DONT_SPLIT = 0x10

_FMT_ZSTD = 4  # the blosc1 codec id stored in flag bits 5-7

_MAX_TYPESIZE = 255

_ZSTD_CONTENTSIZE_UNKNOWN = 2**64 - 1
_ZSTD_CONTENTSIZE_ERROR = 2**64 - 2


@cache
def zstd_library():
    """The system's libzstd through ctypes, with the signatures this module
    calls. Raises where no libzstd is found: the codec has no other
    implementation."""
    name = ctypes.util.find_library('zstd')
    if name is None:
        raise OSError('libzstd not found (ctypes.util.find_library("zstd") is None): the Blosc '
                      'codec of abacusutils_tpu_torch.io needs the system zstd library')
    lib = ctypes.CDLL(name)
    size_t, vp = ctypes.c_size_t, ctypes.c_void_p
    for fn, args, res in (
        ('ZSTD_decompress', (vp, size_t, vp, size_t), size_t),
        ('ZSTD_compress', (vp, size_t, vp, size_t, ctypes.c_int), size_t),
        ('ZSTD_compressBound', (size_t,), size_t),
        ('ZSTD_getFrameContentSize', (vp, size_t), ctypes.c_ulonglong),
        ('ZSTD_isError', (size_t,), ctypes.c_uint),
        ('ZSTD_getErrorName', (size_t,), ctypes.c_char_p),
    ):
        f = getattr(lib, fn)
        f.argtypes, f.restype = args, res
    return lib


def _address(buf):
    """The address of a contiguous numpy array or a bytes-like object's
    first byte (read-only buffers included)."""
    if isinstance(buf, np.ndarray):
        return buf.ctypes.data
    return np.frombuffer(buf, dtype=np.uint8).ctypes.data


def _zstd_into(src, dst):
    """Decompress the zstd frame `src` (bytes-like) into the uint8 array
    `dst`, which it must fill exactly."""
    lib = zstd_library()
    n = len(src)
    size = lib.ZSTD_getFrameContentSize(_address(src), n)
    if size == _ZSTD_CONTENTSIZE_ERROR:
        raise ValueError('not a zstd frame')
    if size != _ZSTD_CONTENTSIZE_UNKNOWN and size != len(dst):
        raise ValueError(f'stream decompresses to {size} bytes, expected {len(dst)}')
    got = lib.ZSTD_decompress(dst.ctypes.data, len(dst), _address(src), n)
    if lib.ZSTD_isError(got):
        raise ValueError(f'zstd: {lib.ZSTD_getErrorName(got).decode()}')
    if got != len(dst):
        raise ValueError(f'stream decompressed to {got} bytes, expected {len(dst)}')


def _zstd_compress(data, level):
    lib = zstd_library()
    data = np.ascontiguousarray(data)
    cap = lib.ZSTD_compressBound(len(data))
    out = np.empty(cap, dtype=np.uint8)
    got = lib.ZSTD_compress(out.ctypes.data, cap, data.ctypes.data, len(data), level)
    if lib.ZSTD_isError(got):
        raise ValueError(f'zstd: {lib.ZSTD_getErrorName(got).decode()}')
    return out[:got].tobytes()


def _unshuffle(buf: np.ndarray, typesize: int) -> np.ndarray:
    """Undo blosc byte-shuffle on a single block (uint8 array)."""
    n = len(buf)
    nel = n // typesize
    body = n - n % typesize
    out = np.empty(n, dtype=np.uint8)
    # shuffled layout: byte 0 of every element, then byte 1, ...
    out[:body] = buf[:body].reshape(typesize, nel).T.ravel()
    out[body:] = buf[body:]
    return out


def _unbitshuffle(buf: np.ndarray, typesize: int) -> np.ndarray:
    """Undo blosc bit-shuffle on a single block (uint8 array).

    Forward bitshuffle stores bit-plane-major data: row r = 8*b + k of a
    [8*typesize, nelem/8] byte matrix holds bit k of byte b of every element,
    8 elements per byte, LSB first. As c-blosc (>= 1.18) does, a block whose
    element count is not a multiple of 8 is stored raw; otherwise every
    element is transposed and the sub-typesize remainder copied raw.
    """
    n = len(buf)
    nelem = n // typesize
    if nelem % 8:
        return buf.copy()
    body = nelem * typesize
    out = np.empty(n, dtype=np.uint8)
    if body:
        planes = buf[:body].reshape(8 * typesize, nelem // 8)
        bits = np.unpackbits(planes, axis=1, bitorder='little')  # [8T, nelem]
        out[:body] = np.packbits(
            bits.T.reshape(nelem, typesize, 8), axis=2, bitorder='little'
        ).reshape(body)
    out[body:] = buf[body:]
    return out


def _shuffle(buf: np.ndarray, typesize: int) -> np.ndarray:
    n = len(buf)
    nel = n // typesize
    body = n - n % typesize
    out = np.empty(n, dtype=np.uint8)
    out[:body] = buf[:body].reshape(nel, typesize).T.ravel()
    out[body:] = buf[body:]
    return out


def decompress_chunk(chunk, out=None):
    """Decompress one blosc1 chunk (bytes-like) into a uint8 ndarray; into
    `out` (a writable uint8 ndarray of length nbytes) when it is given."""
    chunk = memoryview(chunk)
    flags = chunk[2]
    typesize = chunk[3]
    nbytes, blocksize, _ = struct.unpack_from('<III', chunk, 4)

    if out is None:
        out = np.empty(nbytes, dtype=np.uint8)
    elif len(out) != nbytes:
        raise ValueError(f'out has length {len(out)}, expected {nbytes}')

    if flags & _MEMCPYED:
        out[:] = np.frombuffer(chunk[16 : 16 + nbytes], dtype=np.uint8)
        return out

    fmt = flags >> 5
    if fmt != _FMT_ZSTD:
        raise NotImplementedError(f'blosc codec format {fmt} not supported (zstd only)')

    bitshuffle = bool(flags & _DOBITSHUFFLE)
    shuffle = (bool(flags & _DOSHUFFLE) and typesize > 1) or bitshuffle
    nblocks = (nbytes + blocksize - 1) // blocksize
    offsets = struct.unpack_from(f'<{nblocks}I', chunk, 16)

    # c-blosc1 splits a block into `typesize` streams unless dont_split is set
    nstreams = 1 if (flags & _DONT_SPLIT) or not shuffle else typesize

    for i, off in enumerate(offsets):
        lo = i * blocksize
        expected = min(blocksize, nbytes - lo)
        neblock = expected // nstreams if nstreams > 1 else expected
        pos = off
        block = np.empty(expected, dtype=np.uint8) if shuffle else out[lo : lo + expected]
        written = 0
        while written < expected:
            (cb,) = struct.unpack_from('<i', chunk, pos)
            pos += 4
            ne = min(neblock, expected - written)
            dst = block[written : written + ne]
            if cb == 0:
                dst[:] = 0
            elif cb == ne:
                dst[:] = np.frombuffer(chunk[pos : pos + cb], dtype=np.uint8)
            else:
                _zstd_into(chunk[pos : pos + cb], dst)
            pos += cb
            written += ne
        if bitshuffle:
            out[lo : lo + expected] = _unbitshuffle(block, typesize)
        elif shuffle:
            out[lo : lo + expected] = _unshuffle(block, typesize)
    return out


def compress_chunk(data, typesize, clevel=1, shuffle=True, blocksize=512 * 1024) -> bytes:
    """Compress bytes-like `data` into one blosc1 chunk (zstd codec)."""
    data = np.frombuffer(memoryview(data).cast('B'), dtype=np.uint8)
    nbytes = len(data)
    if typesize < 1 or typesize > _MAX_TYPESIZE:
        typesize = 1
    shuffle = shuffle and typesize > 1
    # blocks a multiple of typesize, so a shuffle never straddles two
    blocksize = max(typesize, blocksize - blocksize % typesize)
    nblocks = max(1, (nbytes + blocksize - 1) // blocksize)

    flags = _DONT_SPLIT | (_FMT_ZSTD << 5)
    if shuffle:
        flags |= _DOSHUFFLE

    header = bytearray(16)
    header[0] = 2  # format version
    header[1] = 1
    header[2] = flags
    header[3] = typesize

    offsets = []
    blocks = []
    pos = 16 + 4 * nblocks
    for i in range(nblocks):
        raw = data[i * blocksize : (i + 1) * blocksize]
        if shuffle:
            raw = _shuffle(raw, typesize)
        comp = _zstd_compress(raw, clevel)
        if len(comp) >= len(raw):
            comp = raw.tobytes()  # stored raw: read back by cb == ne
        blocks.append(struct.pack('<i', len(comp)) + comp)
        offsets.append(pos)
        pos += len(blocks[-1])

    struct.pack_into('<III', header, 4, nbytes, blocksize, pos)
    return bytes(header) + struct.pack(f'<{nblocks}I', *offsets) + b''.join(blocks)


class ChunkedBloscDecoder:
    """The Abacus framing: a byte stream of [4-byte BE length][blosc chunk]...

    Chunks decode and encode in a thread pool of `nthreads` (the zstd calls
    release the GIL)."""

    def __init__(self, nthreads=4):
        self.nthreads = nthreads

    def iter_chunks(self, buf):
        buf = memoryview(buf)
        pos = 0
        n = len(buf)
        while pos < n:
            (size,) = struct.unpack_from('!I', buf, pos)
            pos += 4
            yield buf[pos : pos + size]
            pos += size

    def _map(self, fn, items):
        if len(items) > 1 and self.nthreads > 1:
            with ThreadPoolExecutor(self.nthreads) as ex:
                return list(ex.map(fn, items))
        return [fn(x) for x in items]

    def decompress(self, buf, out):
        """Decompress the framed stream `buf` into the uint8 ndarray `out`;
        returns the bytes written."""
        chunks = list(self.iter_chunks(buf))
        sizes = [struct.unpack_from('<I', c, 4)[0] for c in chunks]
        offs = np.concatenate([[0], np.cumsum(sizes, dtype=np.int64)])
        if offs[-1] != len(out):
            raise ValueError(f'decompressed size {offs[-1]} != block size {len(out)}')
        self._map(lambda i: decompress_chunk(chunks[i], out[offs[i] : offs[i + 1]]),
                  range(len(chunks)))
        return len(out)

    def compress(self, data, typesize, clevel=1, shuffle=True, chunk_nbytes=1 << 22):
        """Compress an ndarray or bytes into the framed stream (4 MiB
        chunks)."""
        data = np.frombuffer(memoryview(data).cast('B'), dtype=np.uint8)
        starts = range(0, max(len(data), 1), chunk_nbytes)
        chunks = self._map(
            lambda i: compress_chunk(data[i : i + chunk_nbytes], typesize, clevel=clevel,
                                     shuffle=shuffle),
            list(starts))
        return b''.join(struct.pack('!I', len(c)) + c for c in chunks)
