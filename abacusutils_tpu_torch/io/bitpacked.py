"""The decoders of Abacus's bit-packed particle words (the counterpart of
abacusutils_tpu/io/bitpacked.py), host numpy.

RVint: each of a particle's three int32 words packs a position coordinate
in its upper 20 bits (pos = (i >> 12) * box / 1e6) and a velocity in its
lower 12 (vel = ((i & 0xFFF) - 2048) * 6000 / 2048 km/s).

Packed PIDs (uint64): the Lagrangian index triple in three 15-bit fields at
bits 0, 16 and 32 (``pid`` is the word with the other bits masked off),
the tagged flag at bit 48 and the density in bits 49-58 (squared on
unpack). Every mask and shift is a np.uint64: a Python int would promote
the words to float64 and lose the bits above 2**53.
"""

import numpy as np

__all__ = ['unpack_rvint', 'unpack_pids', 'empty_bitpacked_arrays', 'unpack_pids_into',
           'PID_FIELDS']

AUXDENS = np.uint64(0x07FE000000000000)
ZERODEN = np.uint64(49)
AUXXPID = np.uint64(0x7FFF)
AUXYPID = np.uint64(0x7FFF0000)
AUXZPID = np.uint64(0x7FFF00000000)
AUXPID = AUXXPID | AUXYPID | AUXZPID
AUXTAGGED = np.uint64(48)

PID_FIELDS = ['pid', 'lagr_pos', 'tagged', 'density', 'lagr_idx', 'packedpid']


def unpack_rvint(intdata, boxsize, float_dtype=np.float32, posout=None, velout=None):
    """Unpack rvint data into pos and vel. posout / velout: None to allocate,
    False to skip, or an array to fill (the count of particles is returned in
    its place)."""
    intdata = np.asarray(intdata).reshape(-1, 3)
    if intdata.dtype != np.int32:
        raise TypeError(f'RVint words are int32, not {intdata.dtype}')
    N = len(intdata)

    # the scales stay float64 and each element is rounded to float_dtype
    # once, as the reference's kernel promotes
    posscale = np.float64(boxsize) / 1e6
    velscale = 6000.0 / 2048

    ret = []
    if posout is False:
        ret.append(0)
    else:
        _posout = np.empty((N, 3), dtype=float_dtype) if posout is None else posout.reshape(-1, 3)
        _posout[:N] = (intdata >> 12) * posscale
        ret.append(_posout if posout is None else N)
    if velout is False:
        ret.append(0)
    else:
        _velout = np.empty((N, 3), dtype=float_dtype) if velout is None else velout.reshape(-1, 3)
        _velout[:N] = ((intdata & np.int32(0xFFF)) - np.int32(2048)) * velscale
        ret.append(_velout if velout is None else N)
    return tuple(ret)


def unpack_pids(packed, box=None, ppd=None, pid=False, lagr_pos=False, tagged=False,
                density=False, lagr_idx=False, float_dtype=np.float32):
    """The requested fields of packed PID words, as a dict: ``pid`` (int64),
    ``lagr_idx`` ((N, 3) int16), ``lagr_pos`` ((N, 3) float_dtype: index *
    box / ppd - box / 2, the scale and half box rounded to float_dtype, the
    sum in float64, then one rounding), ``tagged`` (uint8), ``density``
    (float_dtype, the 10-bit field squared). ``lagr_pos`` needs `box` and
    `ppd`."""
    packed = np.asanyarray(packed, dtype=np.uint64)

    if lagr_pos is not False:
        if box is None:
            raise ValueError('Must supply `box` if requesting `lagr_pos`')
        if ppd is None:
            raise ValueError('Must supply `ppd` if requesting `lagr_pos`')
    if ppd is not None:
        if not np.isclose(ppd, int(round(ppd))):
            raise ValueError(f'ppd "{ppd}" not valid int?')
        ppd = int(round(ppd))
    else:
        ppd = 1
    if box is None:
        box = float_dtype(1.0)

    arr = {}
    idx = None

    def _idx():
        nonlocal idx
        if idx is None:
            i0 = (packed & AUXXPID).astype(np.int64)
            i1 = ((packed & AUXYPID) >> np.uint64(16)).astype(np.int64)
            i2 = ((packed & AUXZPID) >> np.uint64(32)).astype(np.int64)
            idx = np.stack([i0, i1, i2], axis=-1)
        return idx

    if pid is True:
        arr['pid'] = (packed & AUXPID).astype(np.int64)
    if lagr_idx is True:
        arr['lagr_idx'] = _idx().astype(np.int16)
    if lagr_pos is True:
        inv_ppd = float_dtype(np.float64(box) / ppd)
        half = float_dtype(np.float64(box) / 2)
        arr['lagr_pos'] = (_idx() * np.float64(inv_ppd) - np.float64(half)).astype(float_dtype)
    if tagged is True:
        arr['tagged'] = ((packed >> AUXTAGGED) & np.uint64(1)).astype(np.uint8)
    if density is True:
        d = ((packed & AUXDENS) >> ZERODEN).astype(float_dtype)
        arr['density'] = d * d
    return arr


def empty_bitpacked_arrays(N, unpack_bits, float_dtype=np.float32):
    """Empty arrays of N rows for the PID fields `unpack_bits` asks for
    (True: every one of PID_FIELDS; False: 'pid'; a name or a list of
    names), in PID_FIELDS' order of allocation: pid, lagr_pos, lagr_idx,
    tagged, density, packedpid."""
    if type(unpack_bits) is str:
        unpack_bits = [unpack_bits]
    if unpack_bits is True:
        unpack_bits = PID_FIELDS
    elif unpack_bits is False:
        unpack_bits = ['pid']

    arr = {}
    if 'pid' in unpack_bits:
        arr['pid'] = np.empty(N, dtype=np.int64)
    if 'lagr_pos' in unpack_bits:
        arr['lagr_pos'] = np.empty((N, 3), dtype=float_dtype)
    if 'lagr_idx' in unpack_bits:
        arr['lagr_idx'] = np.empty((N, 3), dtype=np.int16)
    if 'tagged' in unpack_bits:
        arr['tagged'] = np.empty(N, dtype=np.uint8)
    if 'density' in unpack_bits:
        arr['density'] = np.empty(N, dtype=float_dtype)
    if 'packedpid' in unpack_bits:
        arr['packedpid'] = np.empty(N, dtype=np.uint64)
    return arr


def unpack_pids_into(packed, box, ppd, out, float_dtype=np.float32):
    """Unpack the words `packed` into the first rows of the arrays of `out`
    (keys drawn from PID_FIELDS; 'packedpid' gets the words themselves).
    Returns the number of words."""
    want = {k: True for k in out if k in ('pid', 'lagr_pos', 'tagged', 'density', 'lagr_idx')}
    res = unpack_pids(packed, box=box, ppd=ppd, float_dtype=float_dtype, **want)
    n = len(packed)
    for k, v in res.items():
        out[k][:n] = v
    if 'packedpid' in out:
        out['packedpid'][:n] = packed
    return n
