"""The RVint decoder of Abacus particle files (the counterpart of
abacusutils_tpu/io/bitpacked.py:unpack_rvint), host numpy.

Each of a particle's three int32 words packs a position coordinate in its
upper 20 bits (pos = (i >> 12) * box / 1e6) and a velocity in its lower 12
(vel = ((i & 0xFFF) - 2048) * 6000 / 2048 km/s).

The packed PID decoders and pack9 are not on the disk path the port reads
yet (ROADMAP.md).
"""

import numpy as np

__all__ = ['unpack_rvint']


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
