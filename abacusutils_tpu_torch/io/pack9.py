"""The decoder of Abacus's pack9 particle format (the counterpart of
abacusutils_tpu/io/pack9.py), host numpy.

pack9 stores a particle's position and velocity in 9 bytes, six 12-bit
fields. A row whose first byte is 0xFF is a cell header: its fields give
cpd, the velocity scale and the cell's x, y, z indices. Each particle row
belongs to the last header before it; that association is one
``maximum.accumulate`` over the header rows' indices, so the decode is a
few vectorized passes.
"""

import numpy as np

__all__ = ['unpack_pack9']


def _expand_to_short(c):
    """(N, 9) uint8 rows as (N, 6) int16 12-bit fields, less 2048."""
    c = c.astype(np.int16)
    s = np.empty((len(c), 6), dtype=np.int16)
    s[:, 0] = (c[:, 1] & 0x0F) | (c[:, 0] << 4)
    s[:, 1] = ((c[:, 1] & 0xF0) << 4) | c[:, 2]
    s[:, 2] = (c[:, 4] & 0x0F) | (c[:, 3] << 4)
    s[:, 3] = ((c[:, 4] & 0xF0) << 4) | c[:, 5]
    s[:, 4] = (c[:, 7] & 0x0F) | (c[:, 6] << 4)
    s[:, 5] = ((c[:, 7] & 0xF0) << 4) | c[:, 8]
    s -= 2048
    return s


def unpack_pack9(data, boxsize, velzspace_to_kms, float_dtype=np.float32, posout=None,
                 velout=None):
    """Decode pack9 rows into (pos, vel) of the particle rows. posout /
    velout: None to allocate, False to skip (0 in its place), or an array to
    fill (the count of particles in its place)."""
    data = np.asanyarray(data, dtype=np.ubyte).reshape(-1, 9)
    dtype = float_dtype

    sh = _expand_to_short(data)
    is_hdr = data[:, 0] == np.uint8(0xFF)

    # every row's header quantities (only the header rows' are read). The
    # promotions are the reference kernel's: an integer times a Python
    # float is float64, then cast to `dtype`; products of `dtype` values
    # stay `dtype`
    boxsize_f = dtype(boxsize)
    velz = dtype(velzspace_to_kms)
    halfbox = boxsize_f / dtype(2)
    invcpd = (1.0 / (sh[:, 1].astype(np.int64) + 2000)).astype(dtype)
    csize = boxsize_f * invcpd
    vscale = ((sh[:, 2].astype(np.int64) + 2000) * 0.0005).astype(dtype) * invcpd * velz
    cellx = ((sh[:, 3] + 2000.5) * csize.astype(np.float64) - halfbox).astype(dtype)
    celly = ((sh[:, 4] + 2000.5) * csize.astype(np.float64) - halfbox).astype(dtype)
    cellz = ((sh[:, 5] + 2000.5) * csize.astype(np.float64) - halfbox).astype(dtype)
    pscale = (0.0005 * csize.astype(np.float64)).astype(dtype)

    # the last header at or before each row
    hdr_idx = np.where(is_hdr, np.arange(len(data)), -1)
    np.maximum.accumulate(hdr_idx, out=hdr_idx)
    part = ~is_hdr
    src = hdr_idx[part]
    npart = int(part.sum())

    ret = []
    if posout is False:
        ret.append(0)
    else:
        _pos = np.empty((npart, 3), dtype=dtype) if posout is None else posout
        shp = sh[part]
        _pos[:npart, 0] = shp[:, 0].astype(dtype) * pscale[src] + cellx[src]
        _pos[:npart, 1] = shp[:, 1].astype(dtype) * pscale[src] + celly[src]
        _pos[:npart, 2] = shp[:, 2].astype(dtype) * pscale[src] + cellz[src]
        ret.append(_pos[:npart] if posout is None else npart)
    if velout is False:
        ret.append(0)
    else:
        _vel = np.empty((npart, 3), dtype=dtype) if velout is None else velout
        shp = sh[part]
        _vel[:npart, 0] = shp[:, 3].astype(dtype) * vscale[src]
        _vel[:npart, 1] = shp[:, 4].astype(dtype) * vscale[src]
        _vel[:npart, 2] = shp[:, 5].astype(dtype) * vscale[src]
        ret.append(_vel[:npart] if velout is None else npart)
    return tuple(ret)
