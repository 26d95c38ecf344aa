"""Local mass environment on the host: the ``'host'`` Menv engine.

A copy of abacusutils_tpu/models/hod/menv.py (the port imports nothing of
the JAX package): Menv(halo) = the mass of all halos
within r_outer minus that within r_inner, for halos above mcut, from scipy
KDTree ball queries; periodic in all three axes for boxes, open for light
cones. :func:`~.menv_device.do_menv_device` is the card's engine. The
batched mass-in-radius API (:func:`msum_in_batches`, :func:`msum_batch`,
:func:`msum_core`, :func:`query_inds`, :func:`concat_to_arr`) is JAX's, on
the host.
"""

import itertools

import numpy as np

__all__ = [
    'do_Menv_from_tree', 'msum_in_batches', 'msum_batch', 'msum_core', 'query_inds',
    'concat_to_arr',
]

DEFAULT_BATCH_SIZE = 10**5


def concat_to_arr(lists, dtype=np.int64):
    """Flatten an iterable of index lists; returns (flat, starts), starts of
    length len(lists) + 1."""
    lens = np.fromiter((len(ell) for ell in lists), count=len(lists), dtype=np.int64)
    starts = np.concatenate([[0], np.cumsum(lens)])
    flat = np.fromiter(itertools.chain.from_iterable(lists), count=int(starts[-1]), dtype=dtype)
    return flat, starts


def query_inds(pos, r, tree, nthread):
    """The tree's indices within r of each point, as (flat, starts)."""
    return concat_to_arr(tree.query_ball_point(pos, r=r, workers=nthread))


def msum_core(msum_out, masses, inds, starts, sign, nthread=1):
    """msum_out[p] += sign * the sum of masses[inds[starts[p]:starts[p + 1]]],
    by one segment add."""
    lens = np.diff(starts)
    seg = np.repeat(np.arange(len(lens)), lens)
    np.add.at(msum_out, seg, sign * masses[inds])
    return msum_out


def msum_batch(out, pos, mass, r, tree, sign, nthread):
    """One batch of the mass-in-radius sum: out += sign * M(< r) at `pos`."""
    inds, starts = query_inds(pos, r, tree, nthread)
    return msum_core(out, mass, inds, starts, sign, nthread=nthread)


def msum_in_batches(msum_out, pos, mass, r, tree, nthread, sign=1, batch_size=DEFAULT_BATCH_SIZE):
    """msum_out += sign * the mass within r (a scalar or one radius a point)
    of each point of `pos`, `batch_size` points a query."""
    N = len(pos)
    r = np.asarray(r)
    for i in range(0, N, batch_size):
        j = min(i + batch_size, N)
        rb = r[i:j] if r.ndim > 0 else r
        msum_batch(msum_out[i:j], pos[i:j], mass, rb, tree, sign, nthread)
    return msum_out


def do_Menv_from_tree(pos, mass, r_inner, r_outer, halo_lc, Lbox, nthread=1, mcut=1e11,
                      batch_size=DEFAULT_BATCH_SIZE):
    """Annulus mass sums M(<r_outer) - M(<r_inner) per halo above mcut."""
    from scipy.spatial import KDTree

    if halo_lc:
        treebox = None
    else:
        pos = (pos + Lbox / 2.0) % Lbox
        treebox = Lbox

    mmask = mass > mcut
    pos_cut = pos[mmask]

    r_inner = np.asarray(r_inner)
    if r_inner.ndim > 0:
        r_inner = r_inner[mmask]
    r_outer = np.asarray(r_outer)
    if r_outer.ndim > 0:
        r_outer = r_outer[mmask]

    tree = KDTree(pos, boxsize=treebox)
    n = len(pos_cut)
    Menv_cut = msum_in_batches(np.zeros(n), pos_cut, mass, r_outer, tree, nthread,
                               batch_size=batch_size)
    Menv_cut -= msum_in_batches(np.zeros(n), pos_cut, mass, r_inner, tree, nthread,
                                batch_size=batch_size)

    Menv = np.zeros_like(mass, dtype=np.float64)
    Menv[mmask] = Menv_cut
    return Menv
