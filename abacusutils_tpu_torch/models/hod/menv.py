"""Local mass environment on the host: the ``'host'`` Menv engine.

A copy of abacusutils_tpu/models/hod/menv.py:do_Menv_from_tree (the port
imports nothing of the JAX package): Menv(halo) = the mass of all halos
within r_outer minus that within r_inner, for halos above mcut, from scipy
KDTree ball queries; periodic in all three axes for boxes, open for light
cones. :func:`~.menv_device.do_menv_device` is the card's engine.
"""

import numpy as np

__all__ = ['do_Menv_from_tree']

DEFAULT_BATCH_SIZE = 10**5


def _msum(pos_cut, mass, r, tree, nthread, batch_size):
    """Sum of `mass` over tree neighbours within radius r of each point."""
    N = len(pos_cut)
    out = np.zeros(N, dtype=np.float64)
    r = np.asarray(r)
    for i in range(0, N, batch_size):
        j = min(i + batch_size, N)
        rb = r[i:j] if r.ndim > 0 else r
        lists = tree.query_ball_point(pos_cut[i:j], r=rb, workers=nthread)
        lens = np.fromiter((len(v) for v in lists), count=j - i, dtype=np.int64)
        if lens.sum() == 0:
            continue
        flat = np.concatenate([np.asarray(v, dtype=np.int64) for v in lists if len(v)])
        seg = np.repeat(np.arange(j - i), lens)
        np.add.at(out[i:j], seg, mass[flat])
    return out


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
    Menv_cut = _msum(pos_cut, mass, r_outer, tree, nthread, batch_size)
    Menv_cut -= _msum(pos_cut, mass, r_inner, tree, nthread, batch_size)

    Menv = np.zeros_like(mass, dtype=np.float64)
    Menv[mmask] = Menv_cut
    return Menv
