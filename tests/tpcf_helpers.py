"""Shared pieces of the pair-count parity tests (tests/test_torch_tpcf*.py):
the catalogs, the f32 numpy brute force, and the rule that picks the JAX
engine the port is held against.

The same points, drawn from a seed with numpy, go through both packages; the
integer counts must be equal bin for bin. On the CPU the port's wrappers run
the kernels' plain PyTorch versions (count_pairs_cells_plain,
count_pairs_all_plain) on the stage and work list the CUDA kernels read.

Which JAX the counts were held against depends on jax's x64 flag, which other
test modules flip: MODE says it. With x64 on, JAX's tiled engine computes in
float64 (the port is asked for ``dtype=torch.float64``) and its cell engine
compares a float32 r2 with float64 squared edges, which is the port's rule
(ops/tpcf.py:edges_f32 rounds the edges up). With x64 off JAX rounds the
squared edges to the nearest float32; the two rules differ only for a pair
whose r2 is exactly the float32 just below an edge
(test_edge_rounding_rule_against_both_jax_modes builds one), and
_rules_agree checks that no test catalog holds such a pair.
"""

import jax
import numpy as np
import torch

from abacusutils_tpu.ops import tpcf as jtpcf
from abacusutils_tpu_torch.ops import tpcf as ttpcf

LBOX = 400.0
RPBINS = np.logspace(-1, np.log10(30), 9)
RP0 = np.concatenate([[0.0], np.logspace(-1, np.log10(30), 6)[1:]])
PIMAX = 30
SBINS = np.linspace(0.1, 25, 9)
S0 = np.linspace(0.0, 25, 7)
NMU = 20


def _x64():
    return bool(jax.config.x64_enabled)


def _mode():
    return 'JAX x64 on' if _x64() else 'JAX x64 off'


def _tile_dtype():
    """The type JAX's tiled engine computes in under the current flag."""
    return (np.float64, torch.float64) if _x64() else (np.float32, torch.float32)


def _points(n, rng, lbox=LBOX, clustered=True):
    if not clustered:
        return rng.random((n, 3)) * lbox
    cen = rng.random((40, 3)) * lbox
    half = n // 2
    return np.concatenate(
        [
            (cen[rng.integers(0, 40, half)] + rng.normal(0, 5, (half, 3))) % lbox,
            rng.random((n - half, 3)) * lbox,
        ]
    )


def _brute(pos, pos2, edges, nb2, mode, lbox=LBOX, dt=np.float32, thr=None):
    """Ordered pair counts by brute force in `dt`: wrapped positions, the
    per-pair round-half-even minimum image, every product and sum rounded on
    its own; `thr` the squared-edge thresholds (default: the port's rule for
    float32, the exact float64 squares otherwise)."""
    auto = pos2 is None
    p1 = np.mod(pos, lbox).astype(dt)
    p2 = p1 if auto else np.mod(pos2, lbox).astype(dt)
    d = p1[:, None, :] - p2[None, :, :]
    d = (d - dt(lbox) * np.round(d / dt(lbox))).astype(dt)
    adz = np.abs(d[..., 2]).ravel()
    r2 = d[..., 0] ** 2 + d[..., 1] ** 2
    if mode == 'smu':
        r2 = r2 + d[..., 2] ** 2
    r2 = r2.ravel()
    if thr is None:
        e2 = np.asarray(edges, np.float64) ** 2
        thr = ttpcf.edges_f32(e2) if dt == np.float32 else e2
    nb1 = len(thr) - 1
    b1 = np.searchsorted(thr, r2, side='right') - 1
    ok = (b1 >= 0) & (b1 < nb1)
    if mode == 'rppi':
        b2 = np.floor(adz).astype(np.int64)
        ok &= b2 < nb2
    else:
        s = np.sqrt(r2)
        mu = np.divide(adz, s, out=np.zeros_like(s), where=s > 0)
        b2 = np.minimum((mu * dt(nb2)).astype(np.int64), nb2 - 1)
    if auto:
        n = len(p1)
        ok &= (np.arange(n)[:, None] != np.arange(n)[None, :]).ravel()
    return np.bincount((b1 * nb2 + b2)[ok], minlength=nb1 * nb2).reshape(nb1, nb2)


def _rules_agree(pos, pos2, edges, nb2, mode, lbox=LBOX):
    """True when rounding the squared edges up (the port, JAX with x64) and
    to nearest (JAX without x64) count this catalog alike."""
    e2 = np.asarray(edges, np.float64) ** 2
    up = _brute(pos, pos2, edges, nb2, mode, lbox, thr=ttpcf.edges_f32(e2))
    nearest = _brute(pos, pos2, edges, nb2, mode, lbox, thr=e2.astype(np.float32))
    return np.array_equal(up, nearest)


def _both(mode, pos, edges, nb2, lbox=LBOX, pos2=None, method=None):
    """(port counts, JAX counts) of one call; the all-pairs engine in the
    type JAX's follows."""
    kw = dict(pos2=pos2, method=method)
    tkw = dict(kw, device='cpu', dtype=_tile_dtype()[1])
    if mode == 'rppi':
        return (ttpcf.pair_counts_rppi(pos, edges, nb2, lbox, **tkw),
                jtpcf.pair_counts_rppi(pos, edges, nb2, lbox, **kw))
    return (ttpcf.pair_counts_smu(pos, edges, nb2, lbox, **tkw),
            jtpcf.pair_counts_smu(pos, edges, nb2, lbox, **kw))
