"""K6's float32 pre-filter (csrc/prepare_sim.cu:nn_within_halo_kernel) on
the CPU: its torch mirror ``nn_within_halo_filtered_plain`` (the filter in
float32, then the exact float64 chain for the candidates it keeps) bit-equal
to the plain version ``nn_within_halo_plain`` on catalogs that press the
filter's bound (tests/torch_helpers.py:k6_catalog), its threshold checked in
exact rational arithmetic, and one catalog's keys held to the JAX package's
``_nn_keys``.
"""

from fractions import Fraction

import numpy as np
import numpy.testing as npt
import pytest
import torch

from abacusutils_tpu.models.hod import ranks_device as jrd
from abacusutils_tpu_torch.models.hod import ranks_device as trd
from torch_helpers import K6_CATALOGS, k6_catalog, k6_tensors


@pytest.mark.parametrize('kind', K6_CATALOGS)
def test_filtered_mirror_equals_plain(kind):
    """Bit-equal keys; the chains counted (a seed a query and the kept
    candidates) stay within the pairs and the queries, every zero distance
    (duplicates, float32 underflow) is found, and on clumped halos the
    filter skips most pairs."""
    x, y, z, query, work, pstart, pnum, seg = k6_tensors(*k6_catalog(kind))
    ref = trd.nn_within_halo_plain(x, y, z, query, pstart, pnum, seg)
    got, chains = trd.nn_within_halo_filtered_plain(x, y, z, query, pstart, pnum, seg)
    q = query.long()
    assert torch.equal(got[q], ref[q])
    assert bool(torch.isfinite(ref[q]).all())
    pairs = int(pnum.long()[seg[q].long()].sum())
    assert 0 < chains <= pairs + q.numel()
    if kind in ('three tiles', 'ulp pairs', 'near 2000'):
        assert chains < 0.2 * pairs
    if kind in ('duplicates', 'one point', 'f32 underflow'):
        assert int((ref[q] == 0).sum()) > 0


def test_ulp_pairs_catalog_has_keys_one_ulp_apart():
    """The 'ulp pairs' catalog's query at the origin sees float64 keys one
    ulp apart among its nearest neighbours, and both engines pick the
    smaller."""
    ppos, ps, pn, submask = k6_catalog('ulp pairs')
    p = ppos[ps[0]:ps[0] + pn[0]].astype(np.float64)
    origin = int(np.flatnonzero((p == 0).all(1))[0])
    keys = np.sort((p[:, 0] ** 2 + p[:, 1] ** 2) + p[:, 2] ** 2)[1:]  # the origin itself first
    assert np.nextafter(keys[0], np.inf) in keys[1:13]
    submask = submask.copy()
    submask[ps[0] + origin] = True
    x, y, z, query, work, pstart, pnum, seg = k6_tensors(ppos, ps, pn, submask)
    got, _ = trd.nn_within_halo_filtered_plain(x, y, z, query, pstart, pnum, seg)
    assert float(got[ps[0] + origin]) == keys[0]


def test_threshold_bounds_the_filter_exactly():
    """k6_threshold_plain(best) >= best (1 + 2^-21) + 2^-148 in exact
    arithmetic, for zero, subnormal, ordinary and huge minima; and at that
    threshold the filter's float32 chain of a pair that would lower or tie
    the minimum never exceeds it (sampled pairs at the edge of the bound)."""
    vals = torch.tensor([0.0, 5e-324, 1e-300, 2.0**-149, 1e-45, 1e-12, 0.1, 1.0, 3.0, 1e6,
                         4e7, 1e30, 3.4e38], dtype=torch.float64)
    thr = trd.k6_threshold_plain(vals)
    for b, t in zip(vals.tolist(), thr.tolist()):
        assert Fraction(t) >= Fraction(b) * (1 + Fraction(1, 2**21)) + Fraction(1, 2**148)
    assert trd.k6_threshold_plain(torch.tensor([float('inf')], dtype=torch.float64)).item() == \
        float('inf')
    rng = np.random.default_rng(7)
    for scale in (1e-22, 1e-3, 1.0, 1000.0):
        q = (rng.normal(0, scale, (20000, 3))).astype(np.float32)
        c = (q + rng.normal(0, scale * 1e-3, q.shape)).astype(np.float32)
        d = q.astype(np.float64) - c.astype(np.float64)
        key = torch.from_numpy((d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2])
        f = torch.from_numpy(q) - torch.from_numpy(c)
        d2f = f[:, 0] * f[:, 0] + (f[:, 1] * f[:, 1] + f[:, 2] * f[:, 2])
        # a minimum equal to the pair's own key: the pair ties it and must pass
        assert not bool((d2f > trd.k6_threshold_plain(key)).any())


def test_adversarial_keys_match_jax_nn_keys():
    """One adversarial catalog (faces of a centred slab, neighbours an ulp
    or two apart, a halo over 64 particles) against the JAX package's
    _nn_keys in x64, as tests/test_torch_ranks.py holds the NN keys: the
    root of the port's squared key within 1e-15 of JAX's distance (XLA's
    float64 chain may differ in the last bit)."""
    ppos, ps, pn, submask = k6_catalog('near +-1000')
    x, y, z, query, work, pstart, pnum, seg = k6_tensors(ppos, ps, pn, submask)
    got, _ = trd.nn_within_halo_filtered_plain(x, y, z, query, pstart, pnum, seg)
    with jrd.jax.enable_x64(True):
        key_j = np.asarray(jrd._nn_keys(ppos, ps, pn, np.float64, False)[0])
    q = query.numpy()
    npt.assert_allclose(np.sqrt(got.numpy()[q]), key_j[q], rtol=1e-15, atol=0)
