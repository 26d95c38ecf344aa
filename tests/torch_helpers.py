"""Shared pieces of the abacusutils_tpu_torch parity tests."""

import os

import numpy as np
import pytest
import torch


def _share_the_cores():
    """Give each pytest-xdist worker its share of the host's cores for
    torch's intra-op threads. Every worker imports this module when it
    collects the tests. By default each torch process starts an OpenMP pool
    of every core, and the spin-waits of six such pools take the cores from
    each other: a pair-count test of 8.6 s alone took 280 s beside five
    copies of itself, and 8.2 s with one thread each."""
    workers = int(os.environ.get('PYTEST_XDIST_WORKER_COUNT', '1'))
    if workers > 1:
        torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // workers))


_share_the_cores()


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where there is none. Decided
    when the test runs, never at import, so every worker collects the same
    tests."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda', 0)


def t(a):
    """A CPU tensor sharing a contiguous copy of numpy array `a`."""
    return torch.from_numpy(np.ascontiguousarray(a))



# the tracer parameters of tests/test_pipeline.py:_tracer_params, LRG from
# the example inputs' HOD
TRACERS = {
    'LRG': {
        'logM_cut': 12.8, 'logM1': 14.0, 'sigma': 0.3, 'alpha': 1.0, 'kappa': 0.4,
        'alpha_c': 0.3, 'alpha_s': 1.0, 'ic': 1.0,
        'Acent': 0.0, 'Asat': 0.0, 'Bcent': 0.0, 'Bsat': 0.0,
    },
    'ELG': {
        'logM_cut': 11.6, 'logM1': 13.5, 'sigma': 0.3, 'alpha': 0.8, 'kappa': 1.0,
        'p_max': 0.1, 'Q': 100.0, 'gamma': 1.2, 'A_s': 1.0, 'alpha_c': 0.1, 'alpha_s': 1.0,
    },
    'QSO': {
        'logM_cut': 12.2, 'logM1': 13.8, 'sigma': 0.5, 'alpha': 0.8, 'kappa': 1.0,
        'alpha_c': 0.2, 'alpha_s': 1.0,
    },
}


def linked_inputs(n_halo, n_part, lbox, seed):
    """The example catalogs (numpy) plus part['hidx'], each particle's host
    halo, with the particle's host mass and velocity taken from it (the
    _inputs() of tests/test_pipeline.py)."""
    from abacusutils_tpu_torch.models.pipeline import make_example_inputs

    halo, part, params = make_example_inputs(n_halo, n_part, lbox, seed=seed)
    rng = np.random.default_rng(seed + 1)
    part['hidx'] = rng.integers(0, n_halo, n_part).astype(np.int64)
    part['hmass'] = halo['mass'][part['hidx']]
    part['hvelz'] = halo['vz'][part['hidx']]
    return halo, part, params


def catalog_tensors(cat, device='cpu'):
    """A catalog dict of numpy columns as tensors: float columns as float32,
    integer columns as they are."""
    return {
        k: t(v if np.issubdtype(v.dtype, np.integer) else v.astype(np.float32)).to(device)
        for k, v in cat.items()
    }


def staged_state(n_halo, n_part, lbox, seed):
    """A staged catalog in the column schema of AbacusHOD.staging()."""
    rng = np.random.default_rng(seed)
    hpos = rng.random((n_halo, 3)) * lbox - lbox / 2
    hvel = rng.normal(0, 300, (n_halo, 3))
    hmass = 10 ** (11 + 4 * rng.random(n_halo) ** 3)
    halo = {
        'hpos': hpos, 'hvel': hvel, 'hmass': hmass,
        'hid': np.arange(n_halo, dtype=np.int64),
        'hmultis': np.ones(n_halo), 'hrandoms': rng.random(n_halo),
        'hveldev': rng.normal(0, 100, (n_halo, 3)),
        'hsigma3d': np.abs(rng.normal(200, 50, n_halo)),
        'hdeltac': rng.uniform(-0.5, 0.5, n_halo),
        'hfenv': rng.uniform(-0.5, 0.5, n_halo),
        'hshear': rng.uniform(-0.5, 0.5, n_halo),
    }
    pinds = np.sort(rng.integers(0, n_halo, n_part))
    part = {
        'ppos': hpos[pinds] + rng.normal(0, 0.5, (n_part, 3)),
        'pvel': rng.normal(0, 300, (n_part, 3)),
        'phvel': hvel[pinds], 'phmass': hmass[pinds], 'phid': pinds.astype(np.int64),
        'pweights': rng.uniform(5.0, 20.0, n_part), 'prandoms': rng.random(n_part),
        'pdeltac': halo['hdeltac'][pinds], 'pfenv': halo['hfenv'][pinds],
        'pshear': halo['hshear'][pinds], 'pinds': pinds,
        'pranksc': np.zeros(n_part),
    }
    for k in ('pranks', 'pranksv', 'pranksp', 'pranksr'):
        part[k] = rng.random(n_part) - 0.5
    return halo, part


# K6's adversarial catalogs (tests/test_torch_k6_filter.py, and on the card
# tests/test_torch_cuda.py)
K6_CATALOGS = ('duplicates', 'ulp pairs', 'near zero', 'near 2000', 'near +-1000',
               'f32 underflow', 'three tiles', 'one point')


def _ulp_triples(rng, count):
    """`count` float32 triples (a, b, c) of unlike magnitudes whose
    permutations give float64 keys (x x + y y) + z z exactly one ulp apart."""
    out = []
    for _ in range(100_000):
        a, b, c = (rng.random(3) * np.array([1.0, 0.5, 1e-4])).astype(np.float32).tolist()
        keys = sorted({(x * x + y * y) + z * z for x, y, z in
                       ((a, b, c), (a, c, b), (b, c, a), (b, a, c), (c, a, b), (c, b, a))})
        if any(np.nextafter(k0, np.inf) == k1 for k0, k1 in zip(keys, keys[1:])):
            out.append((a, b, c))
            if len(out) == count:
                return out
    raise RuntimeError('no triple with keys one ulp apart')


def k6_catalog(kind, seed=3):
    """A slab of halos for K6 (ppos (n, 3) float32, pstart, pnum, submask)
    that presses its float32 filter: 'duplicates' (d^2 = 0), 'ulp pairs'
    (a query whose neighbours' float64 keys lie one ulp apart), 'near zero'
    (coordinates of both signs down to float32 subnormals), 'near 2000' and
    'near +-1000' (a box's far face, a centred slab's faces, neighbours an
    ulp or two apart), 'f32 underflow' (differences whose float32 squares
    underflow or turn subnormal), 'three tiles' (a halo over two of K6's
    512-particle tiles) and 'one point' (a halo all at one position)."""
    rng = np.random.default_rng(seed)
    halos = []

    def clump(centre, sigma, n):
        return (np.asarray(centre, np.float64) + rng.normal(0, sigma, (n, 3))).astype(np.float32)

    if kind == 'duplicates':
        for n in (2, 3, 17, 90, 300):
            p = clump(rng.random(3) * 100, 0.3, n)
            p[n // 2:] = p[rng.integers(0, max(n // 2, 1), n - n // 2)]
            halos.append(p)
    elif kind == 'ulp pairs':
        # a query at the origin (exact differences) and its neighbours at
        # the permutations of (a, b, c), of either sign
        for a, b, c in _ulp_triples(rng, 6):
            perms = np.array([(a, b, c), (a, c, b), (b, c, a), (b, a, c), (c, a, b), (c, b, a)])
            p = np.concatenate([np.zeros((1, 3)), perms, -perms, clump([4.0] * 3, 1.0, 40)])
            halos.append(p[rng.permutation(len(p))].astype(np.float32))
    elif kind == 'near zero':
        mags = np.array([1e-3, 1e-7, 1e-20, 1e-30, 1e-38, 1e-40, 1e-44, 0.0, 0.5])
        for n in (5, 40, 200):
            v = rng.choice(mags, (n, 3)) * rng.choice([-1.0, 1.0], (n, 3))
            halos.append((v * rng.uniform(0.5, 2.0, (n, 3))).astype(np.float32))
    elif kind == 'near 2000':
        for n in (4, 60, 250):
            steps = rng.integers(1, 40, (n, 3))
            halos.append((np.float32(2000.0) - steps * np.float32(2.0**-13)).astype(np.float32))
    elif kind == 'near +-1000':
        for sign in (-1.0, 1.0):
            for n in (6, 70, 300):
                steps = rng.integers(0, 30, (n, 3))
                p = sign * (np.float32(1000.0) - steps * np.float32(2.0**-14))
                halos.append(p.astype(np.float32))
    elif kind == 'f32 underflow':
        for scale in (1e-22, 1e-24, 1e-30):
            n = 50
            p = (1e-20 + rng.normal(0, scale, (n, 3))).astype(np.float32)
            p[::7] = (rng.normal(0, 1e-3, (len(p[::7]), 3))).astype(np.float32)
            halos.append(p)
    elif kind == 'three tiles':
        halos += [clump(rng.random(3) * 500, 0.4, 1300), clump(rng.random(3) * 500, 0.4, 20)]
    elif kind == 'one point':
        halos += [np.full((700, 3), 123.456, np.float32), clump([5.0, 5.0, 5.0], 0.2, 30)]
    else:
        raise ValueError(kind)
    pn = np.array([len(h) for h in halos], np.int64)
    ps = np.concatenate([[0], np.cumsum(pn)[:-1]])
    submask = rng.random(int(pn.sum())) < 0.8
    submask[ps] = True
    return np.concatenate(halos).astype(np.float32), ps, pn, submask


def k6_tensors(ppos, ps, pn, submask, device='cpu'):
    """K6's arguments for a k6_catalog: (x, y, z, query, work, pstart, pnum,
    seg) on `device`."""
    from abacusutils_tpu_torch.models.hod import ranks_device as trd

    owner = np.repeat(np.arange(len(pn)), pn).astype(np.int32)
    x, y, z = (t(ppos[:, a]).to(device) for a in range(3))
    seg = t(owner).to(device)
    query, work = trd.nn_work(seg, t(submask).to(device), len(ps))
    return (x, y, z, query, work, t(ps.astype(np.int32)).to(device),
            t(pn.astype(np.int32)).to(device), seg)
