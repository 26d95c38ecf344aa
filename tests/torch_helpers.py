"""Shared pieces of the abacusutils_tpu_torch parity tests."""

import numpy as np
import pytest
import torch


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
