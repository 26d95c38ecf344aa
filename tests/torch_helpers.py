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

