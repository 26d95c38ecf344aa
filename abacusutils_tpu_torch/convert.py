"""Carry the JAX package's host-side state into the port's tensors.

The JAX package describes a fused HOD step by catalog dicts of (N,) arrays,
an HOD parameter dict, a mode-bin plan ``(seg,)`` and the per-axis window
compensation ``Wcomp``. :func:`inputs_from_numpy` turns each into the
tensors the port's step takes, so both packages can compute on identical
state. Arrays go through ``numpy.asarray``, which accepts JAX arrays without
importing JAX.
"""

import numpy as np
import torch

__all__ = ['params_to_tensors', 'inputs_from_numpy']


def params_to_tensors(params, device):
    """HOD parameters as 0-d float32 tensors on `device`, so the markers'
    scalar arithmetic runs in float32, as it does under jax.jit, and the step
    copies nothing from the host."""
    return {
        k: torch.tensor(float(np.float32(v)), dtype=torch.float32, device=device)
        for k, v in params.items()
    }


def _catalog(cat, device):
    return {
        k: torch.from_numpy(np.array(v, np.float32)).to(device)
        for k, v in cat.items()
    }


def inputs_from_numpy(halo, part, params, binplan, Wcomp, device):
    """Return (halo, part, params, seg, Wcomp) as tensors on `device`:
    catalog columns as float32, params via :func:`params_to_tensors`, the
    plan's ``seg`` (``binplan`` is ``(seg,)`` or ``seg``) as int32, and
    ``Wcomp`` as float32 (or None)."""
    seg = binplan[0] if isinstance(binplan, (tuple, list)) else binplan
    seg = torch.from_numpy(np.array(seg, np.int32).reshape(-1)).to(device)
    if Wcomp is not None:
        Wcomp = torch.from_numpy(np.array(Wcomp, np.float32)).to(device)
    params = params_to_tensors(params, device)
    return _catalog(halo, device), _catalog(part, device), params, seg, Wcomp
