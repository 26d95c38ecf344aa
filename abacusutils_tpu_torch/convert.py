"""Carry the JAX package's host-side state into the port's tensors.

The JAX package describes a fused HOD step by catalog dicts of (N,) arrays,
an HOD parameter dict, a mode-bin plan ``(seg,)`` and the per-axis window
compensation ``Wcomp``. :func:`inputs_from_numpy` turns each into the
tensors the port's step takes, so both packages can compute on identical
state. :func:`staged_state_from_numpy` builds the port's ``AbacusHOD`` on
the staged state of a JAX ``AbacusHOD``. Arrays go through
``numpy.asarray``, which accepts JAX arrays without importing JAX.
:func:`position_columns` and :func:`mock_from_numpy` carry a catalog of
positions, or a ``run_hod`` mock, to the form the port's pair counts take.
:func:`resolve_device` gives the device an entry point runs on when its
caller names none: the card.
"""

import numpy as np
import torch

from .utils.profiling import count_copy

__all__ = [
    'resolve_device', 'params_to_tensors', 'inputs_from_numpy', 'staged_state_from_numpy',
    'position_columns', 'mock_from_numpy',
]


def resolve_device(device='cuda'):
    """`device` as a torch.device, the card when None. A CUDA device on a
    machine without one raises: the port's entry points never fall back to
    the CPU, which runs only when the caller asks for it."""
    device = torch.device('cuda' if device is None else device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            f'no CUDA device for {device}: pass device="cpu" to run the plain PyTorch versions'
        )
    return device


def params_to_tensors(params, device):
    """HOD parameters as 0-d float32 tensors on `device`, so the markers'
    scalar arithmetic runs in float32, as it does under jax.jit, and the step
    copies nothing from the host. All values travel in one copy."""
    keys = list(params)
    vals = torch.tensor([float(np.float32(params[k])) for k in keys], dtype=torch.float32)
    return dict(zip(keys, count_copy(vals, vals.to(device)).unbind(0)))


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


def staged_state_from_numpy(halo_data, particle_data, params, tracers, flags, device,
                            mock_dir=None):
    """The port's ``AbacusHOD`` on the staged state of a JAX ``AbacusHOD``:
    its ``halo_data`` and ``particle_data`` column dicts (as numpy arrays;
    the halos' ``hc``, ``hrvir`` and ``hsigma3d`` are what NFW satellites
    read, and a secondary redshift's particle columns are empty), its
    ``params`` (``z``, ``Lbox``, ``velz2kms``, ``origin``, ``chunk``), its
    tracer dict, ``flags``, a dict of the ``want_ranks``, ``want_shear``,
    ``want_expvel``, ``halo_lc`` and ``z_type`` settings, and its
    ``mock_dir`` (where ``run_hod(write_to_disk=True)`` writes). Each call
    of ``run_hod_pk_fused`` turns the per-tracer HOD parameter dicts into
    0-d float32 tensors on `device` with :func:`params_to_tensors`, after
    ``prepare_tracer_params``."""
    from .models.hod.abacus_hod import AbacusHOD

    params = dict(params)
    if params.get('origin') is not None:
        params['origin'] = np.asarray(params['origin'], np.float64)
    return AbacusHOD(
        {k: np.asarray(v) for k, v in halo_data.items()},
        {k: np.asarray(v) for k, v in particle_data.items()},
        params,
        {t: dict(p) for t, p in tracers.items()},
        device,
        mock_dir=mock_dir,
        **flags,
    )


def position_columns(pos, device='cuda'):
    """An (N, 3) array, or an (x, y, z) tuple of columns, as three 1-D
    float32 tensors on `device`: the staged form of the port's pair counts
    (``ops/tpcf.py``), whose cell stage is cached by these tensors."""
    device = resolve_device(device)
    cols = pos if isinstance(pos, (tuple, list)) else np.asarray(pos).T
    return tuple(
        torch.from_numpy(np.array(c, np.float32)).to(device) for c in cols
    )


def mock_from_numpy(mock_dict):
    """A ``run_hod`` mock of the JAX package (tracer -> columns, numpy or JAX
    arrays) as plain numpy column dicts, the input of the port's
    ``compute_xirppi`` / ``compute_wp`` / ``compute_multipole`` /
    ``compute_power``; ``Ncent`` stays an int."""
    return {
        tr: {k: (int(v) if k == 'Ncent' else np.asarray(v)) for k, v in cols.items()}
        for tr, cols in mock_dict.items()
    }
