#!/usr/bin/env python
"""Multi-tracer fused HOD + P(k) on one card (the counterpart of
scripts/hod/bench_multitracer.py, at its cell: 10^7 halos and 5x10^7
particles in (2000 Mpc/h)^3, nmesh 256, LRG + ELG + QSO with the JAX
script's tracer parameters, RSD).

The catalog is drawn on the card (``make_example_inputs_device``, with the
conformity link), staged once by brick (``group_inputs2d_linked_device``),
then each step is ``hod_pk_fused_multi``: three populates, six deposits
(K1), three rfftn and one binning launch for the six auto and cross spectra
(K3). Staging is timed cold and warm, then one cold step and `n_iter` warm
steps. Prints one JSON line with the JAX script's keys ('device' is the
card's name; K_h / K_p are the most points a K1 work item of each stage
holds, where the JAX script gives its padded slot capacity). It is a script,
not the benchmark, and writes nothing.

$ python scripts/torch/hod/bench_multitracer.py
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[3]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from abacusutils_tpu_torch.convert import params_to_tensors, resolve_device  # noqa: E402
from abacusutils_tpu_torch.models.hod.population import prepare_tracer_params  # noqa: E402
from abacusutils_tpu_torch.models.pipeline import (  # noqa: E402
    group_inputs2d_linked_device,
    hod_pk_fused_multi,
    make_bin_plan_arrays,
    make_example_inputs_device,
)
from abacusutils_tpu_torch.ops.power import get_W_compensated  # noqa: E402

N_HALO = 10_000_000
N_PART = 50_000_000
LBOX = 2000.0
NMESH = 256
YB = None  # K1's default brick
SEED = 42
Z = 0.5
VELZ2KMS = 100.0
WANT = ('LRG', 'ELG', 'QSO')
TRACERS = {
    'LRG': dict(logM_cut=12.8, logM1=14.0, sigma=0.3, alpha=1.0, kappa=0.4, alpha_c=0.3,
                alpha_s=1.0),
    'ELG': dict(logM_cut=11.6, logM1=13.5, sigma=0.3, alpha=0.8, kappa=1.0, p_max=0.1, Q=100.0,
                gamma=1.2, A_s=1.0, alpha_c=0.1, alpha_s=1.0),
    'QSO': dict(logM_cut=12.2, logM1=13.8, sigma=0.5, alpha=0.8, kappa=1.0, alpha_c=0.2,
                alpha_s=1.0),
}


def _sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def make_step(halo_g, part_g, plan_h, plan_p, nmesh, lbox, tracers=TRACERS):
    """The bench step on staged catalogs: a function of no argument that
    returns ({(t1, t2): bin sums}, {tracer: n_gal}) of hod_pk_fused_multi
    with TSC compensation, nmesh / 2 k bins and RSD."""
    device = halo_g['x'].device
    nbins_k = nmesh // 2
    seg, _ = make_bin_plan_arrays(nmesh, lbox, nbins_k, device)
    Wcomp = torch.from_numpy(get_W_compensated(lbox, nmesh, 'TSC', False).astype(np.float32))
    Wcomp = Wcomp.to(device)
    tp = prepare_tracer_params({t: tracers[t] for t in WANT}, z=Z)
    params = {t: params_to_tensors(tp[t], device) for t in WANT}

    def step():
        return hod_pk_fused_multi(halo_g, part_g, params, seg, Wcomp, lbox, VELZ2KMS, WANT,
                                  nmesh, YB, nbins_k, plan_h, plan_p, rsd=True)

    return step


def _largest_item(plan):
    return int((plan.work[:, 2] - plan.work[:, 1]).max())


def main(n_halo=N_HALO, n_part=N_PART, nmesh=NMESH, lbox=LBOX, n_iter=5, device=None):
    """Draw, stage (cold and warm) and step (one cold call, `n_iter` warm) on
    `device` (None: the card). Returns (the JSON line's dict, the step, the
    last step's spectra)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    halo, part, _ = make_example_inputs_device(n_halo, n_part, lbox, gen, device, link=True)
    _sync(device)

    t0 = time.perf_counter()
    staged = group_inputs2d_linked_device(halo, part, nmesh, lbox, YB)
    _sync(device)
    t_stage_cold = time.perf_counter() - t0
    # the same shapes again: the per-catalog cost; the first layout is freed
    # first (both alive would double the staged footprint)
    del staged
    t0 = time.perf_counter()
    halo_g, part_g, plan_h, plan_p = group_inputs2d_linked_device(halo, part, nmesh, lbox, YB)
    _sync(device)
    t_stage = time.perf_counter() - t0
    del halo, part
    step = make_step(halo_g, part_g, plan_h, plan_p, nmesh, lbox)

    t0 = time.perf_counter()
    spectra, n_gal = step()
    ngals = {t: float(n_gal[t]) for t in WANT}
    t_cold = time.perf_counter() - t0

    t0 = time.perf_counter()
    for _ in range(n_iter):
        spectra, ng = step()
    for t in WANT:
        float(ng[t])  # sync
    dt = (time.perf_counter() - t0) / n_iter

    total_gal = sum(ngals.values())
    record = {
        'metric': 'hod_multitracer_pk_endtoend',
        'value': total_gal / dt,
        'unit': 'galaxies/s',
        'detail': {
            'tracers': list(WANT),
            'n_gal': {t: int(v) for t, v in ngals.items()},
            'n_spectra': len(spectra),
            'step_seconds': dt,
            'per_tracer_seconds': dt / len(WANT),
            'staging_seconds': t_stage,
            'staging_first_call_seconds': t_stage_cold,
            'compile_seconds': t_cold,
            'K_h': _largest_item(plan_h), 'K_p': _largest_item(plan_p),
            'nmesh': nmesh, 'lbox': lbox,
            'device': (torch.cuda.get_device_name(device) if device.type == 'cuda'
                       else str(device)),
        },
    }
    print(json.dumps(record), flush=True)
    return record, step, spectra


if __name__ == '__main__':
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument('--device', help='torch device (default: the card)')
    main(device=ap.parse_args().device)
