#!/usr/bin/env python3
"""Readings of the two LCV flows, run_lcv_field against run_lcv, in the JAX
package and in the port on the same inputs, on the CPU.

    JAX_PLATFORMS=cpu python3 tests/lcv_flows_readings.py [--nmesh 64] [--out build/lcv_flows_readings.json]

Two inputs at --nmesh cells a side in the 2000 Mpc/h box:

1. tests/test_zcv.py's LCV setup (a Gaussian IC of sigma 0.05, CIC,
   compensated and interlaced) with 2e5 tracers drawn with weight
   1 + 0.7 delta / sigma on the IC cells (tests/test_torch_cv_field.py's
   draw);
2. chip_smoke.py phase 13's cell cut to --nmesh: its seeded Gaussian IC
   with the CLASS P(k) of AbacusSummit_base_c000_ph000 at z 0.5, filtered
   at kcut = pi nmesh / Lbox / 2, and its lattice tracer (2e5 points, the
   RSD positions shifted into [0, Lbox)), TSC.

For each, with recsym and with reciso (R 10 Mpc/h): the elements where each
package's field flow leaves tests/test_zcv.py:test_lcv_field_vs_k_level's
band around its own k-level flow (Pk_lf_lf_ell and Pk_tr_lf_ell: rtol 2e-3
+ 1e-4 of the largest value; Pk_tr_tr_ell_lcv: rtol 0.05 + 0.02 of the
largest value), the worst of them (pole, k, reference, difference, band),
whether the two packages' sets are equal, the largest difference of the
port's field flow from JAX's over the largest value, and for reciso the
same count for the port's field flow with the smoothing taken at the bin
centres (abacusutils_tpu_torch.testing.smoothing_at_bin_centres). Prints
one line a comparison and writes them all to --out as JSON.
"""

import argparse
import json
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch
import yaml

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from abacusutils_tpu.models.zcv import linear_fields as jlin  # noqa: E402
from abacusutils_tpu.models.zcv import tools_cv as jtools  # noqa: E402
from abacusutils_tpu.models.zcv import tracer_power as jtp  # noqa: E402
from abacusutils_tpu.models.zcv.ic_fields import compress_asdf  # noqa: E402
from abacusutils_tpu.models.zcv.zenbu_window import periodic_window_function  # noqa: E402
from abacusutils_tpu.ops.power import get_k_mu_edges  # noqa: E402
from abacusutils_tpu_torch.models.zcv import cosmo as tcosmo  # noqa: E402
from abacusutils_tpu_torch.models.zcv import ic_fields as tic  # noqa: E402
from abacusutils_tpu_torch.models.zcv import tools_cv as ttools  # noqa: E402
from abacusutils_tpu_torch.models.zcv import tracer_power as ttp  # noqa: E402
from abacusutils_tpu_torch.models.zcv.precompute import lcv_products  # noqa: E402
from abacusutils_tpu_torch.testing import smoothing_at_bin_centres  # noqa: E402

LBOX = 2000.0
R = 10.0
N_TRACER = 200_000
BANDS = (('Pk_lf_lf_ell', 2e-3, 1e-4), ('Pk_tr_lf_ell', 2e-3, 1e-4),
         ('Pk_tr_tr_ell_lcv', 0.05, 0.02))


def synthetic_input(n):
    """tests/test_zcv.py's IC at n^3 and the drawn tracer in [0, Lbox)."""
    rng = np.random.default_rng(7)
    dens = rng.normal(0, 0.05, (n,) * 3).astype(np.float32)
    w = np.clip(1.0 + 0.7 * dens / dens.std(), 0.05, None).ravel()
    cells = rng.choice(w.size, size=N_TRACER, p=w / w.sum())
    ijk = np.stack(np.unravel_index(cells, (n,) * 3), axis=1)
    tracer = ((ijk + rng.random((N_TRACER, 3))) * (LBOX / n)).astype(np.float32)
    sim, z, kcut = 'AbacusSummit_base_c000_ph006', 0.8, 0.2261946710584651
    return dict(sim=sim, z=z, kcut=kcut, paste='CIC', dens=dens, tracer=tracer)


def phase13_input(n):
    """chip_smoke.py phase 13's IC and tracer at n^3 on the CPU."""
    meta = tcosmo.get_meta(chip_smoke.ZCV_SIM, redshift=chip_smoke.ZCV_Z)
    kcut = np.pi * n / LBOX / 2
    gen = torch.Generator(device='cpu')
    gen.manual_seed(chip_smoke.SEED + 13)
    dens, disp = chip_smoke.gaussian_ic(n, meta, gen, 'cpu')
    mocks, _ = chip_smoke.lattice_tracers(dens, disp, n, kcut, meta, gen, N_TRACER)
    filt = tic.gaussian_filter(dens, n, LBOX, kcut, 'cpu').numpy()
    tracer = np.stack([np.remainder(mocks[True][c] + LBOX / 2, LBOX) for c in 'xyz'],
                      axis=1).astype(np.float32)
    return dict(sim=chip_smoke.ZCV_SIM, z=chip_smoke.ZCV_Z, kcut=kcut, paste='TSC', dens=filt,
                tracer=tracer)


def outside(ref, got, rtol, atol_frac, k_binc):
    """(pole, k, reference, difference, band) where |got - ref| exceeds
    rtol |ref| + atol_frac max|ref|, the worst first."""
    r = np.asarray(ref, np.float64).reshape(3, -1)
    d = np.abs(np.asarray(got, np.float64).reshape(3, -1) - r)
    band = rtol * np.abs(r) + atol_frac * np.abs(r).max()
    idx = sorted(zip(*np.nonzero(d > band)), key=lambda ij: -d[ij] / band[ij])
    return [(2 * int(i), float(k_binc[j]), float(r[i, j]), float(d[i, j]), float(band[i, j]))
            for i, j in idx]


def flows(inp, n, rec, work):
    """Both packages' run_lcv and run_lcv_field on one input; for reciso
    also the port's field flow smoothed at the bin centres."""
    config = {
        'sim_params': {'sim_name': inp['sim'], 'z_mock': inp['z']},
        'HOD_params': {'want_rsd': True, 'rec_algo': rec, 'smoothing': R},
        'lcv_params': {'lcv_dir': str(work), 'ic_dir': str(work), 'nmesh': n,
                       'kcut': inp['kcut']},
        'power_params': {'nbins_k': n // 2, 'nbins_mu': 1, 'poles': [0, 2, 4],
                         'k_hMpc_max': np.pi * n / LBOX, 'paste': inp['paste'],
                         'compensated': True, 'interlaced': True, 'logk': False, 'nmesh': n},
    }
    (work / inp['sim']).mkdir(parents=True, exist_ok=True)
    compress_asdf(str(work / inp['sim'] / f'ic_filt_nmesh{n}.asdf'), {'dens': inp['dens']},
                  {'sim_name': inp['sim'], 'Lbox': LBOX, 'nmesh': n, 'kcut': inp['kcut']})
    cfg_fn = work / 'cfg.yaml'
    yaml.safe_dump(config, open(cfg_fn, 'w'))
    pk_lin = jlin.main(str(cfg_fn))
    lin_fns = jlin.main(str(cfg_fn), save_3D_power=True)
    k_bins, _ = get_k_mu_edges(LBOX, np.pi * n / LBOX, n // 2, 1, False)
    window, keff = periodic_window_function(n, LBOX, k_bins, 0.5 * (k_bins[1:] + k_bins[:-1]))
    np.savez(work / inp['sim'] / f'window_nmesh{n}.npz', window=window, keff=keff)
    jtr = jtp.get_recon_power(inp['tracer'], None, True, config, want_save=True)
    tr_fns = jtp.get_recon_power(None, None, True, config, want_load_tr_fft=True,
                                 save_3D_power=True)
    out = {'jax': (jtools.run_lcv(jtr, pk_lin, config),
                   jtools.run_lcv_field(tr_fns, lin_fns, config))}
    meta = tcosmo.get_meta(inp['sim'], redshift=inp['z'])
    lcv = lcv_products(inp['dens'], LBOX, n, config, meta, filter_ic=False, engine='host',
                       device='cpu')
    tr = ttp.get_recon_power(inp['tracer'], None, True, config, meta=meta, device='cpu',
                             save_3D_power=True)
    spectra = ttp.get_recon_power(None, None, True, config, lcv.field_ffts, meta,
                                  tr_field_fft=tr)
    pk = ttools.run_lcv(spectra, lcv.pk_lin, config, window=lcv.window, keff=lcv.keff,
                        meta=meta)
    out['port'] = (pk, ttools.run_lcv_field(tr, lcv.field_ffts, config, meta=meta))
    if rec == 'reciso':
        exact = ttools.get_smoothing
        ttools.get_smoothing = smoothing_at_bin_centres(k_bins)
        try:
            out['port, smoothed at the bin centres'] = (
                pk, ttools.run_lcv_field(tr, lcv.field_ffts, config, meta=meta))
        finally:
            ttools.get_smoothing = exact
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--nmesh', type=int, default=64)
    ap.add_argument('--out', default=str(ROOT / 'build' / 'lcv_flows_readings.json'))
    args = ap.parse_args()
    n = args.nmesh
    lines = []
    for name, make in (('synthetic', synthetic_input), ('phase 13 cell', phase13_input)):
        inp = make(n)
        for rec in ('recsym', 'reciso'):
            with tempfile.TemporaryDirectory() as work:
                res = flows(inp, n, rec, Path(work))
            k_binc = np.asarray(res['jax'][0]['k_binc'])
            for key, rtol, atol in BANDS:
                sets = {who: outside(k[key], f[key], rtol, atol, k_binc)
                        for who, (k, f) in res.items()}
                jf, pf = (np.asarray(res[w][1][key], np.float64) for w in ('jax', 'port'))
                line = dict(
                    input=name, nmesh=n, rec_algo=rec, key=key, rtol=rtol, atol_frac=atol,
                    outside={w: len(v) for w, v in sets.items()},
                    worst={w: (v[0] if v else None) for w, v in sets.items()},
                    same_set=[x[:2] for x in sets['jax']] == [x[:2] for x in sets['port']],
                    port_vs_jax_field=float(np.abs(pf - jf).max() / np.abs(jf).max()),
                    size=int(jf.size),
                )
                print(json.dumps(line))
                lines.append(line)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(lines, indent=1))


if __name__ == '__main__':
    main()
