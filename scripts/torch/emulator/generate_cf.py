#!/usr/bin/env python3
"""
Generate a halo 2PCF on a single AbacusSummit halo catalog on the card, for
building emulators over many sims and redshifts (the counterpart of
scripts/emulator/generate_cf.py: the same command line, selection and
output file).

The most massive halos down to a target number density (the full
descending argsort of N, as the reference), their isotropic DD(r) by the
port's pair counts (``ops/tpcf.py:pair_counts_smu`` with one mu bin: the
cell kernel, or the all-pairs kernel under 25,000 halos) and the
analytic-RR xi, written as an ASDF file holding a Corrfunc-DD-shaped table
with ``xi`` and ``rmid`` and the catalog's header in its meta. ``--nthread``
sets the host's Blosc decode threads only.

$ python scripts/torch/emulator/generate_cf.py AbacusSummit_base_c000_ph000/halos/z0.100/

A sweep over a suite drains a taskfile of such commands with the port's
task farmer: ``python -m abacusutils_tpu_torch.utils.taskfarm tasks.txt -w 1``.
"""

import argparse
import sys
from pathlib import Path
from time import perf_counter

import numpy as np

REPO = Path(__file__).resolve().parents[3]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from abacusutils_tpu_torch.io import Table, set_nthreads, write_asdf  # noqa: E402
from abacusutils_tpu_torch.io.compaso import CompaSOHaloCatalog  # noqa: E402
from abacusutils_tpu_torch.ops.tpcf import pair_counts_smu  # noqa: E402

DEFAULT_NDENS = 1e-4
DEFAULT_OUTDIR = '.'

RBINS = np.geomspace(0.1, 50, 13)


def log(*args, **kwargs):
    print(*args, **kwargs, flush=True)


def prepare_cat(halo_cat_path, ndens):
    """Load the catalog and keep the N most massive halos at density `ndens`."""
    cat = CompaSOHaloCatalog(halo_cat_path, subsamples=False, fields=('N', 'x_L2com'),
                             cleaned=False)
    log(f'Loading cat used {cat.nbytes() / 1e9:.3g} GB')
    box = cat.header['BoxSize']
    n_select = int(box**3 * ndens)
    log(f'Selecting {n_select} objects')
    if not 0 < n_select <= len(cat.halos['N']):
        raise ValueError(f'ndens={ndens} selects {n_select} of {len(cat.halos["N"])} halos')
    # the full descending argsort, not argpartition: mass ties at the
    # threshold are generic (N counts particles), and the kept subset must
    # be the reference's np.argsort(N)[::-1][:n_select]
    keep = np.argsort(cat.halos['N'])[::-1][:n_select]
    cat.halos = cat.halos[keep]
    return cat


def generate_cf(cat, rbins=RBINS, device=None):
    """Isotropic DD(r) on `device` (None: the card) and the analytic-RR xi."""
    pos = cat.halos['x_L2com']
    box = float(cat.header['BoxSize'])
    n = len(pos)
    # columns wrapped into [0, box), the cell engine's layout
    soa = tuple(np.ascontiguousarray(pos[:, i] % box, np.float64) for i in range(3))
    npairs = pair_counts_smu(soa, rbins, 1, box, device=device).reshape(-1)

    cf = Table(
        {
            'rmin': rbins[:-1].astype(np.float64),
            'rmax': rbins[1:].astype(np.float64),
            'ravg': np.zeros(len(rbins) - 1),
            'npairs': npairs.astype(np.uint64),
            'weightavg': np.zeros(len(rbins) - 1),
        },
        meta=dict(cat.header),
    )
    # ordered-pair RR in a periodic box (the DD doubling convention)
    rr = n * (n - 1) / box**3 * 4 / 3 * np.pi * np.diff(rbins**3)
    cf['xi'] = cf['npairs'] / rr - 1
    cf['rmid'] = (cf['rmin'] + cf['rmax']) / 2.0
    cf.meta['zname'] = Path(cat.groupdir).name
    return cf


def write_cf(cf, outdir, generate_cf_args=None):
    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    fn = outdir / f'{cf.meta["SimName"]}-{cf.meta["zname"]}-cf.asdf'
    write_asdf(fn, dict(data=cf, generate_cf_args=generate_cf_args))
    return fn


def main(halo_cat_path, ndens=DEFAULT_NDENS, nthread=None, outdir=DEFAULT_OUTDIR, device=None):
    """Select, count and write; returns the output file's path."""
    t0 = perf_counter()
    if nthread:
        set_nthreads(nthread)

    t1 = perf_counter()
    cat = prepare_cat(halo_cat_path, ndens)
    log(f'prepare_cat() took {perf_counter() - t1:.2f} seconds')

    t1 = perf_counter()
    cf = generate_cf(cat, device=device)
    log(f'generate_cf() took {perf_counter() - t1:.2f} seconds')

    args = dict(halo_cat_path=str(halo_cat_path), ndens=ndens, nthread=nthread)
    fn = write_cf(cf, outdir, generate_cf_args=args)
    log(f'Wrote {fn}')
    log(f'Total time: {perf_counter() - t0:.2f} seconds')
    return fn


if __name__ == '__main__':
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument('halo_cat_path', help='Path to the halo catalog redshift dir, like '
                        '"AbacusSummit_base_c000_ph000/halos/z0.100/"')
    parser.add_argument('--ndens', type=float, default=DEFAULT_NDENS,
                        help='Number density of tracers in (Mpc/h)^-3; selects the most '
                        'massive halos down to this abundance')
    parser.add_argument('--nthread', type=int, default=None,
                        help='Host IO threads (pair counting runs on the device)')
    parser.add_argument('--outdir', default=DEFAULT_OUTDIR,
                        help='Directory for the output OUTDIR/SimName-z-cf.asdf')
    parser.add_argument('--device', help='torch device (default: the card)')
    main(**vars(parser.parse_args()))
