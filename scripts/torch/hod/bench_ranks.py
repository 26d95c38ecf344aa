#!/usr/bin/env python
"""prepare_sim's rank decorations at slab scale: the host per-halo loop
against the card's engine (the counterpart of scripts/hod/bench_ranks.py).

The same synthetic slab as the JAX script (:func:`synth_slab`, seed 17):
halos of power-law sizes, many of tens of particles and a few of
thousands. The device engine, ``ranks_device.rank_fields_device`` (K6 for
the nearest-neighbour distance, two stable sorts a rank key), is timed cold
and warm, host keys, uploads and the five rank downloads included; the
host engine is ``prepare_sim._rank_fields`` halo by halo. Prints one JSON
line with the JAX script's keys and returns it as a dict.

$ python scripts/torch/hod/bench_ranks.py --n 1200000
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[3]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from abacusutils_tpu_torch.convert import resolve_device  # noqa: E402
from abacusutils_tpu_torch.models.hod.prepare_sim import _rank_fields  # noqa: E402
from abacusutils_tpu_torch.models.hod.ranks_device import rank_fields_device  # noqa: E402

MPART, HUBBLE = 2.1e9, 0.6736


def synth_slab(n_target, seed=17):
    """Halos of power-law sizes (P(n) ~ n^-2 over [20, 4000] particles), each
    a Gaussian clump of particles, 70 % of them selected (at least two a
    halo): scripts/hod/bench_ranks.py:synth_slab, draw for draw."""
    rng = np.random.default_rng(seed)
    u = rng.random(int(n_target / 55) * 2)
    lo, hi = 20.0, 4000.0
    sizes = (lo ** -1 - u * (lo ** -1 - hi ** -1)) ** -1
    pn = sizes.astype(np.int64)
    pn = pn[np.cumsum(pn) <= n_target]
    ps = np.concatenate([[0], np.cumsum(pn)])[:-1]
    n = int(pn.sum())
    n_halo = len(pn)
    hpos = (rng.random((n_halo, 3)) * 500).astype(np.float32)
    hvel = rng.normal(0, 300, (n_halo, 3)).astype(np.float32)
    N = (pn * rng.uniform(5, 20, n_halo)).astype(np.int64)
    r25 = (rng.random(n_halo) * 0.2 + 0.05).astype(np.float32)
    r98 = (r25 * rng.uniform(1.5, 5.5, n_halo)).astype(np.float32)
    ppos = np.empty((n, 3), np.float32)
    pvel = np.empty((n, 3), np.float32)
    submask = np.zeros(n, bool)
    for j in range(n_halo):
        sl = slice(ps[j], ps[j] + pn[j])
        ppos[sl] = hpos[j] + rng.normal(0, 0.4, (pn[j], 3)).astype(np.float32)
        pvel[sl] = hvel[j] + rng.normal(0, 120, (pn[j], 3)).astype(np.float32)
        m = rng.random(pn[j]) < 0.7
        if m.sum() < 2:
            m[:2] = True
        submask[sl] = m
    return ps, pn, n, hpos, hvel, N, r25, r98, ppos, pvel, submask


def rank_args(slab):
    """rank_fields_device's arguments for a :func:`synth_slab`, every halo
    ranked: the per-particle halo columns of prepare_slab's loop."""
    ps, pn, n, hpos, hvel, N, r25, r98, ppos, pvel, submask = slab
    owner = np.repeat(np.arange(len(pn)), pn)
    nsub = np.bincount(owner, weights=submask, minlength=len(pn))
    return (ppos, pvel, submask, owner.astype(np.int32), nsub[owner], ps, pn, hpos[owner],
            hvel[owner], (N * MPART)[owner].astype(np.float64), r25[owner], r98[owner], HUBBLE)


def host_rank_loop(slab):
    """The 'host' engine: prepare_sim._rank_fields halo by halo. Returns the
    five rank fields (-1 for unselected particles)."""
    ps, pn, n, hpos, hvel, N, r25, r98, ppos, pvel, submask = slab
    out = [np.full(n, -1.0) for _ in range(5)]
    with np.errstate(invalid='ignore', divide='ignore'):
        for j in range(len(ps)):
            sl = slice(ps[j], ps[j] + pn[j])
            m = submask[sl]
            _rank_fields(np.arange(ps[j], ps[j] + pn[j])[m], ppos[sl][m], pvel[sl][m], ppos[sl],
                         hpos[j], hvel[j], N[j] * MPART, r25[j], r98[j], HUBBLE, *out)
    return out


def _flips(dev, hostr, ps, pn, ppos, submask, mism):
    """(key_flips, nn_flips) as the JAX script counts them: a halo whose
    selected ranks of a host-key field are not a permutation of the host
    loop's is one key flip; an NN rank that differs where its distance is
    not tied is one NN flip (a tied group must still be a permutation)."""
    key_flips = 0
    for f in range(4):
        if not mism[f]:
            continue
        for j in range(len(ps)):
            sl = slice(ps[j], ps[j] + pn[j])
            m = submask[sl]
            if not np.array_equal(np.sort(dev[f][sl][m]), np.sort(hostr[f][sl][m])):
                key_flips += 1
    flips_c = 0
    if mism[4]:
        from scipy.spatial import cKDTree

        for j in range(len(ps)):
            sl = slice(ps[j], ps[j] + pn[j])
            m = submask[sl]
            if (np.abs(dev[4][sl][m] - hostr[4][sl][m]) <= 1e-12).all():
                continue
            nn = cKDTree(ppos[sl]).query(ppos[sl][m], k=2)[0][:, 1]
            _, inv, cnt = np.unique(nn, return_inverse=True, return_counts=True)
            untied = cnt[inv] == 1
            flips_c += int((np.abs(dev[4][sl][m][untied] - hostr[4][sl][m][untied])
                            > 1e-12).sum())
            flips_c += 0 if np.array_equal(np.sort(dev[4][sl][m]), np.sort(hostr[4][sl][m])) \
                else int((~untied).sum())
    return key_flips, flips_c


def run(n_target=1_200_000, host=True, verbose=True, device=None):
    """Time rank_fields_device (on `device`, None: the card) cold and warm on
    the slab of `n_target` particles and, with `host`, the host loop, and
    count the flips between them. Returns the JSON line's dict."""
    device = resolve_device(device)
    slab = synth_slab(n_target)
    ps, pn, n, _, _, _, _, _, ppos, _, submask = slab
    n_halo = len(ps)
    if verbose:
        print(f'slab: {n} particles in {n_halo} halos (max {pn.max()}, device {device})',
              flush=True)
    args = rank_args(slab)
    seg = args[3]

    out = {'n_part': n, 'n_halo': n_halo, 'backend': device.type}
    t0 = time.perf_counter()
    dev = rank_fields_device(*args, device=device)
    out['device_cold_s'] = round(time.perf_counter() - t0, 3)
    t0 = time.perf_counter()
    dev = rank_fields_device(*args, device=device)
    out['device_warm_s'] = round(time.perf_counter() - t0, 3)
    if verbose:
        print(f'device: cold {out["device_cold_s"]} s, warm {out["device_warm_s"]} s', flush=True)

    if host:
        t0 = time.perf_counter()
        hostr = host_rank_loop(slab)
        out['host_loop_s'] = round(time.perf_counter() - t0, 3)
        out['speedup_warm'] = round(out['host_loop_s'] / max(out['device_warm_s'], 1e-3), 2)
        sel = submask & (seg >= 0)
        mism = [int((np.abs(d[sel] - hh[sel]) > 1e-12).sum()) for d, hh in zip(dev, hostr)]
        out['mismatch_frac'] = round(max(mism[:4]) / int(sel.sum()), 6)
        out['key_flips'], out['nn_flips'] = _flips(dev, hostr, ps, pn, ppos, submask, mism)
        if verbose:
            print(f'host loop: {out["host_loop_s"]} s; per-field mismatches {mism}; real NN '
                  f'flips {out["nn_flips"]}', flush=True)
    print(json.dumps(out), flush=True)
    return out


if __name__ == '__main__':
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument('--n', type=int, default=1_200_000)
    ap.add_argument('--no-host', action='store_true')
    ap.add_argument('--device', help='torch device (default: the card)')
    args = ap.parse_args()
    run(args.n, host=not args.no_host, device=args.device)
