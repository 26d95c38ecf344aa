#!/usr/bin/env python3
"""Time K6 (the NN distance of prepare_sim's ranks) and K8 (the ZCV window's mode sums) against an earlier tree's on one GPU.

    python3 scripts/torch/k6_k8_compare.py [--old DIR] [--out build/k6_k8_compare.json]

DIR is an unpacked earlier commit of this repository whose port has K6 as
``nn_within_halo(x, y, z, query, work, pstart, pnum, seg)`` and K8 as
``window_mode_sums(kv, kzv, edges, nkout)`` (the full-mesh K8 of the
parent tree); it is loaded under another
package name and builds its own kernels into DIR/build. Without --old only
this tree is measured.

1. K6 on chip_smoke.py's ranks slabs (scripts/hod/bench_ranks.py's, 1.2e6
   particles, and ten times it): each tree timed by CUDA events (3 launches
   after a warm-up) in the order old, new, new, old, and again on the work
   items of halos of at most 64 particles alone and on the rest alone (20
   launches); the
   keys of both trees bit-equal to each other and to the plain version
   (``nn_within_halo_plain``). At the first size the filtered plain mirror
   (``nn_within_halo_filtered_plain``, the filter unfused in float32, its
   threshold up to an ulp higher) estimates the pairs that reach the
   float64 chain; the second size uses
   that share of its pairs. Each line carries both bounds (every pair at 8
   float64 operations; the filter's 9 float32 operations a pair plus 8
   float64 a chain).
2. K8 at nmesh 256 and 512 (chip_smoke.py phase 12's edges, nmesh / 2 bins
   to k_Nyq) in the order old, new, new, old three times over (200 launches
   after a warm-up each), with the mean and spread of the six; this tree's
   plan build timed alone, and this tree's plan build and K8 together
   against the parent's K8, host to host (10 calls each, in turns); both
   trees' counts equal to the plain version's, the other rows within 1e-6
   of the bin's count, two launches bit-equal. Each line carries the
   full-mesh bound and the bound of the plan's in-bin modes.

Prints one line per measurement and writes them all to --out as JSON, with
the card's name and power limit.
"""

import argparse
import importlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from abacusutils_tpu_torch.models.hod import ranks_device  # noqa: E402
from abacusutils_tpu_torch.models.zcv import zenbu_window as tzw  # noqa: E402

import chip_smoke as cs  # noqa: E402

RESULTS = []


def load_old(root):
    """The earlier tree's models.hod.ranks_device and models.zcv.zenbu_window,
    imported under `old_port`."""
    init = Path(root) / 'abacusutils_tpu_torch' / '__init__.py'
    spec = importlib.util.spec_from_file_location(
        'old_port', init, submodule_search_locations=[str(init.parent)]
    )
    mod = importlib.util.module_from_spec(spec)
    sys.modules['old_port'] = mod
    spec.loader.exec_module(mod)
    return (importlib.import_module('old_port.models.hod.ranks_device'),
            importlib.import_module('old_port.models.zcv.zenbu_window'))


def record(shape, design, ms, **extra):
    RESULTS.append(dict(shape=shape, design=design, ms=ms, **extra))
    more = ''.join(f', {k} {v}' for k, v in extra.items())
    print(f'{shape} | {design}: {ms:.4f} ms{more}', flush=True)


def in_turns(runs, reps, cycles=1, clock=None):
    """Time each (name, fn) of `runs`, first to last and back, `cycles`
    times: by CUDA events over `reps` calls, or with `clock`, a function
    of fn giving ms. Returns {name: [ms, ...]}."""
    clock = clock or (lambda fn: cs.event_ms(fn, reps))
    times = {name: [] for name, _ in runs}
    order = list(range(len(runs)))
    for _ in range(cycles):
        for i in order + order[::-1]:
            name, fn = runs[i]
            times[name].append(clock(fn))
    return times


def host_ms(fn):
    """One call of fn host to host, in ms."""
    return cs.sync_seconds(fn)[1] * 1e3


def compare_k6(ord_, dev):
    share = None
    for n_target in cs.N_RANKS:
        slab = cs.synth_slab(n_target)
        args = cs.rank_args(slab)
        inp = cs.k6_inputs(args, dev)
        x, y, z, query, work, ps_d, pn_d, seg_d = inp
        q = query.long()
        shape = f'K6, {slab[2]} particles, {len(slab[0])} halos'
        ref, plain_s = cs.sync_seconds(lambda: cs.k6_plain(inp))
        if share is None:
            (mirror, chains), mirror_s = cs.sync_seconds(
                lambda: ranks_device.nn_within_halo_filtered_plain(x, y, z, query, ps_d, pn_d,
                                                                   seg_d))
            if not torch.equal(mirror[q], ref[q]):
                raise SystemExit(f'{shape}: the filtered mirror differs from the plain version')
            bounds = cs.k6_bounds(args, chains=chains)
            share, first = bounds['chain_share'], f'the slab of {slab[2]} particles'
            record(f'{shape}, filtered plain mirror', 'new', mirror_s * 1e3,
                   float64_chains=chains, chain_share=share)
        else:
            bounds = cs.k6_bounds(args, chain_share=share, counted_on=first)
        size = pn_d.long()[work[:, 0].long()]
        small = size <= 64
        subsets = {'all items': work, 'items of halos <= 64': work[small].contiguous(),
                   'items of halos > 64': work[~small].contiguous()}
        for part, w in subsets.items():
            runs = [('new', lambda w=w: ranks_device.nn_within_halo(x, y, z, query, w, ps_d, pn_d,
                                                                    seg_d))]
            if ord_ is not None:
                runs.insert(0, ('old', lambda w=w: ord_.nn_within_halo(x, y, z, query, w, ps_d,
                                                                       pn_d, seg_d)))
            times = in_turns(runs, 3 if part == 'all items' else 20)
            outs = {name: fn() for name, fn in runs}
            torch.cuda.synchronize()
            wl = w.long()
            extra = dict(items=int(w.shape[0]), queries=int((wl[:, 2] - wl[:, 1]).sum()))
            for name, _ in runs:
                ms = float(np.mean(times[name]))
                more = dict(runs=[round(t, 4) for t in times[name]], **extra)
                if part == 'all items':
                    if not torch.equal(outs[name][q], ref[q]):
                        raise SystemExit(f'{shape}: the {name} tree differs from the plain '
                                         'version')
                    more.update(bit_equal_to_plain=True, plain_ms=plain_s * 1e3,
                                share=bounds['bound_ms'] / ms,
                                **{k: bounds[k] for k in ('pairs', 'f64_ms', 'filtered_ms',
                                                          'chain_share', 'share_from')})
                record(f'{shape}, {part}', name, ms, **more)
        del inp, x, y, z, ref, outs
        torch.cuda.empty_cache()


def compare_k8(ozw, dev):
    for nm in cs.K8_NMESH:
        kout = np.linspace(0.0, np.pi * nm / cs.LBOX, nm // 2 + 1)
        nk = nm // 2
        kv, kz = (torch.from_numpy(a).to(dev) for a in tzw._mode_kgrids(nm, cs.LBOX))
        edges = torch.from_numpy(tzw._f32_ge_edges(kout)).to(dev)
        shape = f'K8, nmesh {nm}, {nk} bins'
        builds = []
        for _ in range(3):
            plan, s = cs.sync_seconds(lambda: tzw.window_plan(kv, kz, edges, nk))
            builds.append(s * 1e3)
        record(f'{shape}, the plan build', 'new', float(np.median(builds)),
               runs=[round(t, 4) for t in builds], rows=int(plan.kxy2.numel()),
               distinct=int(plan.kxy2.numel() + plan.cut_mult.numel()), modes=plan.modes,
               blocks=cs.k8_blocks(plan))
        runs = [('new', lambda: tzw.window_mode_sums(plan))]
        whole = [('new', lambda: tzw.window_mode_sums(tzw.window_plan(kv, kz, edges, nk)))]
        if ozw is not None:
            runs.insert(0, ('old', lambda: ozw.window_mode_sums(kv, kz, edges, nk)))
            whole.insert(0, runs[0])
        times = in_turns(runs, 200, cycles=3)
        host = in_turns(whole, 1, cycles=5, clock=host_ms)
        ref, plain_s = cs.sync_seconds(lambda: tzw.window_mode_sums_plain(kv, kz, edges, nk))
        bounds = cs.k8_bounds(nm, plan)
        for name, fn in runs:
            a, b = fn(), fn()
            counts_equal = bool(torch.equal(a[0], ref[0]))
            rel = float(((a - ref).abs() / ref[0].clamp_min(1.0)).max())
            same = bool(torch.equal(a, b))
            if not (counts_equal and rel <= 1e-6 and same):
                raise SystemExit(f'{shape}: {name} counts equal {counts_equal}, rel {rel}, '
                                 f'two launches equal {same}')
            ms = float(np.mean(times[name]))
            record(shape, name, ms, runs=[round(t, 4) for t in times[name]],
                   spread=[round(min(times[name]), 4), round(max(times[name]), 4)],
                   max_rel=rel, plain_ms=plain_s * 1e3, full_bound_ms=bounds['full_ms'],
                   plan_bound_ms=bounds['plan_ms'], share=bounds['plan_ms'] / ms)
        for name, t in host.items():
            what = 'the plan build and K8' if name == 'new' else 'K8'
            record(f'{shape}, {what} host to host', name, float(np.median(t)),
                   runs=[round(x, 4) for x in t])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--old', help='unpacked earlier commit of this repository')
    ap.add_argument('--out', default=str(REPO / 'build' / 'k6_k8_compare.json'))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('k6_k8_compare: no CUDA device', file=sys.stderr)
        return 1
    dev = torch.device('cuda', 0)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True).stdout.strip()
    print('nvidia-smi:', smi)
    t0 = time.perf_counter()
    ord_ = ozw = None
    if args.old:
        ord_, ozw = load_old(args.old)
        sys.modules['old_port._build'].build()
    from abacusutils_tpu_torch import _build
    _build.lib()
    print(f'builds in {time.perf_counter() - t0:.1f} s', flush=True)
    compare_k6(ord_, dev)
    torch.cuda.empty_cache()
    compare_k8(ozw, dev)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({'card': smi, 'results': RESULTS}, indent=1))
    return 0


if __name__ == '__main__':
    sys.exit(main())
