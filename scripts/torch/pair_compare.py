#!/usr/bin/env python3
"""Time the port's pair-count kernels (K4 and K5) against an earlier tree's on one GPU.

    python3 scripts/torch/pair_compare.py [--old DIR] [--sweep] [--dispatch]
                                          [--out build/pair_compare.json]

DIR is an unpacked earlier commit of this repository; its
``abacusutils_tpu_torch`` is loaded under another package name and builds
its own kernels into DIR/build. Without --old only this tree is measured.

The catalog is the ``run_hod`` mock of chip_smoke.py's phase 8 (LRG + ELG +
QSO with RSD in the (2000 Mpc/h)^3 box, made once with this tree), the bins
are that phase's (rp, s < 30 Mpc/h in 8 log bins, pimax 30, 20 mu bins).

1. K4, ``count_pairs_cells``, in both modes at the six tracer pairs, each
   tree on the stage its own dispatch builds, in the order old, new, new,
   old: the time by CUDA events (3 launches after a warm-up), the work
   items and, for this tree, the candidate pairs its walk evaluates. Each
   tree's counts are checked equal to the other's, bin for bin. A last
   line sums the six pairs a mode.
2. K5, ``count_pairs_all``, on 80,000 of the QSOs, both modes, the same
   order and check.
3. ptxas's registers and spills and the SASS FFMA/DFMA counts of both trees'
   pair-count kernels.
4. --sweep: this tree's K4 at every pair over cells of rmax and rmax / 2
   and items of 1, 2, 3 and 4 cells, to see what the dispatch's choice
   (cell_grid, SPAN) leaves on the table.
5. --dispatch: at 80,000 down to 1,000 QSOs, the cell engine cold (stage
   and K4, ``method='cell'``) against the all-pairs engine
   (``method='tile'``), one whole call each with its caches emptied: the
   median and the least of 20 calls, by the host's clock and by CUDA events
   around the call: what ``_CELL_MIN_N`` should be on this card.

Everything goes to --out as JSON.
"""

import argparse
import importlib
import importlib.util
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from abacusutils_tpu_torch import _build  # noqa: E402
from abacusutils_tpu_torch.models.hod.abacus_hod import AbacusHOD  # noqa: E402
from abacusutils_tpu_torch.ops import tpcf  # noqa: E402

import chip_smoke as cs  # noqa: E402

LBOX, RMAX = cs.LBOX, cs.PAIR_RMAX
RESULTS = {}


def load_old(root):
    """The earlier tree's ops.tpcf and _build, imported under `old_port`."""
    init = Path(root) / 'abacusutils_tpu_torch' / '__init__.py'
    spec = importlib.util.spec_from_file_location(
        'old_port', init, submodule_search_locations=[str(init.parent)]
    )
    mod = importlib.util.module_from_spec(spec)
    sys.modules['old_port'] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module('old_port.ops.tpcf'), importlib.import_module('old_port._build')


def make_mock(dev):
    """Phase 8's mock as wrapped float32 device columns, {tracer: [x, y, z]}."""
    state = cs.fused_state(dev)
    params = {'z': 0.5, 'Lbox': LBOX, 'velz2kms': cs.VELZ2KMS, 'origin': None}
    hod = AbacusHOD(*state, params, cs.TRACERS, dev)
    mock = hod.run_hod(want_rsd=True)
    del hod, state
    torch.cuda.empty_cache()
    lb = float(np.float32(LBOX))
    return {tr: [torch.remainder(torch.from_numpy(np.asarray(d[a], np.float32)).to(dev), lb)
                 for a in 'xyz'] for tr, d in mock.items()}


class Tree:
    """One tree's pair counting on the mock: its stages (cached by grid) and
    a closure that launches K4 on a pair."""

    def __init__(self, name, mod, cols):
        self.name, self.mod, self.cols, self.stages = name, mod, cols, {}
        self.fine = hasattr(mod, 'cell_grid')

    def grid(self, a, b):
        """(cells a side, refinement) of the pair's grid (None: an earlier
        tree, which has one grid and no item spans)."""
        n = min(self.cols[a][0].numel(), self.cols[b][0].numel())
        if self.fine:
            return self.mod.cell_grid(LBOX, RMAX, n)
        return min(int(LBOX // RMAX), self.mod._NC_MAX), None

    def span(self, tr, nc, refine):
        if refine is None:
            return None
        return self.mod.default_span(nc, refine, self.cols[tr][0].numel())

    def stage(self, tr, nc, span):
        key = (tr, nc, span)
        if key not in self.stages:
            extra = () if span is None else (span,)
            self.stages[key] = self.mod.stage_cells(*self.cols[tr], LBOX, nc, *extra)
        return self.stages[key]

    def k4(self, a, b, mode, nb2, aux, grid=None):
        """grid: (cells a side, item span) to force; default the dispatch's."""
        if grid is None:
            nc, refine = self.grid(a, b)
            spans = self.span(a, nc, refine), self.span(b, nc, refine)
        else:
            nc, spans = grid[0], (grid[1], grid[1])
        s1 = self.stage(a, nc, spans[0])
        s2 = None if a == b else self.stage(b, nc, spans[1])
        thr = self.mod.edges_f32(cs.PAIR_BINS**2)
        return (lambda: self.mod.count_pairs_cells(s1, s2, thr, nb2, mode, aux)), s1, s2, thr


def pairs_of(tracers):
    return [(a, b) for i, a in enumerate(tracers) for b in tracers[i:]]


def compare_k4(trees, tracers):
    order = [trees[0], *trees[1:], *trees[1:], trees[0]] if len(trees) > 1 else trees * 2
    out = []
    for mode, nb2, aux in cs.pair_modes():
        sums = {}
        for a, b in pairs_of(tracers):
            times, counts = {}, {}
            for tree in order:
                fn, s1, s2, thr = tree.k4(a, b, mode, nb2, aux)
                times.setdefault(tree.name, []).append(cs.event_ms(fn, reps=3))
                counts[tree.name] = fn()
            ref = counts[order[0].name]
            same = all(bool(torch.equal(c, ref)) for c in counts.values())
            new = trees[-1]
            _, s1, s2, thr = new.k4(a, b, mode, nb2, aux)
            cand = new.mod.candidate_pairs(s1, s2, thr, nb2, mode) if new.fine else None
            rec = dict(mode=mode, pair=f'{a}_{b}', ms=times, counts_equal=same,
                       in_range=int(ref.sum()), items=int(s1.work.shape[0]), nc=s1.nc,
                       candidates=cand)
            out.append(rec)
            print(f'K4 {mode} {a}_{b}: ' + ', '.join(
                f'{k} {" / ".join(f"{t:.4f}" for t in v)} ms' for k, v in times.items())
                + f'; counts equal {same}; this tree: {s1.nc}^3 cells, {rec["items"]} items, '
                f'candidates {cand}, in range {rec["in_range"]}')
            cs.require(same, f'K4 {mode} {a}_{b}: the trees\' counts differ')
            for k, v in times.items():
                sums[k] = sums.get(k, 0.0) + min(v)
        print(f'K4 {mode}, six pairs, best of each: ' + ', '.join(
            f'{k} {v:.4f} ms' for k, v in sums.items()))
        out.append(dict(mode=mode, pair='sum of six', ms=sums))
    RESULTS['k4'] = out


def compare_k5(mods, cols):
    out = []
    order = [mods[0], *mods[1:], *mods[1:], mods[0]] if len(mods) > 1 else mods * 2
    for mode, nb2, aux in cs.pair_modes():
        times, counts = {}, {}
        for name, mod in order:
            thr = mod.edges_f32(cs.PAIR_BINS**2)
            fn = lambda: mod.count_pairs_all(cols, None, thr, nb2, mode, LBOX, aux)  # noqa: E731
            times.setdefault(name, []).append(cs.event_ms(fn, reps=3))
            counts[name] = fn()
        ref = counts[order[0][0]]
        same = all(bool(torch.equal(c, ref)) for c in counts.values())
        n = cols[0].numel()
        print(f'K5 {mode} {n} x {n}: ' + ', '.join(
            f'{k} {" / ".join(f"{t:.4f}" for t in v)} ms' for k, v in times.items())
            + f'; counts equal {same}; in range {int(ref.sum())}')
        cs.require(same, f'K5 {mode}: the trees\' counts differ')
        out.append(dict(mode=mode, n=n, ms=times, counts_equal=same, in_range=int(ref.sum())))
    RESULTS['k5'] = out


def kernel_facts(name, build_mod):
    path, secs, log = build_mod.build()
    regs = cs.ptxas_pairs(log) if name == 'new' else old_ptxas(log)
    fma = cs.sass_fma(path) if name == 'new' else old_sass(path)
    print(f'{name}: built in {secs:.2f} s; (registers, spill stores, spill loads) {regs}; '
          f'FFMA + DFMA {fma}')
    RESULTS[f'{name} kernels'] = dict(build_s=secs, ptxas={k: list(v) for k, v in regs.items()},
                                      fma=fma)


def _old_name(mangled):
    m = re.search(r'pair_count_cells_kernelILi(\d)ELb(\d)EE', mangled)
    if m:
        return f'K4[{tpcf.MODES[int(m.group(1))]}, {"wrap" if m.group(2) == "1" else "round"}]'
    m = re.search(r'pair_count_all_kernelI([fd])Li(\d)EE', mangled)
    if m:
        return f'K5[{tpcf.MODES[int(m.group(2))]}, {"f32" if m.group(1) == "f" else "f64"}]'
    return None


def old_ptxas(log):
    keep, cs.pair_kernel_name = cs.pair_kernel_name, _old_name
    try:
        return cs.ptxas_pairs(log)
    finally:
        cs.pair_kernel_name = keep


def old_sass(path):
    keep, cs.pair_kernel_name = cs.pair_kernel_name, _old_name
    try:
        return cs.sass_fma(path)
    finally:
        cs.pair_kernel_name = keep


def sweep(tree, tracers):
    """This tree's K4 over refinements and item spans, every pair, both modes."""
    out = []
    for mode, nb2, aux in cs.pair_modes():
        for a, b in pairs_of(tracers):
            line = []
            for refine in (1, 2):
                nc = int(LBOX * refine // RMAX)
                for span in (1, 2, 3, 4):
                    fn, s1, s2, thr = tree.k4(a, b, mode, nb2, aux, grid=(nc, span))
                    ms = cs.event_ms(fn, reps=2)
                    out.append(dict(mode=mode, pair=f'{a}_{b}', nc=nc, span=span, ms=ms,
                                    items=int(s1.work.shape[0])))
                    line.append(f'{nc}/{span}: {ms:.3f}')
                tree.stages = {k: v for k, v in tree.stages.items() if k[1] != nc}
                torch.cuda.empty_cache()
            print(f'sweep K4 {mode} {a}_{b} (cells a side / span: ms): ' + ', '.join(line))
    RESULTS['sweep'] = out


def dispatch(cols_all, reps=20):
    """Cold cell engine (stage + K4) against the all-pairs engine: a whole
    call, by the host's clock and by CUDA events, median and least of `reps`."""
    out = []
    rng = np.random.default_rng(cs.SEED)
    calls = {
        'rppi': lambda cols, m: tpcf.pair_counts_rppi(cols, cs.PAIR_BINS, cs.PIMAX, LBOX, method=m),
        'smu': lambda cols, m: tpcf.pair_counts_smu(cols, cs.PAIR_BINS, cs.NMU, LBOX, method=m),
    }
    for n in (80_000, 40_000, 30_000, 25_000, 20_000, 15_000, 10_000, 5_000, 1_000):
        pick = torch.from_numpy(np.sort(rng.choice(cols_all[0].numel(), n, replace=False)))
        cols = tuple(c[pick.to(c.device)].contiguous() for c in cols_all)
        rec = dict(n=n)
        for method in ('cell', 'tile', 'cell', 'tile'):
            for mode, fn in calls.items():
                host, dev = rec.setdefault(f'{method} {mode}', ([], []))
                for k in range(reps // 2 + 1):
                    tpcf._stage_cache.clear()
                    tpcf._span_cache.clear()
                    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    start.record()
                    fn(cols, method)
                    stop.record()
                    torch.cuda.synchronize()
                    if k:  # the first call of a round warms up
                        host.append((time.perf_counter() - t0) * 1e3)
                        dev.append(start.elapsed_time(stop))
        line = []
        for key in list(rec):
            if key == 'n':
                continue
            host, dev = rec[key]
            rec[key] = dict(host_median=float(np.median(host)), host_min=min(host),
                            events_median=float(np.median(dev)), events_min=min(dev))
            line.append(f'{key} {rec[key]["host_median"]:.3f} / {rec[key]["host_min"]:.3f} host, '
                        f'{rec[key]["events_median"]:.3f} / {rec[key]["events_min"]:.3f} events')
        print(f'dispatch {n} points, ms a cold call, median / least of {2 * (reps // 2)}: '
              + '; '.join(line))
        out.append(rec)
    RESULTS['dispatch'] = out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--old', help='an unpacked earlier commit of this repository')
    ap.add_argument('--sweep', action='store_true')
    ap.add_argument('--dispatch', action='store_true')
    ap.add_argument('--out', default=str(REPO / 'build' / 'pair_compare.json'))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('pair_compare: no CUDA device', file=sys.stderr)
        return 1
    dev = torch.device('cuda', 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print('nvidia-smi:', smi)
    RESULTS['card'] = smi
    kernel_facts('new', _build)
    mods = [('new', tpcf)]
    if args.old:
        old_tpcf, old_build = load_old(args.old)
        kernel_facts('old', old_build)
        old_build.lib()
        mods.insert(0, ('old', old_tpcf))
    _build.lib()
    cols = make_mock(dev)
    tracers = list(cols)
    print('mock', {tr: c[0].numel() for tr, c in cols.items()})
    trees = [Tree(name, mod, cols) for name, mod in mods]
    compare_k4(trees, tracers)
    rng = np.random.default_rng(cs.SEED)
    last = tracers[-1]
    pick = torch.from_numpy(np.sort(rng.choice(cols[last][0].numel(), cs.N_SPARSE, replace=False)))
    sparse = [c[pick.to(dev)].contiguous() for c in cols[last]]
    compare_k5(mods, sparse)
    if args.sweep:
        sweep(trees[-1], tracers)
    if args.dispatch:
        dispatch(cols[last])
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(RESULTS, indent=1))
    print(f'pair_compare: wrote {out}')
    return 0


if __name__ == '__main__':
    sys.exit(main())
