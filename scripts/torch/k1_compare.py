#!/usr/bin/env python3
"""Time the port's TSC/CIC deposit K1 against an earlier tree's K1 on one GPU.

    python3 scripts/torch/k1_compare.py --old DIR [--out build/k1_compare.json]

DIR is an unpacked earlier commit of this repository whose
``abacusutils_tpu_torch`` has the (x-cell, y-block) K1 (its ``ops/grid.py``
has ``stage_grouped2d`` and ``default_yblock``); it is loaded under another
package name and builds its own kernels into DIR/build.

Both K1s deposit the same points at the four shapes the main paths run:

1. the bench step (``hod_pk_fused_yb``, phase 4 of chip_smoke.py): 10^7 halos
   + 5x10^7 particles, 256^3, two launches into one grid;
2. the fused box call (``run_hod_pk_fused``, phase 5): LRG + ELG + QSO, six
   launches into three 256^3 grids;
3. ``compute_power`` at 550^3 (phase 7 b): the kept galaxies of 2, one
   launch a tracer, TSC;
4. the same galaxies at 256^3, CIC (phase 7 d).

It then times ``AbacusHOD.compute_power`` of both trees host to host (best
of 3 calls, in the order old, new, new, old) on the run_hod catalog of
chip_smoke.py's phase 7, at its settings (b), (c) and (d).

Each design stages the points its own way (the old: by (x-cell, y-block of
default_yblock), the new: by 16^3 bricks, the box routes before RSD with a z
margin) and is timed by CUDA events over 5 calls after a warm-up, in the
order old, new, new, old; the grids are checked against each other. Shape
1 is also run with the particles in host-halo order (satellites of a halo
adjacent, as in AbacusSummit subsamples), and the new K1 with 16 x 16 x 32
bricks beside its default 16^3. The SASS opcodes of K1's atomics are
printed (cuobjdump -sass). Prints one line per measurement and writes them
all to --out as JSON.
"""

import argparse
import importlib.util
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from abacusutils_tpu_torch import _build  # noqa: E402
from abacusutils_tpu_torch.convert import params_to_tensors  # noqa: E402
from abacusutils_tpu_torch.models import pipeline as pipe  # noqa: E402
from abacusutils_tpu_torch.models.hod.population import prepare_tracer_params  # noqa: E402
from abacusutils_tpu_torch.ops import grid  # noqa: E402

import chip_smoke as cs  # noqa: E402

N_HALO, N_PART, LBOX, NMESH, SEED = cs.N_HALO, cs.N_PART, cs.LBOX, cs.NMESH, cs.SEED
DOCS_NMESH = cs.DOCS_NMESH
HBM = cs.HBM_BYTES_PER_S
WANT, TRACERS = cs.WANT, cs.TRACERS
RESULTS = []


def load_old(root):
    """The earlier tree's port package, imported as `old_port`."""
    init = Path(root) / 'abacusutils_tpu_torch' / '__init__.py'
    spec = importlib.util.spec_from_file_location(
        'old_port', init, submodule_search_locations=[str(init.parent)]
    )
    mod = importlib.util.module_from_spec(spec)
    sys.modules['old_port'] = mod
    spec.loader.exec_module(mod)
    importlib.import_module('old_port.ops.grid')
    return sys.modules['old_port.ops.grid']


def event_ms(fn, reps=5):
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(launches, ngrids, nmesh):
    """Bytes the deposit must move (w of every point and x, y, z of the kept
    ones read once, each grid written once) at 3.35 TB/s."""
    return (sum(4 * n + 12 * k for n, k in launches) + 4 * ngrids * nmesh**3) / HBM * 1e3


def record(shape, design, ms, bound, **extra):
    rec = dict(shape=shape, design=design, ms=ms, bound_ms=bound, bound_share=bound / ms, **extra)
    RESULTS.append(rec)
    more = ''.join(f', {k} {v}' for k, v in extra.items())
    print(f'{shape} | {design}: {ms:.4f} ms, bound {bound:.4f} ms, share {bound / ms:.3f}{more}',
          flush=True)


class Old:
    """The earlier K1 over its (x-cell, y-block) stage of the same points."""

    def __init__(self, og):
        self.og = og

    def stage(self, cols, nmesh, kind, shift=0.0):
        yb = self.og.default_yblock(nmesh)
        staged, starts, order = self.og.stage_grouped2d(
            cols, nmesh, LBOX, yb, shift=shift, return_order=True, kind=kind
        )
        return order, (starts, yb)

    def deposit(self, g, x, y, z, w, st, nmesh, kind, err):
        starts, yb = st
        self.og.tsc_deposit_cells(g, x, y, z, w, starts, nmesh, yb, LBOX, 0.0, err=err, kind=kind)


class New:
    """The brick K1 over its stage of the same points (`brick`: None for the
    port's default)."""

    def __init__(self, brick=None, margin=(0, 0, 0)):
        self.brick, self.margin = brick, margin

    def stage(self, cols, nmesh, kind, shift=0.0):
        brick = self.brick or grid.brick_shape(nmesh, margin=self.margin)
        _, plan, order = grid.stage_bricks(cols, nmesh, LBOX, brick, self.margin, shift=shift,
                                           kind=kind, return_order=True)
        return order, plan

    def deposit(self, g, x, y, z, w, plan, nmesh, kind, overflow):
        grid.tsc_deposit_cells(g, x, y, z, w, plan, LBOX, 0.0, overflow, kind)


def run_shape(shape, designs, deps, ngrids, nmesh, kind, shift):
    """Stage each deposit's key columns (its positions before RSD) by each
    design, deposit its (x, y, z, w) into grid `gi` in that order, time the
    designs (first to last, then back) and check each design's grids
    against the first design's. `deps` is [(key columns, gi, x, y, z, w)]."""
    dev = deps[0][2].device
    launches = [(int(w.numel()), int((w != 0).sum())) for *_, w in deps]
    bound = bound_ms(launches, ngrids, nmesh)
    runs = []
    for name, d in designs:
        staged = []
        for key, gi, x, y, z, w in deps:
            order, st = d.stage(key, nmesh, kind, shift)
            staged.append((gi, *(c.index_select(0, order) for c in (x, y, z, w)), st))
        grids = [torch.zeros((nmesh,) * 3, device=dev) for _ in range(ngrids)]
        word = torch.zeros(1, dtype=torch.int32, device=dev)

        def k1(d=d, staged=staged, grids=grids, word=word):
            for g in grids:
                g.zero_()
            for gi, x, y, z, w, st in staged:
                d.deposit(grids[gi], x, y, z, w, st, nmesh, kind, word)

        runs.append((name, d, k1, grids, word, staged))
    times = {i: [] for i in range(len(runs))}
    for i in list(range(len(runs))) + list(reversed(range(len(runs)))):
        times[i].append(event_ms(runs[i][2]))
    ref = runs[0][3]
    for i, (name, d, k1, grids, word, staged) in enumerate(runs):
        word.zero_()
        k1()
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max()) for a, b in zip(grids, ref))
        gmax = max(float(b.abs().max()) for b in ref)
        extra = dict(times=[round(t, 4) for t in times[i]], max_abs_diff=err,
                     rel_diff=err / gmax)
        if isinstance(d, New):
            plan = staged[0][-1]
            extra.update(overflow_share=int(word) / max(sum(k for _, k in launches), 1),
                         blocks_per_sm=grid.blocks_per_sm(plan, kind), brick=plan.brick,
                         margin=plan.margin, items=int(plan.work.shape[0]))
        record(shape, name, float(np.mean(times[i])), bound, **extra)
        if err > 1e-5 * gmax:
            raise SystemExit(f'{shape} {name}: grids differ by {err} (max {gmax})')


def bench_inputs(gen, dev, host_order=False):
    halo, part, params = pipe.make_example_inputs_device(N_HALO, N_PART, LBOX, gen, dev, link=True)
    if host_order:  # satellites of one halo adjacent, as in the AbacusSummit subsamples
        o = torch.argsort(part['hidx'], stable=True)
        part = {k: v.index_select(0, o) for k, v in part.items()}
    return halo, part, params


def shape_bench(designs, dev, host_order):
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    halo, part, params = bench_inputs(gen, dev, host_order)
    half = float(np.float32(LBOX) / 2)
    inv = float(np.float32(1.0) / np.float32(100.0))
    z_c, keep_c, z_s, keep_s = pipe.populate_weights(halo, part, params, True, inv)
    deps = [([cat['x'], cat['y'], cat['z']], 0, cat['x'] + half, cat['y'] + half, z + half, w)
            for cat, z, w in ((halo, z_c, keep_c), (part, z_s, keep_s))]
    tag = 'bench step, particles in host order' if host_order else 'bench step'
    run_shape(tag, designs, deps, 1, NMESH, 'tsc', half)


def fused_inputs(dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    halo, part, _ = pipe.make_example_inputs_device(N_HALO, N_PART, LBOX, gen, dev, link=True)
    for cat, n in ((halo, N_HALO), (part, N_PART)):
        cat['deltac'] = torch.rand(n, generator=gen, device=dev) - 0.5
        cat['fenv'] = torch.rand(n, generator=gen, device=dev) - 0.5
    part['hkeep_at'] = part.pop('hidx')
    tp = prepare_tracer_params(TRACERS, 0.5)
    params = {t: params_to_tensors(tp[t], dev) for t in WANT}
    inv = float(np.float32(1.0) / np.float32(100.0))
    tr, _ = pipe.populate_weights_multi(halo, part, params, WANT, True, inv)
    return halo, part, tr


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--old', required=True, help='unpacked earlier commit of this repository')
    ap.add_argument('--out', default=str(REPO / 'build' / 'k1_compare.json'))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('k1_compare: no CUDA device', file=sys.stderr)
        return 1
    dev = torch.device('cuda', 0)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True).stdout.strip()
    print('nvidia-smi:', smi)
    og = load_old(args.old)
    sys.modules['old_port._build'].build()
    path, _, _ = _build.build()
    sass_summary(path, Path(args.out).with_name('k1_sass.txt'))
    run(og, dev)
    torch.cuda.empty_cache()
    compare_compute_power(dev)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({'card': smi, 'results': RESULTS}, indent=1))
    return 0


def designs_for(og, margin):
    """The old K1, the new one as the port runs it (16^3 bricks) and with
    16 x 16 x 32 bricks."""
    return [
        ('old', Old(og)), ('new', New(margin=margin)),
        ('new, brick (16,16,32)', New((16, 16, 32), margin)),
    ]


def compare_compute_power(dev):
    """compute_power of the earlier tree against this one, host to host, at
    chip_smoke.py's phase-7 settings, on one run_hod catalog."""
    from abacusutils_tpu_torch.models.hod.abacus_hod import AbacusHOD

    old_hod_cls = importlib.import_module('old_port.models.hod.abacus_hod').AbacusHOD
    state = cs.fused_state(dev)
    params = {'z': 0.5, 'Lbox': LBOX, 'velz2kms': cs.VELZ2KMS, 'origin': None}
    hods = {'old': old_hod_cls(*state, params, TRACERS, dev),
            'new': AbacusHOD(*state, params, TRACERS, dev)}
    mock = hods['new'].run_hod(want_rsd=True)
    del state
    kmax = np.pi * NMESH / LBOX
    settings = {
        '(b) 550^3, poles': ((mock, cs.DOCS_NBINS_K, 1, cs.DOCS_KMAX, False),
                             dict(poles=cs.POLES, num_cells=DOCS_NMESH)),
        '(c) 256^3, compensated': ((mock, cs.NBINS_K, 1, kmax, False),
                                   dict(num_cells=NMESH, compensated=True)),
    }
    for paste in ('TSC', 'CIC'):
        settings[f'(d) {paste}, interlaced, 4 mu bins'] = (
            (mock, cs.NBINS_K, 4, kmax, False),
            dict(poles=cs.POLES, paste=paste, num_cells=NMESH, compensated=True,
                 interlaced=True))
    for tag, (args, kw) in settings.items():
        secs = {'old': [], 'new': []}
        for name in ('old', 'new', 'new', 'old'):
            hod = hods[name]
            hod.compute_power(*args, **kw)  # warm: plans and cuFFT plans
            best = min(cs.sync_seconds(lambda: hod.compute_power(*args, **kw))[1]
                       for _ in range(3))
            secs[name].append(best)
        for name, s in secs.items():
            rec = dict(shape=f'compute_power {tag}', design=name, seconds=min(s), runs=s)
            RESULTS.append(rec)
            print(f'compute_power {tag} | {name}: {min(s):.6f} s a call host to host '
                  f'(best of 3, two passes {[round(x, 6) for x in s]})', flush=True)


def run(og, dev):
    """The four shapes, old K1 (module `og`) against the new, on `dev`."""
    half = float(np.float32(LBOX) / 2)
    margin = (0, 0, pipe.RSD_MARGIN)
    box_designs = designs_for(og, margin)

    for host_order in (False, True):
        shape_bench(box_designs, dev, host_order)
        torch.cuda.empty_cache()

    halo, part, tr = fused_inputs(dev)
    deps = []
    for gi, t in enumerate(WANT):
        z_c, w_c, z_s, w_s = tr[t]
        for cat, z, w in ((halo, z_c, w_c), (part, z_s, w_s)):
            deps.append(([cat['x'], cat['y'], cat['z']], gi, cat['x'] + half, cat['y'] + half,
                         z + half, w))
    run_shape('fused box', box_designs, deps, len(WANT), NMESH, 'tsc', half)
    del deps

    # the kept galaxies of each tracer, box-centred, as compute_power paints them
    gals = []
    for t in WANT:
        z_c, w_c, z_s, w_s = tr[t]
        cols = []
        for a in ('x', 'y', None):
            hc = halo[a] if a else z_c
            pc = part[a] if a else z_s
            cols.append(torch.cat([hc[w_c != 0], pc[w_s != 0]]))
        gals.append(cols)
    del halo, part, tr
    torch.cuda.empty_cache()
    n_gal = sum(int(c[0].numel()) for c in gals)
    print(f'galaxies for the compute_power shapes: {n_gal}')
    plain = designs_for(og, (0, 0, 0))
    for nmesh, kind in ((DOCS_NMESH, 'tsc'), (NMESH, 'cic')):
        deps = [(c, i, *c, torch.ones_like(c[0])) for i, c in enumerate(gals)]
        run_shape(f'compute_power {nmesh}^3 {kind}', plain, deps, len(gals), nmesh, kind, 0.0)


def sass_summary(lib, listing):
    """Count the atomic opcodes of each K1 instantiation in the library's
    SASS (cuobjdump -sass); the whole listing goes to `listing`."""
    tool = shutil.which('cuobjdump') or '/usr/local/cuda/bin/cuobjdump'
    res = subprocess.run([tool, '-sass', str(lib)], capture_output=True, text=True)
    if res.returncode:
        print('cuobjdump failed:', res.stderr[-500:])
        return
    listing.parent.mkdir(parents=True, exist_ok=True)
    listing.write_text(res.stdout)
    func, counts = None, {}
    for line in res.stdout.splitlines():
        m = re.search(r'Function : (\S+)', line)
        if m:
            func = m.group(1) if 'tsc_deposit_bricks_kernel' in m.group(1) else None
            continue
        if func:
            m = re.search(r'\b((?:ATOMS|ATOMG|ATOM|RED|REDG)\.[A-Za-z0-9_.]+)', line)
            if m:
                counts.setdefault(func, {}).setdefault(m.group(1), 0)
                counts[func][m.group(1)] += 1
    for f, c in counts.items():
        print(f'SASS {f}: {c}')


if __name__ == '__main__':
    sys.exit(main())
