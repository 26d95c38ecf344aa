#!/usr/bin/env python3
"""Time K1's multi-weight form and K7 (Menv) against an earlier tree's on one GPU.

    python3 scripts/torch/k1m_k7_compare.py [--old DIR] [--variants]
                                            [--out build/k1m_k7_compare.json]

DIR is an unpacked earlier commit of this repository whose port has the
brick form of the multi-weight deposit (``stage_bricks`` on
``multi_brick_shape`` bricks, ``tsc_deposit_cells_multi(grids, x, y, z, ws,
plan, box, offset, overflow)``) and K7 over one-cell items (``stage_menv``
returning a tuple, ``menv_annulus(cols, starts, ukeys, nbrs, ncs, periodic,
lbox, rout2, mcut, work)``); it is loaded under another package name and
builds its own kernels into DIR/build. Without --old only this tree is
measured.

1. K1's multi-weight form, a unit column and four weight columns, on
   chip_smoke.py's phase-12 input (the 512^3 lattice moved by up to half a
   cell), on the lattice moved by up to 1 and 2 cells (cells of 0 to many
   points), and on phase 13's advected lattice in redshift space: each tree
   on its own stage, timed by CUDA events (5 launches after a warm-up) in
   the order old, new, new, old; the grids checked equal within 1e-5 of
   max|grid|; each tree's stage of the same points (the brick stage, the
   cell stage) timed the same way. This tree's gather also at one column,
   beside one single-column K1 launch on its brick stage.
2. K7 on phase 10's 2e6 clumped halos, box and light cone, the same order
   (3 launches after a warm-up); the sums checked equal at rtol 1e-12 with
   the same zeros. This tree also with items of 32, 64 and 128 centres (a
   warp to four warps a block), with the items and lane occupancy of each.

3. --variants: the gather beside two other designs of it
   (scripts/torch/gather_variants.cu, built here with nvcc): a thread's 27
   source cells as 27 loops, and a block's neighbourhood copied into shared
   memory first (room for 3,000 points, two blocks an SM, or 6,000, one),
   on the inputs of 1, all bit-equal to the gather.

Prints one line per measurement and writes them all to --out as JSON, with
the card's name and power limit.
"""

import argparse
import ctypes
import importlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from abacusutils_tpu_torch import _build  # noqa: E402
from abacusutils_tpu_torch.models.hod import menv_device  # noqa: E402
from abacusutils_tpu_torch.ops import grid  # noqa: E402

import chip_smoke as cs  # noqa: E402

RESULTS = []


def load_old(root):
    """The earlier tree's ops.grid and models.hod.menv_device, imported
    under `old_port`."""
    init = Path(root) / 'abacusutils_tpu_torch' / '__init__.py'
    spec = importlib.util.spec_from_file_location(
        'old_port', init, submodule_search_locations=[str(init.parent)]
    )
    mod = importlib.util.module_from_spec(spec)
    sys.modules['old_port'] = mod
    spec.loader.exec_module(mod)
    return (importlib.import_module('old_port.ops.grid'),
            importlib.import_module('old_port.models.hod.menv_device'))


def record(shape, design, ms, **extra):
    RESULTS.append(dict(shape=shape, design=design, ms=ms, **extra))
    more = ''.join(f', {k} {v}' for k, v in extra.items())
    print(f'{shape} | {design}: {ms:.4f} ms{more}', flush=True)


def in_turns(runs, reps):
    """Time each (name, fn) of `runs` by CUDA events, first to last and back;
    returns {name: [ms, ms]}."""
    times = {name: [] for name, _ in runs}
    order = list(range(len(runs)))
    for i in order + order[::-1]:
        name, fn = runs[i]
        times[name].append(cs.event_ms(fn, reps))
    return times


def lattice(dev, n, jitter):
    """The n^3 lattice moved by up to `jitter` cells on each axis, wrapped."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED + 12)
    h = cs.LBOX / n
    lat = torch.arange(n, device=dev, dtype=torch.float32) * h
    cols = []
    for ax in range(3):
        shape = [1, 1, 1]
        shape[ax] = n
        p = lat.view(shape).expand(n, n, n).reshape(-1)
        p = p + (torch.rand(n**3, generator=gen, device=dev) - 0.5) * (2 * jitter * h)
        cols.append(torch.remainder(p, cs.LBOX))
    return cols


def advected(dev, n):
    """Phase 13's advected lattice in redshift space: the Gaussian IC's
    displacements, filtered at its kcut, at z = 0.5."""
    from abacusutils_tpu_torch.models.zcv import advect_fields as adv
    from abacusutils_tpu_torch.models.zcv import cosmo
    from abacusutils_tpu_torch.models.zcv import ic_fields

    meta = cosmo.get_meta(cs.ZCV_SIM, redshift=cs.ZCV_Z)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED + 13)
    dens, disp = cs.gaussian_ic(n, meta, gen, dev)
    kcut = cs.zcv_config(n)['zcv_params']['kcut']
    dfl = [ic_fields.gaussian_filter(d, n, cs.LBOX, kcut) for d in disp]
    D, f_growth = cosmo.growth_from_meta(meta, cs.ZCV_Z)
    return list(adv.advected_positions(dfl, cs.LBOX, n, D, f_growth))


def k1m_inputs(dev, n):
    """{tag: a function making the x, y, z columns}: the lattice moved by up
    to 0.5 (phase 12), 1 and 2 cells, and phase 13's advected lattice."""
    inputs = {f'{n}^3 lattice moved <= {j} cell': (lambda j=j: lattice(dev, n, j))
              for j in (0.5, 1, 2)}
    inputs[f'{n}^3 advected lattice (phase 13, RSD)'] = lambda: advected(dev, n)
    return inputs


def variants_lib():
    """scripts/torch/gather_variants.cu built into build/ and loaded."""
    src = Path(__file__).with_name('gather_variants.cu')
    out = _build.BUILD_DIR / 'libgather_variants.so'
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, '-shared', '-o', str(out), str(src)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    lib.gather_variant.argtypes = (ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
    return lib


def compare_variants(dev):
    """The gather against gather_variants.cu's designs, in turns."""
    lib = variants_lib()
    n = cs.ZCV_NMESH
    for tag, make in k1m_inputs(dev, n).items():
        cols = make()
        gen = torch.Generator(device=dev)
        gen.manual_seed(cs.SEED)
        ws = [torch.randn(n**3, generator=gen, device=dev) for _ in range(4)]
        for nw in (4, 0):
            plan = grid.stage_gather(cols + ws[:nw], n, cs.LBOX)
            outs = {}

            def launch(variant, cap, key):
                out = outs.setdefault(key, torch.empty((nw + 1,) + (n,) * 3, device=dev))
                code = lib.gather_variant(variant, out.data_ptr(), plan.points.data_ptr(), nw,
                                          plan.starts.data_ptr(), n, cap,
                                          torch.cuda.current_stream().cuda_stream)
                if code:
                    raise SystemExit(f'gather_variant {key}: cudaError_t {code}')

            main = torch.empty((nw + 1,) + (n,) * 3, device=dev)
            runs = [('gather', lambda: grid.tsc_deposit_cells_multi(main, plan)),
                    ('27 loops a cell', lambda: launch(0, 0, '27 loops a cell'))]
            runs += [(f'shared memory, {cap} points', lambda cap=cap: launch(
                1, cap, f'shared memory, {cap} points')) for cap in (3000, 6000)]
            times = in_turns(runs, 5)
            for name, fn in runs:
                fn()
            torch.cuda.synchronize()
            for name, _ in runs:
                same = name == 'gather' or bool(torch.equal(outs[name], main))
                record(f'K1 multi-weight, {tag}, {nw + 1} columns', name,
                       float(np.mean(times[name])), runs=[round(t, 4) for t in times[name]],
                       bit_equal=same)
                if not same:
                    raise SystemExit(f'{tag}: {name} differs from the gather')
            del plan, outs, main
        del cols, ws
        torch.cuda.empty_cache()


def compare_k1m(og, dev):
    """K1's multi-weight form of both trees on phase 12's lattice (moved by
    up to half a cell), on lattices moved by up to 1 and 2 cells, and on
    phase 13's advected lattice."""
    n, nf = cs.ZCV_NMESH, 5
    for tag, make in k1m_inputs(dev, n).items():
        cols = make()
        gen = torch.Generator(device=dev)
        gen.manual_seed(cs.SEED)
        ws = [torch.randn(n**3, generator=gen, device=dev) for _ in range(nf - 1)]
        shape = f'K1 multi-weight, {tag}, {nf} columns'
        stages = [('new', lambda: grid.stage_gather(cols + ws, n, cs.LBOX))]
        if og is not None:
            stages.insert(0, ('old', lambda: og.stage_bricks(cols + ws, n, cs.LBOX,
                                                              brick=og.multi_brick_shape(n, nf))))
        times = in_turns(stages, 3)
        for name, _ in stages:
            record(f'{shape}: the stage', name, float(np.mean(times[name])),
                   runs=[round(t, 4) for t in times[name]])
        del stages
        plan = grid.stage_gather(cols + ws, n, cs.LBOX)
        outs = {'new': torch.empty((nf,) + (n,) * 3, device=dev)}
        runs = [('new', lambda: grid.tsc_deposit_cells_multi(outs['new'], plan))]
        if og is not None:
            ostaged, oplan = og.stage_bricks(cols + ws, n, cs.LBOX,
                                             brick=og.multi_brick_shape(n, nf))
            osw = [None] + ostaged[3:]
            outs['old'] = torch.zeros((nf,) + (n,) * 3, device=dev)
            overflow = torch.zeros(1, dtype=torch.int32, device=dev)

            def old(ostaged=ostaged, osw=osw, oplan=oplan, overflow=overflow):
                outs['old'].zero_()
                og.tsc_deposit_cells_multi(outs['old'], *ostaged[:3], osw, oplan, cs.LBOX, 0.0,
                                           overflow)

            runs.insert(0, ('old', old))
        times = in_turns(runs, 5)
        for name, fn in runs:
            fn()
        torch.cuda.synchronize()
        ref = outs[runs[0][0]]
        scale = float(ref.abs().max())
        for name, _ in runs:
            err = float((outs[name] - ref).abs().max())
            if err > 1e-5 * scale:
                raise SystemExit(f'{shape}: {name} differs by {err} (max {scale})')
            record(shape, name, float(np.mean(times[name])),
                   runs=[round(t, 4) for t in times[name]], max_abs_diff=err)
        del outs, runs, plan
        if og is not None:
            del ostaged, osw, oplan
        unit = grid.stage_gather(cols, n, cs.LBOX)
        one = torch.empty((1,) + (n,) * 3, device=dev)
        record(f'K1 multi-weight, {tag}, 1 column', 'new',
               cs.event_ms(lambda: grid.tsc_deposit_cells_multi(one, unit), 5))
        del unit
        bstaged, bplan = grid.stage_bricks(cols + [torch.ones_like(cols[0])], n, cs.LBOX)
        g1 = torch.zeros((n,) * 3, device=dev)

        def k1():
            g1.zero_()
            grid.tsc_deposit_cells(g1, *bstaged, bplan, cs.LBOX)

        record(f'K1, {tag}, 1 column', 'new', cs.event_ms(k1, 5))
        del cols, ws, bstaged, bplan, one, g1
        torch.cuda.empty_cache()


def compare_k7(om, dev):
    for lc in (False, True):
        kw = cs.menv_catalog(cs.N_MENV, cs.N_MENV_CLUMPS, lc, cs.SEED + 5)
        lbox = 0.0 if lc else kw['Lbox']
        rout2 = kw['r_outer'] ** 2
        shape = f'K7, {cs.N_MENV} clumped halos, {"light cone" if lc else "box"}'
        st = menv_device.stage_menv(kw['pos'], kw['mass'], kw['r_inner'], kw['r_outer'],
                                    kw['halo_lc'], kw['Lbox'], dev, kw['mcut'])
        runs = [('new', lambda: menv_device.menv_annulus(st, lbox, rout2))]
        if om is not None:
            ost = om.stage_menv(kw['pos'], kw['mass'], kw['r_inner'], kw['r_outer'],
                                kw['halo_lc'], kw['Lbox'], dev)
            cols, starts, ukeys, nbrs, ncs, periodic, work, _ = ost
            runs.insert(0, ('old', lambda: om.menv_annulus(
                cols, starts, ukeys, nbrs, ncs, periodic, lbox, rout2, kw['mcut'], work)))
        times = in_turns(runs, 3)
        outs = {name: fn() for name, fn in runs}
        ref = outs[runs[0][0]]
        for name, _ in runs:
            got = outs[name]
            rel = float(((got - ref).abs() / ref.abs().clamp_min(1e-300)).max())
            if rel > 1e-12 or not torch.equal(got == 0, ref == 0):
                raise SystemExit(f'{shape}: {name} differs (max rel {rel})')
            extra = dict(runs=[round(t, 4) for t in times[name]], max_rel_diff=rel)
            if name == 'old':
                extra['items'] = int(ost[6].shape[0])
            else:
                visits, occ, items = cs.k7_walk(st)
                extra.update(items=items, lane_occupancy=occ, walk_candidates=visits)
            record(shape, name, float(np.mean(times[name])), **extra)
        keep = menv_device.K7_CENTRES
        try:
            for centres in (32, 64, 128):
                menv_device.K7_CENTRES = centres
                sc = menv_device.stage_menv(kw['pos'], kw['mass'], kw['r_inner'], kw['r_outer'],
                                            kw['halo_lc'], kw['Lbox'], dev, kw['mcut'])
                got = menv_device.menv_annulus(sc, lbox, rout2)
                rel = float(((got - ref).abs() / ref.abs().clamp_min(1e-300)).max())
                visits, occ, items = cs.k7_walk(sc)
                record(f'{shape}, items of {centres} centres', 'new', cs.event_ms(
                    lambda: menv_device.menv_annulus(sc, lbox, rout2), 3), items=items,
                    lane_occupancy=occ, walk_candidates=visits, max_rel_diff=rel)
        finally:
            menv_device.K7_CENTRES = keep


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--old', help='unpacked earlier commit of this repository')
    ap.add_argument('--variants', action='store_true',
                    help="also time gather_variants.cu's designs of the gather")
    ap.add_argument('--out', default=str(REPO / 'build' / 'k1m_k7_compare.json'))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('k1m_k7_compare: no CUDA device', file=sys.stderr)
        return 1
    dev = torch.device('cuda', 0)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True).stdout.strip()
    print('nvidia-smi:', smi)
    og = om = None
    if args.old:
        og, om = load_old(args.old)
        sys.modules['old_port._build'].build()
    compare_k1m(og, dev)
    torch.cuda.empty_cache()
    compare_k7(om, dev)
    if args.variants:
        torch.cuda.empty_cache()
        compare_variants(dev)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({'card': smi, 'results': RESULTS}, indent=1))
    return 0


if __name__ == '__main__':
    sys.exit(main())
