#!/usr/bin/env python3
"""Time the port's mode binning (K2 and K3) against an earlier tree's on one GPU.

    python3 scripts/torch/bin_compare.py [--old DIR] [--out build/bin_compare.json]

DIR is an unpacked earlier commit of this repository; its
``abacusutils_tpu_torch`` is loaded under another package name and builds
its own kernels into DIR/build. Without --old only this tree is measured.

Each tree bins the same rfft meshes, with its own bin plan, at the four
shapes the main paths run:

1. ``bin_power_modes`` (K2) on one 256^3 mesh, 128 k-bins to Nyquist, the
   TSC window (the bench step, phase 4 of chip_smoke.py);
2. ``bin_pair_modes`` without poles, 3 meshes of 256^3 (6 pairs), the same
   bins (the fused box call, phase 5);
3. ``bin_pair_modes`` with poles 0, 2, 4, Nmu = 1, 3 meshes of 550^3, 128
   k-bins to 0.5 h/Mpc, no window (``compute_power`` at docs/hod.md's
   settings, phase 7 b);
4. the same at 256^3 with 4 mu bins and the interlaced TSC window (phase
   7 d);
5. over ky slabs at 512^3, 256 k-bins to Nyquist (the sharded path, phase
   20): 3 meshes without poles and the TSC window over the whole mesh's
   rows (``run_hod_pk_fused(mesh=, slab=True)`` on one card) and over
   ranks 0 and 1 of a 4-way split, and 1 mesh with poles 0, 2, 4, no
   window (``calc_power_sharded_slab``), each laid out as
   ``parallel/fft.py:slab_rfftn`` leaves a rank's rows (x fastest), then
   the same rows made contiguous and laid out as rfftn lays a mesh; and
   the whole mesh's rows x fastest with a pitch of n1d + 4 along x (strides
   that are no powers of two).

For each tree and shape, in the order old, new, new, old: the wrapper's
time by CUDA events (5 calls after a warm-up; host work between the
launches included), and the device time of every kernel the wrapper
launches by ``torch.profiler`` (``key_averages`` over 5 calls), split into
the binning kernels themselves (names holding ``mode_bin``) and the rest
(``torch.zeros``, ``.contiguous()``, ``.float()``). Each shape's first line
gives the in-bin share of the modes and the bound (chip_smoke.binning_bound:
the bytes of the in-bin modes' seg and fields, the non-empty row groups'
spans, W and the sums, at 3.35 TB/s); each tree's line its share of the
kernel-only time. The trees' sums are checked against each
other (within 1e-5 of each pair's largest; bit for bit where both trees walk
the groups along y: every layout but slab_rfftn's), and this tree's two
launches for bit-identity. On whole meshes this tree's kernel is then timed
with each histogram layout forced (one a warp, the four tile rows' run ends
merged first; one for each tile row). The layouts of cuFFT's rfftn output at
256^3 and 550^3 and of slab_rfftn's on one rank at 512^3 are printed, and
the SASS atomics of each tree's binning kernels (cuobjdump -sass).
Everything goes to --out as JSON.
"""

import argparse
import importlib
import importlib.util
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

import abacusutils_tpu_torch  # noqa: E402
from abacusutils_tpu_torch import _build  # noqa: E402

import chip_smoke as cs  # noqa: E402

LBOX = cs.LBOX
SEED = cs.SEED
# (tag, kind, n1d, k_max (None: Nyquist), k-bins, mu-bins, poles, fields,
#  window (paste, interlaced) or None, scale, ky rows (y0, y1) or None (the
#  whole mesh), layout: None (rfftn's output as it is), 'slab_rfftn' (x
#  fastest, then y, kz slowest), 'contiguous' or 'rfftn' (copies))
SHAPES = [
    ('K2, 256^3 (phase 4)', 'power', 256, None, 128, 1, (), 1, ('TSC', False), 256.0**-3, None,
     None),
    ('K3 no poles, T=3, 256^3 (phase 5)', 'pairs', 256, None, 128, 1, (), 3, ('TSC', False),
     256.0**-3, None, None),
    ('K3 poles nmu=1, T=3, 550^3 (phase 7 b)', 'pairs', 550, 0.5, 128, 1, (0, 2, 4), 3, None,
     550.0**-3, None, None),
    ('K3 poles nmu=4, T=3, 256^3 (phase 7 d)', 'pairs', 256, None, 128, 4, (0, 2, 4), 3,
     ('TSC', True), 1.0, None, None),
] + [
    (f'K3 {form}, 512^3 ky rows {ys}, {layout} layout (phase 20)', 'pairs', 512, None, 256, 1,
     poles, nf, window, 512.0**-3, ys, layout)
    for form, poles, nf, window, rows in (
        ('no poles, T=3', (), 3, ('TSC', False), ((0, 512), (0, 128), (128, 256))),
        ('poles nmu=1, T=1', (0, 2, 4), 1, None, ((0, 512),)))
    for ys in rows
    for layout in ('slab_rfftn', 'contiguous', 'rfftn')
] + [
    # slab_rfftn's layout with each x row padded by 4 elements, so that the
    # y and kz strides are no powers of two
    ('K3 no poles, T=3, 512^3 ky rows (0, 512), slab_rfftn layout, x pitch 516', 'pairs', 512,
     None, 256, 1, (), 3, ('TSC', False), 512.0**-3, (0, 512), 'slab_rfftn padded'),
]
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
    return importlib.import_module('old_port.ops.power'), importlib.import_module('old_port._build')


def profile_ms(fn, reps=5):
    """{kernel name: device ms a call} of every kernel `fn` launches, from
    torch.profiler's key_averages over `reps` calls after a warm-up."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, 'self_device_time_total', None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            out[e.key] = out.get(e.key, 0.0) + us / reps / 1e3
    return out


def inputs(mod, dev, shape):
    """The shape's plan (from `mod`, a tree's ops.power), fields and call."""
    tag, kind, n1d, kmax, nk, nmu, poles, nf, window, scale, ys, _ = shape
    kmax = np.pi * n1d / LBOX if kmax is None else kmax
    ke, me = mod.get_k_mu_edges(LBOX, kmax, nk, nmu, False)
    dk = 2 * np.pi / LBOX
    plan = mod.get_mode_bin_plan(n1d, ((ke / dk) ** 2).astype(np.float32),
                                 (me**2).astype(np.float32), poles, dev, ys)
    W = None
    if window:
        W = torch.from_numpy(
            mod.get_W_compensated(LBOX, n1d, *window).astype(np.float32)).to(dev)
    pole_w = {p: plan.pole_w[p] for p in poles if p} or None
    return plan, W, pole_w, scale


def fields(dev, n1d, nf):
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + n1d)
    base = torch.randn((n1d,) * 3, generator=gen, device=dev)
    out = []
    for _ in range(nf):
        out.append(torch.fft.rfftn(base + 0.5 * torch.randn(base.shape, generator=gen,
                                                            device=dev)))
    return out


def laid_out(dks, ys, layout):
    """The ky rows `ys` of the meshes `dks`, in `layout` (None: as they are)."""
    if layout is None:
        return dks
    rows = [d[:, ys[0]:ys[1]] for d in dks]
    if layout == 'contiguous':
        return [r.contiguous() for r in rows]
    if layout == 'slab_rfftn padded':
        n1d, ny, kzlen = rows[0].shape
        return [torch.empty((kzlen, ny, n1d + 4), dtype=r.dtype, device=r.device)[..., :n1d]
                .permute(2, 1, 0).copy_(r) for r in rows]
    return [(cs.x_fastest if layout == 'slab_rfftn' else cs.rfftn_layout)(r) for r in rows]


def flat(res, npairs):
    if isinstance(res, tuple):
        return torch.cat([a.reshape(npairs, -1).double() for a in res], 1)
    return res.reshape(npairs, -1).double()


def run_shape(trees, dev, shape, cache):
    tag, kind, n1d, _, _, nmu, poles, nf, window, _, ys, layout = shape
    if cache.get('key') != (n1d, nf):
        cache.clear()
        torch.cuda.empty_cache()
        cache.update(key=(n1d, nf), dks=fields(dev, n1d, nf))
    dks = laid_out(cache['dks'], ys, layout)
    npairs = nf * (nf + 1) // 2
    calls = {}
    for name, mod in trees.items():
        plan, W, pole_w, scale = inputs(mod, dev, shape)
        nbins = plan.nk * plan.nmu
        if kind == 'power':
            calls[name] = (lambda mod=mod, plan=plan, W=W, scale=scale, nbins=nbins:
                           mod.bin_power_modes(dks[0], plan.seg, W, scale, nbins))
        else:
            calls[name] = (lambda mod=mod, plan=plan, W=W, scale=scale, nbins=nbins,
                           pole_w=pole_w: mod.bin_pair_modes(dks, plan.seg, W, scale, nbins,
                                                             pole_w, nmu, yslab=ys))
    nout = npairs * (nbins + (len(pole_w) * plan.nk if pole_w else 0))
    if ys is None:
        bound, share = cs.binning_bound(plan.seg, nbins, nf, window is not None,
                                        nout * (4 if kind == 'power' else 8))
    else:
        bound, share = cs.slab_bin_bound(plan.seg, nbins, ys[1] - ys[0], nf, len(pole_w or ()),
                                         plan.nk, dks[0].stride())
    along_x = dks[0].stride()[0] < dks[0].stride()[1]
    print(f'{tag}: strides {dks[0].stride()} (the new tree\'s groups along '
          f'{"x" if along_x else "y"})', flush=True)
    print(f'{tag}: in-bin share of the modes {share:.4f}; bound {bound:.4f} ms', flush=True)
    names = list(trees)
    order = names + names[::-1]
    wrap = {n: [] for n in names}
    prof = {n: [] for n in names}
    for n in order:
        wrap[n].append(cs.event_ms(calls[n]))
        prof[n].append(profile_ms(calls[n]))
    ref = flat(calls[names[0]](), npairs)
    for n in names:
        got = flat(calls[n](), npairs)
        again = flat(calls[n](), npairs)
        torch.cuda.synchronize()
        rel = float(((got - ref).abs() / ref.abs().amax(1, keepdim=True)).max())
        kern = [sum(v for k, v in p.items() if 'mode_bin' in k) for p in prof[n]]
        other = {}
        for p in prof[n]:
            for k, v in p.items():
                if 'mode_bin' not in k:
                    other[k] = other.get(k, 0.0) + v / len(prof[n])
        by_kernel = {}
        for p in prof[n]:
            for k, v in p.items():
                if 'mode_bin' in k:
                    by_kernel[k] = by_kernel.get(k, 0.0) + v / len(prof[n])
        k_ms = float(np.mean(kern))
        rec = dict(shape=tag, tree=n, wrapper_ms=float(np.mean(wrap[n])), wrapper_runs=wrap[n],
                   kernel_ms=k_ms, kernel_runs=kern, binning_kernels=by_kernel,
                   other_kernels=other, bound_ms=bound, bound_share=bound / k_ms if k_ms else None,
                   in_bin_share=share, rel_diff_to_first=rel,
                   bit_identical_to_first=bool(torch.equal(got, ref)),
                   bit_identical_repeat=bool(torch.equal(got, again)))
        RESULTS.append(rec)
        others = ', '.join(f'{_short(k)} {v:.4f}' for k, v in other.items()) or 'none'
        print(f'{tag} | {n}: kernel-only {k_ms:.4f} ms (profiler; '
              f'{", ".join(f"{_short(k)} {v:.4f}" for k, v in by_kernel.items())}), wrapper '
              f'{rec["wrapper_ms"]:.4f} ms (events), runs {[round(x, 4) for x in wrap[n]]}; '
              f'share of bound {bound / k_ms if k_ms else float("nan"):.3f}; other kernels: '
              f'{others}; rel diff to {names[0]} {rel:.2e}, bit-identical '
              f'{rec["bit_identical_to_first"]}; repeat bit-identical '
              f'{rec["bit_identical_repeat"]}', flush=True)
        if rel > 1e-5:
            raise SystemExit(f'{tag} {n}: sums differ from {names[0]} by {rel:.3e}')
        if not along_x and not rec['bit_identical_to_first']:
            raise SystemExit(f'{tag} {n}: the groups along y give other bits than {names[0]}')
    if 'new' in trees and ys is None:
        histogram_layouts(trees['new'], calls['new'], tag, bound)
    del dks


def histogram_layouts(mod, call, tag, bound):
    """This tree's binning with each histogram layout forced (`mod` is its
    ops.power): one histogram a warp, the tile rows' run ends merged first,
    and one for each row of the tile; kernel-only times by the profiler, in
    the order warp, row, row, warp."""
    keep = mod.ROW_COPY_BYTES
    times = {'one histogram a warp': [], 'one histogram a tile row': []}
    try:
        for name in list(times) + list(times)[::-1]:
            mod.ROW_COPY_BYTES = 0 if name == 'one histogram a warp' else 1 << 40
            mod._BIN_GRIDS.clear()
            prof = profile_ms(call)
            times[name].append(sum(v for k, v in prof.items() if 'mode_bin' in k))
    finally:
        mod.ROW_COPY_BYTES = keep
        mod._BIN_GRIDS.clear()
    for name, ts in times.items():
        k_ms = float(np.mean(ts))
        RESULTS.append(dict(shape=tag, tree=f'new, {name}', kernel_ms=k_ms, kernel_runs=ts,
                            bound_ms=bound, bound_share=bound / k_ms))
        print(f'{tag} | new, {name}: kernel-only {k_ms:.4f} ms (profiler), runs '
              f'{[round(x, 4) for x in ts]}; share of bound {bound / k_ms:.3f}', flush=True)


def _short(name):
    return re.sub(r'\(.*', '', name.replace('void ', '')).strip()[:90]


def layouts(dev):
    """Whether cuFFT's rfftn output is C-contiguous at the main paths'
    meshes, and the layout of slab_rfftn's output on one rank at 512^3 (its
    three passes: rfft along z, fft along y, fft along x)."""
    for name, n1d, fn in (
            ('rfftn', 256, torch.fft.rfftn), ('rfftn', 550, torch.fft.rfftn),
            ('slab_rfftn, one rank,', 512, lambda g: torch.fft.fft(
                torch.fft.fft(torch.fft.rfft(g, dim=2), dim=1), dim=0))):
        dk = fn(torch.zeros((n1d,) * 3, device=dev))
        print(f'{name} output at {n1d}^3: shape {tuple(dk.shape)}, strides {dk.stride()}, '
              f'contiguous {dk.is_contiguous()}', flush=True)
        RESULTS.append(dict(shape=f'{name} {n1d}^3', strides=list(dk.stride()),
                            contiguous=dk.is_contiguous()))
        del dk


def sass_summary(lib, tag):
    """Count the atomic, shuffle and match opcodes of each binning kernel in
    the library's SASS (cuobjdump -sass)."""
    tool = shutil.which('cuobjdump') or '/usr/local/cuda/bin/cuobjdump'
    res = subprocess.run([tool, '-sass', str(lib)], capture_output=True, text=True)
    if res.returncode:
        print('cuobjdump failed:', res.stderr[-500:])
        return
    func, counts = None, {}
    for line in res.stdout.splitlines():
        m = re.search(r'Function : (\S+)', line)
        if m:
            func = m.group(1) if 'mode_bin' in m.group(1) else None
        elif func:
            m = re.search(r'\b((?:ATOMS|ATOMG|ATOM|RED|REDG|SHFL|MATCH)\.[A-Za-z0-9_.]+)', line)
            if m:
                counts.setdefault(func, {}).setdefault(m.group(1), 0)
                counts[func][m.group(1)] += 1
    for f, c in counts.items():
        if re.search(r'ILi3ELi[02]E', f) or 'Li1ELi0E' in f or 'reduce' in f or 'power' in f:
            print(f'SASS {tag} {f}: {c}')
    RESULTS.append(dict(shape='sass', tree=tag, counts=counts))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--old', help='unpacked earlier commit of this repository')
    ap.add_argument('--out', default=str(REPO / 'build' / 'bin_compare.json'))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('bin_compare: no CUDA device', file=sys.stderr)
        return 1
    dev = torch.device('cuda', 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True).stdout.strip()
    print('nvidia-smi:', smi)
    out = Path(args.out)
    trees = {}
    if args.old:
        old_power, old_build = load_old(args.old)
        path, _, _ = old_build.build()
        sass_summary(path, 'old')
        trees['old'] = old_power
    path, _, _ = _build.build()
    sass_summary(path, 'new')
    trees['new'] = importlib.import_module('abacusutils_tpu_torch.ops.power')
    layouts(dev)
    cache = {}
    for shape in SHAPES:
        run_shape(trees, dev, shape, cache)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({'card': smi, 'torch': torch.__version__,
                               'package': abacusutils_tpu_torch.__name__, 'results': RESULTS},
                              indent=1))
    return 0


if __name__ == '__main__':
    sys.exit(main())
