"""Build the port's CUDA kernels with nvcc at first use and load them with ctypes.

Every ``csrc/*.cu`` file is compiled by its own nvcc process, all of them
started together, and the objects are linked into one shared library with a
plain C interface (no PyTorch headers, so a build takes seconds). The library
lands in ``build/torch_kernels/`` at the repository root, named by a hash of
the sources and the compiler flags, so an edited source never loads a stale
library.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` turns a non-zero code into an exception.
Nothing here runs when the module is imported: the CPU test suite imports every
module of the port on machines without nvcc.
"""

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from functools import cache
from pathlib import Path

CSRC = Path(__file__).resolve().parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parent.parent / 'build' / 'torch_kernels'
NVCC_FLAGS = (
    '-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
    '-Xcompiler', '-fPIC', '-Xptxas', '-v',
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_D = ctypes.c_double
# C signatures of the entry points in csrc/ (all return a cudaError_t as int)
SIGNATURES = {
    # grid, x, y, z, w, work, nitems, nmesh, brick (x, y, z), margin (x, y,
    # z), box, offset, kind, wrap, overflow, slab planes (0: the periodic
    # grid), the slab's x0 and halo planes, fault, stream
    'tsc_deposit_bricks': (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _I, _I,
                           _P, _I, _I, _I, _P, _P),
    # kind, nmesh, shared bytes, out blocks
    'tsc_deposit_blocks_per_sm': (_I, _I, _I, _P),
    # grids, packed points, weight columns, unit grid first, starts, nmesh,
    # brick (x, y, z), stream
    'tsc_gather_cells': (_P, _P, _I, _I, _P, _I, _I, _I, _I, _P),
    # weight columns, unit grid first, out blocks
    'tsc_gather_blocks_per_sm': (_I, _I, _P),
    # nfields, npoles, warps, shared bytes, device, out blocks per SM
    'mode_bin_pairs_occupancy': (_I, _I, _I, _I, _I, _P),
    # fields (array of pointers), nfields, the fields' strides (x, y, z, in
    # complex elements), seg, non-empty groups of four rows, their count, row
    # spans, W, scale, n1d, nbins, nmu, pole degrees (array of ints), npoles,
    # blocks, warps, histogram copies a warp, shared bytes, device, partials,
    # out, out is f64, the rows along y of the fields and the plan (n1d, or a
    # ky slab's), the slab's first global iy, the groups run along x (1) or
    # y (0), stream
    'mode_bin_pairs': (ctypes.POINTER(_P), _I, _L, _L, _L, _P, _P, _I, _P, _P, _F, _I, _I, _I,
                       ctypes.POINTER(_I), _I, _I, _I, _I, _I, _I, _P, _P, _I, _I, _I, _I, _P),
    # the first side's sorted x, y, z, the second side's, its cell starts, the
    # work list, nitems, the walk's rows, nrows, nc, groups a row, nc / lbox,
    # lbox, squared edges, nb1, nb2, aux, mode, use_wrap, skip_self, histogram
    # copies, the bin table's edges and counts, its cells, shift and first
    # key, out (int64), stream
    'pair_count_cells': (_P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _F, _F, _P, _I, _I,
                         _F, _I, _I, _I, _I, _P, _P, _I, _I, _I, _P, _P),
    # x1, y1, z1, n1, x2, y2, z2, n2, rows of the second set a block, lbox,
    # the round's threshold, squared edges, nb1, nb2, aux, mode, skip_self,
    # the first set's first row in the second (skip_self's index offset), is
    # f64, one period, histogram copies, the bin table (as above), out
    # (int64), stream
    'pair_count_all': (_P, _P, _P, _I, _P, _P, _P, _I, _I, _D, _D, _P, _I, _I, _D, _I, _I, _I, _I,
                       _I, _I, _P, _P, _I, _I, _I, _P, _P),
    # the plan's reach (int32), rows, rows a block, row values (f32),
    # multiplicities (f64), izlo, izhi (int32), kzv, kz2, thresholds (f32),
    # nkout, threads a block, partials, out (f64), stream
    'zcv_window_rows': (_P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _P),
    # weights, their x and y strides (elements), n1d, kz in a pi bin, the
    # Nyquist kz, rows, items, nitems, item starts, pi bins' first kz, nk,
    # npi, threads a block, partials, out (f64), stream
    'kppi_bin': (_P, _L, _L, _I, _I, _I, _P, _P, _I, _P, _P, _I, _I, _I, _P, _P, _P),
    # satellites (0: centrals), the columns (array of pointers, population.py
    # CODE_COLUMNS), host_at, the central codes and their count, the
    # parameters (array of pointers, 3 x population.py CODE_PARAMS), the
    # tracers' bitmask, n, out (int8), stream
    'hod_keep_codes': (_I, ctypes.POINTER(_P), _P, _P, _L, ctypes.POINTER(_P), _I, _L, _P, _P),
    # x, y, z (f32), query, work, nitems, pstart, pnum, nn_d2 (f64), stream
    'nn_within_halo': (_P, _P, _P, _P, _P, _I, _P, _P, _P, _P),
    # x, y, z, m, rin2 (f64, sorted by cell), cells (3, n), n, starts, ukeys
    # or null, nu, cells along each axis, periodic, lbox, r_out^2, query,
    # work, nitems, threads a block, round, out (f64), stream
    'menv_annulus': (_P, _P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _D, _D, _P, _P, _I,
                     _I, _I, _P, _P),
}


def source_hash():
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob('*.cu*')):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _nvcc():
    for cand in (
        os.path.join(os.environ.get('CUDA_HOME', '/usr/local/cuda'), 'bin', 'nvcc'),
        shutil.which('nvcc'),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError('nvcc not found (set CUDA_HOME or put nvcc on PATH)')


def build():
    """Compile csrc/*.cu into build/torch_kernels/ unless a library for the
    current sources exists. Returns (path, seconds spent, compiler log); the
    log (each source's nvcc seconds, then ptxas's registers and spills of
    every kernel) is kept beside the library and returned with it later
    too."""
    out = BUILD_DIR / f'libabacus_torch_{source_hash()}.so'
    log_path = out.with_suffix('.log')
    if out.exists():
        return out, 0.0, log_path.read_text() if log_path.exists() else ''
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    stem = f'{out.with_suffix("")}.{os.getpid()}'
    srcs = sorted(CSRC.glob('*.cu'))
    objs = [f'{stem}.{src.stem}.o' for src in srcs]
    cmds = [[nvcc, *NVCC_FLAGS, '-c', '-o', obj, str(src)] for src, obj in zip(srcs, objs)]
    t0 = time.perf_counter()
    try:
        # one nvcc per source, all started together, each logging to its own file
        with contextlib.ExitStack() as stack:
            logs = [stack.enter_context(open(f'{obj}.log', 'w+')) for obj in objs]
            procs = [
                subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
                for cmd, log in zip(cmds, logs)
            ]
            took = [None] * len(procs)
            while None in took:
                for i, proc in enumerate(procs):
                    if took[i] is None and proc.poll() is not None:
                        took[i] = time.perf_counter() - t0
                time.sleep(0.05)
            codes = [proc.returncode for proc in procs]
            text = [f'nvcc {src.name}: {t:.2f} s\n' for src, t in zip(srcs, took)]
            for log in logs:
                log.seek(0)
                text.append(log.read())
        failed = [
            f'nvcc failed ({code}):\n{" ".join(cmd)}\n{t}'
            for code, cmd, t in zip(codes, cmds, text) if code != 0
        ]
        if failed:
            raise RuntimeError('\n'.join(failed))
        tmp = f'{stem}.tmp'
        cmd = [nvcc, '-shared', '-o', tmp, *objs]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f'nvcc link failed ({res.returncode}):\n{" ".join(cmd)}\n{res.stdout}{res.stderr}'
            )
        log_path.write_text(''.join(text))
        os.replace(tmp, out)
    finally:
        for f in objs + [f'{obj}.log' for obj in objs]:
            if os.path.exists(f):
                os.remove(f)
    return out, time.perf_counter() - t0, ''.join(text)


@cache
def lib():
    """The loaded kernel library (built on first call)."""
    path, _, _ = build()
    so = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(so, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return so


def check(code, name):
    if code != 0:
        raise RuntimeError(f'{name}: CUDA launch failed with cudaError_t {code}')
