"""Build the port's CUDA kernels with nvcc at first use and load them with ctypes.

Every ``csrc/*.cu`` file is compiled into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds). The library lands in
``build/torch_kernels/`` at the repository root, named by a hash of the sources
and the compiler flags, so an edited source never loads a stale library.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` turns a non-zero code into an exception.
Nothing here runs when the module is imported: the CPU test suite imports every
module of the port on machines without nvcc.
"""

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
    '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v',
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of the entry points in csrc/ (all return a cudaError_t as int)
SIGNATURES = {
    # grid, x, y, z, w, starts, ncell, nmesh, yb, box, offset, err, stream
    'tsc_deposit_cells': (_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _P, _P),
    # delta_k, seg, W, scale, n1d, nbins, out, stream
    'mode_bin_power': (_P, _P, _P, _F, _I, _I, _P, _P),
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
    current sources exists. Returns (path, seconds spent, compiler log)."""
    out = BUILD_DIR / f'libabacus_torch_{source_hash()}.so'
    if out.exists():
        return out, 0.0, ''
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f'.{os.getpid()}.tmp')
    cmd = [_nvcc(), *NVCC_FLAGS, '-o', str(tmp), *map(str, sorted(CSRC.glob('*.cu')))]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f'nvcc failed ({res.returncode}):\n{" ".join(cmd)}\n{res.stdout}{res.stderr}'
        )
    os.replace(tmp, out)
    return out, time.perf_counter() - t0, res.stdout + res.stderr


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
