"""abacusutils-tpu on PyTorch and CUDA: the HOD, P(k), pair-count and
prepare_sim paths of ``abacusutils_tpu`` ported to an NVIDIA Hopper GPU.

The layout mirrors the JAX package (``ops/grid.py``, ``ops/power.py``,
``ops/tpcf.py``, ``ops/shear.py``, ``models/hod/``, ``models/pipeline.py``),
so each function has an obvious counterpart there. Plain tensor code is
PyTorch; the TSC deposit, the P(k) mode binning, the pair counts and
prepare_sim's nearest-neighbour and annulus-mass sums are hand-written CUDA
kernels (``csrc/``), built with nvcc at first use. Each kernel wrapper runs
its plain PyTorch version on CPU tensors, and launches the kernel (or
raises) on CUDA tensors.
"""

__version__ = '0.1.0'
