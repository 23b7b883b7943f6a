"""Hand-written Hopper kernels, each beside its plain PyTorch version.

Each kernel package is ``<name>/{csrc/, kernel.py, ops.py, ref.py}``:
  csrc/     -- CUDA C++ source for sm_90a with a plain C interface
  kernel.py -- its library, built with nvcc at first use (``build``) and
               bound with ctypes
  ops.py    -- public wrapper in model layout, with its launch counter
  ref.py    -- plain PyTorch version (the CPU path and the on-card oracle)
"""
