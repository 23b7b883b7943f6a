"""The CUDA flash-attention kernel (``csrc/flash_attention.cu``), built
at first use by ``repro_torch.kernels.build`` and bound with ctypes."""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

from repro_torch.kernels import build

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The bound library, built first if needed (once per process)."""
    lib = build.load(SOURCE)
    fn = lib.flash_attention_fwd
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = ([ptr] * 4 + [i32] * 7 + [i64] * 12
                   + [i32, i32, i32, ctypes.c_float, i32, ptr])
    fn.restype = i32
    return lib
