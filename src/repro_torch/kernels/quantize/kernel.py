"""The CUDA quantize kernel (``csrc/quantize.cu``), built at first use by
``repro_torch.kernels.build`` and bound with ctypes."""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

from repro_torch.kernels import build

SOURCE = Path(__file__).resolve().parent / "csrc" / "quantize.cu"


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The bound library, built first if needed (once per process)."""
    lib = build.load(SOURCE)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.quantize_fwd.argtypes = [ptr, ptr, ptr, i64, i32, i32, ptr]
    lib.quantize_fwd.restype = i32
    return lib
